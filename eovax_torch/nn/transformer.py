"""Transformer encoder with ``torch.nn.TransformerEncoderLayer`` semantics.

Port of ``eovax/nn/transformer.py``. The hypernetwork weight generators run
their wavelength tokens through it: packed ``in_proj`` q/k/v projection,
post-norm (or pre-norm) residual order, erf GELU, LayerNorm eps 1e-5. The
parameter names are torch's (``layers.0.self_attn.in_proj_weight``), so a
reference state dict loads as it is.

The sequences are at most a few hundred tokens, so this is not a hot path:
it runs in fp32 with plain matmuls and softmax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MultiheadSelfAttention(nn.Module):
    """``torch.nn.MultiheadAttention``-compatible self-attention (packed qkv)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        # torch MHA's own init of the packed projection: xavier, zero bias.
        nn.init.xavier_uniform_(self.in_proj_weight, generator=generator)
        self.in_proj_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq, e = x.shape  # unbatched [S, E]
        hd = e // self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)

        def heads(t):  # [S, E] -> [H, S, hd]
            return t.reshape(seq, self.num_heads, hd).transpose(0, 1)

        q, k, v = heads(q), heads(k), heads(v)
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / hd**0.5)
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(0, 1).reshape(seq, e))


class TransformerEncoderLayer(nn.Module):
    """One encoder layer; ``norm_first=False`` is post-norm (the encoder
    generator), ``True`` pre-norm (the factorized generator)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 norm_first: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.norm_first = norm_first
        self.self_attn = MultiheadSelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        # Active only in train mode, as the JAX package's dropout is active
        # only when a dropout RNG is given.
        self.dropout = nn.Dropout(dropout_rate)

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.dropout(F.gelu(self.linear1(x))))  # erf GELU

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            x = x + self.dropout(self.self_attn(self.norm1(x)))
            return x + self._ff(self.norm2(x))
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        return self.norm2(x + self._ff(x))


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (no final norm, matching the torch default)."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 2048,
                 norm_first: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, norm_first, dropout_rate)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x

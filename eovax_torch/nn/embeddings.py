"""Timestep and positional embeddings (diffusers / UViT semantics).

Port of ``eovax/nn/embeddings.py``. Nothing of the port's training or
inference paths uses them; they are kept so that the module surface of the
JAX package is whole:

- ``get_timestep_embedding`` / ``Timesteps``: the DDPM sinusoidal timestep
  embedding with ``flip_sin_to_cos``, ``downscale_freq_shift``, ``scale`` and
  the zero pad of an odd width.
- ``TimestepEmbedding``: Linear → act → Linear with an optional bias-free
  condition projection and a post-activation.
- ``RelativePositionBias``: a learnable Swin-style 2D relative position bias
  over a window, extrapolated to larger grids by padding its table with −1e7.
- ``LearnedPositionalEmbedding``: an additive learned table, N(0, 0.02),
  with the [C, H, W] → [(H·W), C] flatten.

Parameter names are the JAX package's (``linear_1``, ``cond_proj``,
``relative_bias_table`` [2H−1, 2W−1, heads], ``embeds``), so
``state_dict_from_variables`` of its variables loads with ``strict=True``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "silu": F.silu,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": F.relu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
}


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = False, downscale_freq_shift: float = 1.0,
                           scale: float = 1.0, max_period: int = 10_000) -> torch.Tensor:
    """[N] timesteps → [N, embedding_dim] fp32 sinusoidal embedding."""
    if timesteps.ndim != 1:
        raise ValueError("Timesteps should be a 1d-array")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class Timesteps(nn.Module):
    """Stateless wrapper of :func:`get_timestep_embedding`."""

    def __init__(self, num_channels: int, flip_sin_to_cos: bool = False,
                 downscale_freq_shift: float = 1.0, scale: float = 1.0):
        super().__init__()
        self.num_channels = num_channels
        self.flip_sin_to_cos = flip_sin_to_cos
        self.downscale_freq_shift = downscale_freq_shift
        self.scale = scale

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return get_timestep_embedding(timesteps, self.num_channels,
                                      flip_sin_to_cos=self.flip_sin_to_cos,
                                      downscale_freq_shift=self.downscale_freq_shift,
                                      scale=self.scale)


class TimestepEmbedding(nn.Module):
    """Linear → act → Linear time-embedding MLP; ``cond_proj`` (no bias) adds a
    projected condition to the input first. ``act_fn``/``post_act_fn`` name
    silu, swish, gelu (tanh-approximated), relu or mish."""

    def __init__(self, in_channels: int, time_embed_dim: int, act_fn: str = "silu",
                 out_dim: int | None = None, post_act_fn: str | None = None,
                 cond_proj_dim: int | None = None, sample_proj_bias: bool = True):
        super().__init__()
        self.act_fn, self.post_act_fn = act_fn, post_act_fn
        self.cond_proj = (nn.Linear(cond_proj_dim, in_channels, bias=False)
                          if cond_proj_dim is not None else None)
        self.linear_1 = nn.Linear(in_channels, time_embed_dim, bias=sample_proj_bias)
        self.linear_2 = nn.Linear(time_embed_dim, out_dim or time_embed_dim,
                                  bias=sample_proj_bias)

    def forward(self, sample: torch.Tensor, condition: torch.Tensor | None = None
                ) -> torch.Tensor:
        if condition is not None:
            if self.cond_proj is None:
                raise ValueError("condition given but cond_proj_dim is None")
            sample = sample + self.cond_proj(condition)
        h = self.linear_2(_ACTIVATIONS[self.act_fn](self.linear_1(sample)))
        return h if self.post_act_fn is None else _ACTIVATIONS[self.post_act_fn](h)


def _relative_position_index(h: int, w: int) -> np.ndarray:
    """Swin-style index map [(H·W), (H·W)] into a flattened (2H−1)·(2W−1) bias
    table (numpy, a constant per grid shape)."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)  # (2, HW)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, HW, HW)
    rel = rel.transpose(1, 2, 0).copy()  # (HW, HW, 2)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # (HW, HW)


class RelativePositionBias(nn.Module):
    """Learnable 2D relative position bias. Called with a grid shape
    ``(B, H, W)``, returns [B·num_heads, HW, HW] to add to attention logits;
    a grid larger than the window reads −1e7 (≈ −inf after softmax) for the
    offsets beyond the table. The table starts at zero."""

    def __init__(self, window_size: tuple[int, int] | int, num_heads: int):
        super().__init__()
        win = (window_size, window_size) if isinstance(window_size, int) else tuple(window_size)
        self.window_size, self.num_heads = win, num_heads
        self.relative_bias_table = nn.Parameter(torch.zeros(2 * win[0] - 1, 2 * win[1] - 1,
                                                            num_heads))

    def forward(self, grid_shape: tuple[int, int, int]) -> torch.Tensor:
        b, h, w = grid_shape
        if h < self.window_size[0] or w < self.window_size[1]:
            raise NotImplementedError("grid smaller than window: not supported")
        pad_h, pad_w = h - self.window_size[0], w - self.window_size[1]
        # (2H−1, 2W−1, heads): pad the two leading dims (F.pad counts from the last).
        table = F.pad(self.relative_bias_table, (0, 0, pad_w, pad_w, pad_h, pad_h),
                      value=-(10.0**7))
        idx = torch.from_numpy(_relative_position_index(h, w).reshape(-1)).to(table.device)
        bias = table.reshape(-1, self.num_heads)[idx].reshape(h * w, h * w, self.num_heads)
        return bias.permute(2, 0, 1).repeat(b, 1, 1)  # (B·heads, HW, HW)


class LearnedPositionalEmbedding(nn.Module):
    """Additive learned positional table ``embeds`` of ``embeds_shape``,
    N(0, 0.02); a [C, H, W] table is added to [B, (H·W), C] states flattened."""

    def __init__(self, embeds_shape: tuple[int, ...]):
        super().__init__()
        self.embeds = nn.Parameter(torch.empty(tuple(embeds_shape)))
        nn.init.normal_(self.embeds, 0.0, 0.02)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.embeds.normal_(0.0, 0.02, generator=generator)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        embeds = self.embeds
        if embeds.ndim == 3 and hidden_states.ndim - 1 == 2:
            c, h, w = embeds.shape
            embeds = embeds.reshape(c, h * w).T  # C H W → (H·W) C
        if tuple(hidden_states.shape[1:]) != tuple(embeds.shape):
            raise ValueError(f"positional table {tuple(embeds.shape)} does not match hidden "
                             f"states {tuple(hidden_states.shape[1:])}")
        return hidden_states + embeds[None].to(hidden_states.dtype)

"""Wavelength-conditioned dynamic convolutions (hypernetwork stems).

Port of ``eovax/nn/dynamic_conv.py``. A small transformer maps per-band
wavelengths (µm) to the weights of the input and output 3×3 conv stems, so
one model encodes any sensor. The hypernetwork runs in fp32; the generated
kernel, in torch's OIHW layout, feeds one ``F.conv2d`` in the compute dtype.

Reference semantics kept for checkpoint fidelity: the sincos embedding of
wvs·1000 (µm → nm), ``SCALER = 0.1`` on weight and bias, and the decoder's
bias scaled twice in the forward path but once in
:meth:`DynamicConvDecoder.get_distillation_weight`.

The sincos embedding uses plain fp32 ``torch.sin``/``torch.cos``: their
range reduction is accurate for the arguments of up to ~12000 rad that
wvs·1000 gives, so the 3-part 2π reduction the JAX package needs for XLA's
sin/cos is not copied (the parity tests hold the two embeddings together).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.nn.transformer import TransformerEncoder


def sincos_wavelength_embed(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[M] positions (already in nm) → [M, embed_dim] fp32 sin/cos embedding,
    omega = 1/10000^(2i/D)."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device) / (embed_dim / 2.0)
    omega = 1.0 / (10000.0**omega)
    out = pos.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def apply_dynamic_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
                         stride: int = 1, padding: int = 1,
                         policy: Policy = FULL_PRECISION) -> torch.Tensor:
    """Convolve NCHW ``x`` with a generated OIHW kernel and bias."""
    c = policy.cast_to_compute
    return F.conv2d(c(x), c(weight), c(bias), stride=stride, padding=padding)


class FCResLayer(nn.Module):
    """Fully-connected residual layer: x + relu(w2(relu(w1(x))))."""

    def __init__(self, linear_size: int = 128):
        super().__init__()
        self.w1 = nn.Linear(linear_size, linear_size)
        self.w2 = nn.Linear(linear_size, linear_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.relu(self.w2(F.relu(self.w1(x))))


class TransformerWeightGenerator(nn.Module):
    """Transformer hypernetwork emitting conv weights per wavelength token.

    Sequence = [128 learned weight tokens; N wavelength tokens; 1 bias token]
    through a post-norm encoder. Weights come from the wavelength-token
    outputs (+ the wavelength features); the bias from the final token
    (encoder variant) or from the wavelength-token outputs + the input bias
    token, one scalar per output channel (decoder variant).
    """

    def __init__(self, input_dim: int, output_dim: int, embed_dim: int, num_heads: int = 4,
                 num_layers: int = 1, variant: str = "encoder", wt_num: int = 128):
        super().__init__()
        self.variant = variant
        self.wt_num = wt_num
        self.weight_tokens = nn.Parameter(torch.empty(wt_num, input_dim))
        self.bias_token = nn.Parameter(torch.empty(1, input_dim))
        self.transformer_encoder = TransformerEncoder(
            input_dim, num_heads, num_layers, dim_feedforward=2048, norm_first=False
        )
        self.fc_weight = nn.Linear(input_dim, output_dim)
        self.fc_bias = nn.Linear(input_dim, embed_dim if variant == "encoder" else 1)

    def forward(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([self.weight_tokens, waves, self.bias_token], dim=0)
        out = self.transformer_encoder(x)
        weights = self.fc_weight(out[self.wt_num : -1] + waves)  # [N, output_dim]
        if self.variant == "encoder":
            return weights, self.fc_bias(out[-1])  # [embed_dim]
        return weights, self.fc_bias(out[self.wt_num : -1] + self.bias_token)  # [N, 1]


class FactorizedWeightGenerator(nn.Module):
    """Low-rank factorized hypernetwork: a pre-norm encoder (ff = 4·d,
    dropout 0.1 in train mode) and a Linear → GELU → Linear weight head."""

    def __init__(self, input_dim: int, output_dim: int, embed_dim: int, num_heads: int = 4,
                 num_layers: int = 2, rank_ratio: int = 4, variant: str = "encoder",
                 wt_num: int = 128):
        super().__init__()
        self.variant = variant
        self.wt_num = wt_num
        self.weight_tokens = nn.Parameter(torch.empty(wt_num, input_dim))
        self.bias_token = nn.Parameter(torch.empty(1, input_dim))
        self.transformer_encoder = TransformerEncoder(
            input_dim, num_heads, num_layers, dim_feedforward=input_dim * 4,
            norm_first=True, dropout_rate=0.1,
        )
        rank = max(32, output_dim // rank_ratio)
        self.fc_weight = nn.Sequential(
            nn.Linear(input_dim, rank), nn.GELU(), nn.Linear(rank, output_dim)
        )
        self.fc_bias = nn.Linear(input_dim, embed_dim if variant == "encoder" else 1)

    def forward(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([self.weight_tokens, waves, self.bias_token], dim=0)
        out = self.transformer_encoder(x)
        features = out[self.wt_num : -1] + waves
        weights = self.fc_weight(features)
        if self.variant == "encoder":
            return weights, self.fc_bias(out[-1])
        return weights, self.fc_bias(features + self.bias_token)


class _DynamicConvBase(nn.Module):
    """Shared machinery of the encoder and decoder stems."""

    SCALER = 0.1
    VARIANT = "encoder"

    def __init__(self, wv_planes: int, embed_dim: int = 128, inter_dim: int = 128,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1, num_layers: int = 1,
                 num_heads: int = 4, generator_type: str = "transformer", rank_ratio: int = 4,
                 policy: Policy = FULL_PRECISION):
        super().__init__()
        del inter_dim  # kept for config parity; unused, as in the reference
        self.wv_planes = wv_planes
        self.embed_dim = embed_dim
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.policy = policy
        kw = dict(input_dim=wv_planes, output_dim=kernel_size * kernel_size * embed_dim,
                  embed_dim=embed_dim, num_heads=num_heads, num_layers=num_layers,
                  variant=self.VARIANT)
        if generator_type == "factorized":
            self.weight_generator = FactorizedWeightGenerator(rank_ratio=rank_ratio, **kw)
        else:
            self.weight_generator = TransformerWeightGenerator(**kw)
        self.fclayer = FCResLayer(wv_planes)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        # Reference init: xavier-uniform Linears with bias 0.01, tokens N(0, 0.02).
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.fill_(0.01)
        self.weight_generator.weight_tokens.normal_(0.0, 0.02, generator=generator)
        self.weight_generator.bias_token.normal_(0.0, 0.02, generator=generator)

    def _raw_weight_bias(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        waves = self.fclayer(sincos_wavelength_embed(self.wv_planes, wvs.float() * 1000.0))
        return self.weight_generator(waves)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return apply_dynamic_kernel(x, weight, bias, stride=self.stride, padding=self.padding,
                                    policy=self.policy)


class DynamicConv(_DynamicConvBase):
    """Encoder input stem: [B, N_wv, H, W] → [B, embed_dim, H, W]."""

    VARIANT = "encoder"

    def generate(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [E, N, K, K], bias [E]), both scaled by 0.1."""
        weight, bias = self._raw_weight_bias(wvs)
        n, k = wvs.shape[0], self.kernel_size
        weight = weight.reshape(n, k, k, self.embed_dim).permute(3, 0, 1, 2)
        return weight * self.SCALER, bias.reshape(self.embed_dim) * self.SCALER

    def get_distillation_weight(self, wvs_microns: torch.Tensor):
        """Torch-layout (weight [E, N, K, K], bias [E]) ·0.1 for stage-1 distillation."""
        return self.generate(wvs_microns)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        return self._conv(x, *self.generate(wvs))


class DynamicConvDecoder(_DynamicConvBase):
    """Decoder output stem: [B, embed_dim, H, W] → [B, N_wv, H, W]."""

    VARIANT = "decoder"

    def __init__(self, wv_planes: int, num_layers: int = 2, **kw):
        super().__init__(wv_planes, num_layers=num_layers, **kw)

    def _generate_raw(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        weight, bias = self._raw_weight_bias(wvs)
        n, k = wvs.shape[0], self.kernel_size
        weight = weight.reshape(n, k, k, self.embed_dim).permute(0, 3, 1, 2)  # [N, E, K, K]
        return weight, bias.reshape(n)

    def generate(self, wvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [N, E, K, K] ·0.1, bias [N] ·0.01 — the double-scaled bias)."""
        weight, bias = self._generate_raw(wvs)
        return weight * self.SCALER, bias * (self.SCALER * self.SCALER)

    def get_distillation_weight(self, wvs_microns: torch.Tensor):
        """Torch-layout (weight [N, E, K, K], bias [N]) ·0.1 — single bias scale."""
        weight, bias = self._generate_raw(wvs_microns)
        return weight * self.SCALER, bias * self.SCALER

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        return self._conv(x, *self.generate(wvs))

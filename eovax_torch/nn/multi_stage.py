"""Multi-stage dynamic decoder heads: experimental output-stem variants.

Port of ``eovax/nn/multi_stage.py`` (NCHW). Each head maps a decoder's
[B, embed_dim, H, W] activation to N bands and exposes
``get_distillation_weight`` (its final projection, torch layout
[N, embed_dim, K, K] and bias [N], both ·0.1) for stage-1 distillation:

- ``MultiStageDynamicDecoder``: shared refinement blocks → a FiLM on the mean
  wavelength → the wavelength-specific projection, from
  ``WavelengthAdaptiveWeightGenerator`` (a K·K spatial pattern ⊗ a channel
  mixing vector per band) or a ``TransformerWeightGenerator``;
- ``StackedDynamicDecoder``: stacked depthwise dynamic convs with residuals →
  the projection;
- ``ProgressiveMultiStageDynamicDecoder``: a shared pre-conv pair →
  progressive refinement stages → the projection.

No config of the repo uses them. Their GroupNorms are the JAX package's flax
``nn.GroupNorm`` (min(32, C) groups, eps 1e-5, fp32 out), not the Pallas
kernel, so ``F.group_norm`` is their counterpart here; their convs are the
library's, as the JAX package leaves them to XLA. The generators run in fp32
(TF32 off through ``Policy.activate``). Parameter names are the JAX
package's (``shared_0.conv1``, ``film_0``, ``final_generator``,
``inter_gen_0``, ``pre_norm_1``, ``wave_fc_0``, ``stage_0``), so
``state_dict_from_variables`` of its variables loads with ``strict=True``.
Weights come from ``eovax_torch.nn.init.init_parameters``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.nn.blocks import Conv2d
from eovax_torch.nn.dynamic_conv import (
    FCResLayer,
    TransformerWeightGenerator,
    apply_dynamic_kernel,
    sincos_wavelength_embed,
)
from eovax_torch.nn.transformer import TransformerEncoder

SCALER = 0.1


def _gn(dim: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, dim), dim, eps=1e-5)


def _norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.GroupNorm(dtype=float32)``: fp32 statistics and output."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps)


def _conv(channels_in: int, channels_out: int, kernel_size: int, policy: Policy) -> Conv2d:
    return Conv2d(channels_in, channels_out, kernel_size, padding=kernel_size // 2, policy=policy)


class SharedRefinementBlock(nn.Module):
    """Wavelength-agnostic residual block: conv → GN → SiLU → conv → GN
    (+ the input) → SiLU."""

    def __init__(self, embed_dim: int, expansion: int = 2, kernel_size: int = 3,
                 use_residual: bool = True, policy: Policy = FULL_PRECISION):
        super().__init__()
        hid = embed_dim * expansion
        self.policy, self.use_residual = policy, use_residual
        self.conv1 = _conv(embed_dim, hid, kernel_size, policy)
        self.norm1 = _gn(hid)
        self.conv2 = _conv(hid, embed_dim, kernel_size, policy)
        self.norm2 = _gn(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        h = c(F.silu(_norm(self.norm1, self.conv1(x))))
        h = c(_norm(self.norm2, self.conv2(h)))
        if self.use_residual:
            h = h + x.to(h.dtype)
        return F.silu(h)


class WavelengthAdaptiveWeightGenerator(nn.Module):
    """Factorized spatial ⊗ channel generator: a wave processor (Linear,
    LayerNorm, GELU, Linear, LayerNorm), a pre-norm transformer over
    ``wt_num`` learned tokens and the bands, then per band the outer product of
    a K·K spatial pattern and an ``in_channels`` mixing vector, and a bias."""

    def __init__(self, wv_planes: int, in_channels: int, kernel_size: int = 3,
                 num_heads: int = 4, num_layers: int = 2, wt_num: int = 64):
        super().__init__()
        self.wt_num = wt_num
        self.wp_0 = nn.Linear(wv_planes, wv_planes * 2)
        self.wp_ln1 = nn.LayerNorm(wv_planes * 2, eps=1e-6)  # flax's default eps
        self.wp_3 = nn.Linear(wv_planes * 2, wv_planes)
        self.wp_ln2 = nn.LayerNorm(wv_planes, eps=1e-6)
        self.weight_tokens = nn.Parameter(torch.empty(wt_num, wv_planes))
        self.transformer = TransformerEncoder(wv_planes, num_heads, num_layers,
                                              dim_feedforward=wv_planes * 4, norm_first=True,
                                              dropout_rate=0.1)
        self.spatial_0 = nn.Linear(wv_planes, wv_planes)
        self.spatial_2 = nn.Linear(wv_planes, kernel_size**2)
        self.channel_0 = nn.Linear(wv_planes, wv_planes)
        self.channel_2 = nn.Linear(wv_planes, in_channels)
        self.bias_head = nn.Linear(wv_planes, 1)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        for m in (self.wp_0, self.wp_3, self.spatial_0, self.spatial_2, self.channel_0,
                  self.channel_2, self.bias_head):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            m.bias.zero_()
        self.weight_tokens.normal_(0.0, 0.02, generator=generator)

    def forward(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = self.wp_ln2(self.wp_3(F.gelu(self.wp_ln1(self.wp_0(waves)))))
        feats = self.transformer(torch.cat([self.weight_tokens, h], dim=0))[self.wt_num:]
        spatial = self.spatial_2(F.gelu(self.spatial_0(feats)))
        channel = self.channel_2(F.gelu(self.channel_0(feats)))
        weights = torch.einsum("ns,nc->nsc", spatial, channel).reshape(feats.shape[0], -1)
        return weights, self.bias_head(feats)


class _DecoderHeadBase(nn.Module):
    """The wavelength features, the final projection and the distillation API."""

    def __init__(self, wv_planes: int = 128, embed_dim: int = 128, kernel_size: int = 3,
                 num_heads: int = 4, num_layers: int = 2, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.wv_planes, self.embed_dim, self.kernel_size = wv_planes, embed_dim, kernel_size
        self.num_heads, self.num_layers, self.policy = num_heads, num_layers, policy

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        # The hypernetworks' init: xavier-uniform Linears with bias 0.01, tokens
        # N(0, 0.02) (WavelengthAdaptiveWeightGenerator redoes its own after this).
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.fill_(0.01)
            elif isinstance(m, TransformerWeightGenerator):
                m.weight_tokens.normal_(0.0, 0.02, generator=generator)
                m.bias_token.normal_(0.0, 0.02, generator=generator)

    def _generator(self, num_layers: int) -> TransformerWeightGenerator:
        return TransformerWeightGenerator(self.wv_planes, self.kernel_size**2 * self.embed_dim,
                                          self.embed_dim, self.num_heads, num_layers,
                                          variant="decoder")

    def _waves(self, wvs: torch.Tensor) -> torch.Tensor:
        return self.wave_encoder(sincos_wavelength_embed(self.wv_planes, wvs.float() * 1000.0))

    def _final_projection(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight [N, E, K, K], bias [N]), both ·0.1."""
        weight, bias = self.final_generator(waves)
        n, k = waves.shape[0], self.kernel_size
        weight = weight.reshape(n, k, k, self.embed_dim).permute(0, 3, 1, 2)
        return weight * SCALER, bias.reshape(n) * SCALER

    def _project(self, x: torch.Tensor, waves: torch.Tensor) -> torch.Tensor:
        return apply_dynamic_kernel(x, *self._final_projection(waves),
                                    padding=self.kernel_size // 2, policy=self.policy)

    def get_distillation_weight(self, wvs_microns: torch.Tensor):
        """Torch-layout (weight [N, E, K, K], bias [N]) of the final projection."""
        return self._final_projection(self._waves(wvs_microns))


class MultiStageDynamicDecoder(_DecoderHeadBase):
    """Shared refinement → FiLM on the mean wavelength → the wavelength projection."""

    def __init__(self, num_shared_blocks: int = 2, expansion: int = 2,
                 use_enhanced_generator: bool = True, **kw):
        super().__init__(**kw)
        e, k = self.embed_dim, self.kernel_size
        for i in range(num_shared_blocks):
            setattr(self, f"shared_{i}", SharedRefinementBlock(e, expansion, k,
                                                               policy=self.policy))
        self.num_shared_blocks = num_shared_blocks
        self.film_0 = nn.Linear(self.wv_planes, self.wv_planes * 2)
        self.film_2 = nn.Linear(self.wv_planes * 2, e * 2)
        self.mid_conv = _conv(e, e, k, self.policy)
        self.mid_norm = _gn(e)
        self.final_generator = (
            WavelengthAdaptiveWeightGenerator(self.wv_planes, e, k, self.num_heads,
                                              self.num_layers)
            if use_enhanced_generator else self._generator(self.num_layers))
        self.wave_encoder = FCResLayer(self.wv_planes)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        waves = self._waves(wvs)
        for i in range(self.num_shared_blocks):
            x = getattr(self, f"shared_{i}")(x)
        gamma, beta = self.film_2(F.gelu(self.film_0(waves.mean(dim=0)))).chunk(2)
        x = _norm(self.mid_norm, self.mid_conv(x))
        x = x * (1.0 + gamma[:, None, None]) + beta[:, None, None]
        return self._project(self.policy.cast_to_compute(F.silu(x)), waves)


class StackedDynamicDecoder(_DecoderHeadBase):
    """Stacked depthwise dynamic convs with residuals → the projection."""

    def __init__(self, num_stack_layers: int = 3, generator_layers: int = 1, **kw):
        super().__init__(**kw)
        self.wave_encoder = FCResLayer(self.wv_planes)
        self.num_inter = num_stack_layers - 1
        for i in range(self.num_inter):
            setattr(self, f"inter_gen_{i}", self._generator(generator_layers))
            setattr(self, f"inter_norm_{i}", _gn(self.embed_dim))
        self.final_generator = self._generator(generator_layers)

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        waves = self._waves(wvs)
        mean_wave = waves.mean(dim=0, keepdim=True)
        k, e = self.kernel_size, self.embed_dim
        for i in range(self.num_inter):
            weight, _ = getattr(self, f"inter_gen_{i}")(mean_wave)  # [1, K·K·E]
            depthwise = weight.reshape(k, k, e).permute(2, 0, 1)[:, None]  # [E, 1, K, K]
            y = F.conv2d(c(x), c(depthwise * SCALER), padding=k // 2, groups=e)
            y = c(_norm(getattr(self, f"inter_norm_{i}"), y))
            x = F.silu(y + x.to(y.dtype))
        return self._project(x, waves)


class ProgressiveMultiStageDynamicDecoder(_DecoderHeadBase):
    """A shared pre-conv pair → progressive refinement stages → the projection."""

    def __init__(self, num_stages: int = 3, **kw):
        super().__init__(**kw)
        e = self.embed_dim
        self.pre_conv_0 = _conv(e, e, 3, self.policy)
        self.pre_norm_0 = _gn(e)
        self.pre_conv_1 = _conv(e, e, 3, self.policy)
        self.pre_norm_1 = _gn(e)
        self.wave_fc_0 = FCResLayer(self.wv_planes)
        self.wave_fc_1 = FCResLayer(self.wv_planes)
        self.num_stage_blocks = num_stages - 1
        for i in range(self.num_stage_blocks):
            setattr(self, f"stage_{i}", SharedRefinementBlock(e, kernel_size=self.kernel_size,
                                                              policy=self.policy))
        self.final_generator = self._generator(self.num_layers)

    def wave_encoder(self, emb: torch.Tensor) -> torch.Tensor:
        return self.wave_fc_1(self.wave_fc_0(emb))

    def forward(self, x: torch.Tensor, wvs: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        waves = self._waves(wvs)
        h = c(F.silu(_norm(self.pre_norm_0, self.pre_conv_0(x))))
        h = c(F.silu(_norm(self.pre_norm_1, self.pre_conv_1(h))))
        for i in range(self.num_stage_blocks):
            h = getattr(self, f"stage_{i}")(h)
        return self._project(h, waves)

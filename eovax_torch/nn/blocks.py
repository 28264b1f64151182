"""Core conv and attention blocks of the Flux-derived VAE (NCHW).

Port of ``eovax/nn/blocks.py``. Parameters are fp32; convolutions run in the
policy's compute dtype; GroupNorm statistics are fp32 and the output is in
the compute dtype.

- GroupNorm: 32 groups, eps 1e-6, through
  :func:`eovax_torch.kernels.groupnorm.group_norm`, which also applies the
  swish and AdaIN that follow a norm in a ResnetBlock (one rounding to the
  compute dtype where the JAX package rounds after the norm, then computes
  AdaIN and swish in the compute dtype).
- ResnetBlock ``conv1``/``conv2``: 3×3 SAME convs through
  :func:`eovax_torch.kernels.conv3x3.conv3x3`, or under a Winograd or int8
  policy through :mod:`eovax_torch.kernels.winograd` or
  :mod:`eovax_torch.kernels.qconv` (:class:`Conv3x3`), where the JAX package
  calls ``policy_conv3x3``.
- Downsample: asymmetric (0,1,0,1) pad, then a VALID 3×3 stride-2 conv.
- Upsample: nearest ×2, then a 3×3 conv (the plain form; the JAX package's
  input-dilated lowering computes the same up to tap-sum reassociation).
- AttnBlock: single-head attention over the H·W tokens through
  :func:`eovax_torch.kernels.attention.flash_attention`, with a residual
  1×1 output projection.
- AdaIN ``emb_proj`` init: zero weight, bias [1]*C ++ [0]*C.
- ResnetBlock ``remat``: recompute the block in the backward
  (``torch.utils.checkpoint``), the JAX package's ``nn.remat``.

The three kernel wrappers carry their own backward (hand kernels for the conv
data gradient and the GroupNorm), so the blocks train as they infer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.kernels.attention import flash_attention
from eovax_torch.kernels.conv3x3 import conv3x3
from eovax_torch.kernels.groupnorm import group_norm
from eovax_torch.kernels.qconv import (
    abs_percentile,
    int8_conv3x3,
    int8_conv3x3_prequant,
    should_use_int8,
)
from eovax_torch.kernels.winograd import should_use_winograd, winograd_conv3x3


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input, weight and bias are cast to the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, policy: Policy = FULL_PRECISION):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.policy = policy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        return F.conv2d(c(x), c(self.weight), c(self.bias), self.stride, self.padding)


class Conv3x3(Conv2d):
    """3×3 stride-1 SAME conv (``Conv2d``'s parameters) through the policy's conv
    algorithm, the JAX package's ``policy_conv3x3``:

    - ``"direct"``: the conv3x3 kernel;
    - ``"winograd"``: F(2×2, 3×3) where
      :func:`~eovax_torch.kernels.winograd.should_use_winograd` holds, else the
      conv3x3 kernel;
    - ``"int8"``: with an int8 ``weight`` (loaded from a state that
      :func:`~eovax_torch.kernels.qconv.quantize_state_int8` wrote, beside its
      ``kernel_scale`` and, if calibrated, ``act_scale`` buffers) the
      pre-quantized int8 conv; with a float weight the on-the-fly int8 conv where
      :func:`~eovax_torch.kernels.qconv.should_use_int8` holds, else the conv3x3
      kernel;
    - ``"int8-calib"``: the conv3x3 kernel, after appending the eligible input's
      |x| percentile (a device scalar) to ``calib_amax``.
    """

    def __init__(self, in_channels: int, out_channels: int, policy: Policy = FULL_PRECISION):
        super().__init__(in_channels, out_channels, 3, padding=1, policy=policy)
        self.calib_amax: list[torch.Tensor] = []

    def to_int8(self, act_scale: bool) -> None:
        """Hold an int8 weight (not trained), a ``kernel_scale`` buffer and, with
        ``act_scale``, an ``act_scale`` buffer, for a quantized state to fill."""
        w = self.weight
        if w.dtype != torch.int8:
            self.weight = nn.Parameter(torch.zeros(w.shape, dtype=torch.int8, device=w.device),
                                       requires_grad=False)
            self.register_buffer("kernel_scale", torch.ones(w.shape[0], device=w.device))
        if act_scale and "act_scale" not in self._buffers:
            self.register_buffer("act_scale", torch.ones((), device=w.device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if prefix + "kernel_scale" in state_dict:
            self.to_int8(act_scale=prefix + "act_scale" in state_dict)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        policy = self.policy
        x = policy.cast_to_compute(x)
        algo = policy.conv_algorithm
        if self.weight.dtype == torch.int8:
            if algo != "int8":  # a plain conv would read the integers as numbers
                raise ValueError(f"an int8 weight needs the int8 conv algorithm, not {algo!r}")
            return int8_conv3x3_prequant(x, self.weight, self.kernel_scale, self.bias,
                                         act_scale=self._buffers.get("act_scale"),
                                         compute_dtype=policy.compute_dtype)
        if algo == "winograd":
            if should_use_winograd(x.shape, self.weight.shape, (1, 1), policy.compute_dtype):
                return winograd_conv3x3(x, self.weight, self.bias,
                                        compute_dtype=policy.compute_dtype)
        elif algo == "int8":
            if should_use_int8(x.shape, self.weight.shape, (1, 1), policy.compute_dtype):
                return int8_conv3x3(x, self.weight, self.bias, compute_dtype=policy.compute_dtype)
        elif algo == "int8-calib" and should_use_int8(x.shape, self.weight.shape, (1, 1),
                                                      policy.compute_dtype):
            self.calib_amax.append(abs_percentile(x, policy.calib_percentile))
        return conv3x3(x, self.weight, self.bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm (32 groups unless told otherwise) with fp32 statistics, output
    in the compute dtype; optionally followed by AdaIN (``ada_scale``/``ada_shift``,
    [C] or [B, C]) and swish in the same kernel."""

    def __init__(self, num_channels: int, policy: Policy = FULL_PRECISION, groups: int = 32):
        super().__init__(groups, num_channels, eps=1e-6)
        self.policy = policy

    def forward(self, x: torch.Tensor, *, ada_scale: torch.Tensor | None = None,
                ada_shift: torch.Tensor | None = None, swish: bool = False) -> torch.Tensor:
        return group_norm(self.policy.cast_to_compute(x), self.weight, self.bias,
                          self.num_groups, self.eps, ada_scale=ada_scale, ada_shift=ada_shift,
                          swish=swish)


def sincos_embed_microns(embed_dim: int, wvs: torch.Tensor) -> torch.Tensor:
    """Sincos embedding of raw µm wavelengths (no µm → nm scaling here)."""
    half = embed_dim // 2
    omega = torch.arange(half, dtype=torch.float32, device=wvs.device) / float(half)
    omega = 1.0 / (10000.0**omega)
    out = wvs.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)  # [N, D]


class WavelengthConditioner(nn.Module):
    """Wavelength set → global AdaIN style vector (fp32 MLP)."""

    def __init__(self, embed_dim: int = 512):
        super().__init__()
        self.embed_dim = embed_dim
        self.mlp = nn.Sequential(
            nn.Linear(embed_dim, embed_dim * 2), nn.SiLU(),
            nn.Linear(embed_dim * 2, embed_dim), nn.SiLU(),
            nn.Linear(embed_dim, embed_dim),
        )

    def forward(self, wvs: torch.Tensor) -> torch.Tensor:
        emb = sincos_embed_microns(self.embed_dim, wvs).mean(dim=0)  # modality fingerprint
        return self.mlp(emb)


class Downsample(nn.Module):
    """Stride-2 3×3 conv after an asymmetric (right/bottom) pad."""

    def __init__(self, in_channels: int, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, stride=2, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest ×2 upsample, then a 3×3 conv."""

    def __init__(self, in_channels: int, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, policy=policy)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class ResnetBlock(nn.Module):
    """GN → swish → conv, twice, with optional AdaIN modulation after norm2.

    With ``remat`` the block keeps only its inputs for the backward and runs
    its forward again there (off by default, as in the JAX package)."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int | None = None,
                 policy: Policy = FULL_PRECISION, remat: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.remat = remat
        self.norm1 = GroupNorm(in_channels, policy)
        self.conv1 = Conv3x3(in_channels, out_channels, policy)
        self.norm2 = GroupNorm(out_channels, policy)
        self.conv2 = Conv3x3(out_channels, out_channels, policy)
        self.nin_shortcut = (
            Conv2d(in_channels, out_channels, 1, policy=policy)
            if in_channels != out_channels else None
        )
        self.emb_proj = nn.Linear(cond_dim, 2 * out_channels) if cond_dim is not None else None

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        if self.emb_proj is not None:  # identity modulation at init
            self.emb_proj.weight.zero_()
            self.emb_proj.bias[: self.out_channels] = 1.0
            self.emb_proj.bias[self.out_channels :] = 0.0

    def forward(self, x: torch.Tensor, emb: torch.Tensor | None = None) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, emb, use_reentrant=False)
        return self._forward(x, emb)

    def _forward(self, x: torch.Tensor, emb: torch.Tensor | None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, swish=True))
        scale = shift = None
        if self.emb_proj is not None and emb is not None:
            # [C] shared across the batch, or [B, C]
            scale, shift = self.emb_proj(emb.float()).chunk(2, dim=-1)
        h = self.conv2(self.norm2(h, ada_scale=scale, ada_shift=shift, swish=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x.to(h.dtype) + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H·W tokens with a residual projection.

    The 1×1 convs ``q``/``k``/``v``/``proj_out`` keep conv parameters (the
    reference layout) and run as matmuls over the [B, H·W, C] token matrix.
    """

    def __init__(self, in_channels: int, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.policy = policy
        self.norm = GroupNorm(in_channels, policy)
        self.q = Conv2d(in_channels, in_channels, 1, policy=policy)
        self.k = Conv2d(in_channels, in_channels, 1, policy=policy)
        self.v = Conv2d(in_channels, in_channels, 1, policy=policy)
        self.proj_out = Conv2d(in_channels, in_channels, 1, policy=policy)

    def _pointwise(self, conv: Conv2d, tokens: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        return F.linear(tokens, c(conv.weight.flatten(1)), c(conv.bias)).contiguous()

    def qkv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW activation → contiguous [B, H·W, C] q, k, v in the compute dtype."""
        tokens = self.norm(x).flatten(2).transpose(1, 2)
        return tuple(self._pointwise(m, tokens) for m in (self.q, self.k, self.v))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self._pointwise(self.proj_out, flash_attention(*self.qkv(x)))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return x.to(out.dtype) + out

"""Conditional diffusion UNet (NCHW) for latent super-resolution.

Port of ``eovax/models/unet.py``: ``unet(x_t, t, cond) → prediction``, cond
concatenated to x_t on the channel axis, a sinusoidal time embedding through
a SiLU MLP that modulates every residual block (FiLM after the second norm),
symmetric down and up paths with skip connections, stride-2 down and
nearest-up transitions, and self-attention at the innermost level. The
forward splits into :meth:`UNet.encode_path` and :meth:`UNet.decode_path`
for the cached sampler.

Where the work goes:

- The residual blocks' ``conv1``/``conv2`` run through
  :func:`eovax_torch.kernels.conv3x3.conv3x3` (the JAX package's
  ``policy_conv3x3``). ``conv_in``, the downsamples (stride 2, padding 1 on
  every side), the upsamples, ``conv_out`` and the 1×1 convs stay on the
  library's conv, as the VAE's do.
- Every GroupNorm (``min(32, C)`` groups, eps 1e-6) is one
  :func:`eovax_torch.kernels.groupnorm.group_norm` launch. The JAX package keeps
  fp32 from the norm through the FiLM ``h·(1 + scale) + shift`` and the SiLU
  and rounds once before the conv; the kernel does the same, with
  ``ada_scale = 1 + scale`` and ``ada_shift = shift`` ([B, C] fp32).
- The mid attention is one :func:`eovax_torch.kernels.attention.flash_attention`
  launch over the H·W tokens in row-major order, with the 1×1 ``qkv`` and
  ``proj`` as matmuls over the token matrix.

Module names follow the JAX package's (``down_0_block_1`` → ``down.0.block.1``,
``mid_block_1`` → ``mid.block_1``, ``mid_attn``, ``temb_0``), so
:func:`eovax_torch.utils.convert.state_dict_from_variables` of its params loads
with ``strict=True``. ``conv2``, ``proj`` and ``conv_out`` start at zero, as in
the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from eovax_torch.core.precision import FULL_PRECISION, Policy
from eovax_torch.kernels.attention import flash_attention
from eovax_torch.nn.blocks import Conv2d, Conv3x3, GroupNorm


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal fp32 embedding [B, dim] of continuous t ∈ [0, 1] (scaled by 1000)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float().reshape(-1, 1) * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _norm(channels: int, policy: Policy) -> GroupNorm:
    return GroupNorm(channels, policy, groups=min(32, channels))


class TimeResBlock(nn.Module):
    """GN → SiLU → conv, then GN → FiLM(temb) → SiLU → conv, plus a residual
    (through a 1×1 ``skip`` where the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 policy: Policy = FULL_PRECISION):
        super().__init__()
        self.norm1 = _norm(in_channels, policy)
        self.conv1 = Conv3x3(in_channels, out_channels, policy)
        self.temb_proj = nn.Linear(temb_dim, 2 * out_channels)  # fp32
        self.norm2 = _norm(out_channels, policy)
        self.conv2 = Conv3x3(out_channels, out_channels, policy)
        self.skip = (Conv2d(in_channels, out_channels, 1, policy=policy)
                     if in_channels != out_channels else None)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.conv2.weight.zero_()

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, swish=True))
        scale, shift = self.temb_proj(F.silu(temb)).chunk(2, dim=-1)
        h = self.conv2(self.norm2(h, ada_scale=1.0 + scale, ada_shift=shift, swish=True))
        if self.skip is not None:
            x = self.skip(x)
        return x.to(h.dtype) + h


class SelfAttention(nn.Module):
    """Single-head self-attention over the H·W tokens with a residual 1×1 projection."""

    def __init__(self, channels: int, policy: Policy = FULL_PRECISION):
        super().__init__()
        self.policy = policy
        self.norm = _norm(channels, policy)
        self.qkv = Conv2d(channels, 3 * channels, 1, policy=policy)
        self.proj = Conv2d(channels, channels, 1, policy=policy)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.proj.weight.zero_()

    def _pointwise(self, conv: Conv2d, tokens: torch.Tensor) -> torch.Tensor:
        c = self.policy.cast_to_compute
        return F.linear(tokens, c(conv.weight.flatten(1)), c(conv.bias))

    def qkv_tokens(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW activation → contiguous [B, H·W, C] q, k, v in the compute dtype."""
        tokens = self.norm(x).flatten(2).transpose(1, 2)
        return tuple(t.contiguous() for t in self._pointwise(self.qkv, tokens).chunk(3, dim=-1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        out = self._pointwise(self.proj, flash_attention(*self.qkv_tokens(x)))
        out = out.transpose(1, 2).reshape(b, c, h, w)
        return (x.to(out.dtype) + out).contiguous()


class UNet(nn.Module):
    """Conditional UNet: (x_t [B,Cin,H,W], t [B], cond [B,Ccond,H,W]) → [B,Cout,H,W]."""

    def __init__(self, in_channels: int = 32, out_channels: int = 32, cond_channels: int = 0,
                 hid_channels: tuple[int, ...] = (256, 128, 64),
                 hid_blocks: tuple[int, ...] = (3, 3, 3), attention_at_bottom: bool = True,
                 policy: Policy = FULL_PRECISION):
        super().__init__()
        ch = tuple(hid_channels)
        self.hid_channels, self.hid_blocks = ch, tuple(hid_blocks)
        temb_dim = ch[0] * 4
        self.temb_0 = nn.Linear(ch[0], temb_dim)
        self.temb_2 = nn.Linear(temb_dim, temb_dim)
        self.conv_in = Conv2d(in_channels + cond_channels, ch[0], 3, padding=1, policy=policy)

        levels = len(ch)
        self.down = nn.ModuleList()
        for i in range(levels):
            level = nn.Module()
            level.block = nn.ModuleList(
                TimeResBlock(ch[i], ch[i], temb_dim, policy) for _ in range(self.hid_blocks[i]))
            if i != levels - 1:
                level.downsample = Conv2d(ch[i], ch[i + 1], 3, stride=2, padding=1, policy=policy)
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = TimeResBlock(ch[-1], ch[-1], temb_dim, policy)
        self.mid.block_2 = TimeResBlock(ch[-1], ch[-1], temb_dim, policy)
        self.mid_attn = SelfAttention(ch[-1], policy) if attention_at_bottom else None

        # Every up block takes the running h and one skip, both ch[i] wide.
        self.up = nn.ModuleList()
        for i in range(levels):
            level = nn.Module()
            level.block = nn.ModuleList(
                TimeResBlock(2 * ch[i], ch[i], temb_dim, policy)
                for _ in range(self.hid_blocks[i] + 1))
            if i != 0:
                level.upsample = Conv2d(ch[i], ch[i - 1], 3, padding=1, policy=policy)
            self.up.append(level)

        self.norm_out = _norm(ch[0], policy)
        self.conv_out = Conv2d(ch[0], out_channels, 3, padding=1, policy=policy)

    @torch.no_grad()
    def init_special(self, generator: torch.Generator) -> None:
        self.conv_out.weight.zero_()

    def _temb(self, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.hid_channels[0])
        return self.temb_2(F.silu(self.temb_0(temb)))

    def encode_path(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """conv_in → down blocks → bottleneck. Returns (h_mid, skips)."""
        temb = self._temb(t)
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=1)
        h = self.conv_in(x)
        skips = [h]
        for i, level in enumerate(self.down):
            for block in level.block:
                h = block(h, temb)
                skips.append(h)
            if i != len(self.down) - 1:
                h = level.downsample(h)
                skips.append(h)
        h = self.mid.block_1(h, temb)
        if self.mid_attn is not None:
            h = self.mid_attn(h)
        h = self.mid.block_2(h, temb)
        return h, tuple(skips)

    def decode_path(self, h: torch.Tensor, skips: tuple[torch.Tensor, ...], t: torch.Tensor
                    ) -> torch.Tensor:
        """Up blocks (each on [h, skip], in that channel order) and the output head."""
        temb = self._temb(t)
        skips = list(skips)
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(torch.cat([h, skips.pop().to(h.dtype)], dim=1), temb)
            if i != 0:
                h = level.upsample(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.norm_out(h, swish=True))

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor | None = None
                ) -> torch.Tensor:
        h, skips = self.encode_path(x, t, cond)
        return self.decode_path(h, skips, t)

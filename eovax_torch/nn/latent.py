"""Latent patch shuffle and the affine-free latent BatchNorm (NCHW).

Port of ``eovax/nn/latent.py``. The [B, z, H/8, W/8] latent is packed into
[B, 4z, H/16, W/16] by a 2×2 patch shuffle and normalized by a BatchNorm
whose running statistics belong to the public checkpoint.

- Packed channel order is (c, pi, pj): index = c·pi·pj + a·pj + b.
- eps is 1e-5 for the forward normalization and 1e-4 for the inverse.
- Train mode updates ``running_var`` with the unbiased batch variance but
  normalizes with the biased one, as torch's BatchNorm2d does.
"""

from __future__ import annotations

import torch
from torch import nn


def patch_shuffle(z: torch.Tensor, ps: tuple[int, int] = (2, 2)) -> torch.Tensor:
    """[B, C, H, W] → [B, C·pi·pj, H/pi, W/pj] with (c, pi, pj) channel order."""
    b, c, h, w = z.shape
    pi, pj = ps
    z = z.reshape(b, c, h // pi, pi, w // pj, pj).permute(0, 1, 3, 5, 2, 4)
    return z.reshape(b, c * pi * pj, h // pi, w // pj)


def patch_unshuffle(z: torch.Tensor, ps: tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Inverse of :func:`patch_shuffle`."""
    b, cp, i, j = z.shape
    pi, pj = ps
    c = cp // (pi * pj)
    z = z.reshape(b, c, pi, pj, i, j).permute(0, 1, 4, 2, 5, 3)
    return z.reshape(b, c, i * pi, j * pj)


class LatentBatchNorm(nn.Module):
    """Affine-free BatchNorm over the packed latent channels."""

    def __init__(self, num_features: int, eps: float = 1e-5, inv_eps: float = 1e-4,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.inv_eps = inv_eps
        self.momentum = momentum
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, *, use_running_average: bool) -> torch.Tensor:
        xf = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            dims = (0, 2, 3)
            mean = xf.mean(dim=dims)
            var = (xf - mean[None, :, None, None]).square().mean(dim=dims)  # biased
            n = xf.numel() // xf.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        y = (xf - mean[None, :, None, None]) * torch.rsqrt(var + self.eps)[None, :, None, None]
        return y.to(x.dtype)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """De-normalize with the running statistics: z·sqrt(var + 1e-4) + mean."""
        y = z.float() * torch.sqrt(self.running_var + self.inv_eps)[None, :, None, None]
        return (y + self.running_mean[None, :, None, None]).to(z.dtype)

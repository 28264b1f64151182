"""Latent patch shuffle and the affine-free latent BatchNorm (NCHW).

Port of ``eovax/nn/latent.py``. The [B, z, H/8, W/8] latent is packed into
[B, 4z, H/16, W/16] by a 2×2 patch shuffle and normalized by a BatchNorm
whose running statistics belong to the public checkpoint.

- Packed channel order is (c, pi, pj): index = c·pi·pj + a·pj + b.
- eps is 1e-5 for the forward normalization and 1e-4 for the inverse.
- Train mode updates ``running_var`` with the unbiased batch variance but
  normalizes with the biased one, as torch's BatchNorm2d does.
- :meth:`LatentBatchNorm.normalize_batch` also returns the updated running
  statistics as tensors that carry the gradient of the batch statistics. In
  the JAX package the inverse of the same train step reads the updated
  statistics from the mutable collection, so its gradient flows through them
  into the batch mean and variance; the port's train step passes them to
  :meth:`LatentBatchNorm.inverse` to compute the same gradient.
- Under a process group the batch statistics are global, as XLA makes them
  under the JAX package's data mesh: the mean is the mean of the ranks' means
  (Σx over the global count, since every rank holds as many rows), the biased
  variance the same of the mean of (x − mean)², and the unbiased update's n
  is the global count. Both means are differentiable
  (``parallel.mesh.rank_mean``): the backward sums their gradients over the
  ranks. At world size 1 this is the statistics of one process, bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from eovax_torch.core.device import process_count
from eovax_torch.parallel.mesh import rank_mean


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

    def normalize_batch(self, x: torch.Tensor
                        ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """Train mode: normalize with the batch statistics and update the running
        ones; returns the output and the updated (running_mean, running_var)."""
        xf = x.float()
        dims = (0, 2, 3)
        mean = rank_mean(xf.mean(dim=dims))
        var = rank_mean((xf - mean[None, :, None, None]).square().mean(dim=dims))  # biased
        n = xf.numel() // xf.shape[1] * process_count()  # the global count
        m = self.momentum
        new_mean = (1 - m) * self.running_mean + m * mean
        new_var = (1 - m) * self.running_var + m * var * (n / max(n - 1, 1))
        with torch.no_grad():
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)
            self.num_batches_tracked.add_(1)
        return self._normalize(x, mean, var), (new_mean, new_var)

    def _normalize(self, x, mean, var):
        rstd = torch.rsqrt(var + self.eps)
        return ((x.float() - mean[None, :, None, None]) * rstd[None, :, None, None]).to(x.dtype)

    def forward(self, x: torch.Tensor, *, use_running_average: bool) -> torch.Tensor:
        if use_running_average:
            return self._normalize(x, self.running_mean, self.running_var)
        return self.normalize_batch(x)[0]

    def inverse(self, z: torch.Tensor,
                stats: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        """De-normalize with the running statistics (or ``stats``):
        z·sqrt(var + 1e-4) + mean."""
        mean, var = stats if stats is not None else (self.running_mean, self.running_var)
        y = z.float() * torch.sqrt(var + self.inv_eps)[None, :, None, None]
        return (y + mean[None, :, None, None]).to(z.dtype)

"""Diagonal Gaussian VAE posterior (NCHW).

Port of ``eovax/nn/distributions.py``. Moments are split on the channel axis
and logvar is clamped to [-30, 20]. Sampling takes an explicit
``torch.Generator``; under a process group the noise is drawn at the global
batch's shape and each rank keeps its rows (``parallel.mesh.global_rows``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from eovax_torch.parallel.mesh import global_rows


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    """Diagonal Gaussian with NCHW mean/logvar tensors."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None) -> torch.Tensor:
        noise = global_rows(lambda shape: torch.randn(
            shape, generator=generator, device=self.mean.device, dtype=self.mean.dtype),
            self.mean.shape)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """KL to N(0, 1) (or to ``other``), summed over all non-batch axes."""
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean.square() + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean).square() / other.var
            + self.var / other.var
            - 1.0
            - self.logvar
            + other.logvar,
            dim=dims,
        )

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean).square() / self.var,
            dim=dims,
        )

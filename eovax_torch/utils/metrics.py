"""Functional image metrics (PSNR / SSIM / RMSE / SAM), NHWC, fp32.

Port of ``eovax/utils/metrics.py`` (the torchmetrics functional calls of the
reference's eval scripts). SSIM is the single-scale gaussian-window SSIM of
:func:`eovax_torch.losses.msssim._ssim_and_cs` (NCHW inside) in full fp32: on
the card, convolutions without TF32 (``Policy.activate``), the counterpart of
the JAX package's ``Precision.HIGHEST`` blurs.
"""

from __future__ import annotations

import math

import torch


def _diff(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return pred.float() - target.float()


def rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = _diff(pred, target)
    return torch.sqrt(torch.mean(d * d))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = _diff(pred, target)
    return torch.mean(d * d)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_diff(pred, target)))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 20.0 * math.log10(data_range) - 10.0 * torch.log10(mse(pred, target))


def spectral_angle(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean spectral angle (radians) over the channel axis (the last) — the
    torchmetrics SpectralAngleMapper convention."""
    pred, target = pred.float(), target.float()
    dot = torch.sum(pred * target, dim=-1)
    norm = torch.linalg.norm(pred, dim=-1) * torch.linalg.norm(target, dim=-1)
    cos = torch.clamp(dot / (norm + eps), -1.0, 1.0)
    return torch.mean(torch.arccos(cos))


def ssim(pred: torch.Tensor, target: torch.Tensor, *, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Single-scale SSIM (gaussian window, torchmetrics algorithm) of NHWC images."""
    from eovax_torch.losses.msssim import _ssim_and_cs

    def nchw(x):
        return x.float().permute(0, 3, 1, 2).contiguous()

    sim, _ = _ssim_and_cs(nchw(pred), nchw(target), data_range, kernel_size, sigma, k1, k2)
    return sim.mean()

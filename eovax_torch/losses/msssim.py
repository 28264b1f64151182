"""Multi-scale SSIM (NCHW, fp32) with torchmetrics-compatible semantics.

Port of ``eovax/losses/msssim.py``, the algorithm of torchmetrics'
``MultiScaleStructuralSimilarityIndexMeasure(data_range=6.0, kernel_size=5,
betas=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333))``: reflect pad → gaussian
filter → crop, per-sample contrast sensitivity per scale, 2×2 average pool
between scales, ``relu`` normalization, beta-weighted product. The gaussian is
a separable depthwise conv in fp32 (the JAX package's banded matmuls are a
choice for the TPU's matrix unit).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=8)
def _gaussian_1d(kernel_size: int, sigma: float) -> tuple[float, ...]:
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0)
    g = np.exp(-((dist / sigma) ** 2) / 2.0)
    return tuple(float(v) for v in g / g.sum())


def _blur(x: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian filter, VALID padding, of fp32 NCHW ``x``."""
    c = x.shape[1]
    g = torch.tensor(_gaussian_1d(kernel_size, sigma), dtype=torch.float32, device=x.device)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def _ssim_and_cs(pred, target, data_range, kernel_size, sigma, k1, k2):
    """Per-sample mean SSIM and contrast sensitivity (torchmetrics algorithm)."""
    pad = (kernel_size - 1) // 2
    pred = F.pad(pred, (pad, pad, pad, pad), mode="reflect")
    target = F.pad(target, (pad, pad, pad, pad), mode="reflect")
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_p, mu_t = _blur(pred, kernel_size, sigma), _blur(target, kernel_size, sigma)
    mu_pp = _blur(pred * pred, kernel_size, sigma)
    mu_tt = _blur(target * target, kernel_size, sigma)
    mu_pt = _blur(pred * target, kernel_size, sigma)
    sigma_p = mu_pp - mu_p * mu_p
    sigma_t = mu_tt - mu_t * mu_t
    sigma_pt = mu_pt - mu_p * mu_t

    upper = 2.0 * sigma_pt + c2
    lower = sigma_p + sigma_t + c2
    ssim_map = ((2.0 * mu_p * mu_t + c1) * upper) / ((mu_p ** 2 + mu_t ** 2 + c1) * lower)
    cs_map = upper / lower

    # Crop the padded border (torchmetrics _ssim_update).
    h, w = ssim_map.shape[2:]
    ssim_map = ssim_map[:, :, pad:h - pad, pad:w - pad]
    cs_map = cs_map[:, :, pad:h - pad, pad:w - pad]
    b = ssim_map.shape[0]
    return ssim_map.reshape(b, -1).mean(dim=-1), cs_map.reshape(b, -1).mean(dim=-1)


def multiscale_ssim(pred: torch.Tensor, target: torch.Tensor, *, data_range: float = 6.0,
                    kernel_size: int = 5, sigma: float = 1.5,
                    betas: tuple[float, ...] = DEFAULT_BETAS, k1: float = 0.01, k2: float = 0.03,
                    normalize: str | None = "relu") -> torch.Tensor:
    """MS-SSIM over NCHW batches → scalar (mean over the batch)."""
    min_side = (kernel_size - 1) * 2 ** (len(betas) - 1)
    if pred.shape[2] <= min_side or pred.shape[3] <= min_side:
        raise ValueError(
            f"MS-SSIM with kernel {kernel_size} and {len(betas)} scales needs inputs > "
            f"{min_side}px per side; got {tuple(pred.shape[2:])} (torchmetrics enforces the "
            "same bound)."
        )
    pred, target = pred.float(), target.float()
    mcs = []
    sim = None
    for i in range(len(betas)):
        sim, cs = _ssim_and_cs(pred, target, data_range, kernel_size, sigma, k1, k2)
        mcs.append(cs)
        if i != len(betas) - 1:
            pred, target = F.avg_pool2d(pred, 2), F.avg_pool2d(target, 2)
    mcs[-1] = sim  # the last scale contributes the full SSIM, not CS
    stack = torch.stack(mcs)  # [scales, B]
    if normalize == "relu":
        stack = F.relu(stack)
    weighted = stack ** torch.tensor(betas, dtype=torch.float32, device=stack.device)[:, None]
    return torch.prod(weighted, dim=0).mean()


def msssim_loss(pred: torch.Tensor, target: torch.Tensor, **kw) -> torch.Tensor:
    """1 − MS-SSIM."""
    return 1.0 - multiscale_ssim(pred, target, **kw)

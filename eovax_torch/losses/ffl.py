"""Focal frequency loss (NCHW, fp32 FFT).

Port of ``eovax/losses/ffl.py``: patch unfold → orthonormal 2-D FFT in fp32
→ a log-scaled, batch-max-normalized spectrum-distance weight matrix (no
gradient) × the squared frequency distance, with the NaN/inf guards. Under a
process group the batch's maximum and mean spectrum are the global batch's.
"""

from __future__ import annotations

import torch

from eovax_torch.parallel.mesh import rank_max, rank_mean


def _to_patch_freq(x: torch.Tensor, patch_factor: int) -> torch.Tensor:
    """[B, C, H, W] → fp32 FFT stack [B, P, C, h, w, 2] (real/imag last)."""
    x = x.float()
    b, c, h, w = x.shape
    ph, pw = h // patch_factor, w // patch_factor
    x = x.reshape(b, c, patch_factor, ph, patch_factor, pw).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, patch_factor * patch_factor, c, ph, pw)
    freq = torch.view_as_real(torch.fft.fft2(x, norm="ortho"))
    return torch.nan_to_num(freq, nan=0.0, posinf=1e6, neginf=-1e6)


def focal_frequency_loss(pred: torch.Tensor, target: torch.Tensor, *, loss_weight: float = 1.0,
                         alpha: float = 1.0, patch_factor: int = 1, ave_spectrum: bool = False,
                         log_matrix: bool = False, batch_matrix: bool = False,
                         matrix: torch.Tensor | None = None) -> torch.Tensor:
    """Focal frequency loss over NCHW batches → scalar."""
    pred_freq = _to_patch_freq(pred, patch_factor)
    target_freq = _to_patch_freq(target, patch_factor)
    if ave_spectrum:  # over the global batch under a process group
        pred_freq = rank_mean(pred_freq.mean(dim=0, keepdim=True))
        target_freq = rank_mean(target_freq.mean(dim=0, keepdim=True))

    diff_sq = (pred_freq - target_freq) ** 2
    freq_distance = diff_sq[..., 0] + diff_sq[..., 1]

    if matrix is not None:
        weight_matrix = matrix.detach()
    else:
        with torch.no_grad():
            m = torch.sqrt(freq_distance + 1e-8) ** alpha
            if log_matrix:
                m = torch.log1p(m)
            if batch_matrix:
                max_val = rank_max(m.max())  # the global batch's
            else:
                max_val = m.reshape(*m.shape[:3], -1).max(dim=-1).values[..., None, None]
            max_val = torch.where(torch.isfinite(max_val) & (max_val > 0), max_val,
                                  torch.ones_like(max_val))
            weight_matrix = torch.clamp(m / max_val, 0.0, 1.0)
    return torch.mean(weight_matrix * freq_distance) * loss_weight

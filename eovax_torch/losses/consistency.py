"""EO consistency loss — the stage-2 training objective (NCHW).

Port of ``eovax/losses/consistency.py``: a weighted sum of a pixel term (L1 or
Charbonnier), spectral angle (SAM), gradient difference, focal frequency
(with a linear warm-in over 1000 steps), MS-SSIM and an optional feature
term, each gated by its start step. The channel axis is 1 and H, W are axes
2 and 3. Every term is computed in fp32.

``EOConsistencyLoss(inputs, wvs, reconstructions, global_step=, split=)``
returns (scalar, logs), the logs under the JAX package's keys as detached
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from eovax_torch.losses.ffl import focal_frequency_loss
from eovax_torch.losses.msssim import msssim_loss


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """mean(sqrt(diff² + eps²))."""
    diff = pred.float() - target.float()
    return torch.mean(torch.sqrt(diff * diff + eps * eps))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def sam_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """1 − spectral cosine similarity over the channel axis."""
    pred, target = pred.float(), target.float()
    dot = torch.sum(pred * target, dim=1)
    norm = torch.linalg.vector_norm(pred, dim=1) * torch.linalg.vector_norm(target, dim=1)
    return torch.mean(1.0 - dot / (norm + eps))


def gradient_difference_loss(pred: torch.Tensor, target: torch.Tensor,
                             alpha: float = 1.0) -> torch.Tensor:
    """|∇pred| against |∇target| along H and W."""
    pred, target = pred.float(), target.float()
    p_dy = torch.abs(pred[:, :, 1:] - pred[:, :, :-1])
    t_dy = torch.abs(target[:, :, 1:] - target[:, :, :-1])
    p_dx = torch.abs(pred[..., 1:] - pred[..., :-1])
    t_dx = torch.abs(target[..., 1:] - target[..., :-1])
    return (torch.abs(p_dx - t_dx) ** alpha).mean() + (torch.abs(p_dy - t_dy) ** alpha).mean()


def berhu_loss(pred: torch.Tensor, target: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Reverse Huber: L1 up to the threshold, a scaled L2 above it."""
    diff = torch.abs(pred.float() - target.float())
    l2 = (diff * diff + threshold * threshold) / (2.0 * threshold)
    return torch.mean(torch.where(diff <= threshold, diff, l2))


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def spatial_gradient_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between the Sobel edges of both, per channel."""

    def grads(x):
        x = x.float()
        c = x.shape[1]
        out = []
        for k in (_SOBEL_X, _SOBEL_Y):
            kernel = torch.tensor(k, device=x.device).expand(c, 1, 3, 3)
            out.append(F.conv2d(x, kernel, padding=1, groups=c))
        return out

    (px, py), (tx, ty) = grads(pred), grads(target)
    return torch.mean(torch.abs(px - tx)) + torch.mean(torch.abs(py - ty))


@dataclasses.dataclass(frozen=True)
class EOConsistencyLoss:
    """Configurable multi-term reconstruction loss (NCHW inputs)."""

    pixel_weight: float = 1.0
    rec_loss_type: str = "l1"  # 'l1' | 'char'
    spectral_weight: float = 0.0
    spatial_weight: float = 0.0
    freq_weight: float = 0.0
    feature_weight: float = 0.0
    msssim_weight: float = 0.0
    spectral_start_step: int = 0
    spatial_start_step: int = 0
    freq_start_step: int = 0
    feature_start_step: int = 0
    msssim_start_step: int = 0
    patch_factor: int = 2
    ffl_alpha: float = 1.0
    freq_warmup_steps: int = 1000
    # Optional frozen feature net: fn(x, wvs) -> list of feature maps.
    dofa_features: Callable[[torch.Tensor, torch.Tensor], list[torch.Tensor]] | None = None

    def __call__(self, inputs: torch.Tensor, wvs: torch.Tensor, reconstructions: torch.Tensor, *,
                 global_step: int = 0, split: str = "train") -> tuple[torch.Tensor, dict[str, Any]]:
        logs: dict[str, Any] = {}
        step = float(global_step)
        total = torch.zeros((), dtype=torch.float32, device=reconstructions.device)

        def gate(start: int) -> float:
            return float(step >= start)

        if self.pixel_weight > 0:
            if self.rec_loss_type == "l1":
                l_rec = l1_loss(reconstructions, inputs)
            elif self.rec_loss_type == "char":
                l_rec = charbonnier_loss(reconstructions, inputs)
            else:
                raise ValueError("rec_loss_type must be 'l1' or 'char'")
            total = total + self.pixel_weight * l_rec
            logs[f"{split}/loss_rec"] = l_rec

        if self.spectral_weight > 0:
            l_sam = sam_loss(reconstructions, inputs)
            total = total + self.spectral_weight * gate(self.spectral_start_step) * l_sam
            logs[f"{split}/loss_spectral"] = l_sam

        if self.spatial_weight > 0:
            l_spat = gradient_difference_loss(reconstructions, inputs)
            total = total + self.spatial_weight * gate(self.spatial_start_step) * l_spat
            logs[f"{split}/loss_spatial"] = l_spat

        if self.freq_weight > 0:
            l_freq = focal_frequency_loss(
                reconstructions, inputs, alpha=self.ffl_alpha, patch_factor=self.patch_factor,
                ave_spectrum=False, batch_matrix=True, log_matrix=True,
            )
            # Linear warm-in over `freq_warmup_steps` after the start step.
            warm = min(max((step - self.freq_start_step) / self.freq_warmup_steps, 0.0), 1.0)
            w = self.freq_weight * warm * gate(self.freq_start_step)
            total = total + w * l_freq
            logs[f"{split}/loss_freq_raw"] = l_freq
            logs[f"{split}/ffl_weight"] = torch.tensor(w, dtype=torch.float32)

        if self.msssim_weight > 0:
            l_ms = msssim_loss(reconstructions, inputs)
            total = total + self.msssim_weight * gate(self.msssim_start_step) * l_ms
            logs[f"{split}/loss_msssim"] = l_ms

        if self.feature_weight > 0:
            if self.dofa_features is None:
                raise ValueError("feature_weight > 0 requires a dofa_features fn")
            with torch.no_grad():
                f_in = self.dofa_features(inputs, wvs)
            f_rec = self.dofa_features(reconstructions, wvs)
            l_feat = torch.zeros((), dtype=torch.float32, device=total.device)
            for fi, fr in zip(f_in, f_rec):
                # dim=1: cosine similarity over the TOKEN axis of [B, N, D]
                # features, as the reference's F.cosine_similarity(fi, fr, dim=1).
                num = torch.sum(fi * fr, dim=1)
                den = (torch.linalg.vector_norm(fi, dim=1) * torch.linalg.vector_norm(fr, dim=1)
                       + 1e-8)
                l_feat = l_feat + torch.mean(1.0 - num / den)
            total = total + self.feature_weight * gate(self.feature_start_step) * l_feat
            logs[f"{split}/loss_feature"] = l_feat

        logs[f"{split}/loss_total"] = total
        return total, {k: v.detach() for k, v in logs.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "EOConsistencyLoss":
        d = dict(d)
        target = d.pop("_target_", None)
        if target is not None and not target.endswith("EOConsistencyLoss"):
            raise ValueError(f"Unknown loss _target_: {target}")
        return cls(**d)

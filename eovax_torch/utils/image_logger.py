"""Validation image logging: input | reconstruction | error grids.

Port of ``eovax/utils/image_logger.py``: denormalize to physical units per
modality and scheme, robust 2–98 percentile display scaling per image, RGB
band selection, PNG grids on disk. The trainer's validation calls it on val
batch 0. Inputs are NHWC numpy arrays; PIL is imported only when a PNG is
written.
"""

from __future__ import annotations

import os

import numpy as np

from eovax_torch.data.normalize import unnormalize_image

#: RGB channel indices per modality.
RGB_INDICES = {
    "S2RGB": [0, 1, 2],
    "S2L2A": [3, 2, 1],  # B04 / B03 / B02
    "S2L1C": [3, 2, 1],
}


def robust_to_uint8(x: np.ndarray, low_q: float = 0.02, high_q: float = 0.98) -> np.ndarray:
    """Per-image 2–98 percentile scaling → uint8 (image_logger.py:234-249)."""
    out = np.zeros_like(x, dtype=np.uint8)
    for i in range(x.shape[0]):
        img = x[i]
        low, high = np.quantile(img, low_q), np.quantile(img, high_q)
        scaled = np.clip((img - low) / (high - low + 1e-5), 0, 1)
        out[i] = (scaled * 255).astype(np.uint8)
    return out


def _grid(rows: list[np.ndarray]) -> np.ndarray:
    """Stack [B,H,W,3] uint8 row-arrays into one grid image."""
    rows = [np.concatenate(list(r), axis=1) for r in rows]  # B along width
    return np.concatenate(rows, axis=0)


class ImageLogger:
    """VAE reconstruction grids on validation batch 0."""

    def __init__(self, save_dir: str, max_images: int = 8):
        self.save_dir = save_dir
        self.max_images = max_images

    def log(
        self,
        images: np.ndarray,  # NHWC normalized inputs
        recons: np.ndarray,  # NHWC reconstructions
        *,
        modality: str = "S2RGB",
        norm_scheme: str = "legacy",
        step: int = 0,
        split: str = "val",
    ) -> str:
        root = os.path.join(self.save_dir, "image_log", split)
        os.makedirs(root, exist_ok=True)
        n = min(images.shape[0], self.max_images)
        inputs = np.asarray(images[:n], np.float32)
        recons = np.asarray(recons[:n], np.float32)

        # Physical units, then RGB band selection.
        inputs_phys = unnormalize_image(inputs, modality, norm_scheme)
        recons_phys = unnormalize_image(recons, modality, norm_scheme)
        idx = RGB_INDICES.get(modality, [0, 1, 2])
        idx = [i for i in idx if i < inputs.shape[-1]]
        while len(idx) < 3:  # SAR: repeat bands to fill RGB
            idx.append(idx[-1])
        in_rgb = inputs_phys[..., idx]
        rec_rgb = recons_phys[..., idx]

        diff = np.abs(in_rgb - rec_rgb).mean(axis=-1, keepdims=True)
        diff = (diff - diff.min()) / (diff.max() - diff.min() + 1e-5)
        diff_rgb = (np.repeat(diff, 3, axis=-1) * 255).astype(np.uint8)

        grid = _grid([robust_to_uint8(in_rgb), robust_to_uint8(rec_rgb), diff_rgb])
        path = os.path.join(root, f"recon_{modality}_step{step:08d}.png")
        _save_png(grid, path)
        return path


class SuperResImageLogger:
    """LR | prediction | HR grids."""

    def __init__(self, save_dir: str, max_images: int = 4):
        self.save_dir = save_dir
        self.max_images = max_images

    def log(
        self,
        lr: np.ndarray,
        pred: np.ndarray,
        hr: np.ndarray,
        *,
        step: int = 0,
        split: str = "val",
    ) -> str:
        root = os.path.join(self.save_dir, "image_log", split)
        os.makedirs(root, exist_ok=True)
        n = min(lr.shape[0], self.max_images)

        # Nearest-upsample LR to the HR geometry so the rows align.
        if lr.shape[1:3] != hr.shape[1:3]:
            ry = hr.shape[1] // lr.shape[1]
            rx = hr.shape[2] // lr.shape[2]
            lr = np.repeat(np.repeat(lr, max(ry, 1), axis=1), max(rx, 1), axis=2)

        def rgb(x):
            x = np.asarray(x[:n, ..., :3], np.float32)
            if x.shape[-1] < 3:  # single-channel latents / SAR
                x = np.repeat(x[..., :1], 3, axis=-1)
            return robust_to_uint8(x)

        grid = _grid([rgb(lr), rgb(pred), rgb(hr)])
        path = os.path.join(root, f"sr_step{step:08d}.png")
        _save_png(grid, path)
        return path


def _save_png(array_hw3: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(array_hw3).save(path)

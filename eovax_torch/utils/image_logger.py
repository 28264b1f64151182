"""Reconstruction-check image helpers: robust uint8 scaling, grids, PNGs.

The part of ``eovax/utils/image_logger.py`` that the bulk-encode CLI's
reconstruction check needs. PIL is imported only when a PNG is written.
"""

from __future__ import annotations

import numpy as np


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


def _save_png(array_hw3: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(array_hw3).save(path)

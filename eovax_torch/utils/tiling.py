"""Tiled inference over large EO scenes.

A copy of ``eovax/utils/tiling.py``. Real EO scenes are tens of thousands of
pixels per side; this module runs any image→image function over a large
scene in fixed-size overlapping tiles with smooth (Hann-window) blending.
Every model call sees the same ``[tile, tile]`` shape, tiles are batched to
keep the card busy, and the blend runs host-side in numpy.

The latent of a tiled encode differs from a full-scene encode only near
tile borders (receptive field), which the overlap absorbs for
reconstruction purposes.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def _hann2d(tile: int) -> np.ndarray:
    """Separable raised-cosine weight, strictly positive so coverage never
    divides by zero (minimum clamp 1e-3)."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(tile) + 0.5) / tile)
    w2 = np.outer(w, w).astype(np.float32)
    return np.maximum(w2, 1e-3)


def tile_grid(size: int, tile: int, overlap: int) -> list[int]:
    """Start offsets covering ``size`` with ``tile``-sized windows and at
    least ``overlap`` pixels shared between neighbors; the last window is
    clamped flush to the edge."""
    if not 0 <= overlap < tile:
        raise ValueError(
            f"overlap must be in [0, tile); got {overlap} vs tile {tile}"
        )
    if size <= tile:
        return [0]
    stride = tile - overlap
    n = math.ceil((size - tile) / stride) + 1
    starts = [min(i * stride, size - tile) for i in range(n)]
    # dedupe while keeping order (clamping can repeat the last start)
    out: list[int] = []
    for s in starts:
        if not out or s != out[-1]:
            out.append(s)
    return out


def tiled_apply(
    fn: Callable[[np.ndarray], np.ndarray],
    x: np.ndarray,
    *,
    tile: int = 256,
    overlap: int = 32,
    batch_size: int = 16,
    out_channels: int | None = None,
    scale: int = 1,
) -> np.ndarray:
    """Apply an image→image ``fn`` over ``x`` in blended tiles.

    Args:
        fn: maps ``[B, C, tile, tile]`` → ``[B, C', tile·scale, tile·scale]``
            (NCHW, matching the public EOFluxVAE contract). Called with
            fixed-size batches (the last batch may be smaller).
        x: ``[C, H, W]`` or ``[B=1, C, H, W]`` scene.
        tile: tile side in pixels.
        overlap: pixels shared between neighboring tiles (blended).
        batch_size: tiles per model call.
        out_channels: C' if different from C.
        scale: output spatial scale factor (1 for reconstruct, 1/8 is not
            supported — use the latent-space variant of your pipeline).

    Returns ``[C', H·scale, W·scale]`` (or with the leading batch dim if
    the input had one).
    """
    if not 0 <= overlap < tile:
        raise ValueError(f"overlap must be in [0, tile); got {overlap} vs tile {tile}")
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    if x.shape[0] != 1:
        raise ValueError("tiled_apply processes one scene at a time")
    _, c, h, w = x.shape
    if h < tile or w < tile:
        raise ValueError(f"scene {h}x{w} smaller than tile {tile}")
    co = out_channels or c

    ys = tile_grid(h, tile, overlap)
    xs = tile_grid(w, tile, overlap)
    coords = [(y0, x0) for y0 in ys for x0 in xs]

    out = np.zeros((co, h * scale, w * scale), np.float32)
    cover = np.zeros((1, h * scale, w * scale), np.float32)
    weight = _hann2d(tile * scale)[None]  # [1, t', t']

    for i in range(0, len(coords), batch_size):
        chunk = coords[i : i + batch_size]
        tiles = np.stack(
            [x[0, :, y0 : y0 + tile, x0 : x0 + tile] for y0, x0 in chunk]
        )
        result = np.asarray(fn(tiles), np.float32)  # [b, co, t', t']
        for (y0, x0), r in zip(chunk, result):
            sy, sx = y0 * scale, x0 * scale
            t = tile * scale
            out[:, sy : sy + t, sx : sx + t] += r * weight
            cover[:, sy : sy + t, sx : sx + t] += weight
    out /= cover
    return out[None] if not squeeze else out


def tiled_reconstruct(model, x, wvs, *, tile: int = 256, overlap: int = 32,
                      batch_size: int = 16) -> np.ndarray:
    """Blend-tiled ``model.reconstruct`` over a large scene
    (``x``: [C, H, W] or [1, C, H, W] NCHW); each batch of tiles is copied
    back to the host as fp32 numpy."""
    return tiled_apply(
        lambda t: model.reconstruct(t, wvs).float().cpu().numpy(),
        np.asarray(x, np.float32),
        tile=tile, overlap=overlap, batch_size=batch_size,
    )

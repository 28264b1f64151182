"""Separable resize as precomputed weight matrices (torch-interpolate parity).

A copy of ``eovax/utils/resize.py``. A resize along one axis is a matmul
with a precomputed [out, in] weight matrix, so 2-D resizes become two small
einsums: numpy on the host, torch for tensors (on the tensor's device, in
fp32). Weight construction matches torch semantics:

- bilinear, align_corners=False: half-pixel mapping i = (o+0.5)·s − 0.5
  (used by the collate target_size resize, terramesh_datamodule.py:476-479).
- area: adaptive average pooling with integer boundaries
  floor(o·in/out) … ceil((o+1)·in/out) (EQ-VAE targets,
  new_autoencoder.py:615-617).
- bicubic, a=−0.75: the Sen2NAIP LR→HR upsample (sen2naip.py:694-728).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    o = np.arange(n_out, dtype=np.float64)
    i = (o + 0.5) * scale - 0.5
    i0 = np.floor(i).astype(np.int64)
    frac = i - i0
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), i0c] += (1.0 - frac).astype(np.float32)
    w[np.arange(n_out), i1c] += frac.astype(np.float32)
    return w


@functools.lru_cache(maxsize=64)
def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """torch F.interpolate(mode='area') == adaptive_avg_pool: integer bins."""
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        start = (o * n_in) // n_out
        end = -(-((o + 1) * n_in) // n_out)  # ceil
        w[o, start:end] = 1.0 / (end - start)
    return w


def _cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    out = np.where(
        t <= 1,
        (a + 2) * t**3 - (a + 3) * t**2 + 1,
        np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
    )
    return out


@functools.lru_cache(maxsize=64)
def bicubic_weights(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    o = np.arange(n_out, dtype=np.float64)
    i = (o + 0.5) * scale - 0.5
    i0 = np.floor(i).astype(np.int64)
    frac = i - i0
    w = np.zeros((n_out, n_in), np.float32)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(i0 + tap, 0, n_in - 1)
        w[np.arange(n_out), idx] += _cubic(frac - tap).astype(np.float32)
    return w


_BUILDERS = {"bilinear": bilinear_weights, "area": area_weights, "bicubic": bicubic_weights}


def resize_nhwc(x, out_hw: tuple[int, int], mode: str = "bilinear"):
    """Resize [B,H,W,C] via two separable matmuls. Works for numpy arrays
    (host pipeline) and torch tensors alike."""
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    build = _BUILDERS[mode]
    wh = build(h_in, h_out)
    ww = build(w_in, w_out)
    if isinstance(x, np.ndarray):
        y = np.einsum("oh,bhwc->bowc", wh, x.astype(np.float32))
        return np.einsum("pw,bowc->bopc", ww, y)
    import torch

    y = torch.einsum("oh,bhwc->bowc", torch.as_tensor(wh, device=x.device), x.float())
    return torch.einsum("pw,bowc->bopc", torch.as_tensor(ww, device=x.device), y)

"""Batch collation: modality selection, normalization, resize, D4 augment.

A numpy copy of ``eovax/data/collate.py``, the re-design of the reference's
single_modality_collate_fn / deterministic_modality_collate_fn
(terramesh_datamodule.py:418-577). Runs on the host in numpy; every batch is
homogeneous in modality (so ``wvs`` is a single [C] vector) while the
modality varies batch-to-batch.

Layout: emits **NHWC**, as the JAX package does; the trainer makes the
contiguous NCHW tensor the kernels take on the device.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Mapping

import numpy as np

from eovax_torch.data.normalize import make_normalizer
from eovax_torch.data.wavelengths import WAVELENGTHS
from eovax_torch.utils.resize import resize_nhwc


def apply_batch_augmentations(
    images: np.ndarray, rng: random.Random | None = None
) -> np.ndarray:
    """Random D4 transforms on an NHWC batch (terramesh_datamodule.py:347-369):
    H-flip, V-flip, rot90×k — one shared draw per batch."""
    r = rng or random
    if r.random() > 0.5:
        images = images[:, :, ::-1]  # horizontal (W) flip
    if r.random() > 0.5:
        images = images[:, ::-1]  # vertical (H) flip
    k = r.randint(0, 3)
    if k:
        images = np.rot90(images, k, axes=(1, 2))
    return np.ascontiguousarray(images)


def _roll_d4(rng: random.Random | None) -> np.ndarray:
    """One (flip_h, flip_v, rot_k) draw — SAME rng consumption order as
    apply_batch_augmentations so host and device paths share the stream."""
    r = rng or random
    fh = int(r.random() > 0.5)
    fv = int(r.random() > 0.5)
    k = r.randint(0, 3)
    return np.asarray([fh, fv, k], np.int32)


def _prepare(
    images: np.ndarray,
    modality: str,
    *,
    normalize: bool,
    norm_scheme: str,
    target_size: tuple[int, int] | None,
    train: bool,
    rng: random.Random | None,
    device_prep: bool = False,
) -> dict[str, Any]:
    x = np.asarray(images)
    if x.ndim == 3:
        x = x[None]
    if device_prep:
        # Emit the raw decoded batch + tiny descriptors; normalize and D4
        # run on the device (eovax_torch.data.device_prep).
        needs_resize = (
            target_size is not None and x.shape[1:3] != tuple(target_size)
        )
        if needs_resize:
            # The host path clips+normalizes BEFORE resize and the clip
            # does not commute with bilinear interpolation — so when a
            # resize is needed, normalize here (host order; the
            # normalizer fuses the fp32 cast) and ship identity
            # descriptors. Only D4 stays on device.
            if normalize:
                x = make_normalizer(modality, norm_scheme)(x)
            else:
                x = np.asarray(x, np.float32)
            x = resize_nhwc(x, tuple(target_size), mode="bilinear")
            mean = np.zeros(x.shape[-1], np.float32)
            std = np.ones(x.shape[-1], np.float32)
            clip = (-np.inf, np.inf)
        else:
            n = make_normalizer(modality, norm_scheme)
            clip = n.clip if n.clip is not None else (-np.inf, np.inf)
            if not normalize:
                mean = np.zeros(x.shape[-1], np.float32)
                std = np.ones(x.shape[-1], np.float32)
                clip = (-np.inf, np.inf)
            else:
                mean, std = n.mean, n.std + n.eps
        b = x.shape[0]
        out = {
            "image": x,
            "wvs": np.asarray(WAVELENGTHS[modality], np.float32),
            "modality": modality,
            # Descriptors are per-sample ([B,C]/[B,2], ~2 KB per step):
            # a batch that resized ships identity normalization while
            # another process's (or a later batch of the same modality)
            # ships the real one — per-sample values make that correct
            # with no process-invariance or cacheable-per-modality
            # assumption.
            "norm_mean": np.tile(np.asarray(mean, np.float32), (b, 1)),
            "norm_std": np.tile(np.asarray(std, np.float32), (b, 1)),
            "norm_clip": np.tile(np.asarray(clip, np.float32), (b, 1)),
        }
        if train:
            # The "d4" leaf is present iff mode == train, whatever was
            # drawn: processes with independent rng streams must agree on
            # a batch's structure in the same step (data parallel).
            # Identity draws ship and cost a few no-op selects; eval
            # batches omit the leaf entirely.
            roll = _roll_d4(rng)
            if x.shape[1] != x.shape[2] and roll[2] % 2:
                # Non-square: odd rotations change the batch's shape, and
                # would desync local batch shapes across processes. Fold
                # the draw onto the shape-preserving subgroup (1→2, 3→0;
                # same rng consumption; flips + rot180 still apply on the
                # device).
                roll[2] = (roll[2] + 1) % 4
            # Per-sample rows all carry this batch's single draw — the
            # [B,3] shape exists so the leaf splits along the batch axis
            # with the image (each process's samples keep that process's
            # draw).
            out["d4"] = np.tile(roll, (b, 1))
        return out
    if normalize:
        # The normalizer fuses the fp32 cast into its subtract pass —
        # feeding it the stored dtype (int16 bands) skips a full-batch
        # cast copy on this core.
        x = make_normalizer(modality, norm_scheme)(x)
    else:
        x = np.asarray(x, np.float32)
    if target_size is not None and x.shape[1:3] != tuple(target_size):
        x = resize_nhwc(x, tuple(target_size), mode="bilinear")
    if train:
        x = apply_batch_augmentations(x, rng)
    return {
        "image": x,
        "wvs": np.asarray(WAVELENGTHS[modality], np.float32),
        "modality": modality,
    }


def single_modality_collate(
    modalities: list[str],
    *,
    normalize: bool = True,
    norm_scheme: str = "legacy",
    target_size: tuple[int, int] | None = (224, 224),
    mode: str = "train",
    return_metadata: bool = False,
    seed: int | None = None,
    device_prep: bool = False,
) -> Callable[[Mapping[str, Any]], dict[str, Any]]:
    """Pick ONE random modality per batch and prepare it."""
    rng = random.Random(seed) if seed is not None else random

    def collate(batch: Mapping[str, Any]) -> dict[str, Any]:
        if len(modalities) == 1:
            selected = modalities[0]
            images = batch["image"] if "image" in batch else batch[selected]
        else:
            available = [m for m in modalities if m in batch]
            if not available:
                raise ValueError(
                    f"None of {modalities} found in batch keys {list(batch.keys())}"
                )
            selected = rng.choice(available)
            images = batch[selected]
        out = _prepare(
            images, selected,
            normalize=normalize, norm_scheme=norm_scheme,
            target_size=target_size, train=(mode == "train"),
            rng=rng if isinstance(rng, random.Random) else None,
            device_prep=device_prep,
        )
        if return_metadata:
            for key in ("time", "lat", "lon", "crs", "grid_id", "center_lat", "center_lon"):
                if key in batch:
                    out[key] = batch[key]
        return out

    return collate


def deterministic_modality_collate(
    modality: str,
    *,
    normalize: bool = True,
    norm_scheme: str = "legacy",
    target_size: tuple[int, int] | None = (224, 224),
    mode: str = "train",
    return_metadata: bool = False,
    seed: int | None = None,
    device_prep: bool = False,
) -> Callable[[Mapping[str, Any]], dict[str, Any]]:
    """Always the same modality (validation path)."""
    rng = random.Random(seed) if seed is not None else None

    def collate(batch: Mapping[str, Any]) -> dict[str, Any]:
        images = batch[modality] if modality in batch else batch["image"]
        out = _prepare(
            images, modality,
            normalize=normalize, norm_scheme=norm_scheme,
            target_size=target_size, train=(mode == "train"), rng=rng,
            device_prep=device_prep,
        )
        if return_metadata:
            for key in ("time", "lat", "lon", "crs", "grid_id", "center_lat", "center_lon"):
                if key in batch:
                    out[key] = batch[key]
        return out

    return collate

"""Sen2NAIP cross-sensor super-resolution data.

A copy of ``eovax/data/sen2naip.py`` (the reference's
eo_vae/datasets/sen2naip.py):
- deterministic 12×8 lon/lat block split, seed 42, 10%/10% val/test
  (assign_spatial_split, sen2naip.py:27-86)
- pixel datasets over lr.tif (→128²) / hr.tif (→512²) pairs — requires
  rasterio, imported where a dataset is built (offline encoding only)
- latent dataset over the encode_latents .npz outputs + latent_stats.json,
  normalizing BOTH lr and hr latents with the HR statistics
  (sen2naip.py:634-639) and applying latent_scale_factor
- collate functions with the hard-coded LR(S2)/HR(NAIP) z-score stats and
  bicubic LR→HR upsample (sen2naip.py:694-728), plus the TerraMesh
  domain-adaptation variant (sen2naip.py:731-784)
- the reference tokenizers' published latent statistics (sen2naip.py:322-545),
  a copy of the JAX package's latent_stats.json beside this module

Arrays are NHWC here, as in the JAX package; the encode CLI transposes them
to the model's NCHW.
"""

from __future__ import annotations

import json
import os
import random
from glob import glob
from typing import Any, Iterator

import numpy as np

from eovax_torch.data.wavelengths import SEN2NAIP_WAVELENGTHS
from eovax_torch.utils.resize import resize_nhwc

#: Fixed SR conditioning wavelengths: RGB+NIR (sen2naip.py:650,
#: encode_latents.py:420-421).
SEN2NAIP_WVS = np.asarray(SEN2NAIP_WAVELENGTHS, np.float32)

# Hard-coded z-score stats (sen2naip.py:694-704).
LR_S2_MEAN = np.asarray([1302.9685, 1085.2820, 764.7739, 2769.4824], np.float32)
LR_S2_STD = np.asarray([780.8768, 513.2825, 414.3385, 793.6396], np.float32)
HR_NAIP_MEAN = np.asarray([125.1176, 121.9117, 100.0240, 143.8500], np.float32)
HR_NAIP_STD = np.asarray([39.8066, 30.3501, 28.9109, 28.8952], np.float32)

# Domain-adaptation constants (new_..._collate_fn, sen2naip.py:731-784).
TM_LR_MEAN = np.asarray([2199.116, 1853.926, 1718.211, 3132.235], np.float32)
TM_LR_STD = np.asarray([2105.179, 2152.477, 2059.311, 1775.656], np.float32)
DA_TARGET_LOC = -0.4
DA_TARGET_SCALE = 0.6


def reference_latent_stats(name: str = "eo-vae") -> dict[str, np.ndarray]:
    """Published 32-channel latent statistics of the reference tokenizers
    (sen2naip.py:322-545): fp32 ``mean`` and ``std`` of ``name`` in
    ``latent_stats.json`` ("eo-vae", "flux-vae", "flux-vae-01")."""
    path = os.path.join(os.path.dirname(__file__), "latent_stats.json")
    with open(path) as f:
        stats = json.load(f)[name]
    return {k: np.asarray(v, np.float32) for k, v in stats.items()}


def assign_spatial_split(
    lons: np.ndarray,
    lats: np.ndarray,
    *,
    n_blocks_x: int = 12,
    n_blocks_y: int = 8,
    random_state: int = 42,
) -> np.ndarray:
    """Spatial block split: grid the bounding box, shuffle block ids with
    seed 42, first 10% → test, next 10% → val (sen2naip.py:27-86).

    Returns an array of 'train'/'val'/'test' labels.
    """
    lons = np.asarray(lons, np.float64)
    lats = np.asarray(lats, np.float64)
    minx, maxx = lons.min(), lons.max()
    miny, maxy = lats.min(), lats.max()
    bx = (maxx - minx) * 0.001
    by = (maxy - miny) * 0.001
    minx, maxx = minx - bx, maxx + bx
    miny, maxy = miny - by, maxy + by
    x_step = (maxx - minx) / n_blocks_x
    y_step = (maxy - miny) / n_blocks_y
    block_x = np.clip(((lons - minx) / x_step).astype(int), 0, n_blocks_x - 1)
    block_y = np.clip(((lats - miny) / y_step).astype(int), 0, n_blocks_y - 1)
    block_id = block_y * n_blocks_x + block_x

    total = n_blocks_x * n_blocks_y
    all_blocks = np.arange(total)
    np.random.RandomState(random_state).shuffle(all_blocks)
    n_test = max(1, int(total * 0.1))
    n_val = max(1, int(total * 0.1))
    test_blocks = set(all_blocks[:n_test].tolist())
    val_blocks = set(all_blocks[n_test : n_test + n_val].tolist())

    return np.asarray(
        [
            "test" if b in test_blocks else ("val" if b in val_blocks else "train")
            for b in block_id
        ]
    )


# ---------------------------------------------------------------------------
# Pixel-space dataset (offline encoding; needs rasterio)
# ---------------------------------------------------------------------------


def _epoch_batches(ds, batch_size, *, shuffle, seed, drop_remainder,
                   repeat, make_batch, process_index=0, process_count=1):
    """Shared epoch loop for both Sen2NAIP datasets: shuffle order,
    drop the remainder, optionally repeat. Guards the silent-forever
    case (fewer samples than one full batch + repeat=True).

    With ``process_count`` R > 1, ``batch_size`` is per process: each global
    batch is R·batch_size samples of the order, and process r yields its rows
    [r·batch_size, (r + 1)·batch_size), so that R processes see the batches of
    one process at R·batch_size. Every process then holds as many rows; a short
    last global batch is split evenly or, where it cannot be, dropped."""
    rng = random.Random(seed)
    size = batch_size * process_count
    while True:
        order = list(range(len(ds)))
        if shuffle:
            rng.shuffle(order)
        yielded = False
        for i in range(0, len(order), size):
            idxs = order[i : i + size]
            if len(idxs) < size and (drop_remainder or len(idxs) % process_count):
                continue
            per = len(idxs) // process_count
            idxs = idxs[process_index * per : (process_index + 1) * per]
            yielded = True
            yield make_batch([ds[j] for j in idxs])
        if not repeat:
            return
        if not yielded:
            raise ValueError(
                f"dataset of {len(ds)} samples yields no full batches of "
                f"{batch_size} (drop_remainder) — repeat=True would spin "
                "forever"
            )


class Sen2NaipCrossSensor:
    """LR Sentinel-2 (4ch ~128²) / HR NAIP (4ch ~512²) tif pairs
    (sen2naip.py:89-220). Directory layout: {root}/{aoi}/{lr,hr}.tif."""

    def __init__(self, root: str, split: str = "train",
                 lr_size: int = 128, hr_size: int = 512, collate=None):
        try:
            import rasterio  # noqa: F401
        except ImportError as exc:  # pragma: no cover
            raise ImportError(
                "Sen2NaipCrossSensor needs rasterio for tif IO; use the "
                "latent dataset (Sen2NaipCrossSensorLatent) where it is missing."
            ) from exc
        self.root = root
        self.lr_size = lr_size
        self.hr_size = hr_size
        self.collate = collate if collate is not None else sen2naip_collate
        aois = sorted(glob(os.path.join(root, "*")))
        import rasterio

        lons, lats = [], []
        for aoi in aois:
            with rasterio.open(os.path.join(aoi, "hr.tif")) as src:
                center = src.lnglat()
            lons.append(center[0])
            lats.append(center[1])
        labels = assign_spatial_split(np.asarray(lons), np.asarray(lats))
        self.aois = [a for a, s in zip(aois, labels) if s == split]

    def __len__(self):
        return len(self.aois)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        import rasterio

        aoi = self.aois[idx]
        with rasterio.open(os.path.join(aoi, "lr.tif")) as src:
            lr = src.read().astype(np.float32)  # [4, h, w]
        with rasterio.open(os.path.join(aoi, "hr.tif")) as src:
            hr = src.read().astype(np.float32)
        lr = np.transpose(lr, (1, 2, 0))[None]  # [1,h,w,4]
        hr = np.transpose(hr, (1, 2, 0))[None]
        lr = resize_nhwc(lr, (self.lr_size, self.lr_size), "bilinear")[0]
        hr = resize_nhwc(hr, (self.hr_size, self.hr_size), "bilinear")[0]
        return {"image_lr": lr, "image_hr": hr, "aoi": os.path.basename(aoi)}

    def batches(
        self, batch_size: int, *, shuffle: bool = False, seed: int = 0,
        drop_remainder: bool = True, repeat: bool = False,
        process_index: int = 0, process_count: int = 1,
    ) -> Iterator[dict]:
        """Collated normalized batches (same interface as the latent
        dataset's ``batches`` so the SR CLI trains either space): the
        collate z-scores and bicubic-upsamples LR to HR size, yielding
        {image_lr, image_hr, wvs} pixel batches. ``process_index`` of
        ``process_count``: this process's rows of each global batch."""

        def make_batch(samples):
            out = self.collate(samples)
            out["wvs"] = SEN2NAIP_WVS
            return out

        return _epoch_batches(
            self, batch_size, shuffle=shuffle, seed=seed,
            drop_remainder=drop_remainder, repeat=repeat,
            make_batch=make_batch, process_index=process_index,
            process_count=process_count,
        )


def sen2naip_collate(samples: list[dict]) -> dict:
    """Z-score LR/HR with the hard-coded stats + bicubic LR→HR upsample
    (sen2naip.py:694-728). NHWC."""
    hr = np.stack([s["image_hr"] for s in samples]).astype(np.float32)
    lr = np.stack([s["image_lr"] for s in samples]).astype(np.float32)
    hr = (hr - HR_NAIP_MEAN) / HR_NAIP_STD
    lr = (lr - LR_S2_MEAN) / LR_S2_STD
    lr = resize_nhwc(lr, hr.shape[1:3], mode="bicubic")
    return {"image_lr": lr, "image_hr": hr, "aoi": [s["aoi"] for s in samples]}


def sen2naip_domain_adapted_collate(samples: list[dict]) -> dict:
    """Domain adaptation to TerraMesh statistics (sen2naip.py:731-784)."""
    hr = np.stack([s["image_hr"] for s in samples]).astype(np.float32)
    lr = np.stack([s["image_lr"] for s in samples]).astype(np.float32)
    z_hr = (hr - HR_NAIP_MEAN) / HR_NAIP_STD
    hr = z_hr * DA_TARGET_SCALE + DA_TARGET_LOC
    lr = np.clip(lr, 0.0, None)
    lr = (lr - TM_LR_MEAN) / TM_LR_STD
    lr = resize_nhwc(lr, hr.shape[1:3], mode="bicubic")
    return {"image_lr": lr, "image_hr": hr, "aoi": [s["aoi"] for s in samples]}


# ---------------------------------------------------------------------------
# Latent dataset (stage-3 training input)
# ---------------------------------------------------------------------------


class Sen2NaipCrossSensorLatent:
    """.npz latent pairs written by encode_latents (sen2naip.py:548-667).

    Normalizes BOTH lr and hr latents with the **HR** statistics from
    {root}/latent_stats.json — preserving the LR/HR magnitude gap
    (sen2naip.py:634-639) — then applies ``latent_scale_factor``.
    Arrays are stored CHW in the npz (reference schema) and returned NHWC.
    """

    valid_splits = ("train", "val", "test")

    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        latent_scale_factor: float = 1.0,
        normalize: bool = True,
    ):
        assert split in self.valid_splits
        self.root = root
        self.paths = sorted(glob(os.path.join(root, split, "*.npz")))
        self.latent_scale_factor = latent_scale_factor
        self.normalize = normalize

        stats_path = os.path.join(root, "latent_stats.json")
        if not os.path.exists(stats_path):
            raise FileNotFoundError(f"Latent stats file not found at {stats_path}")
        with open(stats_path) as f:
            stats = json.load(f)
        self.hr_mean = np.asarray(stats["hr_latent"]["mean"], np.float32)
        self.hr_std = np.asarray(stats["hr_latent"]["std"], np.float32)
        self.lr_mean = np.asarray(stats["lr_latent"]["mean"], np.float32)
        self.lr_std = np.asarray(stats["lr_latent"]["std"], np.float32)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict[str, Any]:
        with np.load(self.paths[idx]) as data:
            hr = np.transpose(data["hr_latent"], (1, 2, 0)).astype(np.float32)
            lr = np.transpose(data["lr_latent"], (1, 2, 0)).astype(np.float32)
            hr_img = np.transpose(data["hr_image"], (1, 2, 0)).astype(np.float32)
            lr_img = np.transpose(data["lr_image"], (1, 2, 0)).astype(np.float32)
        if self.normalize:
            hr = (hr - self.hr_mean) / self.hr_std
            lr = (lr - self.hr_mean) / self.hr_std  # HR stats for both!
        hr = hr * self.latent_scale_factor
        lr = lr * self.latent_scale_factor
        return {
            "image_hr": hr,
            "image_lr": lr,
            "orig_image_hr": hr_img,
            "orig_image_lr": lr_img,
            "wvs": SEN2NAIP_WVS,
        }

    def batches(
        self, batch_size: int, *, shuffle: bool = False, seed: int = 0,
        drop_remainder: bool = True, repeat: bool = False,
        process_index: int = 0, process_count: int = 1,
    ) -> Iterator[dict]:
        def make_batch(samples):
            return {
                "image_hr": np.stack([s["image_hr"] for s in samples]),
                "image_lr": np.stack([s["image_lr"] for s in samples]),
                "wvs": SEN2NAIP_WVS,
            }

        return _epoch_batches(
            self, batch_size, shuffle=shuffle, seed=seed,
            drop_remainder=drop_remainder, repeat=repeat,
            make_batch=make_batch, process_index=process_index,
            process_count=process_count,
        )

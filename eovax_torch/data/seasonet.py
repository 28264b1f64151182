"""SeasoNet datamodule (legacy path; the reference's datamodule.py).

Port of ``eovax/data/seasonet.py``. The reference's early torchgeo-based
alternative to TerraMesh: the SeasoNet dataset with a fixed 12-band
Sentinel-2 wavelength vector attached to every sample, /3000 radiometric
scaling, resize-to-size, and random H/V flips for training. Unused by the
main training flow (SURVEY.md §2.2); kept for config compatibility and gated
on torchgeo. Host code: numpy NHWC batches, as the TerraMesh reader gives.
"""

from __future__ import annotations

import random
from typing import Iterator

import numpy as np

#: Sentinel-2 band centers for the SeasoNet band stack (datamodule.py:21-24).
SEASONET_WVS = np.asarray(
    [0.66, 0.56, 0.49, 0.842, 0.705, 0.74, 0.783, 0.865, 1.61, 2.19, 0.945, 1.375],
    np.float32,
)

#: Per-band statistics computed on the summer season (datamodule.py:39-68).
SEASONET_MEANS = np.asarray(
    [723.2311, 700.6459, 459.1584, 2828.0876, 1135.0892, 2236.9810,
     2690.9607, 2959.0400, 2100.0281, 1318.8518, 353.0888, 2952.8635],
    np.float32,
)
SEASONET_STDS = np.asarray(
    [635.5509, 409.1886, 323.9882, 1138.0142, 653.9771, 828.4099,
     1037.7228, 1118.3160, 1045.8048, 867.0016, 216.1276, 1061.7631],
    np.float32,
)


def seasonet_stats(bands=None) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) for the selected band stack — the RGB subset when
    bands == ['10m_RGB'] (datamodule.py:83-86)."""
    if bands == ["10m_RGB"]:
        return SEASONET_MEANS[:3], SEASONET_STDS[:3]
    return SEASONET_MEANS, SEASONET_STDS


def make_seasonet_datamodule(
    root: str,
    batch_size: int = 8,
    *,
    size: int = 256,
    split: str = "train",
    seed: int | None = None,
    **kwargs,
):
    """Build the SeasoNet pipeline with wvs attached (datamodule.py:14-107):
    /3000 image scaling, resize 1000² → ``size``², random H/V flips on the
    train split. Requires torchgeo (not installed with the port); raises a
    clear error otherwise."""
    try:
        from torchgeo.datasets import SeasoNet as _SeasoNet
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "SeasoNet support needs torchgeo — legacy path only; use the "
            "TerraMesh pipeline."
        ) from exc

    bands = kwargs.get("bands")
    wvs = SEASONET_WVS[:3] if bands == ["10m_RGB"] else SEASONET_WVS

    class SeasoNetWithWaves(_SeasoNet):
        """datamodule.py:14-32 — wvs attached, image scaled /3000."""

        def __getitem__(self, index):
            sample = super().__getitem__(index)
            sample["wvs"] = wvs.copy()
            sample["image"] = np.asarray(sample["image"], np.float32) / 3000.0
            return sample

    dataset = SeasoNetWithWaves(root=root, **kwargs)
    train = split == "train"
    rng = random.Random(seed)

    def batches() -> Iterator[dict]:
        from eovax_torch.utils.resize import resize_nhwc

        buf: list[np.ndarray] = []
        for i in range(len(dataset)):
            s = dataset[i]
            img = np.asarray(s["image"], np.float32)
            buf.append(np.transpose(img, (1, 2, 0)))
            if len(buf) == batch_size:
                images = np.stack(buf)
                if images.shape[1:3] != (size, size):  # K.Resize(size)
                    images = np.asarray(
                        resize_nhwc(images, (size, size), mode="bilinear")
                    )
                if train:
                    # K.RandomHorizontalFlip/VerticalFlip p=0.5 with
                    # kornia's default same_on_batch=False: an independent
                    # coin per SAMPLE per flip axis (datamodule.py:96-101),
                    # not one decision for the whole batch.
                    flipped = []
                    for img in images:  # img: [H, W, C]
                        if rng.random() < 0.5:
                            img = img[:, ::-1]  # horizontal
                        if rng.random() < 0.5:
                            img = img[::-1]  # vertical
                        flipped.append(img)
                    images = np.stack(flipped)
                yield {
                    "image": np.ascontiguousarray(images),
                    "wvs": wvs,
                    "modality": "SeasoNet",
                }
                buf = []

    return batches

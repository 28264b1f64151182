"""Synthetic TerraMesh-like batches for tests, smoke training and benches.

A copy of ``eovax/data/synthetic.py``: the same draws from the same seed
(``random.Random`` picks the modality, ``np.random.default_rng`` draws the
images), so both packages see equal batches. Batches keep the collate's
structure: ``{'image' NHWC float32, 'wvs', 'modality'}``.
"""

from __future__ import annotations

import random
from typing import Iterator

import numpy as np

from eovax_torch.data.wavelengths import WAVELENGTHS


def synthetic_terramesh_batches(
    batch_size: int = 8,
    target_size: tuple[int, int] = (256, 256),
    modalities: tuple[str, ...] = ("S2L2A", "S1RTC", "S2RGB"),
    *,
    mode: str = "random",
    seed: int = 0,
    num_batches: int | None = None,
) -> Iterator[dict]:
    """Yields normalized-looking (z-scored) random batches.

    mode='random' picks a modality per batch (stage-2 training contract);
    any modality name yields that modality deterministically (validation).
    """
    rng = random.Random(seed)
    g = np.random.default_rng(seed)
    produced = 0
    while num_batches is None or produced < num_batches:
        modality = rng.choice(list(modalities)) if mode == "random" else mode
        c = len(WAVELENGTHS[modality])
        image = g.standard_normal(
            (batch_size, target_size[0], target_size[1], c), dtype=np.float32
        )
        yield {
            "image": image,
            "wvs": np.asarray(WAVELENGTHS[modality], np.float32),
            "modality": modality,
        }
        produced += 1

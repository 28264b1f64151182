"""Data: wavelength tables, normalization, the TerraMesh reader and collates,
on-device batch preparation, Sen2NAIP and synthetic batches. Port of
``eovax/data``, with the same exports."""

from eovax_torch.data.wavelengths import WAVELENGTHS, BAND_WAVELENGTHS  # noqa: F401
from eovax_torch.data.normalize import (  # noqa: F401
    NORM_STATS_LEGACY,
    Normalizer,
    make_normalizer,
    normalize_image,
    unnormalize_image,
)
from eovax_torch.data.collate import (  # noqa: F401
    apply_batch_augmentations,
    deterministic_modality_collate,
    single_modality_collate,
)
from eovax_torch.data.synthetic import synthetic_terramesh_batches  # noqa: F401

"""Per-modality normalization (host-side numpy, NHWC).

A copy of ``eovax/data/normalize.py`` (the reference's
terramesh_datamodule.py:53-339):
- 'legacy' scheme: z-score with the original TerraMesh statistics
  (terramesh_datamodule.py:53-122), ``(x - mean) / (std + 1e-8)``.
- 'custom' scheme for S2L2A/S2L1C: clip to [0, 10000] then z-score with the
  recomputed (time-aware harmonized) statistics
  (terramesh_datamodule.py:130-275). The +1000 harmonization offset for
  S2L2A frames captured on/after 2022-01-24 is applied at decode time
  by the data pipeline, not here — matching the reference's split of
  responsibilities.

These run on the CPU host inside the input pipeline; the arrays reach the
device already normalized.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NORM_STATS_LEGACY: dict[str, dict[str, list[float]]] = {
    "S2L2A": {
        "mean": [
            1375.648, 1489.600, 1709.087, 1831.752, 2186.075, 2794.358,
            3008.528, 3096.780, 3155.180, 3169.651, 2415.761, 1838.622,
        ],
        "std": [
            2101.107, 2138.673, 2033.628, 2118.186, 2061.646, 1869.234,
            1801.386, 1841.173, 1734.404, 1751.174, 1375.131, 1284.165,
        ],
    },
    "S1RTC": {"mean": [-10.793, -17.198], "std": [4.278, 4.346]},
    "S2L1C": {
        "mean": [
            2475.625, 2260.839, 2143.561, 2230.225, 2445.427, 2992.950,
            3257.843, 3171.695, 3440.958, 1567.433, 561.076, 2562.809,
            1924.178,
        ],
        "std": [
            1761.905, 1804.267, 1661.263, 1932.020, 1918.007, 1812.421,
            1795.179, 1734.280, 1780.039, 1082.531, 512.077, 1350.580,
            1177.511,
        ],
    },
    "S2RGB": {"mean": [110.349, 99.507, 75.843], "std": [69.905, 53.708, 53.378]},
    "DEM": {"mean": [651.663], "std": [928.168]},
}

#: 'custom' scheme stats (clipped/harmonized — terramesh_datamodule.py:144-257).
NORM_STATS_CUSTOM: dict[str, dict[str, list[float]]] = {
    "S2L2A": {
        "mean": [
            1718.9949, 1825.5669, 2043.5834, 2175.4543, 2522.9522, 3114.2216,
            3323.3469, 3417.3660, 3470.9655, 3489.4869, 2725.9735, 2152.0551,
        ],
        "std": [
            2126.3409, 2140.1035, 2044.6618, 2125.3351, 2065.3251, 1874.4652,
            1808.0426, 1839.0210, 1737.9521, 1738.5136, 1456.5919, 1365.1743,
        ],
    },
    "S2L1C": {
        "mean": [
            2424.2556, 2207.7019, 2098.2302, 2167.1584, 2382.3115, 2938.8499,
            3204.8447, 3126.6599, 3389.0706, 1580.1287, 572.5726, 2552.1208,
            1917.9390,
        ],
        "std": [
            1700.3824, 1731.5450, 1610.9904, 1833.5536, 1808.5067, 1694.4427,
            1678.2327, 1625.7446, 1659.3112, 1093.5255, 515.6395, 1300.8892,
            1151.6169,
        ],
    },
}


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Channel-wise z-score normalizer over NHWC arrays."""

    mean: np.ndarray
    std: np.ndarray
    clip: tuple[float, float] | None = None
    eps: float = 0.0  # legacy scheme divides by (std + 1e-8)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """Accepts the stored dtype directly (int16/uint8/fp32): the
        fp32 cast fuses into the subtract (one ufunc pass instead of a
        separate 100 MB/batch cast copy), the clip runs on the native
        dtype (half the bytes for int16), and the scale is an IN-PLACE
        multiply by the precomputed reciprocal."""
        x = np.asarray(x)
        if self.clip is not None:
            lo, hi = self.clip
            if (
                np.issubdtype(x.dtype, np.integer)
                and float(lo).is_integer()
                and float(hi).is_integer()
                and int(lo) <= np.iinfo(x.dtype).max
                and int(hi) >= np.iinfo(x.dtype).min
            ):
                # Integral bounds keep the clip in the native dtype
                # (float bounds would promote the temp to float64, and
                # NumPy 2 raises on out-of-dtype-range Python ints).
                # Clamping the bounds INTO the dtype's range is exact as
                # long as [lo, hi] intersects it: values can't lie beyond
                # the range either. A bound strictly outside the range on
                # the far side (lo > dtype max / hi < dtype min) would
                # force every element to an unrepresentable value, so
                # that case falls through to the fp32 clip.
                info = np.iinfo(x.dtype)
                x = np.clip(x, max(int(lo), info.min), min(int(hi), info.max))
            else:
                x = np.clip(np.asarray(x, np.float32), lo, hi)
        out = np.subtract(x, self.mean, dtype=np.float32)  # fused cast+sub
        out *= np.float32(1.0) / (self.std + self.eps)
        return out

    def inverse(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) * (self.std + self.eps) + self.mean


def make_normalizer(modality: str, scheme: str = "legacy") -> Normalizer:
    """Factory mirroring NormalizerFactory.create
    (terramesh_datamodule.py:305-329): 'custom' exists for S2L2A/S2L1C
    (clip + new stats); everything else falls back to legacy z-score."""
    if scheme == "custom" and modality in NORM_STATS_CUSTOM:
        s = NORM_STATS_CUSTOM[modality]
        return Normalizer(
            mean=np.asarray(s["mean"], np.float32),
            std=np.asarray(s["std"], np.float32),
            clip=(0.0, 10000.0),
        )
    if modality not in NORM_STATS_LEGACY:
        raise ValueError(f"Unknown modality {modality} for normalization")
    s = NORM_STATS_LEGACY[modality]
    return Normalizer(
        mean=np.asarray(s["mean"], np.float32),
        std=np.asarray(s["std"], np.float32),
        eps=1e-8,
    )


def normalize_image(x: np.ndarray, modality: str, scheme: str = "legacy") -> np.ndarray:
    return make_normalizer(modality, scheme)(x)


def unnormalize_image(x: np.ndarray, modality: str, scheme: str = "legacy") -> np.ndarray:
    """Recover physical units (DN / dB) for display and metric eval
    (terramesh_datamodule.py:395-410)."""
    if scheme == "legacy" and modality not in NORM_STATS_LEGACY:
        return x
    return make_normalizer(modality, scheme).inverse(x)

"""Canonical per-modality wavelength tables (µm).

A copy of ``eovax/data/wavelengths.py``: the per-modality vectors fed to the
model as ``wvs``, and the band-name → centre wavelength table.
"""

from __future__ import annotations

import numpy as np

#: Per-modality wavelength vectors — THE conditioning contract. Order
#: matches the channel order of each sensor's arrays.
WAVELENGTHS: dict[str, list[float]] = {
    "S2RGB": [0.665, 0.56, 0.49],
    "S1RTC": [5.4, 5.6],
    "S2L2A": [
        0.443, 0.490, 0.560, 0.665, 0.705, 0.740,
        0.783, 0.842, 0.865, 1.610, 2.190, 0.945,
    ],
    "S2L1C": [
        0.443, 0.490, 0.560, 0.665, 0.705, 0.740, 0.783,
        0.842, 0.865, 0.945, 1.375, 1.610, 2.190,
    ],
}

#: Sen2NAIP cross-sensor RGB+NIR wavelengths.
SEN2NAIP_WAVELENGTHS: list[float] = [0.665, 0.56, 0.49, 0.842]

#: Band-name → center wavelength (µm). SAR bands carry the 5.405 cm C-band
#: value expressed in the µm-equivalent convention used by DOFA.
BAND_WAVELENGTHS: dict[str, float] = {
    "COASTAL_AEROSOL": 0.44,
    "BLUE": 0.49,
    "GREEN": 0.56,
    "RED": 0.665,
    "RED_EDGE_1": 0.705,
    "RED_EDGE_2": 0.74,
    "RED_EDGE_3": 0.783,
    "NIR_BROAD": 0.832,
    "NIR_NARROW": 0.864,
    "WATER_VAPOR": 0.945,
    "CIRRUS": 1.373,
    "SWIR_1": 1.61,
    "SWIR_2": 2.20,
    "THERMAL_INFRARED_1": 10.90,
    "THERMAL_INFRARED_2": 12.00,
    "VV": 5.405,
    "VH": 5.405,
    "ASC_VV": 5.405,
    "ASC_VH": 5.405,
    "DSC_VV": 5.405,
    "DSC_VH": 5.405,
    "VV-VH": 5.405,
}


def wavelengths_for(modality: str) -> np.ndarray:
    return np.asarray(WAVELENGTHS[modality], dtype=np.float32)

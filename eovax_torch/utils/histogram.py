"""Streaming per-channel histogram diagnostic.

Re-design of StreamingHistogram (the reference's eo_vae/datasets/sen2naip.py:
851-917): fixed-range binned counts accumulated over a data stream, used to
hunt no-data spikes and normalization problems (default range [-1200, 1000],
~1 unit/bin). A copy of ``eovax/utils/histogram.py``: numpy host-side;
`plot` renders the reference's log-scale figure (matplotlib Agg), imported
only there.
"""

from __future__ import annotations

import numpy as np


class StreamingHistogram:
    def __init__(self, num_channels: int, min_val: float = -1200,
                 max_val: float = 1000, bins: int = 2200):
        self.num_channels = num_channels
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.bins = bins
        self.hist_counts = np.zeros((num_channels, bins), np.float64)
        self.bin_edges = np.linspace(min_val, max_val, bins + 1)
        self.bin_centers = (self.bin_edges[:-1] + self.bin_edges[1:]) / 2

    def update(self, x: np.ndarray) -> None:
        """x: [B,H,W,C] (NHWC) or [C, ...]."""
        x = np.asarray(x)
        if x.ndim == 4:  # NHWC → [C, N]
            flat = x.transpose(3, 0, 1, 2).reshape(self.num_channels, -1)
        else:
            flat = x.reshape(self.num_channels, -1)
        for c in range(self.num_channels):
            counts, _ = np.histogram(
                flat[c], bins=self.bins, range=(self.min_val, self.max_val)
            )
            self.hist_counts[c] += counts

    def quantile(self, q: float) -> np.ndarray:
        """Approximate per-channel quantile from the binned counts."""
        cdf = np.cumsum(self.hist_counts, axis=1)
        total = cdf[:, -1:]
        idx = np.argmax(cdf >= q * total, axis=1)
        return self.bin_centers[idx]

    def plot(self, path: str, channel_names: list[str] | None = None,
             nodata_line: float = -999.0) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(15, 8))
        for c in range(self.num_channels):
            label = channel_names[c] if channel_names else f"Ch {c}"
            plt.plot(self.bin_centers, self.hist_counts[c], label=label, alpha=0.7)
        plt.yscale("log")
        plt.xlabel("Pixel Value")
        plt.ylabel("Count (Log Scale)")
        plt.grid(True, which="both", ls="-", alpha=0.2)
        plt.axvline(x=nodata_line, color="r", linestyle="--", alpha=0.5)
        plt.axvline(x=0, color="k", linestyle="-", alpha=0.5)
        plt.legend()
        plt.savefig(path)
        plt.close()
        return path

"""Online statistics (Chan/Welford parallel algorithm).

A copy of ``eovax/utils/stats.py`` (the reference's RunningStatsButFast,
encode_latents.py:36-109): numerically stable streaming mean/var/min/max
per channel. Host-side numpy: it aggregates device outputs during the
bulk-encode pass.
"""

from __future__ import annotations

import numpy as np


class RunningStats:
    """Accumulate per-channel statistics over a stream of arrays.

    Args:
        shape: shape of the resulting statistics (e.g. (32,) for latents).
        dims: axes reduced over (e.g. (0, 1, 2) for NHWC batches).
    """

    def __init__(self, shape, dims):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = 0.0
        self.min = np.full(shape, np.inf, np.float64)
        self.max = np.full(shape, -np.inf, np.float64)
        self.dims = tuple(dims)

    def update(self, x) -> None:
        x = np.asarray(x, np.float64)
        batch_mean = x.mean(axis=self.dims)
        batch_count = float(np.prod([x.shape[d] for d in self.dims]))
        # ddof=1 matches the reference's torch.var(unbiased=True) — its
        # M2_b is then overstated by n/(n-1), immaterial at real batch
        # sizes and kept for latent_stats.json parity. The guard must be
        # on the REDUCED count per channel: a batch with one sample per
        # channel has x.size == n_channels > 1 but ddof=1 divides by
        # zero, and a single NaN would poison the accumulator forever.
        if batch_count > 1:
            batch_var = x.var(axis=self.dims, ddof=1)
        else:
            batch_var = np.zeros_like(batch_mean)

        n_ab = self.count + batch_count
        m_a = self.mean * self.count
        m_b = batch_mean * batch_count
        m2_a = self.var * self.count
        m2_b = batch_var * batch_count
        delta = batch_mean - self.mean

        self.mean = (m_a + m_b) / n_ab
        self.var = (m2_a + m2_b + delta**2 * self.count * batch_count / (n_ab + 1e-8)) / n_ab
        self.count = n_ab
        self.min = np.minimum(self.min, x.min(axis=self.dims))
        self.max = np.maximum(self.max, x.max(axis=self.dims))

    __call__ = update

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.var + 1e-8)

    def to_dict(self) -> dict:
        """JSON-ready stats (latent_stats.json schema,
        encode_latents.py:521-529)."""
        return {
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "var": self.var.tolist(),
            "min": self.min.tolist(),
            "max": self.max.tolist(),
            "count": [self.count],
        }

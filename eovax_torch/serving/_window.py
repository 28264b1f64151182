"""Shared last-N latency window with percentile snapshots.

A copy of ``eovax/serving/_window.py``. Both the HTTP handler metrics
(server._Metrics) and the micro-batcher's queue-wait stats keep a capped
window of recent latencies and report percentiles from it; this is the one
implementation they share.
"""

from __future__ import annotations

from collections import deque

import numpy as np

#: window size — large enough for stable p99, small enough to stay cheap.
WINDOW = 512


class LatencyWindow:
    """Capped window of the last :data:`WINDOW` latency samples (ms).

    Backed by ``deque(maxlen=...)`` so a full window evicts in O(1) —
    callers add under the lock the hot request path also contends on, so
    per-sample list copies would be contention, not just garbage.

    Not thread-safe on its own — callers guard it with their own lock
    (both users already hold one around their whole stats dict).
    """

    __slots__ = ("_values",)

    def __init__(self):
        self._values: deque[float] = deque(maxlen=WINDOW)

    def add(self, ms: float) -> None:
        self._values.append(ms)

    def __bool__(self) -> bool:
        return bool(self._values)

    def snapshot(self, prefix: str = "", mean: bool = False) -> dict:
        """``{<prefix>p50_ms, <prefix>p99_ms[, <prefix>mean_ms]}``.

        Empty window -> empty dict (callers splat this into their row).
        """
        if not self._values:
            return {}
        lat = np.asarray(self._values)
        out = {}
        if mean:
            out[f"{prefix}mean_ms"] = round(float(lat.mean()), 2)
        out[f"{prefix}p50_ms"] = round(float(np.percentile(lat, 50)), 2)
        out[f"{prefix}p99_ms"] = round(float(np.percentile(lat, 99)), 2)
        return out

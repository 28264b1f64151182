"""Metric logging: CSV (always) + optional W&B.

A copy of ``eovax/utils/logging.py``. W&B is optional and degrades to a
no-op when the package or the network is absent.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any


class CSVLogger:
    """metrics.csv with a growing union of columns.

    Rows are appended and no history is kept in memory. When a new column
    first appears, the existing file is re-read once and rewritten with the
    wider header. On resume into an existing file only its header is read,
    so earlier rows are kept and appended to."""

    def __init__(self, log_dir: str, name: str = "metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self._fields: list[str] = ["step", "wall_time"]
        self._header_written = False
        if os.path.exists(self.path):
            with open(self.path, newline="") as f:
                fieldnames = csv.DictReader(f).fieldnames
            if fieldnames:
                self._fields = list(fieldnames)
                self._header_written = True

    def log(self, step: int, scalars: dict[str, float]) -> None:
        # wall_time at fixed precision: a stable row length and parse.
        row = {"step": step, "wall_time": f"{time.time():.6f}", **scalars}
        grew = False
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
                grew = True
        if grew or not self._header_written:
            self._rewrite_with_row(row)
            self._header_written = True
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writerow(row)

    def _rewrite_with_row(self, row: dict[str, Any]) -> None:
        """Re-read the existing rows, rewrite them under the widened header,
        and append ``row``: the only path that is not an append."""
        old_rows: list[dict[str, Any]] = []
        if self._header_written and os.path.exists(self.path):
            with open(self.path, newline="") as f:
                old_rows = [dict(r) for r in csv.DictReader(f)]
        with open(self.path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields)
            writer.writeheader()
            writer.writerows(old_rows)
            writer.writerow(row)


class WandbLogger:
    """Thin W&B wrapper with resume='allow'."""

    def __init__(self, project: str, entity: str | None = None, name: str | None = None,
                 config: dict | None = None, mode: str = "online"):
        try:
            import wandb

            self._run = wandb.init(
                project=project, entity=entity, name=name, config=config,
                mode=mode, resume="allow",
            )
        except Exception as e:  # no package or no network: log to CSV only
            print(f"[eovax_torch] wandb unavailable ({type(e).__name__}); logging disabled")
            self._run = None

    def log(self, step: int, scalars: dict[str, float]) -> None:
        if self._run is not None:
            self._run.log(scalars, step=step)


class MultiLogger:
    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log(self, step: int, scalars: dict[str, float]) -> None:
        for lg in self.loggers:
            lg.log(step, scalars)

"""Checkpoint IO on ``torch.save``.

Port of ``eovax/utils/checkpoint.py`` with ``torch.save``/``torch.load`` in
place of orbax and flax's msgpack:

- ``save_variables``/``load_variables``: one ``.pt`` file holding
  ``{"state_dict": ...}``, the format ``EOFluxVAE.load_checkpoint`` reads;
- ``TrainCheckpointer``: step checkpoints written in a background thread,
  the last two kept, restore-latest for resume, and a best checkpoint by a
  monitored metric.

Under a process group only rank 0 writes (its state is every rank's: the
parameters are replicated), and a restore waits for every rank at a barrier
(rank 0 first finishing its write in flight) before it reads, so every rank
reads the same complete file; call the restores on every rank. The ranks
share the checkpoint directory's filesystem.

A checkpoint is a tree of dicts, lists and tuples whose leaves are tensors
and Python scalars. On disk, step n is ``<dir>/step_<n>/state.pt``; a step
directory appears only once it is complete (it is written under a temporary
name and renamed).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import torch

from eovax_torch.core.device import process_index
from eovax_torch.parallel.mesh import barrier

_STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"step_(\d+)")
# The step checkpoints kept on disk, and the direction in which a monitored
# metric improves (the trainer monitors a loss).
MAX_TO_KEEP = 2
MODE = "min"


def host_copy(tree: Any) -> Any:
    """The tree with every tensor copied into a fresh host tensor.

    ``Tensor.cpu()`` of a CPU tensor is the tensor itself; a copy is needed
    so that a background write never sees updates made after the snapshot.
    """
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def _save_atomic(tree: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def save_variables(path: str, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a model state dict as ``{"state_dict": ...}`` to one ``.pt`` file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _save_atomic({"state_dict": host_copy(state_dict)}, path)


def load_variables(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a file written by :func:`save_variables`, on the host."""
    return _load(path)["state_dict"]


class TrainCheckpointer:
    """Step-managed training checkpoints with background writes.

    ``save`` blocks only for the copy of the state into fresh host tensors;
    the file is written in a background thread while training goes on. One
    write is in flight at a time: ``save`` first waits for the previous one.
    A step at or below the last saved one is skipped. An error of the writer
    is raised again from ``wait`` or the next ``save``. The last
    ``MAX_TO_KEEP`` steps are kept.
    """

    def __init__(self, directory: str):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._last_saved = self.latest_step()

    def all_steps(self) -> list[int]:
        """The steps whose checkpoint is complete, in order."""
        steps = []
        for name in os.listdir(self._dir):
            m = _STEP_DIR.fullmatch(name)
            if m and os.path.isfile(os.path.join(self._dir, name, _STATE_FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Snapshot ``state`` to host memory and write it in the background;
        returns whether a save was started (on a rank other than 0, whether rank
        0 started one: that rank copies and writes nothing)."""
        self.wait()
        step = int(step)
        if self._last_saved is not None and step <= self._last_saved:
            return False
        if process_index() != 0:
            self._last_saved = step
            return True
        snapshot = host_copy(state)
        self._thread = threading.Thread(target=self._write_step, args=(step, snapshot),
                                        name=f"checkpoint-step-{step}")
        self._thread.start()
        return True

    def _write_step(self, step: int, snapshot: Any) -> None:
        try:
            tmp = os.path.join(self._dir, f".tmp_step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(snapshot, os.path.join(tmp, _STATE_FILE))
            os.replace(tmp, os.path.join(self._dir, f"step_{step}"))
            self._last_saved = step
            # Older steps go only once the newer one is complete.
            for old in self.all_steps()[:-MAX_TO_KEEP]:
                shutil.rmtree(os.path.join(self._dir, f"step_{old}"))
        except Exception as e:  # raised again on the caller's thread by wait()
            self._error = e

    def restore_latest(self) -> Any | None:
        """The latest complete checkpoint, on the host (None if there is none)."""
        self._sync()
        step = self.latest_step()
        if step is None:
            return None
        return _load(os.path.join(self._dir, f"step_{step}", _STATE_FILE))

    def _sync(self) -> None:
        """Finish this rank's write in flight, then wait for every rank."""
        self.wait()
        barrier()

    def wait(self) -> None:
        """Join the writer; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # -- the best checkpoint by a monitored metric: best/state.pt, and
    # best_metric.json saying what and when. --------------------------------

    @property
    def _best_path(self) -> str:
        return os.path.join(self._dir, "best", _STATE_FILE)

    @property
    def _best_meta_path(self) -> str:
        return os.path.join(self._dir, "best_metric.json")

    def best_info(self) -> dict | None:
        """{'step', 'metric', 'monitor', 'mode'} of the stored best checkpoint, or None."""
        try:
            with open(self._best_meta_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def save_best(self, step: int, state: Any, metric: float, monitor: str = "metric") -> bool:
        """Write ``state`` as the best checkpoint iff ``metric`` is strictly below
        the stored best (``MODE``). Synchronous. Returns whether it saved (False
        on a rank other than 0, which writes nothing)."""
        if process_index() != 0:
            return False
        prev = self.best_info()
        if prev is not None and not metric < prev["metric"]:
            return False
        os.makedirs(os.path.dirname(self._best_path), exist_ok=True)
        _save_atomic(state, self._best_path)
        tmp = self._best_meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "metric": float(metric), "monitor": monitor,
                       "mode": MODE}, f)
        os.replace(tmp, self._best_meta_path)
        return True

    def restore_best(self) -> Any | None:
        """The best checkpoint, on the host (None if none was saved)."""
        self._sync()
        if self.best_info() is None or not os.path.isfile(self._best_path):
            return None
        return _load(self._best_path)

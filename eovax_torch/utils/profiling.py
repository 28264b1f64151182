"""Profiling / tracing utilities.

Port of ``eovax/utils/profiling.py``:
- `trace(...)`: context manager around ``torch.profiler`` writing a Chrome
  trace (``chrome://tracing`` or Perfetto loads it): the host's operators and
  the card's kernels on one timeline.
- `device_barrier(x)`: a synchronize of the device ``x`` lives on; returns a
  scalar of it.
- `enable_nan_checks()`: ``torch.autograd.set_detect_anomaly``, the closest
  switch torch has to ``jax_debug_nans``.
- `memory_stats()`: ``torch.cuda.memory_stats`` of the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "eovax_trace", *, host_tracer_level: int = 2):
    """Capture a ``torch.profiler`` trace around the block and write it to
    ``log_dir/trace.json`` (Chrome trace format); yields the profiler.

    ``host_tracer_level``: 0 traces the card alone, 1 adds the host's
    operators, 2 (default) also their input shapes and Python stacks. Without
    a card only the host is traced.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_tracer_level > 0 else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    verbose = host_tracer_level >= 2
    prof = profile(activities=activities, record_shapes=verbose, with_stack=verbose)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_barrier(x) -> float:
    """Wait for everything queued on ``x``'s device; returns ``x``'s first
    element (a one-element fetch on the CPU)."""
    x = torch.as_tensor(x)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[:1].sum())


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward that computes a NaN raises, naming
    the forward op that made it. Unlike ``jax_debug_nans`` it does not check a
    forward or inference pass, nor any computation without autograd (a NaN
    there propagates silently), and it slows the backward while on."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def stopwatch(label: str = ""):
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[{label}] {box['seconds'] * 1000:.1f} ms")


def memory_stats(device: str | torch.device | None = None) -> dict:
    """The card's memory counters (``torch.cuda.memory_stats``: the caching
    allocator's current and peak bytes, the analogue of
    ``torch.cuda.max_memory_allocated`` in benchmark_compute.py:223,233); an
    empty dict without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))

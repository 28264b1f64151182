"""Slope-method device timing — the port's one shared implementation.

Port of ``eovax/utils/slopetime.py``, same recipe and contract:

  * the workload is chained through a data dependency: each iteration takes
    the previous one's output (here a Python loop of launches, where the JAX
    package runs an on-device ``fori_loop``);
  * two chain lengths are run (``lo`` and ``hi``), each warmed twice (the
    kernels' build and cuDNN's algorithm choice, then a warm run) and timed
    twice (min taken);
  * the only host sync is one ``torch.cuda.synchronize(device)`` after the
    chain (none on the CPU, where each op returns when it is done);
  * ms/iter = (t_hi - t_lo) / (hi - lo) — the constant launch and sync
    overhead cancels in the difference.

On the card the chain's launches queue ahead of the device, so the slope
reads the device's time per iteration where the host launches faster than
the device computes, and the host's launch time where it does not.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

__all__ = ["slope_ms", "chained_ms", "scalar_chained_ms", "random_variables"]


def _first_tensor(tree) -> torch.Tensor | None:
    leaves = torch.utils._pytree.tree_leaves(tree)
    return next((t for t in leaves if torch.is_tensor(t)), None)


def slope_ms(loop: Callable, x0, lo: int = 8, hi: int = 24) -> float:
    """ms per iteration of ``loop(x0, n)`` by the two-length slope method.

    ``loop`` must run its workload n times chained and return a value whose
    first tensor leaf depends on the whole chain; the sync is on its device.
    """

    def run(n):
        t0 = time.perf_counter()
        leaf = _first_tensor(loop(x0, n))
        if leaf is not None and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
        return time.perf_counter() - t0

    for n in (lo, hi):
        run(n)  # build and cuDNN's choice
        run(n)  # warm
    t_lo = min(run(lo), run(lo))
    t_hi = min(run(hi), run(hi))
    return (t_hi - t_lo) / (hi - lo) * 1e3


def chained_ms(fn: Callable, x0, consts=None, lo: int = 8, hi: int = 24) -> float:
    """Slope-time ``fn(consts, x) -> x`` (same-shaped carry, e.g. tanh'd)."""

    def loop(x, n):
        for _ in range(n):
            x = fn(consts, x)
        return x

    return slope_ms(loop, x0, lo, hi)


def scalar_chained_ms(fn_scalar: Callable, consts=None, lo: int = 8, hi: int = 24) -> float:
    """Slope-time ``fn_scalar(consts, s f32 scalar) -> f32 scalar``.

    The scalar must depend on the full computation — reduce everything into
    it. It starts as a zero on the device of the first tensor in ``consts``
    (the card when there is none).
    """
    from eovax_torch.core.device import resolve_device

    leaf = _first_tensor(consts)
    s0 = torch.zeros((), dtype=torch.float32,
                     device=leaf.device if leaf is not None else resolve_device(None))
    return chained_ms(fn_scalar, s0, consts, lo, hi)


def random_variables(module: torch.nn.Module, rng=None) -> dict:
    """N(0, 0.02) values for every entry of ``module``'s state dict, drawn on
    the host from ``rng`` (a numpy Generator, seed 0 by default), in the
    module's dtypes. BatchNorm running statistics (``running_mean`` /
    ``running_var``) are reset to identity (mean 0 / var 1) and integer buffers
    to 0, so timed eval paths see sane normalization."""
    rng = rng if rng is not None else np.random.default_rng(0)
    out = {}
    for name, t in module.state_dict().items():
        if name.endswith("running_var"):
            out[name] = torch.ones_like(t, device="cpu")
        elif name.endswith("running_mean") or not t.is_floating_point():
            out[name] = torch.zeros_like(t, device="cpu")
        else:
            out[name] = torch.from_numpy(
                rng.normal(0, 0.02, size=tuple(t.shape)).astype(np.float32)).to(t.dtype)
    return out

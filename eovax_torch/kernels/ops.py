"""The hand kernels' forwards as torch custom ops (``eovax::conv3x3``,
``eovax::conv3x3_int8``, ``eovax::group_norm``, ``eovax::flash_attention``),
for ``torch.export``.

A ``torch.export`` trace runs on fake tensors: a launch that reads
``data_ptr()`` fails there, and a choice between kernel and plain version
made in Python by the input's device would be baked into the graph. So each
wrapper's forward reaches its kernel through a custom op whenever it is
traced: the op's CUDA implementation is the wrapper's launch with its launch
count, its CPU implementation the plain version, and its fake implementation
gives the output's shape. An exported graph holds the op, and picks the
implementation by the device of the tensors it runs on.

Live (eager) calls take the wrapper's direct call, except inside :func:`live`:
a custom op's dispatch costs host time on every call, and the host paces the
SR sampler's evals (``PERF.md``). Both routes run one launch function.
"""

from __future__ import annotations

import contextlib

import torch

_live = False


@contextlib.contextmanager
def live():
    """Route eager calls through the custom ops inside the block (to time
    their dispatch against the direct call)."""
    global _live
    before, _live = _live, True
    try:
        yield
    finally:
        _live = before


def through_op() -> bool:
    """Whether a wrapper's forward goes through its custom op: under a
    ``torch.export`` trace, or inside :func:`live`."""
    return _live or torch.compiler.is_exporting()

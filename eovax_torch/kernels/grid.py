"""A 3×3 SAME conv as several launches of a kernel whose grid cannot hold it.

The conv kernels (``csrc/conv3x3.cu``, ``csrc/conv3x3_int8.cu``) put a plane's
pixel tiles on the grid's y and the batch on its z, each at most
:data:`GRID_LIMIT` blocks. A conv past either limit runs as several launches:
batch blocks of at most :data:`GRID_LIMIT` rows, and the plane cut into bands
of output rows (and, for a plane wider than the grid, columns). Each band's
input carries one halo row or column of the real plane on each inner side, so
every output pixel reads the same nine inputs as in the whole conv (zeros past
the plane's edge, the neighbour band's pixels at an inner edge), and the band's
output less its halo lands in place: the pieces compute what one launch would.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

GRID_LIMIT = 65535  # blocks on the grid's y and z


def tiles(h: int, w: int, tile: tuple[int, int]) -> int:
    """Pixel tiles of an ``h`` × ``w`` plane in ``tile`` (rows, columns) blocks."""
    return -(-h // tile[0]) * -(-w // tile[1])


def fits(b: int, h: int, w: int, tile: tuple[int, int]) -> bool:
    """Whether one launch's grid holds a [b, ·, h, w] conv."""
    return tiles(h, w, tile) <= GRID_LIMIT and b <= GRID_LIMIT


def _bands(n: int, tile: int, limit: int) -> list[tuple[int, int]]:
    """Output ranges [lo, hi) along an axis of ``n`` pixels whose inputs, one halo
    pixel on each inner side, span at most ``limit`` tiles of ``tile`` pixels."""
    if -(-n // tile) <= limit:
        return [(0, n)]
    step = limit * tile - 2
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def pieces(b: int, h: int, w: int, tile: tuple[int, int]) -> list[tuple[slice, int, int, int, int]]:
    """The launches of a [b, ·, h, w] conv: (batch slice, r0, r1, c0, c1) of each
    piece's output, in order. One piece where :func:`fits`."""
    cols = _bands(w, tile[1], GRID_LIMIT)
    widest = max(min(c1 + 1, w) - max(c0 - 1, 0) for c0, c1 in cols)
    rows = _bands(h, tile[0], GRID_LIMIT // -(-widest // tile[1]))
    return [(slice(b0, min(b0 + GRID_LIMIT, b)), r0, r1, c0, c1)
            for b0 in range(0, b, GRID_LIMIT) for r0, r1 in rows for c0, c1 in cols]


def in_pieces(x: torch.Tensor, co: int, tile: tuple[int, int],
              launch: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The conv of NCHW ``x`` to ``co`` channels by ``launch`` (one kernel launch on
    a contiguous piece of ``x``, its output of the piece's plane), in the pieces
    of :func:`pieces`."""
    b, _, h, w = x.shape
    if fits(b, h, w, tile):
        return launch(x)
    out = x.new_empty((b, co, h, w))
    for bs, r0, r1, c0, c1 in pieces(b, h, w, tile):
        i0, j0 = max(r0 - 1, 0), max(c0 - 1, 0)
        y = launch(x[bs, :, i0:min(r1 + 1, h), j0:min(c1 + 1, w)].contiguous())
        out[bs, :, r0:r1, c0:c1] = y[:, :, r0 - i0:r1 - i0, c0 - j0:c1 - j0]
    return out

"""GroupNorm over NCHW tensors: fp32 statistics and the fused apply in one kernel; and its gradient.

Port of ``eovax/kernels/groupnorm.py``. On a CUDA tensor :func:`group_norm`
launches one hand-written Hopper kernel of ``csrc/groupnorm.cu`` on the plan
of :func:`_fwd_plan`: one thread-block cluster per (batch, group) that reads
its group into shared memory once, takes the group's statistics across the
cluster, and writes the normalized output with the ResnetBlock's AdaIN scale
and shift and its SiLU (a group of at most 4 KiB in one warp's registers
instead), so that a norm → AdaIN → swish sequence reads its input once and
writes its output once. :func:`gn_channel_sums`
keeps the TPU kernel's contract (per-(B, C) fp32 Σx and Σx²) on a statistics
kernel of its own. On a CPU tensor each function computes its plain PyTorch
version.

Every group has a plan: a group that no cluster of up to 16 CTAs cuts on
channel boundaries (an odd cpg above 64, twice an odd cpg above 128, any cpg
above 1024, as ``GroupNorm(1, C)``) takes the pixel-split plan, whose slices
cut the group's pixels anywhere (:func:`_plan`). A grid past 2³¹ − 1 CTAs runs
as several launches over blocks of the batch (:func:`in_kernel_envelope`),
each counted in ``launches``.

The kernels take bf16 (the inference policy) and fp32 (``FULL_PRECISION``);
statistics and arithmetic are fp32, and the output has the input's dtype.

When an input requires grad, :func:`group_norm` is a ``torch.autograd.Function``
that saves x and the per-group fp32 mean and rstd that its kernel writes, and
whose backward is :func:`group_norm_backward`: the JAX package's closed form
``_gn_bwd`` carried through the affine, AdaIN and SiLU, as one more
hand-written kernel (one cluster per (batch, group) that reads x and the
output gradient once, on the plan of :func:`_bwd_plan`) and a few [B, C]
tensor ops.

The forward without statistics is also the custom op ``eovax::group_norm``
(:mod:`eovax_torch.kernels.ops`), through which a ``torch.export`` trace reaches
it; the op takes the plan and checks the operands inside, where the batch is a
number.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from eovax_torch.kernels import build, ops

SOURCE = "groupnorm.cu"
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def gn_channel_sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) fp32 (Σx, Σx²) of an NCHW tensor."""
    xf = x.float()
    return xf.sum(dim=(2, 3)), (xf * xf).sum(dim=(2, 3))


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """[C] or [B, C] → broadcastable over NCHW, fp32."""
    v = v.float()
    return v.view(1, -1, 1, 1) if v.dim() == 1 else v[:, :, None, None]


def group_stats_plain(x: torch.Tensor, groups: int, eps: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass fp32 (mean, rstd) per (B, group)."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    mean = xf.mean(dim=-1)
    var = (xf - mean[..., None]).square().mean(dim=-1)
    return mean, torch.rsqrt(var + eps)


def _normalize_plain(x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    b, groups = mean.shape
    xf = x.float().reshape(b, groups, -1)
    y = ((xf - mean[..., None]) * rstd[..., None]).reshape(x.shape)
    y = y * _per_channel(weight) + _per_channel(bias)
    if ada_scale is not None:
        y = y * _per_channel(ada_scale) + _per_channel(ada_shift)
    if swish:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-6, *, ada_scale: torch.Tensor | None = None,
                     ada_shift: torch.Tensor | None = None, swish: bool = False) -> torch.Tensor:
    """Two-pass fp32 GroupNorm, affine, optional AdaIN (y·s + t) and SiLU,
    rounded once to ``x.dtype``."""
    mean, rstd = group_stats_plain(x, groups, eps)
    return _normalize_plain(x, mean, rstd, weight, bias, ada_scale, ada_shift, swish)


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(build.load(SOURCE))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a library built from ``SOURCE``."""
    for suffix in _SUFFIX.values():
        stats = getattr(lib, f"eovax_gn_stats_{suffix}")
        stats.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
        stats.restype = ctypes.c_int
        fwd = getattr(lib, f"eovax_gn_fwd_{suffix}")
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                        + [ctypes.c_int] * 3 + [ctypes.c_long, ctypes.c_float, ctypes.c_int]
                        + [ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"eovax_gn_bwd_{suffix}")
        bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                        + [ctypes.c_int] * 3 + [ctypes.c_long, ctypes.c_int]
                        + [ctypes.c_int, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int]
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        clusters = getattr(lib, f"eovax_gn_clusters_{suffix}")
        clusters.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        clusters.restype = ctypes.c_int
    return lib


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"{what}: dtype must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be NCHW, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def gn_channel_sums(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) fp32 (Σx, Σx²) of an NCHW tensor.

    CPU tensors take :func:`gn_channel_sums_plain`; CUDA tensors launch the
    statistics kernel (and add one to ``gn_channel_sums.launches``) or raise.
    """
    if x.device.type == "cpu":
        return gn_channel_sums_plain(x)
    _check_input(x, "gn_channel_sums")
    b, c, h, w = x.shape
    if x.numel() == 0:
        raise ValueError(f"gn_channel_sums: empty input {tuple(x.shape)}")
    stats = torch.empty(2, b, c, device=x.device, dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(x.device):
        code = getattr(lib, f"eovax_gn_stats_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), b * c, h * w,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, code, "gn_channel_sums")
    gn_channel_sums.launches += 1
    mean, m2 = stats
    n = float(h * w)
    return mean * n, m2 + mean * mean * n


def _check_params(x, weight, bias, groups, ada_scale, ada_shift, what) -> int:
    """Check the operands of the kernels; returns the AdaIN stride (0: [C], C: [B, C])."""
    _check_input(x, what)
    b, c = x.shape[:2]
    if x.numel() == 0 or c % groups:
        raise ValueError(f"{what}: {tuple(x.shape)} with {groups} groups")
    params = [weight, bias]
    if (ada_scale is None) != (ada_shift is None):
        raise ValueError(f"{what}: ada_scale and ada_shift go together")
    ada_stride = 0
    if ada_scale is not None:
        if ada_scale.shape != ada_shift.shape or ada_scale.shape not in ((c,), (b, c)):
            raise ValueError(f"{what}: AdaIN scale/shift must be [{c}] or [{b}, {c}], got "
                             f"{tuple(ada_scale.shape)}, {tuple(ada_shift.shape)}")
        ada_stride = 0 if ada_scale.dim() == 1 else c
        params += [ada_scale, ada_shift]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{what}: weight and bias must be [{c}]")
    if any(p.device != x.device for p in params):
        raise ValueError(f"{what}: parameters must be on the input's device")
    return ada_stride


def _fp32(*tensors):
    """Contiguous fp32 copies (or the tensors themselves) of the optional operands."""
    return [None if t is None else t.float().contiguous() for t in tensors]


def _row(t, b0: int):
    """The address of row ``b0`` of ``t`` along its first dimension (None for None)."""
    return None if t is None else t.data_ptr() + b0 * t.stride(0) * t.element_size()


def _forward(x, weight, bias, groups, eps, ada_scale, ada_shift, swish, with_stats):
    """The forward on either device; with ``with_stats`` also (mean, rstd) [B, G]."""
    if not with_stats and ops.through_op():
        return _group_norm_op(x, weight, bias, ada_scale, ada_shift, groups, eps, swish)
    if x.device.type == "cpu":
        mean, rstd = group_stats_plain(x, groups, eps)
        out = _normalize_plain(x, mean, rstd, weight, bias, ada_scale, ada_shift, swish)
        return (out, mean, rstd) if with_stats else out
    return _launch(x, weight, bias, groups, eps, ada_scale, ada_shift, swish, with_stats)


def _launch(x, weight, bias, groups, eps, ada_scale, ada_shift, swish, with_stats):
    """Check the operands, plan and launch the forward kernel on a CUDA tensor (adds
    one to ``group_norm.launches`` a launch)."""
    ada_stride = _check_params(x, weight, bias, groups, ada_scale, ada_shift, "group_norm")
    b, c, h, w = x.shape
    n, itemsize, aligned = h * w, x.element_size(), x.data_ptr() % 16 == 0
    weight, bias, ada_scale, ada_shift = _fp32(weight, bias, ada_scale, ada_shift)
    out = torch.empty_like(x)
    stats = torch.empty(2, b, groups, device=x.device, dtype=torch.float32) if with_stats else None
    lib = _library()
    entry = getattr(lib, f"eovax_gn_fwd_{_SUFFIX[x.dtype]}")
    ada_rows = ada_stride != 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        plan = _fwd_plan(b, c, groups, n, itemsize, aligned=aligned)
        for b0, b1 in _batch_blocks(b, groups, plan):
            code = entry(
                _row(x, b0), _row(out, b0), weight.data_ptr(), bias.data_ptr(),
                _row(ada_scale, b0 if ada_rows else 0), _row(ada_shift, b0 if ada_rows else 0),
                ada_stride, _row(stats[0], b0) if with_stats else None,
                _row(stats[1], b0) if with_stats else None, b1 - b0, c, groups, n, eps,
                int(swish), *plan, stream,
            )
            build.check(lib, code, "group_norm")
            group_norm.launches += 1
    return (out, stats[0], stats[1]) if with_stats else out


@torch.library.custom_op("eovax::group_norm", mutates_args=(), device_types="cpu")
def _group_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   ada_scale: torch.Tensor | None, ada_shift: torch.Tensor | None, groups: int,
                   eps: float, swish: bool) -> torch.Tensor:
    return group_norm_plain(x, weight, bias, groups, eps, ada_scale=ada_scale,
                            ada_shift=ada_shift, swish=swish)


@_group_norm_op.register_kernel("cuda")
def _(x, weight, bias, ada_scale, ada_shift, groups, eps, swish):
    return _launch(x, weight, bias, groups, eps, ada_scale, ada_shift, swish, with_stats=False)


@_group_norm_op.register_fake
def _(x, weight, bias, ada_scale, ada_shift, groups, eps, swish):
    return torch.empty_like(x)


def _plane_coefficients(x, mean, rstd, weight, bias, ada_scale, ada_shift):
    """fp32 [B, C] (μ, r, a, c) with x̂ = (x − μ)·r and z = x̂·a + c, as the kernels
    work them out for each plane."""
    b, c = x.shape[:2]
    per_channel = (lambda v: v.float().repeat_interleave(c // mean.shape[1], dim=1))
    s = (ada_scale if ada_scale is not None else torch.ones_like(weight)).float().expand(b, c)
    t = (ada_shift if ada_shift is not None else torch.zeros_like(bias)).float().expand(b, c)
    return per_channel(mean), per_channel(rstd), weight.float() * s, bias.float() * s + t


def _xhat_dz(x, g, coef, swish):
    mu, r, a, c = (v[:, :, None, None] for v in coef)
    xh = (x.float() - mu) * r
    dz = g.float()
    if swish:
        z = xh * a + c
        sg = torch.sigmoid(z)
        dz = dz * sg * (1.0 + z * (1.0 - sg))
    return xh, dz


def _backward_plain(g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    """The kernel's contract in plain PyTorch: (dx, S1 = Σ dz, S2 = Σ dz·x̂)."""
    coef = _plane_coefficients(x, mean, rstd, weight, bias, ada_scale, ada_shift)
    xh, dz = _xhat_dz(x, g, coef, swish)
    s1, s2 = dz.sum(dim=(2, 3)), (dz * xh).sum(dim=(2, 3))
    b, c = s1.shape
    groups, a, r = mean.shape[1], coef[2], coef[1]
    # _gn_bwd's per-group means of g·γ' and g·γ'·x̂, with γ' = a the scale of x̂ in z.
    group_mean = (lambda v: (v.view(b, groups, -1).sum(dim=-1) / x[0, : c // groups].numel())
                  .repeat_interleave(c // groups, dim=1)[:, :, None, None])
    dx = r[:, :, None, None] * (a[:, :, None, None] * dz - group_mean(a * s1)
                                - xh * group_mean(a * s2))
    return dx.to(x.dtype), s1, s2


class FwdPlan(NamedTuple):
    """How the forward kernel cuts one (b, group), a contiguous run of cpg·n
    elements in NCHW: a cluster of ``cluster`` CTAs, each owning ``slice``
    elements on channel boundaries, the first ``resident`` of them (x) in
    ``smem_bytes`` of shared memory and the rest read from device memory twice.
    With ``split`` (the pixel-split plan) the slices are cut anywhere in the
    run: each CTA owns ``slice`` elements but the last, which owns the rest.
    ``cluster`` 0 is the warp plan: one warp holds the whole group (``slice``
    and ``resident`` its cpg·n elements) in registers, with no shared memory."""

    cluster: int
    slice: int
    resident: int
    smem_bytes: int
    split: bool = False


class BwdPlan(NamedTuple):
    """How the backward kernel cuts one (b, group), as :class:`FwdPlan` does, the
    first ``resident`` elements of each slice of x and of g in ``smem_bytes``."""

    cluster: int
    slice: int
    resident: int
    smem_bytes: int
    split: bool = False


_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # above 8 the card's non-portable cluster size
_MAX_SEGMENTS = 64  # channels in one CTA's slice (kMaxSegments in csrc/groupnorm.cu)
# x of one CTA's slice in shared memory in the forward: three CTAs fit on an SM
# (228 KB), as many as the kernel's registers allow.
_FWD_SMEM_TARGET = 64 * 1024
# The forward's cluster grows for the grid's size only while a CTA keeps this
# much of x: at [8, 256, 16, 16] bf16 (4 KiB groups) one CTA a group took
# 0.0071 ms, two 0.0162 (scripts/ablate_gn_forward.py).
_FWD_MIN_SLICE_BYTES = 4 * 1024
# 16-byte vectors a lane holds in the forward's warp plan (kWarpVecs in
# csrc/groupnorm.cu): groups of up to 32 of these a warp take it.
_WARP_VECS = 8
# x and g of one CTA's slice in shared memory in the backward: three CTAs an
# SM. At [16, 256, 256, 256] bf16 a 64 KiB resident part (three CTAs an SM)
# beat 96 KiB (two) on an H100 SXM at 700 W (scripts/ablate_gn_backward.py).
_BWD_SMEM_TARGET = 64 * 1024
# Grow the cluster (where the slices allow) until the grid has this many CTAs:
# two per SM of the H100's 132.
_MIN_CTAS = 264
# CTAs of one launch's grid (its x dimension); a larger grid runs in batch blocks.
_MAX_GRID = 0x7FFFFFFF


@functools.lru_cache(maxsize=256)
def _cluster_sizes(cpg: int, n: int, itemsize: int) -> tuple[int, ...]:
    """The cluster sizes that cut a group of ``cpg`` planes of ``n`` elements on
    channel boundaries: cpg/k whole planes a CTA (at most ``_MAX_SEGMENTS``),
    or 1/m of one plane (k = m·cpg), a whole number of 16-byte vectors where n
    is one."""
    vec = 16 // itemsize

    def splits(k):
        if cpg % k == 0:
            return cpg // k <= _MAX_SEGMENTS
        m = k // cpg
        return k % cpg == 0 and n % m == 0 and (n % vec != 0 or (n // m) % vec == 0)

    return tuple(k for k in _CLUSTER_SIZES if splits(k))


def _split_slice(span: int, k: int, unit: int) -> int:
    """The pixel-split plan's slice for ``k`` CTAs: span/k rounded up to whole ``unit``s."""
    return -(-span // (k * unit)) * unit


def _plan(b: int, c: int, groups: int, n: int, itemsize: int, operands: int, target: int,
          min_slice_bytes: int = 0) -> tuple[int, int, int, bool]:
    """(cluster, slice, resident, split) of a cluster kernel that holds ``operands``
    tensors of a CTA's slice in ``target`` bytes of shared memory: the smallest
    cluster whose slices fit (grown until the grid has ``_MIN_CTAS`` CTAs, while
    a slice keeps ``min_slice_bytes`` of x); where none fits, the largest, with
    the resident part cut to the target and the rest streamed. The cluster sizes
    are those that cut a group on channel boundaries; where there is none, the
    pixel-split plan's, whose slices are whole 16-byte vectors where n is (and
    single elements otherwise) and leave every CTA at least one element."""
    cpg = c // groups
    span, vec = cpg * n, 16 // itemsize
    sizes = _cluster_sizes(cpg, n, itemsize)
    split = not sizes
    if split:
        unit = vec if n % vec == 0 else 1
        cut = functools.partial(_split_slice, span, unit=unit)
        sizes = tuple(k for k in _CLUSTER_SIZES if (k - 1) * cut(k) < span)
    else:
        cut = span.__floordiv__
    fits = [k for k in sizes if operands * itemsize * cut(k) <= target]
    k = fits[0] if fits else sizes[-1]
    for m in sizes:
        if m > k and b * groups * k < _MIN_CTAS and itemsize * cut(m) >= min_slice_bytes:
            k = m
    slice_ = cut(k)
    return k, slice_, min(slice_, target // (operands * itemsize) // vec * vec), split


def _fwd_plan(b: int, c: int, groups: int, n: int, itemsize: int,
              aligned: bool = True) -> FwdPlan:
    """The forward kernel's plan for x of shape [b, c, n] (n = H·W) in ``groups``
    groups and elements of ``itemsize`` bytes: the warp plan for a group of at
    most 32·``_WARP_VECS`` 16-byte vectors (n a whole number of them, x
    ``aligned`` to 16 bytes), else a cluster plan on ``_FWD_SMEM_TARGET``."""
    if _warp_plan(c, groups, n, itemsize, aligned):
        span = c // groups * n
        return FwdPlan(0, span, span, 0)
    k, slice_, resident, split = _plan(b, c, groups, n, itemsize, 1, _FWD_SMEM_TARGET,
                                       _FWD_MIN_SLICE_BYTES)
    return FwdPlan(k, slice_, resident, itemsize * resident, split)


def _bwd_plan(b: int, c: int, groups: int, n: int, itemsize: int) -> BwdPlan:
    """The backward kernel's plan, as :func:`_fwd_plan`, on ``_BWD_SMEM_TARGET``
    for x and g."""
    k, slice_, resident, split = _plan(b, c, groups, n, itemsize, 2, _BWD_SMEM_TARGET)
    return BwdPlan(k, slice_, resident, 2 * itemsize * resident, split)


def _warp_plan(c: int, groups: int, n: int, itemsize: int, aligned: bool) -> bool:
    """Whether the forward takes the warp plan: a group of at most 32·``_WARP_VECS``
    16-byte vectors, n a whole number of them, x 16-byte aligned."""
    span, vec = c // groups * n, 16 // itemsize
    return aligned and n % vec == 0 and span <= 32 * _WARP_VECS * vec


def _batch_blocks(b: int, groups: int, plan: FwdPlan | BwdPlan) -> list[tuple[int, int]]:
    """The batch rows [b0, b1) of each launch on ``plan`` (the plan of the whole
    batch, which every block keeps): one launch where its grid (``groups``
    clusters of ``plan.cluster`` CTAs a row; the warp plan a warp a group) holds
    at most ``_MAX_GRID`` CTAs, else blocks of as many rows as fit."""
    rows = max(1, _MAX_GRID // (groups * max(plan.cluster, 1)))
    return [(b0, min(b0 + rows, b)) for b0 in range(0, b, rows)]


def in_kernel_envelope(b: int, c: int, groups: int, n: int, itemsize: int, *,
                       forward: bool = True, aligned: bool = True) -> bool:
    """Whether one launch of the forward kernel (or with ``forward`` False the
    backward) takes x [b, c, n] (n = H·W) in ``groups`` groups of elements of
    ``itemsize`` bytes, x 16-byte ``aligned`` or not. Every group has a plan (the
    pixel-split plan where no cluster size cuts it on channel boundaries), so
    this is whether the plan's grid holds at most ``_MAX_GRID`` CTAs; past it
    the wrappers launch in batch blocks (:func:`_batch_blocks`)."""
    if min(b, c, groups, n) <= 0 or c % groups:
        return False
    plan = (_fwd_plan(b, c, groups, n, itemsize, aligned) if forward
            else _bwd_plan(b, c, groups, n, itemsize))
    return len(_batch_blocks(b, groups, plan)) == 1


def active_clusters(plan: FwdPlan | BwdPlan, dtype: torch.dtype, vec: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the forward or backward kernel (by the
    plan's type; its vectorized or scalar instance, on its plan's form) for
    ``plan``: how many of its clusters the card holds at once (the warp plan
    launches none: 0)."""
    if plan.cluster == 0:
        return 0
    lib = _library()
    count = ctypes.c_int()
    code = getattr(lib, f"eovax_gn_clusters_{_SUFFIX[dtype]}")(
        int(isinstance(plan, FwdPlan)), plan.cluster, plan.smem_bytes, int(vec), int(plan.split),
        ctypes.byref(count))
    build.check(lib, code, "active_clusters")
    return count.value


def _check_backward(g, x, mean, rstd, weight, bias, ada_scale, ada_shift) -> None:
    """Raise ValueError unless these are operands of the backward on a CUDA tensor."""
    groups = mean.shape[-1]
    _check_params(x, weight, bias, groups, ada_scale, ada_shift, "group_norm_backward")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError("group_norm_backward: g must be a contiguous tensor like x")
    b = x.shape[0]
    if (mean.shape != (b, groups) or rstd.shape != mean.shape
            or mean.device != x.device or rstd.device != x.device):
        raise ValueError(f"group_norm_backward: mean and rstd must be [{b}, groups] on x's "
                         f"device, got {tuple(mean.shape)}, {tuple(rstd.shape)}")


def _backward_kernel(g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    """Plan and launch the backward kernel on operands that :func:`_check_backward`
    took (adds one to ``group_norm_backward.launches`` a launch)."""
    groups = mean.shape[-1]
    b, c, h, w = x.shape
    n, itemsize = h * w, x.element_size()
    ada_rows = ada_scale is not None and ada_scale.dim() == 2
    mean, rstd, weight, bias, ada_scale, ada_shift = _fp32(mean, rstd, weight, bias, ada_scale,
                                                           ada_shift)
    dx = torch.empty_like(x)
    sums = torch.empty(2, b, c, device=x.device, dtype=torch.float32)
    lib = _library()
    entry = getattr(lib, f"eovax_gn_bwd_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        plan = _bwd_plan(b, c, groups, n, itemsize)
        for b0, b1 in _batch_blocks(b, groups, plan):
            at = b0 if ada_rows else 0
            code = entry(
                _row(x, b0), _row(g, b0), _row(dx, b0), _row(mean, b0), _row(rstd, b0),
                weight.data_ptr(), bias.data_ptr(), _row(ada_scale, at), _row(ada_shift, at),
                c if ada_rows else 0, _row(sums[0], b0), _row(sums[1], b0), b1 - b0, c, groups,
                n, int(swish), *plan, stream,
            )
            build.check(lib, code, "group_norm_backward")
            group_norm_backward.launches += 1
    return dx, sums[0], sums[1]


def _backward(passes, g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish):
    dx, s1, s2 = passes(g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish)
    if ada_scale is None:
        return dx, s2.sum(dim=0), s1.sum(dim=0), None, None
    s = ada_scale.float().expand_as(s1)
    d_scale, d_shift = weight.float() * s2 + bias.float() * s1, s1
    if ada_scale.dim() == 1:
        d_scale, d_shift = d_scale.sum(dim=0), d_shift.sum(dim=0)
    return dx, (s * s2).sum(dim=0), (s * s1).sum(dim=0), d_scale, d_shift


def group_norm_backward(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor, *,
                        ada_scale: torch.Tensor | None = None,
                        ada_shift: torch.Tensor | None = None, swish: bool = False):
    """Gradients of :func:`group_norm` for the output gradient ``g`` (x's dtype and
    shape, contiguous), from the saved ``x`` and fp32 per-group ``mean`` and
    ``rstd`` [B, G]: (dx in x's dtype, dweight, dbias, d_ada_scale, d_ada_shift)
    in fp32, the AdaIN ones None without AdaIN and summed over B for a [C] AdaIN.

    CPU tensors take :func:`group_norm_backward_plain`; CUDA tensors launch the
    backward kernel once (a batch block a launch past :func:`in_kernel_envelope`;
    each adds one to ``group_norm_backward.launches``) or raise. The parameter
    gradients are a few tensor ops on the kernel's per-plane sums.
    """
    if x.device.type == "cpu":
        return group_norm_backward_plain(g, x, mean, rstd, weight, bias, ada_scale=ada_scale,
                                         ada_shift=ada_shift, swish=swish)
    _check_backward(g, x, mean, rstd, weight, bias, ada_scale, ada_shift)
    return _backward(_backward_kernel, g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish)


def group_norm_backward_plain(g, x, mean, rstd, weight, bias, *, ada_scale=None, ada_shift=None,
                              swish=False):
    """:func:`group_norm_backward` with its kernel's work in plain PyTorch."""
    return _backward(_backward_plain, g, x, mean, rstd, weight, bias, ada_scale, ada_shift, swish)


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, ada_scale, ada_shift, groups, eps, swish):
        out, mean, rstd = _forward(x, weight, bias, groups, eps, ada_scale, ada_shift, swish,
                                   with_stats=True)
        ctx.save_for_backward(x, mean, rstd, weight, bias, ada_scale, ada_shift)
        ctx.swish = swish
        return out

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, bias, ada_scale, ada_shift = ctx.saved_tensors
        dx, dw, db, ds, dt = group_norm_backward(
            g.to(x.dtype).contiguous(), x, mean, rstd, weight, bias, ada_scale=ada_scale,
            ada_shift=ada_shift, swish=ctx.swish)
        cast = (lambda d, p: None if d is None else d.to(p.dtype))
        return (dx, cast(dw, weight), cast(db, bias), cast(ds, ada_scale), cast(dt, ada_shift),
                None, None, None)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
               eps: float = 1e-6, *, ada_scale: torch.Tensor | None = None,
               ada_shift: torch.Tensor | None = None, swish: bool = False) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` with fp32 statistics, then ``weight``/``bias``,
    the optional AdaIN ``y·ada_scale + ada_shift`` ([C] shared or [B, C]) and
    the optional SiLU; the output has ``x.dtype``.

    CPU tensors take :func:`group_norm_plain`; CUDA tensors launch the forward
    kernel once (a batch block a launch past :func:`in_kernel_envelope`; each adds
    one to ``group_norm.launches``) or raise. Where grad is enabled and an input
    requires it, the output carries the backward of :func:`group_norm_backward`.
    """
    inputs = (x, weight, bias, ada_scale, ada_shift)
    if (torch.is_grad_enabled() and not torch.compiler.is_exporting()
            and any(t is not None and t.requires_grad for t in inputs)):
        return _GroupNorm.apply(x, weight, bias, ada_scale, ada_shift, groups, eps, swish)
    return _forward(x, weight, bias, groups, eps, ada_scale, ada_shift, swish, with_stats=False)


gn_channel_sums.launches = 0
group_norm.launches = 0
group_norm_backward.launches = 0

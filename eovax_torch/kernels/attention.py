"""Single-head, unmasked attention over [B, S, D] tensors.

Port of ``eovax/kernels/attention.py``. On a CUDA tensor
:func:`flash_attention` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` for every S (the JAX package sends only
S ≥ 4096 to its Pallas kernel; here the kernel is the path's attention
whatever the length). On a CPU tensor it computes
:func:`flash_attention_plain`, the plain PyTorch version of the same
function.

The kernel takes bf16 (the inference policy) and fp32 (``FULL_PRECISION``),
with D in :data:`KERNEL_HEAD_DIMS` or, in its D-split variant, any multiple of
64 above 512, and at most 65535 batch rows (its grid's y); the logits, softmax
statistics and the P·V accumulator are fp32, and the output has the input's
dtype. Where one launch cannot take the shape as it is
(:func:`in_kernel_envelope`) the wrapper widens it for the kernel
(:func:`widened`): a narrower D is zero-padded to the next kernel width Dk (q
scaled by √(Dk/D) in its dtype, so the kernel's 1/√Dk gives q·kᵀ/√D), a wider
D to the next multiple of 64 (the D-split kernel takes the true D's 1/√D); the
zero columns add nothing to q·kᵀ, and the output's are dropped. More than
65535 batch rows run as several launches, each adding one to the count.

When an input requires grad, :func:`flash_attention` is a
``torch.autograd.Function``; the JAX trainer's gradient is autodiff of
``sdpa_auto``'s plain einsum, outside any Pallas kernel, and its backward
computes that gradient. On a CUDA tensor the forward kernel also writes each
row's log-sum-exp of the scaled logits (:func:`flash_attention_with_lse`), and
the backward is :func:`flash_attention_backward_from_stats`: three launches of
the hand kernels in ``csrc/flash_attention_bwd.cu`` (Δ = rowsum(dO∘O); dK and
dV; dQ), which recompute the probabilities tile by tile from those statistics
and keep nothing of size S². :func:`backward_kernels` picks them by dtype and
width: bf16 at kernel widths 64 and 128 the `wgmma` kernels, at 256 and 512 the
`wgmma` kernels with D split over a thread-block cluster, above 512 the
`mma.sync` kernels, fp32 the FMA kernels. A call outside
:func:`in_kernel_envelope` is widened as the forward widens it, and its
gradients narrowed by the chain rule.
On a CPU tensor the backward is :func:`flash_attention_backward`, which
recomputes the fp32 probabilities from the saved q, k and v in tensor ops.
:func:`flash_attention_lse_plain` and
:func:`flash_attention_backward_from_stats_plain` are the kernels' arithmetic
in tensor ops, for the tests.

The forward is also the custom op ``eovax::flash_attention``
(:mod:`eovax_torch.kernels.ops`), through which a ``torch.export`` trace reaches it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eovax_torch.kernels import build, grid, ops

SOURCE = "flash_attention.cu"
BACKWARD_SOURCE = "flash_attention_bwd.cu"
KERNEL_HEAD_DIMS = (64, 128, 256, 512)
# D above the widest kernel width goes to the D-split kernel, padded to this.
_SPLIT_ALIGN = 64
_ENTRY = {torch.bfloat16: "eovax_flash_attention_bf16", torch.float32: "eovax_flash_attention_f32"}
_SPLIT_ENTRY = {torch.bfloat16: "eovax_flash_attention_split_bf16",
                torch.float32: "eovax_flash_attention_split_f32"}
# The backward kernels of each route (:func:`backward_kernels`): the C entries
# eovax_flash_attention_bwd_<part> of Δ (with, for the wgmma and cluster kernels,
# the statistics padded to their rows), dK/dV and dQ.
_BACKWARD_PARTS = {"wgmma": ("stats_bf16", "dkdv_wgmma_bf16", "dq_wgmma_bf16"),
                   "cluster": ("stats_bf16", "dkdv_cluster_bf16", "dq_cluster_bf16"),
                   "mma": ("delta_bf16", "dkdv_bf16", "dq_bf16"),
                   "fma": ("delta_f32", "dkdv_f32", "dq_f32")}
# Kernel widths at which bf16 takes the wgmma backward kernels, and those at which
# it takes them with D split over a cluster of D/128 CTAs.
WGMMA_BACKWARD_WIDTHS = (64, 128)
CLUSTER_BACKWARD_WIDTHS = (256, 512)
# The kernels' row statistics are in log2 units: log2 Σ exp2(x·log2 e) of the
# scaled logits x.
_LOG2E = 1.4426950408889634


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √D) v in fp32, cast to ``q.dtype``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The forward kernel's row statistics in tensor ops: the fp32 [B, S]
    log-sum-exp of each row of q kᵀ / √D, in log2 units (the natural one times
    log2 e). ``v`` is not read: the signature is the forward's."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(logits, dim=-1) * _LOG2E


def flash_attention_backward_from_stats_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
        do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in tensor ops: (dq, dk, dv) from the
    forward's output ``o`` and row statistics ``lse`` (log2 units, as
    :func:`flash_attention_lse_plain` gives them).

    Δ = rowsum(dO∘O) in fp32; P = exp2(q kᵀ·log2(e)/√D − lse) in fp32, rounded to
    the compute dtype before dV = Pᵀ·dO; dP = dO·Vᵀ in fp32; dS = P∘(dP − Δ),
    rounded to the compute dtype before dQ = dS·K and dK = dSᵀ·Q, each times the
    scale. Every product accumulates in fp32, and each gradient is rounded once.
    """
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    do = do.to(dt).float()
    delta = (do * o.float()).sum(dim=-1, keepdim=True)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp2(logits * (scale * _LOG2E) - lse.float()[..., None])
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do).to(dt)
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(dt)
    return dq, dk, dv


def _kernel_width(d: int) -> int:
    """The D a launch takes for head width ``d``: the least of
    :data:`KERNEL_HEAD_DIMS` not below it, or above them the next multiple of
    ``_SPLIT_ALIGN`` (the D-split kernel)."""
    if d > KERNEL_HEAD_DIMS[-1]:
        return -(-d // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return next(w for w in KERNEL_HEAD_DIMS if w >= d)


def in_kernel_envelope(q_shape) -> bool:
    """Whether one launch takes q, k, v of shape [B, S, D] as they are: D a kernel
    width (in :data:`KERNEL_HEAD_DIMS`, or a multiple of 64 above them for the
    D-split kernel) and B at most 65535 (the grid's y). Outside it the wrapper
    pads D to a kernel width or launches in batch blocks."""
    b, s, d = q_shape
    return _kernel_width(d) == d and b <= grid.GRID_LIMIT


def widened(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v [B, S, D] at the kernel width Dk of :func:`_kernel_width`, zero
    columns appended. Up to the widest of :data:`KERNEL_HEAD_DIMS` q is scaled
    by √(Dk/D) (one rounding to its dtype) so that the kernel's 1/√Dk scale gives
    q·kᵀ/√D; above it q is left as it is, since the D-split kernel takes the
    true D's scale. The attention of the result, less its last Dk − D columns,
    is that of the inputs."""
    d = q.shape[-1]
    dk = _kernel_width(d)
    if dk == d:
        return q, k, v
    if d <= KERNEL_HEAD_DIMS[-1]:
        q = (q.float() * (dk / d) ** 0.5).to(q.dtype)
    return tuple(F.pad(t, (0, dk - d)) for t in (q, k, v))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    for name in _SPLIT_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


def backward_kernels(dtype: torch.dtype, d: int) -> str:
    """The route of the backward kernels for a call of head width ``d`` in
    ``dtype``, at the kernel width the call is widened to (:func:`_kernel_width`):
    ``"wgmma"`` for bf16 at :data:`WGMMA_BACKWARD_WIDTHS`, ``"cluster"`` for bf16
    at :data:`CLUSTER_BACKWARD_WIDTHS`, ``"mma"`` for bf16 at the wider widths,
    ``"fma"`` for fp32."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_backward: no kernel for {dtype}")
    width = _kernel_width(d)
    if width in WGMMA_BACKWARD_WIDTHS:
        return "wgmma"
    return "cluster" if width in CLUSTER_BACKWARD_WIDTHS else "mma"


def bind_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of the C entries eovax_flash_attention_bwd_<part> of a
    library built from :data:`BACKWARD_SOURCE` (or from a variant of it)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    argtypes = {"delta_bf16": [ptr] * 3 + [ctypes.c_longlong, i32, ptr],
                "dkdv_bf16": [ptr] * 8 + [i32] * 4 + [ptr],
                "dq_bf16": [ptr] * 7 + [i32] * 4 + [ptr],
                "stats_rows": [i32],
                "stats_bf16": [ptr] * 5 + [i32] * 4 + [ptr],
                "dkdv_wgmma_bf16": [ptr] * 8 + [i32] * 5 + [ptr],
                "dq_wgmma_bf16": [ptr] * 7 + [i32] * 5 + [ptr],
                "cluster_occupancy": [i32, i32, ptr]}
    for part in ("dkdv", "dq"):
        argtypes[f"{part}_cluster_bf16"] = argtypes[f"{part}_wgmma_bf16"]
    for part in ("delta", "dkdv", "dq"):
        argtypes[f"{part}_f32"] = argtypes[f"{part}_bf16"]
    for part, types in argtypes.items():
        fn = getattr(lib, f"eovax_flash_attention_bwd_{part}")
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    return bind_backward(build.load(BACKWARD_SOURCE))


def backward_active_clusters(d: int, part: str) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster kernel of kernel width ``d``
    (in :data:`CLUSTER_BACKWARD_WIDTHS`) for ``part`` ``"dkdv"`` or ``"dq"`` on the
    current card: how many of its clusters the card holds at once. A launch
    raises where it is 0."""
    if d not in CLUSTER_BACKWARD_WIDTHS or part not in ("dkdv", "dq"):
        raise ValueError(f"backward_active_clusters: no cluster kernel {part} at D = {d}")
    lib = _backward_library()
    count = ctypes.c_int(0)
    code = lib.eovax_flash_attention_bwd_cluster_occupancy(d, int(part == "dkdv"),
                                                           ctypes.byref(count))
    build.check(lib, code, f"backward_active_clusters ({part}, D = {d})")
    return count.value


def _backward_launch(lib: ctypes.CDLL, part: str, *args) -> None:
    """Launch the backward kernel of C entry ``part``, raise on its error, and count it."""
    code = getattr(lib, f"eovax_flash_attention_bwd_{part}")(*args)
    build.check(lib, code, f"flash_attention_backward ({part})")
    flash_attention_backward.launches += 1
    flash_attention_backward.kernels[part] = flash_attention_backward.kernels.get(part, 0) + 1


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             do: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q kᵀ / √D) v for the output gradient ``do``, in tensor
    ops (adds one to ``flash_attention_backward.calls``).

    As autodiff of the JAX package's ``sdpa_auto``: fp32 logits and softmax, P
    rounded to the compute dtype before dV = Pᵀ·dO and dP = dO·Vᵀ in the compute
    dtype, dS = P∘(dP − rowsum(dP∘P)) in fp32, and dQ, dK from dS times the scale.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    do = do.to(q.dtype)
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(v.dtype).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2)).float()
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, k.float()).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).to(k.dtype)
    flash_attention_backward.calls += 1
    return dq, dk, dv


def _check_operands(what: str, *ts: torch.Tensor) -> None:
    """Raise unless the tensors are contiguous [B, S, D] of one shape, dtype
    (bf16 or fp32) and CUDA device."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 3 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: operands must share one [B, S, D] shape, got "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: operands must be on one device")
    if q.dtype not in _ENTRY or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: dtypes must all be bfloat16 or float32, got "
                         f"{', '.join(str(t.dtype) for t in ts)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: operands must be contiguous")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            stats: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward on the kernel: the output and, where ``stats``, the [B, S] fp32
    row statistics (else None)."""
    _check_operands("flash_attention", q, k, v)
    b, s, d = q.shape
    lse = torch.empty((b, s), device=q.device, dtype=torch.float32) if stats else None
    if b == 0 or s == 0 or d == 0:
        return torch.empty_like(q), lse
    if not in_kernel_envelope(q.shape):
        q, k, v = widened(q, k, v)
    dk = q.shape[-1]
    lib = _library()
    # D above the widest kernel width: the D-split kernel, told the true D's scale.
    entry, extra = ((_SPLIT_ENTRY[q.dtype], (d,)) if dk > KERNEL_HEAD_DIMS[-1]
                    else (_ENTRY[q.dtype], ()))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        row = s * dk * q.element_size()  # bytes of one batch row
        for b0 in range(0, b, grid.GRID_LIMIT):
            at = b0 * row
            code = getattr(lib, entry)(
                q.data_ptr() + at, k.data_ptr() + at, v.data_ptr() + at, out.data_ptr() + at,
                min(grid.GRID_LIMIT, b - b0), s, dk, *extra,
                lse.data_ptr() + b0 * s * 4 if stats else None, stream
            )
            build.check(lib, code, "flash_attention")
            flash_attention.launches += 1
    return (out if dk == d else out[..., :d].contiguous()), lse


def _launch_counted(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _launch(q, k, v, stats=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention and its fp32 [B, S] row statistics (log2 units). CUDA
    tensors launch the forward kernel with its statistics written (one count a
    launch, as :func:`flash_attention`); CPU tensors take
    :func:`flash_attention_plain` and :func:`flash_attention_lse_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v), flash_attention_lse_plain(q, k, v)
    return _launch(q, k, v, stats=True)


def widened_for_backward(q, k, v, o, do):
    """q, k, v, the output o and its gradient do at the kernel width of
    :func:`widened`: q, k, v as the forward widened them, o and do with zero
    columns appended (the widened forward's output has zeros there)."""
    d = q.shape[-1]
    width = _kernel_width(d)
    if width == d:
        return q, k, v, o, do
    return (*widened(q, k, v), *(F.pad(t, (0, width - d)) for t in (o, do)))


def narrowed_gradients(dq, dk, dv, d: int):
    """The gradients of the inputs of width ``d`` from those of their widened
    copies: the pad columns dropped, and dq times √(width/d) where
    :func:`widened` scaled q by it (the chain rule of q_w = q·√(width/d))."""
    width = dq.shape[-1]
    if width == d:
        return dq, dk, dv
    if d <= KERNEL_HEAD_DIMS[-1]:
        dq = (dq[..., :d].float() * (width / d) ** 0.5).to(dq.dtype)
    return tuple(t[..., :d].contiguous() for t in (dq, dk, dv))


def route_takes(route: str, dtype: torch.dtype, d: int) -> bool:
    """Whether the backward kernels of ``route`` take a call of head width ``d`` in
    ``dtype`` (at the kernel width :func:`_kernel_width` widens it to): the wgmma
    kernels bf16 at :data:`WGMMA_BACKWARD_WIDTHS`, the cluster kernels bf16 at
    :data:`CLUSTER_BACKWARD_WIDTHS`, the mma.sync kernels bf16 at any width, the
    FMA kernels fp32."""
    width = _kernel_width(d)
    return {"wgmma": dtype == torch.bfloat16 and width in WGMMA_BACKWARD_WIDTHS,
            "cluster": dtype == torch.bfloat16 and width in CLUSTER_BACKWARD_WIDTHS,
            "mma": dtype == torch.bfloat16,
            "fma": dtype == torch.float32}.get(route, False)


def _launch_backward(q, k, v, o, lse, do, route: str | None = None):
    _check_operands("flash_attention_backward", q, k, v, o, do)
    b, s, d = q.shape
    if lse.shape != (b, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_backward: lse must be contiguous fp32 [B, S], got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if route is None:
        route = backward_kernels(q.dtype, d)
    elif not route_takes(route, q.dtype, d):
        raise ValueError(f"flash_attention_backward: the {route} kernels do not take "
                         f"{q.dtype} at D = {d}")
    if b == 0 or s == 0 or d == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q, k, v, o, do = widened_for_backward(q, k, v, o, do)
    width = q.shape[-1]
    # Up to the widest kernel width the kernels scale by 1/√width (q was scaled for
    # it); above, by the true D's, as the D-split forward does.
    scale_d = d if width > KERNEL_HEAD_DIMS[-1] else width
    lib = _backward_library()
    stats, dkdv, dq_part = _BACKWARD_PARTS[route]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if stats == "stats_bf16":
            # Δ and a copy of lse, padded to the rows the kernels read.
            rows = lib.eovax_flash_attention_bwd_stats_rows(s)
            delta, lse_p = (torch.empty((b, rows), device=q.device, dtype=torch.float32)
                            for _ in range(2))
            _backward_launch(lib, stats, o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), lse_p.data_ptr(), b, s, rows, width, stream)
            lse, extra = lse_p, (rows,)
        else:
            rows, extra = s, ()
            delta = torch.empty((b, s), device=q.device, dtype=torch.float32)
            _backward_launch(lib, stats, o.data_ptr(), do.data_ptr(), delta.data_ptr(), b * s,
                             width, stream)
        row = s * width * q.element_size()  # bytes of one batch row
        for b0 in range(0, b, grid.GRID_LIMIT):
            at, st = b0 * row, b0 * rows * 4
            common = (q.data_ptr() + at, k.data_ptr() + at, v.data_ptr() + at,
                      do.data_ptr() + at, lse.data_ptr() + st, delta.data_ptr() + st)
            shape = (min(grid.GRID_LIMIT, b - b0), s, *extra, width, scale_d, stream)
            _backward_launch(lib, dkdv, *common, dk.data_ptr() + at, dv.data_ptr() + at, *shape)
            _backward_launch(lib, dq_part, *common, dq.data_ptr() + at, *shape)
    return narrowed_gradients(dq, dk, dv, d)


def flash_attention_backward_from_stats(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
        do: torch.Tensor, route: str | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q kᵀ / √D) v for the output gradient ``do``, from
    the forward's output ``o`` and row statistics ``lse``
    (:func:`flash_attention_with_lse`). CUDA tensors launch the backward kernels,
    three a call (Δ, dK/dV, dQ; two more for each further 65535 batch rows), each
    adding one to ``flash_attention_backward.launches`` and, under its C entry
    (:data:`_BACKWARD_PARTS`), to ``flash_attention_backward.kernels``; CPU tensors
    take :func:`flash_attention_backward_from_stats_plain`. ``route`` names the
    kernels to launch where it is not :func:`backward_kernels`' choice (another
    route that takes the width, :func:`route_takes`, to compare the two on the
    card); the CPU ignores it."""
    if q.device.type == "cpu":
        return flash_attention_backward_from_stats_plain(q, k, v, o, lse, do)
    return _launch_backward(q, k, v, o, lse, do.to(q.dtype).contiguous(), route)


@torch.library.custom_op("eovax::flash_attention", mutates_args=(), device_types="cpu")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return flash_attention_plain(q, k, v)


_flash_attention_op.register_kernel("cuda")(_launch_counted)


@_flash_attention_op.register_fake
def _(q, k, v):
    return torch.empty_like(q)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if ops.through_op():
        return _flash_attention_op(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    return _launch_counted(q, k, v)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v)
        out, lse = _launch(q, k, v, stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        if len(saved) == 3:  # the CPU's forward
            return flash_attention_backward(*saved, do)
        return flash_attention_backward_from_stats(*saved, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √D) v for single-head [B, S, D] tensors.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (and add one to ``flash_attention.launches`` a launch) or raise. Where grad
    is enabled and an input requires it, the output carries a backward: on a CUDA
    tensor :func:`flash_attention_backward_from_stats` (the backward kernels, from
    the row statistics the forward launch wrote), on a CPU tensor
    :func:`flash_attention_backward`.
    """
    if (torch.is_grad_enabled() and not torch.compiler.is_exporting()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashAttention.apply(q, k, v)
    return _forward(q, k, v)


flash_attention.launches = 0
flash_attention_backward.calls = 0
flash_attention_backward.launches = 0
flash_attention_backward.kernels = {}

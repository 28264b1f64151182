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
``torch.autograd.Function`` whose backward, :func:`flash_attention_backward`,
recomputes the fp32 probabilities from the saved q, k and v in tensor ops: the
JAX trainer's gradient is autodiff of ``sdpa_auto``'s plain einsum, outside any
Pallas kernel, and this is that gradient.

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
KERNEL_HEAD_DIMS = (64, 128, 256, 512)
# D above the widest kernel width goes to the D-split kernel, padded to this.
_SPLIT_ALIGN = 64
_ENTRY = {torch.bfloat16: "eovax_flash_attention_bf16", torch.float32: "eovax_flash_attention_f32"}
_SPLIT_ENTRY = {torch.bfloat16: "eovax_flash_attention_split_bf16",
                torch.float32: "eovax_flash_attention_split_f32"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √D) v in fp32, cast to ``q.dtype``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(logits, dim=-1), v.float()).to(q.dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _SPLIT_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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


def _launch_counted(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q, k, v must share one [B, S, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes must all be bfloat16 or float32, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, s, d = q.shape
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if b == 0 or s == 0 or d == 0:
        return torch.empty_like(q)
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
                min(grid.GRID_LIMIT, b - b0), s, dk, *extra, stream
            )
            build.check(lib, code, "flash_attention")
            flash_attention.launches += 1
    return out if dk == d else out[..., :d].contiguous()


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
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return flash_attention_backward(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √D) v for single-head [B, S, D] tensors.

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (and add one to ``flash_attention.launches`` a launch) or raise. Where grad
    is enabled and an input requires it, the output carries the backward of
    :func:`flash_attention_backward`.
    """
    if (torch.is_grad_enabled() and not torch.compiler.is_exporting()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashAttention.apply(q, k, v)
    return _forward(q, k, v)


flash_attention.launches = 0
flash_attention_backward.calls = 0

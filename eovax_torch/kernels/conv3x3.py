"""3×3 stride-1 SAME convolution with bias over NCHW tensors, and its gradient.

Port of ``eovax/kernels/conv3x3.py``. On a CUDA tensor :func:`conv3x3`
launches the hand-written Hopper kernel of ``csrc/conv3x3.cu``: an implicit
GEMM on ``wgmma`` for the bf16 inference policy, a plain FMA kernel
for fp32 (``FULL_PRECISION``). On a CPU tensor it computes
:func:`conv3x3_plain`, the plain PyTorch version of the same function.

Where one launch cannot take the shape as it is (:func:`in_kernel_envelope`)
the wrapper widens it for the kernel: bf16 input channels are zero-padded to a
multiple of :data:`KERNEL_CI_MULTIPLE` (x and the weights alike, so the
products do not change), and a plane or batch past the kernel's grid runs as
several launches (:mod:`eovax_torch.kernels.grid`), each adding one to the
count. The JAX package gives such shapes to XLA's conv; here the hand kernel
computes them. A conv with an empty output launches nothing.

The products accumulate in fp32; the bias, in the input's dtype, is added in
fp32 before the one rounding to the input's dtype, as in the TPU kernel.

When an input requires grad, :func:`conv3x3` is a ``torch.autograd.Function``
whose backward is the JAX package's ``_bwd``: the data gradient through the
same kernel on the flipped, in/out-transposed weights without bias
(:func:`conv3x3_dx`), the weight gradient as the library's conv weight
gradient in the compute dtype (the JAX package leaves it to XLA), and the bias
gradient as Σg in fp32; each is cast to its input's dtype.

The forward is also the custom op ``eovax::conv3x3`` (:mod:`eovax_torch.kernels.ops`),
through which a ``torch.export`` trace reaches it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eovax_torch.kernels import build, grid, ops

SOURCE = "conv3x3.cu"
KERNEL_CI_MULTIPLE = 16  # the bf16 kernel's K chunk
_ENTRY = {torch.bfloat16: "eovax_conv3x3_bf16", torch.float32: "eovax_conv3x3_f32"}
_PIXEL_TILE = {torch.bfloat16: (4, 64), torch.float32: (8, 32)}  # rows × columns per block


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The nine tap products of NCHW ``x`` and OIHW ``w`` (cast to ``x.dtype``)
    summed in fp32, plus the bias (if any) in ``x.dtype``, rounded to ``x.dtype``."""
    h, wd = x.shape[2:]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = torch.einsum("oi,bihw->bohw", wf[:, :, dy, dx], xp[:, :, dy:dy + h, dx:dx + wd])
            acc = tap if acc is None else acc + tap
    if bias is not None:
        acc = acc + bias.to(x.dtype).float()[None, :, None, None]
    return acc.to(x.dtype)


def in_kernel_envelope(x_shape, co: int, dtype: torch.dtype) -> bool:
    """Whether one launch takes a conv of NCHW ``x_shape`` to ``co`` output channels
    in ``dtype`` as it is: bf16 input channels a multiple of
    :data:`KERNEL_CI_MULTIPLE`, a non-empty input and output, and a grid of at
    most 65535 pixel tiles and 65535 batch rows (``csrc/conv3x3.cu``
    ``grid_fits``). Outside it the wrapper pads the channels or launches in pieces."""
    if dtype not in _PIXEL_TILE:
        return False
    b, ci, h, w = x_shape
    if dtype == torch.bfloat16 and ci % KERNEL_CI_MULTIPLE:
        return False
    return min(b, ci, h, w, co) > 0 and grid.fits(b, h, w, _PIXEL_TILE[dtype])


def flipped(w: torch.Tensor) -> torch.Tensor:
    """OIHW weights of the data gradient: taps flipped, in and out swapped."""
    return w.flip(2, 3).transpose(0, 1)


def conv3x3_dx_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Data gradient of :func:`conv3x3` for the output gradient ``g``."""
    return conv3x3_plain(g, flipped(w), None)


def _weight_grad(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1).to(w.dtype)


def conv3x3_backward_plain(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) of :func:`conv3x3` in plain PyTorch."""
    g = g.to(x.dtype)
    return conv3x3_dx_plain(g, w), _weight_grad(x, w, g), g.float().sum((0, 2, 3)).to(bias.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, what: str) -> None:
    """Raise ValueError unless these are operands of the conv on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"{what}: dtype must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"{what}: x [B, Ci, H, W] and w [Co, Ci, 3, 3] expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    co = w.shape[0]
    if bias is not None and bias.shape != (co,):
        raise ValueError(f"{what}: bias must be [{co}], got {tuple(bias.shape)}")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"{what}: x, w and bias must be on one device")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def _weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW ``w`` as the kernel reads it, in ``dtype``: bf16 as [tap_y, tap_x, Ci/8,
    Co, 8] (16-byte rows of 8 input channels, the layout of its shared memory),
    fp32 as [tap_y, tap_x, Co, Ci]. One copy kernel either way."""
    co, ci = w.shape[:2]
    if dtype == torch.bfloat16:
        wt = torch.empty((3, 3, ci // 8, co, 8), dtype=dtype, device=w.device)
        wt.copy_(w.reshape(co, ci // 8, 8, 3, 3).permute(3, 4, 1, 0, 2))
    else:
        wt = torch.empty((3, 3, co, ci), dtype=dtype, device=w.device)
        wt.copy_(w.permute(2, 3, 0, 1))
    return wt


def _launch(x: torch.Tensor, wt: torch.Tensor, bias: torch.Tensor | None, co: int,
            what: str) -> torch.Tensor:
    """One launch on contiguous ``x`` inside the grid, weights from :func:`_weights`
    (no count)."""
    b, ci, h, wd = x.shape
    out = torch.empty((b, co, h, wd), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        code = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), wt.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, ci, co, h, wd, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, code, what)
    return out


def _run(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, counted) -> torch.Tensor:
    """The conv of checked operands on the kernel, widened where
    :func:`in_kernel_envelope` says so, each launch counted on ``counted``
    (``conv3x3`` or ``conv3x3_dx``)."""
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if min(b, h, wd, co) == 0:
        return x.new_empty((b, co, h, wd))
    if not in_kernel_envelope(x.shape, co, x.dtype):
        multiple = KERNEL_CI_MULTIPLE if x.dtype == torch.bfloat16 else 1
        pad = -ci % multiple if ci else multiple
        if pad:  # zero channels: the products do not change
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            w = F.pad(w, (0, 0, 0, 0, 0, pad))
    wt = _weights(w, x.dtype)
    if bias is not None:
        bias = bias.to(x.dtype).contiguous()

    def launch(piece):
        out = _launch(piece, wt, bias, co, counted.__name__)
        counted.launches += 1
        return out

    return grid.in_pieces(x, co, _PIXEL_TILE[x.dtype], launch)


def _dispatch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, counted) -> torch.Tensor:
    _check(x, w, bias, counted.__name__)
    return _run(x, w, bias, counted)


def _launch_counted(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return _dispatch(x, w, bias, conv3x3)


@torch.library.custom_op("eovax::conv3x3", mutates_args=(), device_types="cpu")
def _conv3x3_op(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return conv3x3_plain(x, w, bias)


_conv3x3_op.register_kernel("cuda")(_launch_counted)


@_conv3x3_op.register_fake
def _(x, w, bias):
    return x.new_empty((x.shape[0], w.shape[0], x.shape[2], x.shape[3]))


def _forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    if ops.through_op():
        return _conv3x3_op(x, w, bias)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias)
    return _launch_counted(x, w, bias)


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Data gradient of :func:`conv3x3` for the contiguous output gradient
    ``g`` [B, Co, H, W]: the conv of ``g`` with :func:`flipped` ``w`` and no bias.

    CPU tensors take :func:`conv3x3_dx_plain`; CUDA tensors launch the conv3x3
    kernel (and add one to ``conv3x3_dx.launches`` a launch).
    """
    if g.device.type == "cpu":
        return conv3x3_dx_plain(g, w)
    return _dispatch(g, flipped(w), None, conv3x3_dx)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad
        return (conv3x3_dx(g, w) if need_x else None,
                _weight_grad(x, w, g) if need_w else None,
                g.float().sum((0, 2, 3)).to(ctx.bias_dtype) if need_b else None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NCHW ``x`` with OIHW ``w`` and bias [Co].

    CPU tensors take :func:`conv3x3_plain`; CUDA tensors launch the kernel
    (and add one to ``conv3x3.launches`` a launch) or raise. Where grad is
    enabled and an input requires it, the output carries the backward described above.
    """
    if (torch.is_grad_enabled() and not torch.compiler.is_exporting()
            and (x.requires_grad or w.requires_grad or bias.requires_grad)):
        return _Conv3x3.apply(x, w, bias)
    return _forward(x, w, bias)


conv3x3.launches = 0
conv3x3_dx.launches = 0

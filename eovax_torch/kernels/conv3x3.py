"""3×3 stride-1 SAME convolution with bias over NCHW tensors.

Port of ``eovax/kernels/conv3x3.py``. On a CUDA tensor :func:`conv3x3`
launches the hand-written Hopper kernel of ``csrc/conv3x3.cu``: an implicit
GEMM on ``wgmma`` for the bf16 inference policy, a plain FMA kernel
for fp32 (``FULL_PRECISION``). On a CPU tensor it computes
:func:`conv3x3_plain`, the plain PyTorch version of the same function. It
never falls back from the kernel, and it raises on shapes outside the
kernel's envelope (bf16: input channels a multiple of :data:`KERNEL_CI_MULTIPLE`).

The products accumulate in fp32; the bias, in the input's dtype, is added in
fp32 before the one rounding to the input's dtype, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eovax_torch.kernels import build

SOURCE = "conv3x3.cu"
KERNEL_CI_MULTIPLE = 16  # the bf16 kernel's K chunk
_ENTRY = {torch.bfloat16: "eovax_conv3x3_bf16", torch.float32: "eovax_conv3x3_f32"}
_PIXEL_TILE = {torch.bfloat16: (4, 64), torch.float32: (8, 32)}  # rows × columns per block


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The nine tap products of NCHW ``x`` and OIHW ``w`` (cast to ``x.dtype``)
    summed in fp32, plus the bias in ``x.dtype``, rounded to ``x.dtype``."""
    h, wd = x.shape[2:]
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = torch.einsum("oi,bihw->bohw", wf[:, :, dy, dx], xp[:, :, dy:dy + h, dx:dx + wd])
            acc = tap if acc is None else acc + tap
    return (acc + bias.to(x.dtype).float()[None, :, None, None]).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NCHW ``x`` with OIHW ``w`` and bias [Co].

    CPU tensors take :func:`conv3x3_plain`; CUDA tensors launch the kernel
    (and add one to ``conv3x3.launches``) or raise.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"conv3x3: dtype must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3: x [B, Ci, H, W] and w [Co, Ci, 3, 3] expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if bias.shape != (co,):
        raise ValueError(f"conv3x3: bias must be [{co}], got {tuple(bias.shape)}")
    if w.device != x.device or bias.device != x.device:
        raise ValueError("conv3x3: x, w and bias must be on one device")
    if not x.is_contiguous():
        raise ValueError("conv3x3: x must be contiguous")
    if x.dtype == torch.bfloat16 and ci % KERNEL_CI_MULTIPLE:
        raise ValueError(f"conv3x3: bf16 kernel needs Ci a multiple of {KERNEL_CI_MULTIPLE}, "
                         f"got Ci={ci}")
    th, tw = _PIXEL_TILE[x.dtype]
    if x.numel() == 0 or co == 0 or -(-h // th) * -(-wd // tw) > 65535 or b > 65535:
        raise ValueError(f"conv3x3: shape {tuple(x.shape)} is outside the kernel's grid")
    # The kernel reads the weights in x's dtype, bf16 as [tap_y, tap_x, Ci/8, Co, 8]
    # (16-byte rows of 8 input channels, the layout of its shared memory), fp32
    # as [tap_y, tap_x, Co, Ci]. One copy kernel either way.
    if x.dtype == torch.bfloat16:
        wt = torch.empty((3, 3, ci // 8, co, 8), dtype=x.dtype, device=x.device)
        wt.copy_(w.reshape(co, ci // 8, 8, 3, 3).permute(3, 4, 1, 0, 2))
    else:
        wt = torch.empty((3, 3, co, ci), dtype=x.dtype, device=x.device)
        wt.copy_(w.permute(2, 3, 0, 1))
    bias = bias.to(x.dtype).contiguous()
    out = torch.empty((b, co, h, wd), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        code = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(), b, ci, co, h, wd,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, code, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0

"""GroupNorm over NCHW tensors: fp32 statistics, then one fused apply.

Port of ``eovax/kernels/groupnorm.py``. On a CUDA tensor :func:`group_norm`
launches the two hand-written Hopper kernels of ``csrc/groupnorm.cu``: the
statistics pass and the apply pass, which also takes the ResnetBlock's AdaIN
scale and shift and its SiLU, so that a norm → AdaIN → swish sequence reads
its input twice and writes its output once. :func:`gn_channel_sums` keeps
the TPU kernel's contract (per-(B, C) fp32 Σx and Σx²) on top of the same
statistics kernel. On a CPU tensor each function computes its plain PyTorch
version. Neither falls back from the kernel.

Both kernels take bf16 (the inference policy) and fp32 (``FULL_PRECISION``);
statistics and arithmetic are fp32, and the output has the input's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from eovax_torch.kernels import build

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


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-6, *, ada_scale: torch.Tensor | None = None,
                     ada_shift: torch.Tensor | None = None, swish: bool = False) -> torch.Tensor:
    """Two-pass fp32 GroupNorm, affine, optional AdaIN (y·s + t) and SiLU,
    rounded once to ``x.dtype``."""
    b = x.shape[0]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * _per_channel(weight) + _per_channel(bias)
    if ada_scale is not None:
        y = y * _per_channel(ada_scale) + _per_channel(ada_shift)
    if swish:
        y = F.silu(y)
    return y.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for suffix in _SUFFIX.values():
        stats = getattr(lib, f"eovax_gn_stats_{suffix}")
        stats.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
        stats.restype = ctypes.c_int
        apply = getattr(lib, f"eovax_gn_apply_{suffix}")
        apply.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                          + [ctypes.c_long, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        apply.restype = ctypes.c_int
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


def _channel_stats(lib: ctypes.CDLL, x: torch.Tensor, what: str) -> torch.Tensor:
    """Launch the statistics kernel: fp32 [2, B·C] of (mean, M2) per plane."""
    b, c, h, w = x.shape
    stats = torch.empty(2, b * c, device=x.device, dtype=torch.float32)
    code = getattr(lib, f"eovax_gn_stats_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), b * c, h * w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, code, what)
    return stats


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
    with torch.cuda.device(x.device):
        mean, m2 = _channel_stats(_library(), x, "gn_channel_sums").view(2, b, c)
    gn_channel_sums.launches += 1
    n = float(h * w)
    return mean * n, m2 + mean * mean * n


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int = 32,
               eps: float = 1e-6, *, ada_scale: torch.Tensor | None = None,
               ada_shift: torch.Tensor | None = None, swish: bool = False) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` with fp32 statistics, then ``weight``/``bias``,
    the optional AdaIN ``y·ada_scale + ada_shift`` ([C] shared or [B, C]) and
    the optional SiLU; the output has ``x.dtype``.

    CPU tensors take :func:`group_norm_plain`; CUDA tensors launch the
    statistics and apply kernels (and add one to ``group_norm.launches``) or
    raise.
    """
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, ada_scale=ada_scale,
                                ada_shift=ada_shift, swish=swish)
    _check_input(x, "group_norm")
    b, c, h, w = x.shape
    if x.numel() == 0 or c % groups:
        raise ValueError(f"group_norm: {tuple(x.shape)} with {groups} groups")
    params = [weight, bias]
    if (ada_scale is None) != (ada_shift is None):
        raise ValueError("group_norm: ada_scale and ada_shift go together")
    ada_stride = 0
    if ada_scale is not None:
        if ada_scale.shape != ada_shift.shape or ada_scale.shape not in ((c,), (b, c)):
            raise ValueError(f"group_norm: AdaIN scale/shift must be [{c}] or [{b}, {c}], got "
                             f"{tuple(ada_scale.shape)}, {tuple(ada_shift.shape)}")
        ada_stride = 0 if ada_scale.dim() == 1 else c
        params += [ada_scale, ada_shift]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm: weight and bias must be [{c}]")
    if any(p.device != x.device for p in params):
        raise ValueError("group_norm: parameters must be on the input's device")
    weight, bias, *ada = [p.float().contiguous() for p in params]
    scale_ptr, shift_ptr = (ada[0].data_ptr(), ada[1].data_ptr()) if ada else (None, None)
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        mean, m2 = _channel_stats(lib, x, "group_norm")
        code = getattr(lib, f"eovax_gn_apply_{_SUFFIX[x.dtype]}")(
            x.data_ptr(), out.data_ptr(), mean.data_ptr(), m2.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), scale_ptr, shift_ptr, ada_stride, b, c, groups, h * w, eps,
            int(swish), torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, code, "group_norm")
    group_norm.launches += 1
    return out


gn_channel_sums.launches = 0
group_norm.launches = 0

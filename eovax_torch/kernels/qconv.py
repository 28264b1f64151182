"""int8 (W8A8) 3×3 stride-1 SAME conv over NCHW tensors, for inference serving.

Port of ``eovax/kernels/qconv.py`` (an XLA int8 conv with int32 accumulation
there; PyTorch has no int8 convolution on CUDA, so here it is the hand-written
Hopper kernel of ``csrc/conv3x3_int8.cu``). It quantizes the ResnetBlock and
SR UNet 3×3 convs:

- activations: per-tensor symmetric → int8, from the dynamic abs-max of the
  input (a torch reduction, no host sync) or from a static ``act_scale``
  that a percentile calibration pass recorded (:func:`abs_percentile`,
  :func:`act_scales_from_calibration`); outliers then saturate at ±127;
- weights: per-output-channel symmetric abs-max → int8, either on the fly
  (:func:`int8_conv3x3`, fp32 weights) or once at export
  (:func:`quantize_state_int8`, :func:`int8_conv3x3_prequant`);
- the products summed in int32, rescaled by ``s_x · s_w[co]`` in fp32, the
  fp32 bias added, one rounding to the compute dtype.

With ``sx = max(amax, 1e-12) / 127`` the kernel computes

    out[b, co, p] = dtype(float(Σ_tap Σ_ci xq · wq) · (sx · w_scale[co]) + bias[co])
    xq = clip(round_half_even(float(x) / sx), −127, 127)

in the order of the JAX package's operations, each rounded once as there;
:func:`conv3x3_int8_plain` computes the same in tensor ops (the int32 sum
exactly, in float64), so the two are equal bit for bit. On a CPU tensor
:func:`conv3x3_int8` computes the plain version; on a CUDA tensor it launches
the kernel (and adds one to ``conv3x3_int8.launches`` a launch). Where one
launch cannot take the shape as it is (:func:`in_kernel_envelope`) the wrapper
widens it for the kernel, as :mod:`eovax_torch.kernels.conv3x3` does: input
channels zero-padded to a multiple of :data:`KERNEL_CI_MULTIPLE` (a zero
quantizes to 0 at any range, and the padded weights are 0), and a plane or
batch past the grid in several launches (:mod:`eovax_torch.kernels.grid`); the
range ``amax`` is the whole tensor's either way. The forward is also
the custom op ``eovax::conv3x3_int8`` (:mod:`eovax_torch.kernels.ops`), through
which a ``torch.export`` trace reaches it.

Both entry points are inference-only: a gradient through them raises (the
round() has zero gradient), with the JAX package's message.
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch
import torch.nn.functional as F

from eovax_torch.kernels import build, grid, ops

SOURCE = "conv3x3_int8.cu"
KERNEL_CI_MULTIPLE = 32  # the kernel's K chunk: one wgmma k32 step a tap
_ENTRY = {torch.bfloat16: "eovax_conv3x3_int8_bf16", torch.float32: "eovax_conv3x3_int8_f32"}
_PIXEL_TILE = (4, 64)  # output rows × columns per block

_INFERENCE_ONLY = (
    "int8_conv3x3 is inference-only: gradients through the round() "
    "quantization are zero. Train with the 'direct' conv algorithm "
    "(DEFAULT_POLICY / '16-mixed') and switch to INT8_POLICY for "
    "serving/export."
)


def quant_step(amax: torch.Tensor) -> torch.Tensor:
    """The quantization step ``max(amax, 1e-12) / 127`` in fp32, by IEEE division
    on every device (CUDA divides by a Python scalar as a reciprocal multiply)."""
    a = torch.clamp_min(amax.float(), 1e-12)
    return a / torch.full_like(a, 127.0)


def quantize_symmetric(x: torch.Tensor, dim=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max int8 quantization over ``dim`` (all of ``x`` when None).
    Returns (q, scale) with ``x ≈ q · scale``; scale keeps the reduced dims."""
    xf = x.float()
    scale = quant_step(xf.abs().amax(dim=tuple(range(x.dim())) if dim is None else dim,
                                     keepdim=True))
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def should_use_int8(x_shape, kernel_shape, strides, compute_dtype) -> bool:
    """The envelope of the int8 dispatch (NCHW ``x_shape``, OIHW ``kernel_shape``):
    bf16 compute, a 3×3 stride-1 conv, and at least 128 input and output
    channels; stems, 1×1 and strided convs stay bf16."""
    if compute_dtype != torch.bfloat16:
        return False
    if tuple(kernel_shape[2:]) != (3, 3) or tuple(strides) != (1, 1):
        return False
    return min(x_shape[1], kernel_shape[0]) >= 128


def conv3x3_int8_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                       bias: torch.Tensor | None, amax: torch.Tensor) -> torch.Tensor:
    """The kernel's function in tensor ops: NCHW ``x`` quantized with the per-tensor
    range ``amax``, OIHW int8 ``wq`` with fp32 per-channel scales ``w_scale``, the
    int32 sum exact (float64), fp32 rescale and bias, one rounding to ``x.dtype``."""
    sx = quant_step(amax)
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127)
    acc = F.conv2d(xq.double(), wq.double(), padding=1)
    out = acc.float() * (sx * w_scale.float())[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def in_kernel_envelope(x_shape, co: int) -> bool:
    """Whether one launch takes a conv of NCHW ``x_shape`` to ``co`` output channels
    as it is: input channels a multiple of :data:`KERNEL_CI_MULTIPLE`, a non-empty
    input and output, and a grid of at most 65535 (4, 64) pixel tiles and 65535
    batch rows. Outside it the wrapper pads the channels or launches in pieces."""
    b, ci, h, w = x_shape
    return (ci % KERNEL_CI_MULTIPLE == 0 and min(b, ci, h, w, co) > 0
            and grid.fits(b, h, w, _PIXEL_TILE))


def check_operands(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                   bias: torch.Tensor | None, amax: torch.Tensor) -> None:
    """Raise ValueError unless these are operands of the conv (on any device);
    the shape's envelope is :func:`in_kernel_envelope`'s."""
    what = "conv3x3_int8"
    if x.dtype not in _ENTRY:
        raise ValueError(f"{what}: x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or wq.dim() != 4 or wq.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"{what}: x [B, Ci, H, W] and wq [Co, Ci, 3, 3] expected, got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}")
    co = wq.shape[0]
    if wq.dtype != torch.int8:
        raise ValueError(f"{what}: wq must be int8, got {wq.dtype}")
    if w_scale.dtype != torch.float32 or w_scale.shape != (co,):
        raise ValueError(f"{what}: w_scale must be float32 [{co}], got {w_scale.dtype} "
                         f"{tuple(w_scale.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (co,)):
        raise ValueError(f"{what}: bias must be float32 [{co}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if amax.dtype != torch.float32 or amax.numel() != 1:
        raise ValueError(f"{what}: amax must be one float32, got {amax.dtype} "
                         f"{tuple(amax.shape)}")
    tensors = [t for t in (wq, w_scale, bias, amax) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{what}: every operand must be on one device")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")


def int8_weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 ``wq`` [Co, Ci, 3, 3] as the kernel reads it, contiguous
    ``[3, 3, Ci/16, Co, 16]``: element (co, ci, ky, kx) at byte
    ``((ky·3 + kx)·(Ci/16) + ci/16)·Co·16 + co·16 + ci % 16``. A (tap, 16-channel
    group) is then Co·16 contiguous bytes, one 16-byte row an output channel: the
    rows of the kernel's shared-memory core matrices. One copy."""
    co, ci = wq.shape[:2]
    wt = torch.empty((3, 3, ci // 16, co, 16), dtype=wq.dtype, device=wq.device)
    wt.copy_(wq.reshape(co, ci // 16, 16, 3, 3).permute(3, 4, 1, 0, 2))
    return wt


def _launch(x: torch.Tensor, wt: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor | None, amax: torch.Tensor, co: int) -> torch.Tensor:
    """One launch on contiguous ``x`` inside the grid, weights from
    :func:`int8_weight_layout` (adds one to ``conv3x3_int8.launches``)."""
    b, ci, h, wd = x.shape
    out = torch.empty((b, co, h, wd), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        code = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), wt.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), amax.data_ptr(), out.data_ptr(),
            b, ci, co, h, wd, torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, code, "conv3x3_int8")
    conv3x3_int8.launches += 1
    return out


def _run(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
         bias: torch.Tensor | None, amax: torch.Tensor) -> torch.Tensor:
    """The conv of checked operands on the kernel, widened where
    :func:`in_kernel_envelope` says so."""
    b, ci, h, wd = x.shape
    co = wq.shape[0]
    if min(b, h, wd, co) == 0:
        return x.new_empty((b, co, h, wd))
    if not in_kernel_envelope(x.shape, co):
        pad = -ci % KERNEL_CI_MULTIPLE if ci else KERNEL_CI_MULTIPLE
        if pad:  # zero channels and zero weights: the int32 sums do not change
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            wq = F.pad(wq, (0, 0, 0, 0, 0, pad))
    wt = int8_weight_layout(wq)
    w_scale, amax = w_scale.contiguous(), amax.contiguous()
    bias = None if bias is None else bias.contiguous()
    return grid.in_pieces(x, co, _PIXEL_TILE,
                          lambda piece: _launch(piece, wt, w_scale, bias, amax, co))


def _launch_counted(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: torch.Tensor | None, amax: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_int8: unsupported device {x.device}")
    check_operands(x, wq, w_scale, bias, amax)
    return _run(x, wq, w_scale, bias, amax)


@torch.library.custom_op("eovax::conv3x3_int8", mutates_args=(), device_types="cpu")
def _conv3x3_int8_op(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor | None, amax: torch.Tensor) -> torch.Tensor:
    return conv3x3_int8_plain(x, wq, w_scale, bias, amax)


_conv3x3_int8_op.register_kernel("cuda")(_launch_counted)


@_conv3x3_int8_op.register_fake
def _(x, wq, w_scale, bias, amax):
    return x.new_empty((x.shape[0], wq.shape[0], x.shape[2], x.shape[3]))


def conv3x3_int8(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor | None, amax: torch.Tensor) -> torch.Tensor:
    """The kernel's function (see the module's docstring): CPU tensors take
    :func:`conv3x3_int8_plain`; CUDA tensors launch the kernel or raise."""
    if ops.through_op():
        return _conv3x3_int8_op(x, wq, w_scale, bias, amax)
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, wq, w_scale, bias, amax)
    return _launch_counted(x, wq, w_scale, bias, amax)


conv3x3_int8.launches = 0


class _InferenceOnly(torch.autograd.Function):
    """``fn(*args)`` whose backward raises."""

    @staticmethod
    def forward(ctx, fn, *args):
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_INFERENCE_ONLY)


def _inference_only(fn, *args) -> torch.Tensor:
    if (torch.is_grad_enabled() and not torch.compiler.is_exporting()
            and any(torch.is_tensor(a) and a.requires_grad for a in args)):
        return _InferenceOnly.apply(fn, *args)
    return fn(*args)


def _prequant(x, wq, w_scale, bias, amax, compute_dtype):
    # Dynamic range: max |x| of the whole tensor (exact in x's dtype, no copy).
    amax = (torch.linalg.vector_norm(x, float("inf")).float() if amax is None
            else amax.float().reshape(()))
    # The kernel rounds once to its input's dtype: a bf16 input with fp32 compute
    # runs in fp32 (the upcast is exact); an fp32 input with bf16 compute runs in
    # fp32 and is rounded after, the JAX package's one rounding of the fp32 sum.
    xk = x if x.dtype == compute_dtype else x.float()
    out = conv3x3_int8(xk, wq, w_scale.float().reshape(-1),
                       None if bias is None else bias.float(), amax)
    return out.to(compute_dtype)


def _on_the_fly(x, w, bias, compute_dtype):
    wq, sw = quantize_symmetric(w, dim=(1, 2, 3))  # per output channel
    return _prequant(x, wq, sw.reshape(-1), bias, None, compute_dtype)


def int8_conv3x3(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None, *,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NCHW ``x`` with OIHW float ``w``, quantized on the
    fly: per-tensor dynamic activations, per-output-channel weights (every call).
    Inference-only: a gradient through it raises."""
    return _inference_only(lambda a, k, c: _on_the_fly(a, k, c, compute_dtype), x, w, bias)


def int8_conv3x3_prequant(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                          bias: torch.Tensor | None, *, act_scale: torch.Tensor | None = None,
                          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3×3 stride-1 SAME conv with export-time int8 weights: OIHW int8 ``wq`` and
    fp32 ``w_scale`` [Co] (:func:`quantize_state_int8`). The activations use the
    calibrated range ``act_scale`` (an amax) when given, else the dynamic abs-max.
    Inference-only: a gradient through it raises."""
    if wq.dtype != torch.int8:
        raise ValueError(f"prequant conv expects int8 weights, got {wq.dtype}")
    return _inference_only(
        lambda a, s, c, r: _prequant(a, wq, s, c, r, compute_dtype), x, w_scale, bias, act_scale)


# ---------------------------------------------------------------------------
# Weights quantized once (export) and calibrated activations
# ---------------------------------------------------------------------------

#: The state keys whose convs go through :class:`eovax_torch.nn.blocks.Conv3x3`'s
#: int8 dispatch: ``conv1``/``conv2`` of a ResnetBlock or an SR UNet TimeResBlock
#: (``down.i.block.j``, ``up.i.block.j``, ``mid.block_k``). Only these may hold
#: int8 weights: any other conv (down/upsample, stems, 1×1, the multi-stage
#: heads' plain convs) would read int8 as numbers, a silently wrong output.
_PREQUANT_WEIGHT = re.compile(
    r"(^|\.)((down|up)\.\d+\.block\.\d+|mid\.block_\d+)\.conv[12]\.weight$")


def _eligible(key: str, t: torch.Tensor) -> bool:
    """The export-time analogue of :func:`should_use_int8`: the conv's input
    channels are the weight's, so its shape decides; the name decides that the
    int8 dispatch reaches it (the stride-2 Downsample conv has a weight of the
    same shape). Float weights only: an int8 weight passes through untouched."""
    return (_PREQUANT_WEIGHT.search(key) is not None and t.dim() == 4
            and tuple(t.shape[2:]) == (3, 3) and min(t.shape[0], t.shape[1]) >= 128
            and t.is_floating_point())


def quantize_state_int8(state: dict, act_scales: dict | None = None) -> tuple[dict, int]:
    """Quantize the eligible body-conv weights of a state dict once (export).

    Each eligible ``<conv>.weight`` becomes its int8 per-output-channel
    quantization, with ``<conv>.kernel_scale`` (fp32 [Co]) beside it and, where
    ``act_scales`` (from :func:`act_scales_from_calibration`, keyed by module
    path) has the conv, ``<conv>.act_scale`` (fp32 [], the calibrated amax). A
    state that is already quantized passes through. Returns (state, n_quantized).
    """
    act_scales = act_scales or {}
    out, n = {}, 0
    for key, t in state.items():
        if not _eligible(key, t):
            out[key] = t
            continue
        conv = key[: -len(".weight")]
        wq, sw = quantize_symmetric(t, dim=(1, 2, 3))
        out[key] = wq
        out[f"{conv}.kernel_scale"] = sw.reshape(-1)
        if act_scales.get(conv) is not None:
            out[f"{conv}.act_scale"] = torch.tensor(act_scales[conv], dtype=torch.float32,
                                                    device=t.device)
        n += 1
    return out, n


def abs_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(|x|, q)`` (its default, linear interpolation between the
    order statistics at q/100·(n−1)) as a device scalar, with the JAX package's
    fp32 position and weights. The order statistics come from one ``topk`` of
    the largest values: ``torch.quantile`` refuses more than 2²⁴ elements."""
    a = x.detach().reshape(-1).float().abs()
    n = a.numel()
    f32 = np.float32
    pos = f32(f32(q) / f32(100.0)) * (f32(n) - f32(1.0))
    low, high = (int(min(max(v, 0.0), n - 1)) for v in (np.floor(pos), np.ceil(pos)))
    w_high = f32(pos - f32(np.floor(pos)))
    top = torch.topk(a, n - low).values  # descending: top[-1] is order statistic `low`
    lo_v, hi_v = top[-1], top[-1 - (high - low)]
    return lo_v * float(f32(1.0) - w_high) + hi_v * float(w_high)


def act_scales_from_calibration(records: list[dict]) -> dict[str, float]:
    """Reduce calibration records (one ``{conv path: [amax of each call]}`` a
    batch) to static activation ranges: the maximum over batches and calls."""
    out: dict[str, float] = {}
    for record in records:
        for key, vals in record.items():
            out[key] = max(out.get(key, 0.0), *(float(v) for v in vals))
    return out

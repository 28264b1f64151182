"""Drive the PyTorch port of the EO-VAE on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Report the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build every kernel of ``eovax_torch/kernels/csrc`` with
   ``nvcc`` (one compiler per source, all started at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, at odd shapes, in fp32, and on real activations of
   the main path captured with forward hooks:
   - ``flash_attention``: [4,4096,512], [16,1024,512], odd S, fp32, and the
     q/k/v of the encoder's ``mid.attn_1``; and a one-hot permutation case at
     [2,512,512] that must give V[π] exactly;
   - ``group_norm`` (affine; + swish; + AdaIN + swish with [C] and [B, C])
     and ``gn_channel_sums``: [4,128,512,512] and [4,512,64,64] bf16,
     [2,96,37,53] fp32, and the input of a decoder ResnetBlock ``norm2``;
   - ``conv3x3``: [4,128,512,512] 128→128, [4,512,256,256] 512→256 and
     [4,512,64,64] 512→512 bf16, [2,48,37,53] 48→96 bf16 (a width that is
     not a multiple of 8 or 64), [2,64,37,53] 64→96 fp32, and the input of
     the decoder's level-0 ``conv1``.
3. Drive the main path at full width: the shipped architecture (ch=128,
   ch_mult (1,2,4,4), 2 res blocks, z=32, wavelength stems with 4 layers
   and 256 planes), bf16 ``DEFAULT_POLICY``, weights N(0, 0.02) from a
   seed. Every kernel's launch count is set to 0 just before each call and
   must be exactly (conv3x3 / group_norm / flash_attention):
   - ``reconstruct`` [4,12,512,512] (12-band S2L2A): 48 / 52 / 2, and the
     same in fp32 (``FULL_PRECISION``) at [1,12,64,64];
   - ``encode_spatial_normalized`` [4,4,512,512] (Sen2NAIP bands):
     20 / 22 / 1; ``decode_spatial_normalized`` of its latent: 28 / 30 / 1;
   - ``eovax_torch.cli.encode_latents.encode_split`` on 2 synthetic
     collated batches of 4 Sen2NAIP pairs at 512²: 80 / 88 / 4;
   - ``eovax_torch.utils.tiling.tiled_reconstruct`` of a [12,1024,1024]
     scene, tile 256, overlap 32, 16 tiles a call: 96 / 104 / 4.
   The full-width model on a small input is held against the same weights
   on the CPU in fp32 and bf16.
4. Time ``reconstruct``, ``encode_split`` and each kernel with CUDA events
   after warm-up (kernel, plain version, the one PyTorch call computing the
   same function, and the card's bound), break one 512² ``reconstruct``
   down by kernel with ``torch.profiler``.
5. Train: the stage-2 generator step (``eovax_torch.train.stage2``) at full
   width, 12-band 256² B=16 bf16, Charbonnier + MS-SSIM (start step 0), Adam
   at the shipped base lr 1e-4 with the clip at 1.0 (the 2000-step warmup
   cut), the posterior's mode. The backward kernels against their plain versions at the main
   path's shapes, at odd shapes and in fp32, and on the activations and
   output gradients of one train step captured with hooks (``conv3x3_dx``:
   the decoder's level-0 ``conv1``; ``group_norm_backward``: the decoder's
   level-0 ``norm2``); ``group_norm_backward`` at each of the step's 8
   GroupNorm shapes, at two whose slices are streamed (bf16 [2,128,512,512],
   fp32 [2,256,256,256]) and at odd shapes, each with its cluster plan and
   ``cudaOccupancyMaxActiveClusters``, and two calls bit-identical; exact
   launches per step: forward 48 / 52 / 2 and
   backward 48 ``conv3x3_dx``, 52 ``group_norm_backward`` and 2 attention
   backward calls; all parameter gradients of the full model in train mode on
   the card (fp32 and bf16) against fp32 on the CPU at [1,12,64,64]; 2
   warm-up and 10 timed steps (CUDA events) on one fixed batch, whose loss
   must be finite and fall; ms/step, imgs/s, peak memory, the optimizer
   step's host time, the kernel rows of one profiled step (52 ``gn_bwd_``
   launches); the backward kernels' times beside their plain
   versions, library calls and bounds (``group_norm_backward`` at
   [16,128,256,256] and [16,256,256,256]). Then one ``{"kernels": [...]}`` line
   (flash_attention and conv3x3 also with their TFLOP/s at each timed shape;
   flash_attention with the bytes its blocks read from L2 and the rate they
   imply).
6. Trainer: ``Stage2Trainer`` at full width in bf16 (the shipped VAE
   settings, the posterior sampled, the warmup cut) over 6 synthetic batches
   (B=16, 256², S2L2A/S1RTC/S2RGB drawn from seed 0), a checkpoint and a
   validation (2 batches of 32 S2L2A) after steps 3 and 6: exact launches
   over the fit (per step 48 / 52 / 2 forward and 48 / 52 / 2 backward, per
   validation three forwards), the CSV rows and PNGs on disk, each save's
   blocking host copy and its write (waited for at once, so timed alone),
   the steps' device gaps, the validation time and the peak memory; a fresh
   trainer resumes at step 6 with the model and Adam's state ``torch.equal``
   to the first's and takes 2 steps; 4 steady steps before a save, 4 with its
   write in flight (and what was left of the write after them) and 4 after
   it, beside phase 5's bare step; a 4-step fit with ``accumulate_steps=2`` whose
   parameters move only at steps 2 and 4; the train CLI
   (``eovax_torch.cli.train.main``, ``--synthetic-data --max-steps 4``),
   whose ``eo-vae-final.pt`` must reconstruct a batch. Its files go to a
   temporary directory under ``build/``, removed at the end.
7. Data: the TerraMesh path into the trainer. A shard tree under
   ``build/chip_smoke_data_*`` (removed at the end), written with
   ``tests/_zarr_helpers.py`` under ``SPLIT_FILES`` names (one present shard
   per subset, split and modality; the other names missing): S2L2A int16 at
   256² (every other ssl4eos12 sample after the S2 baseline change, so
   harmonised and promoted to fp32), S1RTC float32 at 256², S2RGB uint8 at
   264² (resized by the collate). The first decode (it builds the native
   decoder), then the reader alone with 1 and 4 threads
   (samples/s, MB/s, each missing shard skipped with a warning), and its two
   stages apart: the tar read alone, and the decode alone in 1 and 4 threads;
   the train
   collate's ms a batch of each modality, host and ``device_prep``; the
   shipped datamodule block's first 4 train and 2 val batches (seed 7)
   built both ways, placed on the card by the trainer, ``torch.equal``; ``device_prepare`` on the card
   ``torch.equal`` to the CPU over the 16 D4 cases, and its time beside its
   bytes bound; ``eovax_torch.cli.train.main`` from the shards on the
   shipped config (``limit_train_batches: 3``, ``limit_val_batches: 1``,
   ``--max-steps 6 --seed 7``): exact launches (per step 48 / 52 / 2 forward and
   backward, per validation two forwards), the CSV, two checkpoints, two
   PNGs and ``eo-vae-final.pt``, finite losses, the steps' device gaps
   beside phase 6's synthetic step, the device's idle share over steps 4-6
   (profiled), the bytes copied per step and the peak memory.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with an error before any result.
"""

from __future__ import annotations

import concurrent.futures
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

# Tolerances, each relative to max |reference|.
#  Attention, bf16: one bf16 rounding of the output (2^-8) plus P rounded to
#  bf16 before P·V; 2e-2 leaves room for the sum over S keys.
#  Attention, fp32: fp32 FMA in another summation order and exp2 for exp, ~1e-6 seen.
TOL_BF16 = 2e-2
TOL_F32 = 1e-4
#  GroupNorm, bf16: one rounding of the output (2^-8 of |y|); fp32: the
#  statistics summed in another order.
TOL_GN_BF16 = 1e-2
TOL_GN_F32 = 1e-5
#  gn_channel_sums: fp32 sums of the same values in another order.
TOL_SUMS = 1e-5
#  conv3x3, bf16: the sum over K = 9·Ci ≤ 4608 products in another order,
#  plus one output rounding; fp32: another summation order.
TOL_CONV_BF16 = 2e-2
TOL_CONV_F32 = 1e-4
#  Full model, fp32 on the card (TF32 off) vs fp32 on the CPU: about 60
#  conv layers summed in other orders.
TOL_MODEL_F32 = 1e-3
#  Full model, bf16 on the card vs fp32 on the CPU: bf16 activations
#  between every layer.
TOL_MODEL_BF16 = 1e-1
#  GroupNorm backward: dx in bf16 takes TOL_GN_BF16 (one output rounding);
#  dx in fp32 and every parameter gradient are fp32 sums in another order.
TOL_GN_BWD_F32 = 1e-4
#  All parameter gradients of the full model, card vs CPU fp32, as the norm of
#  the difference over the norm of the CPU's: fp32, other summation orders
#  through ~60 layers and back; bf16, bf16 activations and gradients between
#  every layer.
TOL_GRAD_F32 = 1e-3
TOL_GRAD_BF16 = 1e-1

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12    # fp32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
# fp32 operations per element of one GroupNorm + swish: statistics (x − K,
# two adds, one FMA) and apply (subtract, FMA, SiLU's exp, add and divide).
GN_FLOPS_PER_ELEMENT = 11
# fp32 operations per element of one GroupNorm + swish backward: each of its
# two steps recomputes x̂ (2), z (2), σ(z) (exp, add, divide) and dz (5); the
# reduction adds 3 for its two sums, the apply 4 for dx.
GN_BWD_FLOPS_PER_ELEMENT = 31
# The stage-2 train step's GroupNorm shapes (12-band 256² B=16, the shipped
# architecture) with their calls a step: 52 backward calls.
TRAIN_GN_SHAPES = {(16, 128, 256, 256): 10, (16, 256, 256, 256): 1, (16, 128, 128, 128): 1,
                   (16, 256, 128, 128): 8, (16, 512, 128, 128): 1, (16, 256, 64, 64): 1,
                   (16, 512, 64, 64): 9, (16, 512, 32, 32): 21}

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()


def stamp(label: str) -> None:
    """Print the script's wall time so far, at the end of a phase."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {label}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, flops_per_s: float, nbytes: float) -> dict:
    """The least time for ``flops`` at ``flops_per_s`` and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flops / flops_per_s * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_kernels(label: str, fn, card: str, calls: int = 2) -> dict:
    """Kernel time by name over ``calls`` calls of ``fn`` (torch.profiler, kernel
    rows only), each hand kernel's share, and the device-busy share of the
    profiled wall time. Only the device is traced: tracing the host's operators
    as well lengthened the profiled call and so understated the device-busy
    share (``PERF.md`` §5). Returns each kernel name's launches per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # Device rows only; a user annotation's device range (the optimizer step's)
    # spans kernels that have rows of their own.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"profile {label}: wall {wall_ms:.3f} ms/call (profiler on), "
          f"kernels {busy_ms:.3f} ms/call, device busy {busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        ms = e.self_device_time_total / 1e3 / calls
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count // calls:<4d} {e.key[:96]}")
    for group, tag in (("conv3x3", "conv3x3_"), ("group_norm", "gn_apply_kernel"),
                       ("group_norm statistics", "gn_stats_"),
                       ("group_norm_backward", "gn_bwd_"), ("flash_attention", "flash_")):
        ours = [e for e in kernels if tag in e.key]
        ms = sum(e.self_device_time_total for e in ours) / 1e3 / calls
        count = sum(e.count for e in ours) // calls
        print(f"  {group} kernels: {ms:.3f} ms/call x{count}, {100 * ms / busy_ms:.2f}% of "
              "kernel time")
    return {e.key: e.count // calls for e in kernels}


def rel_err(out, ref) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def build_kernels() -> float:
    from eovax_torch.kernels import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build.build, sources))
    seconds = time.perf_counter() - t0
    for src, lib in zip(sources, libs):
        print(f"built {src} -> {lib}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Performance Loss" in line:
                print(f"  ptxas {line.strip()}")
    return seconds


def check(name: str, label: str, out, ref, tol: float) -> float:
    """Kernel output vs plain output; returns the max abs error."""
    import torch

    err, rel = rel_err(out, ref)
    ok = bool(torch.isfinite(out).all()) and out.shape == ref.shape and rel <= tol
    print(f"kernel-vs-plain {name} {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {label}")
    return err


def check_attention(q, k, v, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain

    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    return check("flash_attention", f"{label} {tuple(q.shape)} {q.dtype}", out,
                 flash_attention_plain(q, k, v), tol)


def check_attention_permutation(b: int, s: int, d: int, g) -> float:
    """K = the first S rows of the identity (S ≤ D), Q = c·K[π] with c the power
    of two that makes the logit gap c/√D at least 30, and |V| ≥ 1/4: softmax is
    one-hot to far below half a bf16 ulp of any output, so the kernel must
    return V[π] bit for bit."""
    import math

    import torch

    from eovax_torch.kernels.attention import flash_attention

    dev = g.device
    c = 2.0 ** math.ceil(math.log2(30.0 * math.sqrt(d)))
    eye = torch.eye(s, d, device=dev, dtype=torch.bfloat16)
    perm = torch.stack([torch.randperm(s, generator=g, device=dev) for _ in range(b)])
    v = torch.randn(b, s, d, generator=g, device=dev)
    v = torch.where(v >= 0, v + 0.25, v - 0.25).to(torch.bfloat16)
    out = flash_attention((c * eye[perm]).contiguous(), eye.expand(b, s, d).contiguous(), v)
    torch.cuda.synchronize()
    expected = v[torch.arange(b, device=dev)[:, None], perm]
    err = (out.float() - expected.float()).abs().max().item()
    ok = torch.equal(out, expected)
    print(f"kernel permutation flash_attention {(b, s, d)} bf16: max_abs_err={err:.3e} tol=0 "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention does not return V[π] exactly on one-hot inputs")
    return err


def gn_variants(b: int, c: int, g) -> dict:
    """The GroupNorm calls the model makes: affine (AttnBlock), + swish
    (ResnetBlock norm1, norm_out), + AdaIN + swish ([C] and [B, C], norm2)."""
    import torch

    dev = g.device
    ada = {}
    for label, shape in (("adain[C]+swish", (c,)), ("adain[B,C]+swish", (b, c))):
        ada[label] = dict(swish=True,
                          ada_scale=1.0 + 0.2 * torch.randn(shape, generator=g, device=dev),
                          ada_shift=0.2 * torch.randn(shape, generator=g, device=dev))
    return {"affine": {}, "swish": dict(swish=True), **ada}


def check_group_norm(x, weight, bias, tol: float, label: str, variants: dict) -> dict:
    """group_norm in each variant and gn_channel_sums vs their plain versions;
    returns the max abs error of each group_norm variant."""
    import torch

    from eovax_torch.kernels.groupnorm import (
        gn_channel_sums,
        gn_channel_sums_plain,
        group_norm,
        group_norm_plain,
    )

    errs = {}
    for name, kw in variants.items():
        out = group_norm(x, weight, bias, **kw)
        torch.cuda.synchronize()
        errs[name] = check("group_norm", f"{label} {name} {tuple(x.shape)} {x.dtype}", out,
                           group_norm_plain(x, weight, bias, **kw), tol)
    sums = gn_channel_sums(x)
    torch.cuda.synchronize()
    for which, out, ref in zip(("sum", "sum_sq"), sums, gn_channel_sums_plain(x)):
        check("gn_channel_sums", f"{label} {which} {tuple(x.shape)} {x.dtype}", out, ref,
              TOL_SUMS)
    return errs


def check_conv(x, w, bias, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_plain

    out = conv3x3(x, w, bias)
    torch.cuda.synchronize()
    return check("conv3x3", f"{label} {tuple(x.shape)}→{w.shape[0]} {x.dtype}", out,
                 conv3x3_plain(x, w, bias), tol)


def check_conv_dx(grad, w, tol: float, label: str) -> float:
    import torch

    from eovax_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_dx_plain

    out = conv3x3_dx(grad, w)
    torch.cuda.synchronize()
    return check("conv3x3_dx", f"{label} {tuple(grad.shape)}→{w.shape[1]} {grad.dtype}", out,
                 conv3x3_dx_plain(grad, w), tol)


def check_gn_backward(grad, x, weight, bias, label: str, **kw) -> float:
    """group_norm_backward's five gradients vs the plain backward; returns the
    max abs error of dx."""
    import torch

    from eovax_torch.kernels.groupnorm import (
        group_norm_backward,
        group_norm_backward_plain,
        group_stats_plain,
    )

    stats = group_stats_plain(x, 32, 1e-6)
    got = group_norm_backward(grad, x, *stats, weight, bias, **kw)
    torch.cuda.synchronize()
    ref = group_norm_backward_plain(grad, x, *stats, weight, bias, **kw)
    tol_dx = TOL_GN_BF16 if x.dtype == torch.bfloat16 else TOL_GN_BWD_F32
    errs = []
    for name, a, r in zip(("dx", "dweight", "dbias", "d_ada_scale", "d_ada_shift"), got, ref):
        if r is not None:
            errs.append(check("group_norm_backward", f"{label} {name} {tuple(x.shape)} {x.dtype}",
                              a, r, tol_dx if name == "dx" else TOL_GN_BWD_F32))
    return errs[0]


def check_gn_backward_repeat(grad, x, weight, bias, label: str, **kw) -> None:
    """Two backward kernel calls give bit-identical dx, S1 and S2 (the per-plane
    sums the parameter gradients come from)."""
    import torch

    from eovax_torch.kernels.groupnorm import _backward_kernel, group_stats_plain

    args = (grad, x, *group_stats_plain(x, 32, 1e-6), weight, bias, kw.get("ada_scale"),
            kw.get("ada_shift"), kw.get("swish", False))
    first, second = _backward_kernel(*args), _backward_kernel(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernel repeat group_norm_backward {label} {tuple(x.shape)} {x.dtype}: dx, S1, S2 "
          f"{'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"group_norm_backward differs between two calls at {label}")


def gn_backward_plan_line(shape, dtype) -> str:
    """The backward kernel's plan for ``shape`` and how many of its clusters the
    card holds at once."""
    import torch

    from eovax_torch.kernels.groupnorm import _bwd_plan, bwd_active_clusters

    b, c, h, w = shape
    plan = _bwd_plan(b, c, 32, h * w, torch.tensor([], dtype=dtype).element_size())
    vec = (h * w) % (16 // torch.tensor([], dtype=dtype).element_size()) == 0
    return (f"{plan._asdict()}, {'16-byte vectors' if vec else 'scalar loads'}, "
            f"cudaOccupancyMaxActiveClusters {bwd_active_clusters(plan, dtype, vec)}")


def conv_inputs(b, ci, co, h, w, dtype, g):
    import torch

    dev = g.device
    return (torch.randn(b, ci, h, w, generator=g, device=dev).to(dtype),
            0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev),
            0.1 * torch.randn(co, generator=g, device=dev))


def shipped_config(bands: int):
    from eovax_torch.core.config import DecoderConfig, EncoderConfig, StemConfig, VAEConfig

    stem = StemConfig(num_layers=4, wv_planes=256)
    return VAEConfig(encoder=EncoderConfig(in_channels=bands, stem=stem),
                     decoder=DecoderConfig(out_ch=bands, stem=stem))


def bench_state_dict(model, seed: int) -> dict:
    """N(0, 0.02) weights from ``seed``, latent BN mean 0 and var 1 (as bench.py)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.core.state_dict().items():
        if name.endswith("running_var"):
            sd[name] = torch.ones_like(t, device="cpu")
        elif not t.is_floating_point() or name.endswith("running_mean"):
            sd[name] = torch.zeros_like(t, device="cpu")
        else:
            sd[name] = torch.empty(t.shape).normal_(0.0, 0.02, generator=g)
    return sd


def drive(label: str, fn, expected: dict):
    """Run ``fn()`` with every kernel's launch count set to 0 just before it;
    the counts read just after must equal ``expected``. Returns the output
    and the counts."""
    import torch

    from eovax_torch.kernels import attention, conv3x3, groupnorm

    # (wrapper, its count): the kernels' launches, and the attention backward's
    # calls (tensor ops, no kernel of its own).
    counters = {"conv3x3": (conv3x3.conv3x3, "launches"),
                "group_norm": (groupnorm.group_norm, "launches"),
                "flash_attention": (attention.flash_attention, "launches"),
                "conv3x3_dx": (conv3x3.conv3x3_dx, "launches"),
                "group_norm_backward": (groupnorm.group_norm_backward, "launches"),
                "flash_attention_backward": (attention.flash_attention_backward, "calls")}
    for f, attr in counters.values():
        setattr(f, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    got = {name: getattr(f, attr) for name, (f, attr) in counters.items()}
    print(f"{label}: launches {got}")
    if got != expected:
        raise AssertionError(f"{label}: expected launches {expected}, got {got}")
    return out, got


def launches(conv: int, gn: int, attn: int, conv_dx: int = 0, gn_bwd: int = 0,
             attn_bwd: int = 0) -> dict:
    return {"conv3x3": conv, "group_norm": gn, "flash_attention": attn, "conv3x3_dx": conv_dx,
            "group_norm_backward": gn_bwd, "flash_attention_backward": attn_bwd}


def sen2naip_batches(n_batches: int, batch: int, seed: int) -> list[dict]:
    """Collated synthetic Sen2NAIP batches: LR 128² S2 and HR 512² NAIP digital
    numbers from ``seed``, z-scored and LR bicubic-upsampled to 512²."""
    import numpy as np

    from eovax_torch.data.sen2naip import sen2naip_collate

    rng = np.random.default_rng(seed)
    return [
        sen2naip_collate([
            {"image_lr": rng.uniform(0.0, 4000.0, (128, 128, 4)).astype(np.float32),
             "image_hr": rng.uniform(0.0, 255.0, (512, 512, 4)).astype(np.float32),
             "aoi": f"aoi{i}_{j}"}
            for j in range(batch)
        ])
        for i in range(n_batches)
    ]


def run_encode_split(model, batches, out_dir: Path, compress: bool = True):
    from eovax_torch.cli.encode_latents import encode_split
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.utils.stats import RunningStats

    shutil.rmtree(out_dir, ignore_errors=True)
    z = model.config.encoder.z_channels
    stats = {"lr_latent": RunningStats((z,), (0, 1, 2)), "hr_latent": RunningStats((z,), (0, 1, 2))}
    n = encode_split(model, iter(batches), str(out_dir / "train"), wvs=SEN2NAIP_WVS,
                     stats_lr=stats["lr_latent"], stats_hr=stats["hr_latent"],
                     use_spatial_norm=True, compress=compress)
    return n, {k: v.to_dict() for k, v in stats.items()}


def check_encode_split(n: int, stats: dict, out_dir: Path, expected: int) -> None:
    import numpy as np

    files = sorted((out_dir / "train").glob("*.npz"))
    if n != expected or len(files) != expected:
        raise AssertionError(f"encode_split wrote {n} / {len(files)} AOIs, expected {expected}")
    for path in files:
        with np.load(path) as d:
            if sorted(d.files) != ["hr_image", "hr_latent", "lr_image", "lr_latent"]:
                raise AssertionError(f"{path.name}: npz keys {d.files}")
            for key in ("lr_latent", "hr_latent"):
                if d[key].shape != (32, 64, 64) or not np.isfinite(d[key]).all():
                    raise AssertionError(f"{path.name}: {key} {d[key].shape} or non-finite")
            if d["hr_image"].shape != (4, 512, 512):
                raise AssertionError(f"{path.name}: hr_image {d['hr_image'].shape}")
    for part in ("lr_latent", "hr_latent"):
        if sorted(stats[part]) != ["count", "max", "mean", "min", "std", "var"]:
            raise AssertionError(f"latent_stats {part} keys {sorted(stats[part])}")
        if not all(np.isfinite(v).all() for v in stats[part].values()):
            raise AssertionError(f"latent_stats {part} has non-finite values")
    print(f"encode_split: {len(files)} npz files, keys and [32,64,64] latents ok, "
          f"latent_stats keys ok and finite (count {stats['hr_latent']['count'][0]:.0f})")


def train_config(bands: int):
    """The shipped architecture with the shipped optimizer settings, the warmup cut
    (constant base lr), and the posterior's mode instead of a sample, so that the
    loss on one fixed batch is a function of the weights alone."""
    import dataclasses

    return dataclasses.replace(shipped_config(bands), base_lr=1e-4, final_lr=None,
                               clip_grad=1.0, sample_posterior=False)


def train_loss():
    from eovax_torch.losses import EOConsistencyLoss

    return EOConsistencyLoss(rec_loss_type="char", pixel_weight=1.0, msssim_weight=1.0,
                             msssim_start_step=0)


def model_grads(sd: dict, policy, device, x, wvs) -> dict:
    """All parameter gradients of one train-mode forward (posterior mode) and the
    Charbonnier loss, in fp32 on the CPU."""
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.losses.consistency import charbonnier_loss

    core = EOFluxVAE(train_config(12), sd, policy=policy, device=device).core
    x, wvs = x.to(device), wvs.to(device)
    recon, _ = core(x, wvs, sample_posterior=False, train=True)
    charbonnier_loss(recon, x).backward()
    return {n: p.grad.float().cpu() for n, p in core.named_parameters()}


def check_model_grads(label: str, got: dict, ref: dict, tol: float) -> float:
    """Relative global norm of the difference; prints the worst tensor among those
    holding at least a thousandth of the global norm."""
    import torch

    ref_norm = torch.sqrt(sum(g.double().square().sum() for g in ref.values())).item()
    diff = {n: (got[n].double() - g.double()).norm().item() for n, g in ref.items()}
    rel = (sum(d * d for d in diff.values()) ** 0.5) / ref_norm
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    worst = max((d / ref[n].double().norm().item(), n) for n, d in diff.items()
                if ref[n].double().norm().item() >= 1e-3 * ref_norm)
    ok = finite and rel <= tol
    print(f"full model gradients {label} on the card vs fp32 on the CPU [1,12,64,64]: "
          f"|diff|/|ref| = {rel:.3e} (tol {tol:g}) over {len(ref)} tensors; worst tensor "
          f"{worst[1]} {worst[0]:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"full-model gradients ({label}) disagree with the CPU")
    return rel


def train_phase(sd: dict, card: str, g) -> tuple[dict, dict, dict]:
    """Phase 5; returns the launches of one train step, the backward kernels'
    errors at the main path's shapes, and their times."""
    import torch
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.conv3x3 import conv3x3_dx, conv3x3_dx_plain
    from eovax_torch.kernels.groupnorm import (
        group_norm_backward,
        group_norm_backward_plain,
        group_stats_plain,
    )
    from eovax_torch.train import stage2

    dev = g.device
    errs, timings = {}, {}

    # Backward kernels vs plain at the main path's shapes, odd shapes and fp32.
    for b, ci, co, h, w, dtype, tol in ((16, 128, 128, 256, 256, torch.bfloat16, TOL_CONV_BF16),
                                        (16, 512, 512, 32, 32, torch.bfloat16, TOL_CONV_BF16),
                                        (2, 48, 96, 37, 53, torch.bfloat16, TOL_CONV_BF16),
                                        (2, 64, 96, 37, 53, torch.float32, TOL_CONV_F32)):
        grad = torch.randn(b, co, h, w, generator=g, device=dev).to(dtype)
        k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev)
        errs["conv3x3_dx", (b, ci, co, h, w)] = check_conv_dx(grad, k, tol, "synthetic")
    # group_norm_backward at the step's 8 shapes, two streamed ones and odd ones.
    gn_shapes = ([(shape, torch.bfloat16) for shape in TRAIN_GN_SHAPES]
                 + [((2, 128, 512, 512), torch.bfloat16), ((2, 256, 256, 256), torch.float32),
                    ((2, 96, 37, 53), torch.bfloat16), ((2, 96, 37, 53), torch.float32)])
    for shape, dtype in gn_shapes:
        print(f"group_norm_backward plan {list(shape)} {dtype}: "
              f"{gn_backward_plan_line(shape, dtype)}")
        b, c = shape[:2]
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(dtype)
        grad = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        variants = gn_variants(b, c, g)
        for name, kw in variants.items():
            err = check_gn_backward(grad, x, w, bias, f"synthetic {name}", **kw)
            errs.setdefault(("group_norm_backward", shape), {})[name] = err
        check_gn_backward_repeat(grad, x, w, bias, "adain[B,C]+swish",
                                 **variants["adain[B,C]+swish"])
        del x, grad
        torch.cuda.empty_cache()
    stamp("phase 5: backward kernels vs plain")

    # The main path: the stage-2 train step at full width, 12-band 256² B=16 bf16.
    s2 = torch.tensor(wavelengths_for("S2L2A"), device=dev)
    cfg = train_config(12)
    model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev)
    core = model.core
    opt, schedule = stage2.make_optimizer(cfg, core.parameters())
    step = stage2.make_train_step(core, train_loss(), opt, cfg, schedule=schedule)
    state = stage2.TrainState()
    x = torch.randn(16, 12, 256, 256, generator=g, device=dev)

    captured = {}

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].detach().clone(), dict(kwargs))
            out.register_hook(lambda grad: captured.__setitem__(key + "/grad", grad.clone()))
        return hook

    conv1 = core.decoder.up[0].block[0].conv1
    norm2 = core.decoder.up[0].block[1].norm2
    hooks = [conv1.register_forward_hook(capture("conv1"), with_kwargs=True),
             norm2.register_forward_hook(capture("norm2"), with_kwargs=True)]
    losses = [step(state, x, s2)["train/loss_total"]]  # the first warm-up step
    for h in hooks:
        h.remove()
    with torch.no_grad():
        check_conv_dx(captured["conv1/grad"].contiguous(), conv1.weight, TOL_CONV_BF16,
                      "decoder-up0-block0-conv1-captured")
        xn, kw = captured["norm2"]
        check_gn_backward(captured["norm2/grad"].contiguous(), xn, norm2.weight, norm2.bias,
                          "decoder-up0-block1-norm2-captured", **kw)
    del captured, xn, kw

    logs, counts = drive("train step [16,12,256,256] bf16", lambda: step(state, x, s2),
                         launches(48, 52, 2, conv_dx=48, gn_bwd=52, attn_bwd=2))
    losses.append(logs["train/loss_total"])
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: losses.append(step(state, x, s2)["train/loss_total"]), 10,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"train losses over {len(losses)} steps on one batch: "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    if not all(torch.isfinite(torch.tensor(losses))) or losses[-1] >= losses[0]:
        raise AssertionError("the train loss is not finite or did not fall")
    print(f"time train step [16,12,256,256] bf16: {ms:.3f} ms/step, {16e3 / ms:.2f} imgs/s, "
          f"peak memory {peak / 2**30:.2f} GiB [{card}]")
    timings["train_step_ms"] = ms
    # The optimizer step alone, on the last step's gradients: the host's time to
    # issue its foreach passes, and the time until the card has run them.
    host, total = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
    print(f"time optimizer step (ClippedAdam, {sum(p.numel() for p in opt.params)} params): "
          f"host {min(host):.3f}-{max(host):.3f} ms, until the card is done "
          f"{min(total):.3f}-{max(total):.3f} ms (5 calls) [{card}]")
    stamp("phase 5: timed train steps")
    rows = profile_kernels("train step [16,12,256,256] bf16", lambda: step(state, x, s2), card,
                           calls=1)
    gn_bwd_rows = {k: v for k, v in rows.items() if "gn_bwd_" in k}
    if (sum(gn_bwd_rows.values()) != sum(TRAIN_GN_SHAPES.values())
            or any("gn_bwd_reduce" in k or "gn_bwd_apply" in k for k in gn_bwd_rows)):
        raise AssertionError(f"the profiled step's GroupNorm backward rows: {gn_bwd_rows}")
    del model, core, opt, step, x
    torch.cuda.empty_cache()
    stamp("phase 5: train steps")

    # Full-model gradients: card (fp32, bf16) vs fp32 on the CPU, same weights.
    x_small = torch.randn(1, 12, 64, 64, generator=torch.Generator().manual_seed(4))
    s2_cpu = s2.cpu()
    ref = model_grads(sd, FULL_PRECISION, "cpu", x_small, s2_cpu)
    for label, policy, tol in (("fp32", FULL_PRECISION, TOL_GRAD_F32),
                               ("bf16", DEFAULT_POLICY, TOL_GRAD_BF16)):
        check_model_grads(label, model_grads(sd, policy, dev, x_small, s2_cpu), ref, tol)
    del ref
    stamp("phase 5: full-model gradients")

    # Backward kernels' times at the largest main-path shapes.
    b, ci, co, h, w = 16, 128, 128, 256, 256
    grad = torch.randn(b, co, h, w, generator=g, device=dev).to(torch.bfloat16)
    k = 0.05 * torch.randn(co, ci, 3, 3, generator=g, device=dev)
    kb = k.bfloat16()
    kernel_ms = cuda_ms(lambda: conv3x3_dx(grad, k), 10)
    plain_ms = cuda_ms(lambda: conv3x3_dx_plain(grad, k), 3)
    library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input((b, ci, h, w), kb, grad, padding=1),
                         10)
    flops = 2.0 * b * h * w * 9 * ci * co
    timings["conv3x3_dx"] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                 **bound(flops, H100_BF16_FLOPS,
                                         2.0 * (grad.numel() + k.numel() + b * ci * h * w)))
    print(f"time conv3x3_dx [{b},{co}→{ci},{h},{w}] bf16: kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN dgrad "
          f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s), bound "
          f"{timings['conv3x3_dx']['bound_ms']:.4f} ms [{card}]")
    del grad, k, kb

    for shape in ((16, 128, 256, 256), (16, 256, 256, 256)):
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(torch.bfloat16)
        grad = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=dev)
        bias = 0.1 * torch.randn(shape[1], generator=g, device=dev)
        stats = group_stats_plain(x, 32, 1e-6)
        kernel_ms = cuda_ms(lambda: group_norm_backward(grad, x, *stats, w, bias, swish=True), 20)
        plain_ms = cuda_ms(lambda: group_norm_backward_plain(grad, x, *stats, w, bias, swish=True),
                           5)
        xr, wr, br = (t.detach().clone().requires_grad_()
                      for t in (x, w.bfloat16(), bias.bfloat16()))
        y = F.silu(F.group_norm(xr, 32, wr, br, 1e-6))
        library_ms = cuda_ms(lambda: torch.autograd.grad(y, (xr, wr, br), grad, retain_graph=True),
                             20)
        # The least traffic: x and g read once, dx written once.
        nbytes = 3.0 * x.numel() * x.element_size()
        timings["group_norm_backward", shape] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(GN_BWD_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS, nbytes))
        print(f"time group_norm_backward+swish {list(shape)} bf16: kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, autograd of F.silu(F.group_norm) {library_ms:.4f} ms, "
              f"bound {timings['group_norm_backward', shape]['bound_ms']:.4f} ms "
              f"({nbytes / kernel_ms / 1e6:.0f} GB/s of its 3-access traffic; plan "
              f"{gn_backward_plan_line(shape, torch.bfloat16)}) [{card}]")
        del x, grad, xr, y
        torch.cuda.empty_cache()
    return counts, errs, timings


def timed_batches(batches, events: list, probe=None):
    """Yield ``batches``, recording a CUDA event (and calling ``probe``) before
    each one and after the last: the events' gaps are the device time of each
    step and of what follows it in the loop, with no synchronisation added."""
    import torch

    for batch in batches:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        if probe is not None:
            probe()
        yield batch
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    if probe is not None:
        probe()


def step_gaps_ms(events: list) -> list[float]:
    import torch

    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def trainer_phase(sd: dict, card: str, bare_ms: float) -> float:
    """Phase 6: ``Stage2Trainer`` and the train CLI at full width, bf16. Returns
    the steady ms/step of the synthetic batches before a save."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eovax_torch import EOFluxVAE
    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.precision import DEFAULT_POLICY
    from eovax_torch.data.synthetic import synthetic_terramesh_batches
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.train import stage2
    from eovax_torch.utils.image_logger import ImageLogger
    from eovax_torch.utils.logging import CSVLogger

    dev = torch.device("cuda")
    # The shipped VAE settings (the posterior sampled) with the warmup cut: at
    # lr 0 the first update would not move the parameters.
    cfg = dataclasses.replace(shipped_config(12), base_lr=1e-4, final_lr=None, clip_grad=1.0)
    batches = list(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256), seed=0,
                                               num_batches=6))
    val_batches = list(synthetic_terramesh_batches(batch_size=32, target_size=(256, 256),
                                                   mode="S2L2A", seed=1, num_batches=2))
    print(f"trainer batches: {[b['modality'] for b in batches]} x16 at 256², validation "
          f"2 x32 S2L2A")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_", dir=ROOT / "build"))
    ckpt_dir = tmp / "checkpoints"

    saves, val_s = [], []

    class TimedTrainer(stage2.Stage2Trainer):
        """Times each save and validation of the fit around the public methods. A
        save's write is waited for at once, so that it is timed alone; the steps
        beside a write in flight are timed after the fit."""

        def save_checkpoint(self, state):
            torch.cuda.synchronize()  # the blocking copy alone, not the queued step
            t0 = time.perf_counter()
            started = super().save_checkpoint(state)
            t1 = time.perf_counter()
            self.checkpointer.wait()
            if started:
                saves.append({"step": state.step, "copy_ms": (t1 - t0) * 1e3,
                              "write_ms": (time.perf_counter() - t1) * 1e3})
            return started

        def validate(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means = super().validate(*args, **kw)
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t0)
            return means

    def trainer(cls=stage2.Stage2Trainer, **kw):
        model = EOFluxVAE(cfg, sd, policy=DEFAULT_POLICY, device=dev)
        return cls(model=model, loss_obj=train_loss(), cfg=cfg, **kw)

    try:
        # -- the fit: 6 steps, a save and a validation after steps 3 and 6.
        first = trainer(TimedTrainer, max_steps=6, ckpt_dir=str(ckpt_dir), ckpt_every=3,
                        val_every=3, val_max_batches=2, log_every=3,
                        logger=CSVLogger(str(tmp)), image_logger=ImageLogger(str(tmp)),
                        norm_scheme="custom")
        events = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # Per step 48/52/2 forward and 48/52/2 backward; per validation 2 sampled
        # eval forwards and the image grid's forward of the posterior's mode.
        state, counts = drive("trainer fit 6 steps [16,C,256,256] bf16, 2 validations",
                              lambda: first.fit(timed_batches(batches, events),
                                                lambda: iter(val_batches)),
                              launches(6 * 48 + 2 * 3 * 48, 6 * 52 + 2 * 3 * 52,
                                       6 * 2 + 2 * 3 * 2, 6 * 48, 6 * 52, 6 * 2))
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        gaps = step_gaps_ms(events)
        if state.step != 6 or [s["step"] for s in saves] != [3, 6]:
            raise AssertionError(f"fit ended at step {state.step}, saved {saves}")
        rows = CSVLogger(str(tmp)).path
        with open(rows) as f:
            lines = f.read().splitlines()
        pngs = sorted((tmp / "image_log" / "val").glob("*.png"))
        head = lines[0].split(",")
        if ([ln.split(",")[0] for ln in lines[1:]] != ["3", "3", "6", "6"] or len(pngs) != 2
                or "train/loss_total" not in head or "val/loss_rec" not in head):
            raise AssertionError(f"metrics.csv {lines[:1]} {len(lines) - 1} rows, {len(pngs)} PNGs")
        losses = [float(v) for ln in lines[1:] for k, v in zip(head, ln.split(","))
                  if k in ("train/loss_total", "val/loss_total") and v]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite logged losses {losses}")
        print(f"trainer fit: {fit_s:.3f} s for 6 steps, step gaps (device, the gap after "
              f"steps 3 and 6 holds the save, its write, the validation and the best save) "
              f"{', '.join(f'{v:.3f}' for v in gaps)} ms; validation {', '.join(f'{v:.3f}' for v in val_s)} s "
              f"(2 x32 S2L2A, image grid, best checkpoint); peak memory {peak / 2**30:.2f} GiB "
              f"[{card}]")
        for s in saves:
            print(f"trainer save step {s['step']}: blocking host copy {s['copy_ms']:.1f} ms, "
                  f"write {s['write_ms']:.1f} ms (waited for at once) [{card}]")
        print(f"trainer files: metrics.csv {len(lines) - 1} rows, {[p.name for p in pngs]}, "
              f"checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")
        stamp("phase 6: trainer fit")

        # -- a fresh trainer on the same directory resumes at step 6 and takes 2 steps.
        second = trainer(max_steps=8, ckpt_dir=str(ckpt_dir))
        resumed = []

        def same_state():
            if resumed:
                return
            model_b = second.core.state_dict()
            same = [torch.equal(x, model_b[k]) for k, x in first.core.state_dict().items()]
            a, b = first.optimizer.state_dict(), second.optimizer.state_dict()
            same += [torch.equal(x, y) for key in ("mu", "nu") for x, y in
                     zip(a[key], b[key], strict=True)]
            resumed.append(all(same) and a["count"] == b["count"])

        more = list(synthetic_terramesh_batches(batch_size=16, target_size=(256, 256), seed=2,
                                                num_batches=2))
        state2, _ = drive("trainer resume at step 6, 2 more steps",
                          lambda: second.fit(timed_batches(more, [], same_state)),
                          launches(2 * 48, 2 * 52, 2 * 2, 2 * 48, 2 * 52, 2 * 2))
        if resumed != [True] or state2.step != 8:
            raise AssertionError(f"resume: state equal {resumed}, ended at step {state2.step}")
        print(f"trainer resume: {len(sd)} tensors of the model and Adam's moments and count "
              f"torch.equal to the first trainer's at step 6; ended at step {state2.step}")
        del first
        torch.cuda.empty_cache()

        # -- steady steps, without and with a checkpoint write in flight: 2 warm-up
        # steps, 4 quiet, a save and 4 while it writes, 4 quiet after it ended.
        def steps(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for batch in batches[:n]:
                second.train_on_batch(state2, batch)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n

        steps(2)
        quiet_ms = steps(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        second.save_checkpoint(state2)
        copy_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = steps(4)
        t0 = time.perf_counter()
        second.checkpointer.wait()
        left_ms = (time.perf_counter() - t0) * 1e3
        after_ms = steps(4)
        print(f"time trainer steps (4 steps, mixed modalities): {quiet_ms:.3f} ms/step before "
              f"a save, {busy_ms:.3f} ms/step with its write in flight (copy {copy_ms:.1f} ms; "
              f"the write went on for {left_ms:.1f} ms after the 4 steps), {after_ms:.3f} "
              f"ms/step after it; phase 5's bare step {bare_ms:.3f} ms/step [{card}]")
        del second
        torch.cuda.empty_cache()
        stamp("phase 6: resume and steady steps")

        # -- accumulate_steps=2: the parameters move only at steps 2 and 4, the
        # latent BatchNorm statistics at every step.
        third = trainer(max_steps=4, accumulate_steps=2, log_every=0)
        params = list(third.core.parameters())
        seen, moved = [], []

        def probe():
            now = ([p.detach().clone() for p in params], third.core.bn.running_mean.clone())
            if seen:
                moved.append((any(not torch.equal(a, b) for a, b in zip(now[0], seen[-1][0])),
                              not torch.equal(now[1], seen[-1][1])))
                seen.pop()
            seen.append(now)

        drive("trainer fit 4 steps accumulate_steps=2",
              lambda: third.fit(timed_batches(batches[:4], [], probe)),
              launches(4 * 48, 4 * 52, 4 * 2, 4 * 48, 4 * 52, 4 * 2))
        if moved != [(False, True), (True, True), (False, True), (True, True)]:
            raise AssertionError(f"accumulate_steps=2: (parameters, BN) moved at steps 1-4 {moved}")
        print(f"trainer accumulate_steps=2: parameters moved at steps "
              f"{[i + 1 for i, (p, _) in enumerate(moved) if p]}, BN statistics at every step; "
              f"{third.optimizer.count} updates")
        del third, params, seen
        torch.cuda.empty_cache()
        stamp("phase 6: accumulation")

        # -- the train CLI's own body: 4 steps on synthetic batches, then its final model.
        exp = tmp / "cli"
        t0 = time.perf_counter()
        drive("train CLI --synthetic-data --max-steps 4",
              lambda: train_cli.main(["--config", str(ROOT / "configs" / "eo-vae.yaml"),
                                      "--synthetic-data", "--max-steps", "4",
                                      "--resume-dir", str(exp)]),
              launches(4 * 48, 4 * 52, 4 * 2, 4 * 48, 4 * 52, 4 * 2))
        cli_s = time.perf_counter() - t0
        model = EOFluxVAE.from_config(str(ROOT / "configs" / "eo-vae.yaml"),
                                      str(exp / "eo-vae-final.pt"), policy=DEFAULT_POLICY)
        x = torch.from_numpy(val_batches[0]["image"][:4]).to(dev).permute(0, 3, 1, 2)
        recon = model.reconstruct(x, wavelengths_for("S2L2A"))
        if tuple(recon.shape) != (4, 12, 256, 256) or not torch.isfinite(recon).all():
            raise AssertionError("the CLI's eo-vae-final.pt reconstructs wrong or non-finite")
        print(f"train CLI: {cli_s:.3f} s, {sorted(p.name for p in exp.iterdir())}; "
              f"eo-vae-final.pt reconstructs [4,12,256,256] finite")
        del model
        torch.cuda.empty_cache()
        stamp("phase 6: train CLI")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return quiet_ms


# Phase 7's TerraMesh tree: (split, shard name, samples, modalities), named as in
# SPLIT_FILES; every other name of the split tables is missing. majortom holds
# S2L2A, S1RTC and S2RGB, ssl4eos12 S2L2A and S2RGB (it has no S1RTC).
DATA_SHARDS = [("train", "majortom_shard_000001.tar", 48, ("S2L2A", "S1RTC", "S2RGB")),
               ("train", "ssl4eos12_shard_000794.tar", 48, ("S2L2A", "S2RGB")),
               ("val", "majortom_shard_000001.tar", 32, ("S2L2A", "S1RTC", "S2RGB")),
               ("val", "ssl4eos12_shard_000009.tar", 32, ("S2L2A", "S2RGB"))]
DATA_MODALITIES = ["S2L2A", "S1RTC", "S2RGB"]
# The seed of the train CLI and of the pipelines held against each other: on
# the tree above its first 6 train batches draw S1RTC, S2L2A int16, S2RGB,
# S2L2A int16, S2L2A fp32 (harmonised) and S2RGB.
DATA_SEED = 7
# The shard names of each subset's train table (SPLIT_FILES), one of them present.
TRAIN_SHARD_NAMES = {"majortom": 793, "ssl4eos12": 96}


def zarr_helpers():
    """``tests/_zarr_helpers.py`` (the TerraMesh shard writer of the tests), loaded
    by its path: ``tests/`` is no package, and its conftest imports JAX."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_zarr_helpers",
                                                  ROOT / "tests" / "_zarr_helpers.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_shard_tree(root: Path, seed: int) -> int:
    """The DATA_SHARDS tree at the shipped widths, from ``seed``: S2L2A int16 in
    0-10000 at 256² (majortom's stamped before the S2 baseline change, every
    other ssl4eos12 sample after it, so that `custom` harmonises those and
    promotes their batches to fp32), S1RTC float32 dB at 256², S2RGB uint8 at
    264² (the collate resizes it). Returns the bytes written."""
    import numpy as np

    from eovax_torch.data.terramesh import S2L2A_BASELINE_CUTOFF_NS as cutoff

    helpers = zarr_helpers()
    g = np.random.default_rng(seed)
    jobs = []
    for split, name, n, mods in DATA_SHARDS:
        for mod in mods:
            samples = []
            for i in range(n):
                if mod == "S2L2A":
                    bands = g.integers(0, 10001, (1, 12, 256, 256)).astype("<i2")
                    after = name.startswith("ssl4eos12") and i % 2 == 1
                elif mod == "S1RTC":
                    bands, after = g.normal(-14.0, 4.0, (1, 2, 256, 256)).astype("<f4"), False
                else:
                    bands, after = g.integers(0, 256, (1, 3, 264, 264)).astype("u1"), False
                stamp = cutoff + i * 10**9 if after else cutoff - (i + 1) * 10**9
                samples.append({"bands": bands, "time": stamp})
            path = root / split / mod / name
            path.parent.mkdir(parents=True, exist_ok=True)
            jobs.append((str(path), samples))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: helpers.write_terramesh_shard(*job), jobs))
    return sum(p.stat().st_size for p in root.rglob("*.tar"))


def reader_rates(root: Path, card: str, step_ms: float) -> None:
    """The reader alone (decode, no batching) over the train split with 1 and 4
    threads, after a first decode that builds the native decoder: samples/s and
    decoded MB/s; every missing name of the split tables skipped with a warning
    (one per modality of its subset)."""
    import warnings

    import numpy as np

    from eovax_torch.data.terramesh import build_terramesh_dataset, decode_sample, iter_tar_samples

    # The first decode builds the native decoder; it is timed apart from the rates.
    t0 = time.perf_counter()
    decode_sample(next(iter_tar_samples(str(root / "train" / "S2L2A" / DATA_SHARDS[0][1]))))
    print(f"first decode, which builds the native blosc decoder with g++: "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    n_expected = sum(n for split, _, n, _ in DATA_SHARDS if split == "train")
    skips_expected = (TRAIN_SHARD_NAMES["majortom"] - 1) * 3 + (TRAIN_SHARD_NAMES["ssl4eos12"] - 1) * 2
    for threads in (1, 4):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            n = nbytes = 0
            for sample in build_terramesh_dataset(str(root), DATA_MODALITIES, "train",
                                                  batch_size=None, harmonize_s2l2a=True,
                                                  decode_dtype=None, num_reader_threads=threads):
                n += 1
                nbytes += sum(v.nbytes for v in sample.values() if isinstance(v, np.ndarray))
            seconds = time.perf_counter() - t0
        skips = sum("Skipping corrupt shard" in str(w.message) for w in caught)
        if n != n_expected or skips != skips_expected:
            raise AssertionError(f"reader, {threads} threads: {n} samples (expected {n_expected}), "
                                 f"{skips} missing shards skipped (expected {skips_expected})")
        print(f"reader, {threads} thread(s): {n} samples of S2L2A+S1RTC+S2RGB (or S2L2A+S2RGB) "
              f"256², {nbytes / 1e6:.1f} MB decoded in {seconds:.3f} s: {n / seconds:.1f} "
              f"samples/s, {nbytes / 1e6 / seconds:.1f} MB/s ({skips} missing shards skipped "
              f"with a warning); a B=16 step of {step_ms:.1f} ms needs "
              f"{16e3 / step_ms:.1f} samples/s [{card}]")
    reader_stages(root, card)


def reader_stages(root: Path, card: str) -> None:
    """The reader's two stages apart, over the train shards: the tar read alone
    (members to bytes, merged by key, in one thread as the reader reads them; the
    files are in the page cache, just written) and the decode alone of those raw
    samples (``decode_sample`` as the reader calls it) in 1 thread and in a pool
    of 4 (``Executor.map``, as the reader)."""
    from concurrent.futures import ThreadPoolExecutor

    from eovax_torch.data.terramesh import decode_sample, iter_multi_tar_samples

    t0 = time.perf_counter()
    raws = [raw for split, name, _, mods in DATA_SHARDS if split == "train"
            for raw in iter_multi_tar_samples([str(root / split / m / name) for m in mods])]
    read_s = time.perf_counter() - t0
    n_expected = sum(n for split, _, n, _ in DATA_SHARDS if split == "train")
    if len(raws) != n_expected:
        raise AssertionError(f"tar read: {len(raws)} samples, expected {n_expected}")
    raw_mb = sum(len(v) for raw in raws for v in raw.values() if isinstance(v, bytes)) / 1e6

    def decode(raw):
        return decode_sample(raw, harmonize_s2l2a=True, dtype=None)

    t0 = time.perf_counter()
    for raw in raws:
        decode(raw)
    one_s = time.perf_counter() - t0
    with ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        list(pool.map(decode, raws, chunksize=1))
        four_s = time.perf_counter() - t0
    n = len(raws)
    print(f"reader stages, {n} samples ({raw_mb:.1f} MB of members): tar read alone "
          f"{read_s:.3f} s, {n / read_s:.1f} samples/s; decode alone, 1 thread {one_s:.3f} s, "
          f"{n / one_s:.1f} samples/s; 4 threads {four_s:.3f} s, {n / four_s:.1f} samples/s; "
          f"read then decode in series {n / (read_s + one_s):.1f} samples/s [{card}]")


def collate_times(root: Path, card: str) -> None:
    """The train collate of each modality on the first 6 raw B=16 batches that
    hold it, host (normalize, resize, D4 in numpy) and device_prep
    (descriptors only; the S2RGB resize stays on the host), in ms a batch."""
    import itertools

    from eovax_torch.data.collate import deterministic_modality_collate
    from eovax_torch.data.terramesh import build_terramesh_dataset

    it = build_terramesh_dataset(str(root), DATA_MODALITIES, "train", batch_size=16, shuffle=True,
                                 seed=0, harmonize_s2l2a=True, repeat=True, decode_dtype=None,
                                 num_reader_threads=4)
    raws = list(itertools.islice(it, 6))
    it.close()
    for device_prep in (False, True):
        times = {}
        for mod in DATA_MODALITIES:
            collate = deterministic_modality_collate(mod, norm_scheme="custom",
                                                     target_size=(256, 256), mode="train",
                                                     seed=0, device_prep=device_prep)
            for raw in raws:
                if mod in raw:
                    t0 = time.perf_counter()
                    collate(raw)
                    times.setdefault(mod, []).append((time.perf_counter() - t0) * 1e3)
        print(f"collate {'device_prep' if device_prep else 'host'}: "
              + ", ".join(f"{m} {sum(v) / len(v):.2f} ms/batch (x{len(v)})"
                          for m, v in times.items()) + f" [{card}]")


def tiny_trainer(device):
    """A ``Stage2Trainer`` on a tiny model: phase 7 uses its batch placement only."""
    from eovax_torch import EOFluxVAE
    from eovax_torch.core import config as tcfg
    from eovax_torch.train import stage2

    stem = tcfg.StemConfig(num_layers=1, wv_planes=32)
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8, stem=stem)
    cfg = tcfg.VAEConfig(encoder=tcfg.EncoderConfig(in_channels=4, **kw),
                         decoder=tcfg.DecoderConfig(out_ch=4, **kw))
    return stage2.Stage2Trainer(model=EOFluxVAE(cfg, device=device), loss_obj=train_loss(),
                                cfg=cfg)


def check_two_paths(root: Path, dm: dict, device) -> list[dict]:
    """The shipped datamodule block's first 4 train and 2 val batches (with the
    train CLI's default of 4 reader threads), built twice: device_prep (raw, placed and prepared on ``device`` by the trainer)
    and host-collated (copied to ``device``). Raises unless torch.equal on
    every batch; returns the device_prep val batches."""
    import itertools

    import numpy as np
    import torch

    from eovax_torch.data.terramesh import TerraMeshPipeline

    trainer = tiny_trainer(device)
    val_batches = []
    for split, n in (("train_batches", 4), ("val_batches", 2)):
        both = []
        for device_prep in (True, False):
            pipe = TerraMeshPipeline(
                str(root), dm["modalities"], batch_size=dm["batch_size"],
                eval_batch_size=dm["eval_batch_size"],
                train_collate_mode=dm["train_collate_mode"],
                val_collate_mode=dm["val_collate_mode"], normalize=dm["normalize"],
                norm_scheme=dm["norm_scheme"], target_size=tuple(dm["target_size"]),
                seed=DATA_SEED,
                num_workers=dm.get("num_workers", 4), device_prep=device_prep)
            it = getattr(pipe, split)()
            both.append(list(itertools.islice(it, n)))
            it.close()
        for i, (raw, host) in enumerate(zip(*both)):
            image, wvs = trainer._place(raw)
            ref, ref_wvs = trainer._place(host)
            same = torch.equal(image, ref) and torch.equal(wvs, ref_wvs)
            print(f"two paths {split[:-8]} batch {i}: {raw['modality']} raw {raw['image'].dtype} "
                  f"{list(raw['image'].shape)} ({raw['image'].nbytes / 1e6:.2f} MB copied, "
                  f"host-collated {host['image'].nbytes / 1e6:.2f} MB), d4 {'d4' in raw}: "
                  f"device_prep {'==' if same else '!='} host-collated on {image.device}")
            if not same:
                raise AssertionError(f"device_prep and host batches differ: {split} batch {i}")
            if split == "val_batches":
                val_batches.append(raw)
        if split == "val_batches":
            dtypes = {b["image"].dtype for b in both[0]}
            if dtypes != {np.dtype(np.int16), np.dtype(np.float32)}:
                raise AssertionError(f"val batches should be int16 and harmonised fp32: {dtypes}")
    return val_batches


def check_device_prepare(batch: dict, card: str) -> None:
    """``device_prepare`` on the card against the CPU over all 16 D4 cases ([3]
    and [B,3]), per-sample rows that differ and no d4 (torch.equal); its time
    at [16,256,256,12] int16 with a per-sample d4 on the host as the trainer
    passes it (one draw in every row, as a single-process collate gives, and
    four draws of four rows each), and at [32,256,256,12] without, beside the bytes bound (each
    input on the card read once, the fp32 output written once)."""
    import torch

    from eovax_torch.data.device_prep import device_prepare

    dev = torch.device("cuda")
    leaves = [torch.from_numpy(batch[k]) for k in ("image", "norm_mean", "norm_std", "norm_clip")]
    if leaves[0].dtype != torch.int16:
        raise AssertionError(f"expected a raw int16 S2L2A batch, got {leaves[0].dtype}")
    small = [t[:4] for t in leaves]
    cases = [torch.tensor([c >> 3, (c >> 2) & 1, c & 3], dtype=torch.int32) for c in range(16)]
    rows = torch.tensor([[0, 0, 0], [1, 0, 1], [0, 1, 2], [1, 1, 3]], dtype=torch.int32)
    for d4 in cases + [c.expand(4, 3).contiguous() for c in cases] + [rows, None]:
        ref = device_prepare(*small, d4)
        got = device_prepare(*(t.to(dev) for t in small), None if d4 is None else d4.to(dev))
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"device_prepare on the card differs from the CPU, d4 {d4}")
    print(f"device_prepare: card == CPU (torch.equal) on [4,256,256,12] int16 custom for the 16 "
          f"D4 cases as [3] and [B,3], per-sample rows that differ, and no d4")
    on_card = [t.to(dev) for t in leaves]
    for b, d4, what in ((16, torch.tensor([[1, 0, 1]], dtype=torch.int32).expand(16, 3),
                         " with d4, one draw"), (16, rows.repeat_interleave(4, 0), " with d4, four draws"),
                        (32, None, "")):
        args = [t[:b] for t in on_card]
        ms = cuda_ms(lambda: device_prepare(*args, d4), iters=20)
        nbytes = sum(t.nbytes for t in args) + args[0].numel() * 4
        print(f"time device_prepare [{b},256,256,12] int16{what}: {ms:.4f} ms, bound "
              f"{nbytes / H100_BYTES_PER_S * 1e3:.4f} ms (bytes, {nbytes / 1e6:.1f} MB) [{card}]")


def data_phase(card: str, synthetic_ms: float) -> None:
    """Phase 7: the TerraMesh data path into the stage-2 trainer at full width."""
    import tempfile
    import warnings

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eovax_torch.cli import train as train_cli
    from eovax_torch.core.config import load_yaml
    from eovax_torch.train import stage2
    from eovax_torch.utils.checkpoint import TrainCheckpointer

    shipped = ROOT / "configs" / "eo-vae.yaml"
    dm = load_yaml(str(shipped))["datamodule"]
    if not (dm["device_prep"] and dm["norm_scheme"] == "custom"):
        raise AssertionError(f"the shipped datamodule block changed: {dm}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_data_", dir=ROOT / "build"))
    root = tmp / "terramesh"
    real_step = stage2.Stage2Trainer.train_on_batch
    filters = warnings.filters[:]
    try:
        t0 = time.perf_counter()
        nbytes = write_shard_tree(root, seed=7)
        print(f"shard tree: {sum(len(m) for *_, m in DATA_SHARDS)} shards, "
              f"{nbytes / 1e6:.1f} MB written in {time.perf_counter() - t0:.2f} s [{card}]")
        reader_rates(root, card, synthetic_ms)
        stamp("phase 7: reader")
        # The readers warn once for each missing shard name on every pass; the
        # reader's check above counted them.
        warnings.filterwarnings("ignore", message="Skipping corrupt shard")
        collate_times(root, card)
        val = check_two_paths(root, dm, torch.device("cuda"))
        check_device_prepare(next(b for b in val if b["image"].dtype == np.int16), card)
        stamp("phase 7: collate, two paths, device_prepare")

        # -- the train CLI on the shards: the shipped config with data_path set,
        # validating and saving every 3 steps on 1 val batch.
        text = shipped.read_text()
        edits = {"data_path: /data/terramesh": f"data_path: {root}",
                 "limit_train_batches: 2000": "limit_train_batches: 3\n  limit_val_batches: 1"}
        for old, new in edits.items():
            if text.count(old) != 1:
                raise AssertionError(f"configs/eo-vae.yaml no longer holds {old!r} once")
            text = text.replace(old, new)
        config = tmp / "eo-vae-shards.yaml"
        config.write_text(text)
        exp = tmp / "cli"
        seen = {"events": [], "bytes": [], "loss": [], "window": None}

        def recorded(self, state, batch):
            """The trainer's step, with a CUDA event at its entry, the bytes the batch
            copies to the card, and steps 4-6 profiled (device only)."""
            if state.step == 3:
                torch.cuda.synchronize()
                seen["prof"] = profile(activities=[ProfilerActivity.CUDA])
                seen["prof"].__enter__()
                seen["t0"] = time.perf_counter()
            seen["events"].append(torch.cuda.Event(enable_timing=True))
            seen["events"][-1].record()
            seen["bytes"].append(sum(np.asarray(batch[k]).nbytes for k in
                                     ("image", "norm_mean", "norm_std", "norm_clip", "d4")
                                     if k in batch))
            logs = real_step(self, state, batch)
            seen["loss"].append(logs["train/loss_total"])
            if state.step == 6:
                seen["events"].append(torch.cuda.Event(enable_timing=True))
                seen["events"][-1].record()
                torch.cuda.synchronize()
                seen["window"] = (time.perf_counter() - seen["t0"]) * 1e3
                seen["prof"].__exit__(None, None, None)
            return logs

        stage2.Stage2Trainer.train_on_batch = recorded
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # Per step 48/52/2 forward and 48/52/2 backward; per validation one
        # sampled eval forward and the image grid's forward.
        drive("train CLI from shards --max-steps 6 (device_prep, 4 reader threads)",
              lambda: train_cli.main(["--config", str(config), "--max-steps", "6",
                                      "--seed", str(DATA_SEED), "--resume-dir", str(exp)]),
              launches(6 * 48 + 2 * 2 * 48, 6 * 52 + 2 * 2 * 52, 6 * 2 + 2 * 2 * 2,
                       6 * 48, 6 * 52, 6 * 2))
        cli_s = time.perf_counter() - t0
        stage2.Stage2Trainer.train_on_batch = real_step
        peak = torch.cuda.max_memory_allocated()
        gaps = step_gaps_ms(seen["events"])
        kernels = [e for e in seen["prof"].key_averages() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

        losses = torch.stack(seen["loss"]).float().cpu()
        rows = (exp / "metrics.csv").read_text().splitlines()
        head = rows[0].split(",")
        val_losses = [float(v) for row in rows[1:] for k, v in zip(head, row.split(","))
                      if k == "val/loss_total" and v]
        pngs = sorted((exp / "image_log" / "val").glob("*.png"))
        steps = TrainCheckpointer(str(exp / "checkpoints")).all_steps()
        if (len(losses) != 6 or not torch.isfinite(losses).all() or len(val_losses) != 2
                or not np.isfinite(val_losses).all() or len(pngs) != 2 or steps != [3, 6]
                or not (exp / "eo-vae-final.pt").exists()):
            raise AssertionError(f"train CLI from shards: losses {losses.tolist()}, val "
                                 f"{val_losses}, {len(pngs)} PNGs, checkpoints {steps}, "
                                 f"{sorted(p.name for p in exp.iterdir())}")
        steady = [gaps[i] for i in (1, 3, 4)]  # entries 2→3, 4→5, 5→6
        print(f"train CLI from shards: {cli_s:.3f} s, train losses "
              f"{', '.join(f'{v:.4f}' for v in losses.tolist())}, val {val_losses}, checkpoints "
              f"{steps}, {[p.name for p in pngs]}, {sorted(p.name for p in exp.iterdir())} "
              f"[{card}]")
        print(f"time disk-fed steps (device gaps between step entries; the gap after step 3 holds "
              f"the save and the validation): {', '.join(f'{v:.3f}' for v in gaps)} ms; steady "
              f"{sum(steady) / len(steady):.3f} ms/step against phase 6's synthetic "
              f"{synthetic_ms:.3f} ms/step; steps 4-6 profiled: wall {seen['window']:.3f} ms, "
              f"kernels {busy_ms:.3f} ms, device idle {1 - busy_ms / seen['window']:.3f}; copied "
              f"{sum(seen['bytes']) / len(seen['bytes']) / 1e6:.2f} MB/step to the card "
              f"({', '.join(f'{b / 1e6:.2f}' for b in seen['bytes'])}); peak memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
        stamp("phase 7: train CLI from shards")
    finally:
        stage2.Stage2Trainer.train_on_batch = real_step
        warnings.filters[:] = filters
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.sen2naip import SEN2NAIP_WVS
    from eovax_torch.data.wavelengths import wavelengths_for
    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain
    from eovax_torch.kernels.conv3x3 import conv3x3, conv3x3_plain
    from eovax_torch.kernels.groupnorm import group_norm, group_norm_plain
    from eovax_torch.utils.tiling import tiled_reconstruct

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"kernel build: {build_kernels():.1f} s")
    FULL_PRECISION.activate()  # fp32 references without TF32

    # ---- 2. kernels vs their plain versions --------------------------------
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, d, dtype):
        return [torch.randn(b, s, d, generator=g, device=dev, dtype=dtype) for _ in range(3)]

    attn_err = check_attention(*qkv(4, 4096, 512, torch.bfloat16), TOL_BF16, "512px-B4")
    check_attention(*qkv(16, 1024, 512, torch.bfloat16), TOL_BF16, "256px-B16")
    check_attention(*qkv(3, 1037, 512, torch.bfloat16), TOL_BF16, "odd-S")
    check_attention(*qkv(2, 1037, 512, torch.float32), TOL_F32, "odd-S-fp32")
    check_attention_permutation(2, 512, 512, g)

    gn_errs = {}
    for shape, dtype, tol in (((4, 128, 512, 512), torch.bfloat16, TOL_GN_BF16),
                              ((4, 512, 64, 64), torch.bfloat16, TOL_GN_BF16),
                              ((2, 96, 37, 53), torch.float32, TOL_GN_F32)):
        b, c = shape[:2]
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        gn_errs[shape] = check_group_norm(x, w, bias, tol, "synthetic", gn_variants(b, c, g))
        del x

    conv_errs = {}
    for shape, dtype, tol in (((4, 128, 128, 512, 512), torch.bfloat16, TOL_CONV_BF16),
                              ((4, 512, 256, 256, 256), torch.bfloat16, TOL_CONV_BF16),
                              ((4, 512, 512, 64, 64), torch.bfloat16, TOL_CONV_BF16),
                              ((2, 48, 96, 37, 53), torch.bfloat16, TOL_CONV_BF16),
                              ((2, 64, 96, 37, 53), torch.float32, TOL_CONV_F32)):
        conv_errs[shape] = check_conv(*conv_inputs(*shape, dtype, g), tol, "synthetic")
    torch.cuda.empty_cache()
    stamp("phase 2: kernels vs plain")

    # ---- 3. main path at full width ------------------------------------------
    model = EOFluxVAE(shipped_config(12), policy=DEFAULT_POLICY, device=dev, seed=0)
    sd = bench_state_dict(model, seed=0)
    model.core.load_state_dict(sd)
    print(f"model: {model.param_count()} params, bf16 compute, S2L2A 12 bands")
    s2 = wavelengths_for("S2L2A")
    x512 = torch.randn(4, 12, 512, 512, generator=g, device=dev)

    # Real activations of one reconstruct, captured with forward hooks.
    captured = {}
    core = model.core

    def capture(key):
        def hook(mod, args, kwargs, out):  # returns None: the output stays as it is
            captured[key] = (args[0].clone(), dict(kwargs))
        return hook

    hooks = [
        core.encoder.mid.attn_1.register_forward_hook(capture("attn"), with_kwargs=True),
        core.decoder.up[0].block[1].norm2.register_forward_hook(capture("norm2"),
                                                                with_kwargs=True),
        core.decoder.up[0].block[0].conv1.register_forward_hook(capture("conv1"),
                                                                with_kwargs=True),
    ]
    model.reconstruct(x512, s2)  # warm-up, and the hooks' captures
    for h in hooks:
        h.remove()
    with torch.inference_mode():
        check_attention(*core.encoder.mid.attn_1.qkv(captured["attn"][0]), TOL_BF16,
                        "encoder-mid-attn_1-captured")
        norm2 = core.decoder.up[0].block[1].norm2
        xn, kw = captured["norm2"]
        check_group_norm(xn, norm2.weight, norm2.bias, TOL_GN_BF16,
                         "decoder-up0-block1-norm2-captured", {"as-called": kw})
        conv1 = core.decoder.up[0].block[0].conv1
        check_conv(captured["conv1"][0], conv1.weight, conv1.bias, TOL_CONV_BF16,
                   "decoder-up0-block0-conv1-captured")
    del captured, xn, kw
    torch.cuda.empty_cache()

    recon, main_launches = drive("main path reconstruct [4,12,512,512] bf16",
                                 lambda: model.reconstruct(x512, s2), launches(48, 52, 2))
    if tuple(recon.shape) != (4, 12, 512, 512) or not torch.isfinite(recon).all():
        raise AssertionError("reconstruct gave a wrong shape or non-finite values")

    naip = SEN2NAIP_WVS
    x_naip = torch.randn(4, 4, 512, 512, generator=g, device=dev)
    z, _ = drive("bulk encode_spatial_normalized [4,4,512,512]",
                 lambda: model.encode_spatial_normalized(x_naip, naip), launches(20, 22, 1))
    recon_naip, _ = drive("bulk decode_spatial_normalized [4,32,64,64]",
                          lambda: model.decode_spatial_normalized(z, naip), launches(28, 30, 1))
    print(f"bulk encode/decode: latent {tuple(z.shape)}, out {tuple(recon_naip.shape)}")
    if (tuple(z.shape) != (4, 32, 64, 64) or tuple(recon_naip.shape) != (4, 4, 512, 512)
            or not (torch.isfinite(z).all() and torch.isfinite(recon_naip).all())):
        raise AssertionError("bulk encode/decode gave a wrong shape or non-finite values")
    del recon, recon_naip, z

    # Same weights on a small input: card (fp32 and bf16) vs CPU fp32.
    x_small = torch.randn(1, 12, 64, 64, generator=torch.Generator().manual_seed(1))
    ref = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device="cpu").reconstruct(
        x_small, s2)
    gpu32 = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device=dev)
    out32, _ = drive("reconstruct [1,12,64,64] fp32", lambda: gpu32.reconstruct(x_small, s2),
                     launches(48, 52, 2))
    for label, out, tol in (("fp32", out32, TOL_MODEL_F32),
                            ("bf16", model.reconstruct(x_small, s2), TOL_MODEL_BF16)):
        err, rel = rel_err(out.cpu(), ref)
        ok = rel <= tol and bool(torch.isfinite(out).all())
        print(f"full model {label} on the card vs fp32 on the CPU [1,12,64,64]: "
              f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full model ({label}) disagrees with the CPU reference")
    del gpu32
    stamp("phase 3: reconstruct, bulk encode/decode, card vs CPU")

    # Bulk encode CLI path: 2 batches of 4 Sen2NAIP pairs, both images of each encoded.
    batches = sen2naip_batches(2, 4, seed=2)
    enc_dir = ROOT / "build" / "chip_smoke_encode"
    (n_aoi, stats), _ = drive("encode_split 2 x 4 Sen2NAIP pairs at 512²",
                              lambda: run_encode_split(model, batches, enc_dir),
                              launches(80, 88, 4))
    check_encode_split(n_aoi, stats, enc_dir, expected=8)
    stamp("phase 3: encode_split")

    scene = np.random.default_rng(3).standard_normal((12, 1024, 1024)).astype(np.float32)
    tiled, _ = drive("tiled_reconstruct [12,1024,1024] tile 256 overlap 32 batch 16",
                     lambda: tiled_reconstruct(model, scene, s2, tile=256, overlap=32,
                                               batch_size=16), launches(96, 104, 4))
    if tiled.shape != scene.shape or not np.isfinite(tiled).all():
        raise AssertionError("tiled_reconstruct gave a wrong shape or non-finite values")
    print(f"tiled_reconstruct: out {tiled.shape}, finite")
    stamp("phase 3: tiled_reconstruct")

    # ---- 4. times ----------------------------------------------------------------
    x256 = torch.randn(16, 12, 256, 256, generator=g, device=dev)
    for label, x, iters in (("256px B=16", x256, 10), ("512px B=4", x512, 10)):
        ms = cuda_ms(lambda: model.reconstruct(x, s2), iters)
        print(f"time reconstruct {label}: {ms:.3f} ms/call, {x.shape[0] * 1e3 / ms:.2f} imgs/s "
              f"[{card}]")
    del x256

    for compress in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_encode_split(model, batches, enc_dir, compress=compress)
        seconds = time.perf_counter() - t0
        print(f"time encode_split 8 AOIs at 512² (compress={compress}): {seconds:.3f} s, "
              f"{8 / seconds:.2f} AOIs/s [{card}]")
    shutil.rmtree(enc_dir, ignore_errors=True)
    stamp("phase 4: reconstruct and encode_split times")

    profile_kernels(f"reconstruct {tuple(x512.shape)}", lambda: model.reconstruct(x512, s2), card)
    stamp("phase 4: reconstruct profile")

    timings = {}
    attn_rates = []  # [B, S, D] each: TFLOP/s and the L2 traffic of the kernel's blocks
    for shape in ((16, 1024, 512), (4, 4096, 512)):
        q, k, v = qkv(*shape, torch.bfloat16)
        with torch.inference_mode():
            kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 20)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        b, s, d = shape
        flops = 4.0 * b * s * s * d
        # Each block of 64 query rows reads all of K and V of its image: B·S²·D/16 bytes.
        l2_bytes = b * -(-s // 64) * 2.0 * s * d * q.element_size()
        timings["flash_attention", shape] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            **bound(flops, H100_BF16_FLOPS, 4.0 * b * s * d * q.element_size()))
        attn_rates.append(dict(shape=list(shape), ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                               library_ms=library_ms, library_tflops=flops / library_ms / 1e9,
                               bound_ms=timings["flash_attention", shape]["bound_ms"],
                               l2_bytes=l2_bytes, l2_tb_per_s=l2_bytes / kernel_ms / 1e9))
        print(f"time flash_attention {list(shape)} bf16: kernel {kernel_ms:.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s; L2 {l2_bytes / 1e9:.3f} GB at "
              f"{l2_bytes / kernel_ms / 1e9:.2f} TB/s), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {timings['flash_attention', shape]['bound_ms']:.4f} ms "
              f"[{card}]")
        del q, k, v

    # GroupNorm + swish (ResnetBlock norm1) at the main path's largest activation.
    shape = (4, 128, 512, 512)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=dev)
    bias = 0.1 * torch.randn(shape[1], generator=g, device=dev)
    wb, bb = w.bfloat16(), bias.bfloat16()
    kernel_ms = cuda_ms(lambda: group_norm(x, w, bias, swish=True), 20)
    plain_ms = cuda_ms(lambda: group_norm_plain(x, w, bias, swish=True), 20)
    library_ms = cuda_ms(lambda: F.silu(F.group_norm(x, 32, wb, bb, 1e-6)), 20)
    timings["group_norm", shape] = dict(
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(GN_FLOPS_PER_ELEMENT * x.numel(), H100_F32_FLOPS, 2.0 * x.numel() * 2))
    print(f"time group_norm+swish {list(shape)} bf16: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.group_norm+F.silu {library_ms:.4f} ms, bound "
          f"{timings['group_norm', shape]['bound_ms']:.4f} ms "
          f"({4.0 * x.numel() / kernel_ms / 1e6:.0f} GB/s of the least traffic) [{card}]")
    del x

    conv_rates = []  # [B, Ci, Co, H, W] each: kernel and cuDNN TFLOP/s
    for shape in ((4, 128, 128, 512, 512), (4, 512, 256, 256, 256), (4, 512, 512, 64, 64)):
        x, w, bias = conv_inputs(*shape, torch.bfloat16, g)
        wb, bb = w.bfloat16(), bias.bfloat16()
        kernel_ms = cuda_ms(lambda: conv3x3(x, w, bias), 10)
        plain_ms = cuda_ms(lambda: conv3x3_plain(x, w, bias), 5)
        library_ms = cuda_ms(lambda: F.conv2d(x, wb, bb, padding=1), 10)
        b, ci, co, h, wd = shape
        flops = 2.0 * b * h * wd * 9 * ci * co
        nbytes = 2.0 * (x.numel() + w.numel() + co + b * co * h * wd)
        timings["conv3x3", shape] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                         **bound(flops, H100_BF16_FLOPS, nbytes))
        conv_rates.append(dict(shape=list(shape), ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
                               library_ms=library_ms, library_tflops=flops / library_ms / 1e9,
                               bound_ms=timings["conv3x3", shape]["bound_ms"]))
        print(f"time conv3x3 {list(shape)} bf16: kernel {kernel_ms:.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN "
              f"{library_ms:.4f} ms ({flops / library_ms / 1e9:.1f} TFLOP/s), bound "
              f"{timings['conv3x3', shape]['bound_ms']:.4f} ms [{card}]")
        del x, w, bias
    stamp("phase 4: times")

    train_counts, bwd_errs, bwd_timings = train_phase(sd, card, g)
    synthetic_ms = trainer_phase(sd, card, bwd_timings["train_step_ms"])
    data_phase(card, synthetic_ms)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/flash_attention.cu",
         "replaces": "eovax/kernels/attention.py:28",
         "launches": main_launches["flash_attention"], "max_abs_err": attn_err,
         **timings["flash_attention", (4, 4096, 512)], "shapes": attn_rates},
        {"name": "group_norm", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/groupnorm.cu",
         "replaces": "eovax/kernels/groupnorm.py:31",
         "launches": main_launches["group_norm"],
         "max_abs_err": gn_errs[(4, 128, 512, 512)]["swish"],
         **timings["group_norm", (4, 128, 512, 512)]},
        {"name": "conv3x3", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/conv3x3.cu",
         "replaces": "eovax/kernels/conv3x3.py:53",
         "launches": main_launches["conv3x3"],
         "max_abs_err": conv_errs[(4, 512, 256, 256, 256)],
         **timings["conv3x3", (4, 512, 256, 256, 256)], "shapes": conv_rates},
        {"name": "conv3x3_dx", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/conv3x3.cu",
         "replaces": "eovax/kernels/conv3x3.py:186",
         "launches": train_counts["conv3x3_dx"],
         "max_abs_err": bwd_errs["conv3x3_dx", (16, 128, 128, 256, 256)],
         **bwd_timings["conv3x3_dx"]},
        {"name": "group_norm_backward", "route": "cuda",
         "source": "eovax_torch/kernels/csrc/groupnorm.cu",
         "replaces": "eovax/kernels/groupnorm.py:124",
         "launches": train_counts["group_norm_backward"],
         "max_abs_err": bwd_errs["group_norm_backward", (16, 128, 256, 256)]["swish"],
         **bwd_timings["group_norm_backward", (16, 128, 256, 256)],
         "shapes": [dict(shape=list(shape), **bwd_timings["group_norm_backward", shape])
                    for shape in ((16, 128, 256, 256), (16, 256, 256, 256))]},
    ]
    print(f"wall time: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port of the EO-VAE on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Report the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build every kernel of ``eovax_torch/kernels/csrc`` with
   ``nvcc`` (all sources at once).
2. Hold each kernel against its plain PyTorch version on the card: at the
   main path's shapes, at an odd sequence length, in fp32, and on the real
   q/k/v of an encoder ``mid.attn_1`` call captured with a forward hook.
3. Drive the main path at full width: the shipped architecture (ch=128,
   ch_mult (1,2,4,4), 2 res blocks, z=32, wavelength stems with 4 layers
   and 256 planes), 12-band S2L2A input, bf16 ``DEFAULT_POLICY``, weights
   N(0, 0.02) from a seed. ``reconstruct`` of a [4, 12, 512, 512] batch must
   launch the attention kernel exactly twice (encoder and decoder mid
   blocks); the Sen2NAIP bulk-encode pass (``encode_spatial_normalized`` then
   ``decode_spatial_normalized`` of a [4, 4, 512, 512] batch) twice more.
   The full-width model on a small input is held against the same weights
   on the CPU.
4. Time ``reconstruct`` and each kernel with CUDA events after warm-up,
   break one 512² ``reconstruct`` down by kernel with ``torch.profiler``, and
   print one ``{"kernels": [...]}`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits with an error before any result.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time

# Tolerances, each relative to max |reference|.
#  bf16: one bf16 rounding of the output (2^-8) plus P rounded to bf16
#        before P·V; 2e-2 leaves room for the sum over S keys.
#  fp32: fp32 FMA in another summation order and exp2 for exp, ~1e-6 seen.
TOL_BF16 = 2e-2
TOL_F32 = 1e-4
#  Full model, fp32 on the card (TF32 off) vs fp32 on the CPU: about 60
#  conv layers summed in other orders.
TOL_MODEL_F32 = 1e-3
#  Full model, bf16 on the card vs fp32 on the CPU: bf16 activations
#  between every layer.
TOL_MODEL_BF16 = 1e-1

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_BYTES_PER_S = 3.35e12


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


def profile_reconstruct(model, x, wvs, card: str, calls: int = 2) -> None:
    """Kernel time by name over ``calls`` reconstructs (torch.profiler, kernel
    rows only), and the device-busy share of the profiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            model.reconstruct(x, wvs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    print(f"profile reconstruct {tuple(x.shape)}: wall {wall_ms:.3f} ms/call (profiler on), "
          f"kernels {busy_ms:.3f} ms/call, device busy {busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:16]:
        ms = e.self_device_time_total / 1e3 / calls
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count // calls:<4d} {e.key[:96]}")
    ours = sum(e.self_device_time_total for e in kernels if "flash_" in e.key) / 1e3 / calls
    print(f"  flash_attention kernels: {ours:.3f} ms/call, {100 * ours / busy_ms:.2f}% of kernel time")


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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {line.strip()}")
    return seconds


def check_attention(q, k, v, tol: float, label: str) -> float:
    """Kernel vs plain on the same inputs; returns the max abs error."""
    import torch

    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain

    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v)
    err, rel = rel_err(out, ref)
    ok = bool(torch.isfinite(out).all()) and rel <= tol
    print(f"kernel-vs-plain flash_attention {label} {tuple(q.shape)} {q.dtype}: "
          f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version at {label}")
    return err


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from eovax_torch import EOFluxVAE
    from eovax_torch.core.precision import DEFAULT_POLICY, FULL_PRECISION
    from eovax_torch.data.wavelengths import SEN2NAIP_WAVELENGTHS, wavelengths_for
    from eovax_torch.kernels import attention
    from eovax_torch.kernels.attention import flash_attention, flash_attention_plain

    t_start = time.perf_counter()
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

    main_err = check_attention(*qkv(4, 4096, 512, torch.bfloat16), TOL_BF16, "512px-B4")
    check_attention(*qkv(16, 1024, 512, torch.bfloat16), TOL_BF16, "256px-B16")
    check_attention(*qkv(3, 1037, 512, torch.bfloat16), TOL_BF16, "odd-S")
    check_attention(*qkv(2, 1037, 512, torch.float32), TOL_F32, "odd-S-fp32")

    # ---- 3. main path at full width ------------------------------------------
    model = EOFluxVAE(shipped_config(12), policy=DEFAULT_POLICY, device=dev, seed=0)
    sd = bench_state_dict(model, seed=0)
    model.core.load_state_dict(sd)
    print(f"model: {model.param_count()} params, bf16 compute, S2L2A 12 bands")
    s2 = wavelengths_for("S2L2A")
    naip = SEN2NAIP_WAVELENGTHS
    x512 = torch.randn(4, 12, 512, 512, generator=g, device=dev)

    captured = []
    hook = model.core.encoder.mid.attn_1.register_forward_hook(
        lambda mod, args, out: captured.append(args[0].clone()))
    model.reconstruct(x512, s2)  # warm-up, and the hook's capture
    hook.remove()
    attn = model.core.encoder.mid.attn_1
    with torch.inference_mode():
        check_attention(*attn.qkv(captured[0]), TOL_BF16, "encoder-mid-attn_1-captured")

    attention.flash_attention.launches = 0
    recon = model.reconstruct(x512, s2)
    torch.cuda.synchronize()
    main_launches = attention.flash_attention.launches
    print(f"main path reconstruct [4,12,512,512]: out {tuple(recon.shape)} {recon.dtype}, "
          f"flash_attention launches {main_launches}")
    if tuple(recon.shape) != (4, 12, 512, 512) or not torch.isfinite(recon).all():
        raise AssertionError("reconstruct gave a wrong shape or non-finite values")
    if main_launches != 2:
        raise AssertionError(f"expected 2 flash_attention launches, got {main_launches}")

    x_naip = torch.randn(4, 4, 512, 512, generator=g, device=dev)
    attention.flash_attention.launches = 0
    z = model.encode_spatial_normalized(x_naip, naip)
    recon_naip = model.decode_spatial_normalized(z, naip)
    torch.cuda.synchronize()
    bulk_launches = attention.flash_attention.launches
    print(f"bulk encode/decode [4,4,512,512]: latent {tuple(z.shape)}, out "
          f"{tuple(recon_naip.shape)}, flash_attention launches {bulk_launches}")
    if (tuple(z.shape) != (4, 32, 64, 64) or tuple(recon_naip.shape) != (4, 4, 512, 512)
            or not (torch.isfinite(z).all() and torch.isfinite(recon_naip).all())):
        raise AssertionError("bulk encode/decode gave a wrong shape or non-finite values")
    if bulk_launches != 2:
        raise AssertionError(f"expected 2 flash_attention launches, got {bulk_launches}")

    # Same weights on a small input: card (fp32 and bf16) vs CPU fp32.
    x_small = torch.randn(1, 12, 64, 64, generator=torch.Generator().manual_seed(1))
    ref = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device="cpu").reconstruct(
        x_small, s2)
    gpu32 = EOFluxVAE(shipped_config(12), sd, policy=FULL_PRECISION, device=dev)
    for label, out, tol in (("fp32", gpu32.reconstruct(x_small, s2), TOL_MODEL_F32),
                            ("bf16", model.reconstruct(x_small, s2), TOL_MODEL_BF16)):
        err, rel = rel_err(out.cpu(), ref)
        ok = rel <= tol and bool(torch.isfinite(out).all())
        print(f"full model {label} on the card vs fp32 on the CPU [1,12,64,64]: "
              f"max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"full model ({label}) disagrees with the CPU reference")
    del gpu32

    # ---- 4. times ----------------------------------------------------------------
    x256 = torch.randn(16, 12, 256, 256, generator=g, device=dev)
    for label, x, iters in (("256px B=16", x256, 10), ("512px B=4", x512, 10)):
        ms = cuda_ms(lambda: model.reconstruct(x, s2), iters)
        print(f"time reconstruct {label}: {ms:.3f} ms/call, {x.shape[0] * 1e3 / ms:.2f} imgs/s "
              f"[{card}]")

    profile_reconstruct(model, x512, s2, card)

    # Both shapes the main path gives the kernel; the 512² one goes in the JSON line.
    timings = {}
    for shape in ((16, 1024, 512), (4, 4096, 512)):
        q, k, v = qkv(*shape, torch.bfloat16)
        with torch.inference_mode():
            kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 20)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        b, s, d = shape
        flops = 4.0 * b * s * s * d
        nbytes = 4.0 * b * s * d * q.element_size()
        t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        timings[shape] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                              bound_by="operations" if t_ops >= t_bytes else "bytes",
                              library_ms=library_ms)
        print(f"time flash_attention {list(shape)} bf16: kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms "
              f"({flops / kernel_ms / 1e9:.1f} TFLOP/s) [{card}]")

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "eovax_torch/kernels/csrc/flash_attention.cu",
        "replaces": "eovax/kernels/attention.py:28",
        "launches": main_launches,
        "max_abs_err": main_err,
        **timings[(4, 4096, 512)],
    }]
    print(f"wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the int8 (W8A8) conv3x3 kernel spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/conv3x3_int8.cu``, each the
kernel with one part changed or taken out by a text edit of the source, and
times each with CUDA events at the main path's three shapes (the same as
``chip_smoke.py`` phase 16) and at the int8 SR UNet's shapes of an LR 128²
call at B = 4 (its 256- and 128-channel levels on 16² and 8² latent planes,
where the 64-column tile computes 16 or 8 columns):

- ``kernel``: the source as it is (also held against the plain version);
- ``no-slab``: the slab of each K chunk after the first two is neither
  loaded nor quantized nor stored, so the time is that of the weights'
  copies, the products and the barriers (wrong results);
- ``no-weights``: the weights of each K chunk after the first two are not
  copied (wrong results): the time without their traffic from L2;
- ``no-halo``: the slab's two halo columns are not loaded (zeros; wrong
  results): the time without their 2-byte loads, one 32-byte sector each;
- ``cached-slab``: every K chunk after the first three loads chunk 2's slab
  again (wrong results): the same loads, but from the cache;
- ``no-products``: the wgmma products are dropped (wrong results);
- ``no-quantize``: the slab is stored unquantized, the top byte of each value
  (wrong results): the time without the quantization's arithmetic;
- ``three-stages``: a ring of 3 stages in place of 4, so a chunk's weights
  are copied while only one chunk of products runs;
- ``parent`` (with ``--parent``): the kernel of another revision, built from
  ``git show <rev>:eovax_torch/kernels/csrc/conv3x3_int8.cu`` (or from a file
  holding that source, where the checkout has no git), with the weights in the
  layout that revision's wrapper made: a same-run comparison.

Beside them, ``torch._int_mm`` on pre-made int8 operands of the equivalent
GEMM (M = B·H·W, K = 9·Ci, N = Co) as a yardstick of the card's library int8
GEMM rate (``int_mm_ms``; it computes no conv).

The variants that must stay exact are held against the plain version at each
shape and on every finite bf16 value at four activation ranges (a one-hot
centre tap, so each output is one quantized input). Each shape times every
variant in order and then in reverse, on the same inputs.

Each line gives the time, TOP/s and the share of the int8 bound (1,979 TOP/s,
NVIDIA's data sheet), with the card's name and power limit; ``ptxas``
registers, spills and wgmma serialization warnings (C7515) are printed per
variant. The variants are built with the package's nvcc flags into
``build/ablate_conv3x3_int8/``.

    python3 scripts/ablate_conv3x3_int8.py [--parent REV_OR_FILE]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import build, qconv  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate_conv3x3_int8"
SHAPES = ((4, 512, 256, 256, 256), (4, 128, 128, 512, 512), (4, 512, 512, 64, 64),
          (4, 256, 256, 16, 16), (4, 512, 256, 16, 16), (4, 128, 128, 8, 8), (4, 256, 128, 8, 8))
INT8_OPS = 1979e12

_REFILL = """      store_slab(smem + stage + kWBytes, regs, tid, q);
      if (refill + 1 < nchunks) load_slab(regs, xb, s, (refill + 1) * kKC, y0, x0, tid, q);
"""
_WEIGHTS = "      load_weights(smem_u + stage, wt, s, co0, refill * kKC, tid);\n"
_HALO = "    if (y >= 0 && y < s.H && xx >= 0 && xx < s.W) {\n      const unsigned short* p"
_NEXT = "load_slab(regs, xb, s, (refill + 1) * kKC, y0, x0, tid, q);"
_PRODUCTS = "  mma_steps(acc, lo_a, lo_b, first, std::make_integer_sequence<int, 9 * kWGRows>{});\n"
_QUOTIENT = """  f = fminf(fmaxf(f, -q.lim), q.lim);
  const float q0 = __fmul_rn(f, q.rsx);
  const float t = __fmaf_rn(__fmaf_rn(-q0, q.sx, f), q.rsx, q0);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
"""
VARIANTS = {
    "kernel": [],
    "no-slab": [(_REFILL, "")],
    "no-weights": [(_WEIGHTS, "")],
    "no-halo": [(_HALO, _HALO.replace("y >= 0 && y < s.H && xx >= 0 && xx < s.W", "tid < 0"))],
    "cached-slab": [(_NEXT, _NEXT.replace("(refill + 1) * kKC", "(kStages - 2) * kKC"))],
    "no-products": [(_PRODUCTS, "")],
    "no-quantize": [(_QUOTIENT, "  return __float_as_uint(f) >> 24;\n")],
    "three-stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
}
EXACT = ("kernel", "three-stages", "parent")


def parent_layout(wq):
    """The weights as the wrapper before the wgmma kernel laid them out:
    [Ci/32, 3, 3, Co, 32] int8."""
    co, ci = wq.shape[:2]
    return wq.reshape(co, ci // 32, 32, 3, 3).permute(1, 3, 4, 0, 2).contiguous()


def parent_source(spec: str) -> str:
    """The kernel's source at a git revision, or in a file."""
    if Path(spec).is_file():
        return Path(spec).read_text()
    return subprocess.run(["git", "show", f"{spec}:eovax_torch/kernels/csrc/{qconv.SOURCE}"],
                          cwd=ROOT, capture_output=True, text=True, check=True).stdout


def variant_source(edits) -> str:
    src = (build.CSRC / qconv.SOURCE).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not match the source once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(item: tuple[str, str]) -> tuple[str, ctypes.CDLL, str]:
    name, src = item
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.eovax_conv3x3_int8_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log = (proc.stdout + proc.stderr).splitlines()
    # The bf16 kernel's lines: its entry name holds the bf16 type.
    at = next(i for i, line in enumerate(log) if "Compiling entry" in line and "bfloat16" in line)
    ptxas = [line.strip() for line in log[at:at + 4] if "registers" in line or "spill" in line]
    c7515 = sum("C7515" in line for line in log)
    return name, lib, "; ".join(ptxas) + f"; C7515 warnings: {c7515}"


def check_every_bf16(name: str, lib, layout, dev) -> None:
    """Every finite bf16 value through the variant at four ranges, against the
    plain version: the identity over 32 channels at the centre tap, unit scales."""
    import torch

    from chip_smoke import every_bf16

    x = every_bf16(dev)
    wq = torch.zeros(32, 32, 3, 3, dtype=torch.int8, device=dev)
    wq[torch.arange(32), torch.arange(32), 1, 1] = 1
    sw = torch.ones(32, device=dev)
    wt = layout(wq)
    out = torch.empty_like(x)
    for amax in (1.0, 3.7, 1e-3, 300.0):
        a = torch.tensor(amax, device=dev)
        code = lib.eovax_conv3x3_int8_bf16(x.data_ptr(), wt.data_ptr(), sw.data_ptr(), None,
                                           a.data_ptr(), out.data_ptr(), 1, 32, 32, x.shape[2],
                                           64, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if code != 0 or not torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw, None, a)):
            raise AssertionError(f"{name}: every-bf16 check failed at amax {amax} (code {code})")
    print(f"  {name}: every finite bf16 value at amax 1, 3.7, 1e-3, 300: torch.equal to the "
          "plain version")


def events_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def int_mm_ms(shape, dev) -> float:
    """``torch._int_mm`` of pre-made int8 operands at the conv's GEMM: A [M, K]
    row-major, B [K, N] column-major, int32 out."""
    import torch

    b, ci, co, h, w = shape
    m, k = b * h * w, 9 * ci
    g = torch.Generator(device=dev).manual_seed(1)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8, device=dev)
    bt = torch.randint(-127, 128, (co, k), generator=g, dtype=torch.int8, device=dev).t()
    ms = events_ms(lambda: torch._int_mm(a, bt))
    del a, bt
    torch.cuda.empty_cache()
    return ms


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a git revision, or a file holding its kernel source")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate_conv3x3_int8: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(edits) for name, edits in VARIANTS.items()}
    layouts = {name: qconv.int8_weight_layout for name in sources}
    if args.parent:
        sources["parent"] = parent_source(args.parent)
        layouts["parent"] = parent_layout
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build_variant, sources.items()))
    dev = torch.device("cuda")
    libs = {}
    for name, lib, ptxas in built:
        print(f"{name}: ptxas {ptxas}")
        if name in EXACT:
            check_every_bf16(name, lib, layouts[name], dev)
        libs[name] = lib
    stream = torch.cuda.current_stream().cuda_stream
    for shape in SHAPES:
        b, ci, co, h, w = shape
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(b, ci, h, w, generator=g, device=dev).to(torch.bfloat16)
        wq, sw = qconv.quantize_symmetric(0.05 * torch.randn(co, ci, 3, 3, generator=g,
                                                             device=dev), dim=(1, 2, 3))
        sw = sw.reshape(-1)
        bias = torch.randn(co, generator=g, device=dev)
        amax = torch.linalg.vector_norm(x, float("inf")).float()
        out = torch.empty(b, co, h, w, device=dev, dtype=torch.bfloat16)
        ref = qconv.conv3x3_int8_plain(x, wq, sw, bias, amax)
        ops = 2.0 * b * h * w * 9 * ci * co
        times: dict[str, list[float]] = {}
        for name in (*libs, *reversed(libs)):
            wt = layouts[name](wq)

            def call(fn=libs[name].eovax_conv3x3_int8_bf16, wt=wt, name=name):
                code = fn(x.data_ptr(), wt.data_ptr(), sw.data_ptr(), bias.data_ptr(),
                          amax.data_ptr(), out.data_ptr(), b, ci, co, h, w, stream)
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            if name in EXACT and name not in times:
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} disagrees with the plain version at {shape}")
            times.setdefault(name, []).append(events_ms(call))
        for name, (first, second) in times.items():
            ms = (first + second) / 2
            equal = ", torch.equal to the plain version" if name in EXACT else ""
            print(f"  {name} {list(shape)}: {ms:.4f} ms ({first:.4f} / {second:.4f} in order and "
                  f"reversed), {ops / ms / 1e9:.1f} TOP/s, {100 * ops / INT8_OPS * 1e3 / ms:.1f}% "
                  f"of the int8 bound{equal} [{card}]")
        del x, out, ref
        mm = int_mm_ms(shape, dev)
        print(f"  int_mm_ms {list(shape)}: {mm:.4f} ms, torch._int_mm [{b * h * w}, {9 * ci}] x "
              f"[{9 * ci}, {co}], {ops / mm / 1e9:.1f} TOP/s, "
              f"{100 * ops / INT8_OPS * 1e3 / mm:.1f}% of the int8 bound (a GEMM yardstick, "
              f"no conv) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the int8 (W8A8) conv3x3 kernel spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/conv3x3_int8.cu``, each the
kernel with one part changed or taken out by a text edit of the source, and
times each with CUDA events at the main path's three shapes (the same as
``chip_smoke.py`` phase 16):

- ``kernel``: the source as it is (also held against the plain version);
- ``no-slab``: the slab of each K chunk after the first is not loaded, so the
  time is that of the weights' copies, the products and the barriers (wrong
  results);
- ``no-products``: the mma.sync products are dropped (wrong results);
- ``reciprocal``: the quantization's product with the reciprocal without its
  FMA correction (results off by a step where the two round apart);
- ``ieee-division``: the quotient by ``__fdiv_rn`` (an IEEE division with its
  range check, a call a value) in place of the corrected product;
- ``one-block``: ``__launch_bounds__(256, 1)``: registers unbounded by a
  second block an SM, one block an SM;
- ``lds32``: the fragments read with 32-bit shared loads in place of
  ``ldmatrix.x4``.

The variants that must stay exact are held against the plain version at each
shape and on every finite bf16 value at four activation ranges (a one-hot
centre tap, so each output is one quantized input).

Each line gives the time, TOP/s and the share of the int8 bound (1,979 TOP/s,
NVIDIA's data sheet), with the card's name and power limit; ``ptxas``
registers and spills are printed per variant. The variants are built with the
package's nvcc flags into ``build/ablate_conv3x3_int8/``.

    python3 scripts/ablate_conv3x3_int8.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import build, qconv  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate_conv3x3_int8"
SHAPES = ((4, 512, 256, 256, 256), (4, 128, 128, 512, 512), (4, 512, 512, 64, 64))
INT8_OPS = 1979e12

_BOUNDS = ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")
_PRODUCTS = """        mma_s8(acc[0][j], a[0], b[0], b[1]);
        mma_s8(acc[1][j], a[1], b[0], b[1]);
        mma_s8(acc[0][j + 1], a[0], b[2], b[3]);
        mma_s8(acc[1][j + 1], a[1], b[2], b[3]);
"""
_QUOTIENT = "  int v = __float2int_rn(__fmaf_rn(__fmaf_rn(-q0, sx, f), rsx, q0));\n"
_LDMATRIX = """      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], sa + 4 * swz((wm + dy) * kSlabW + 16 * i + dx + lr + 8 * (lm & 1),
                                   4 * (lm >> 1)));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, sb + 4 * swz(tap * kBN + wn * 64 + 8 * j + lr + 8 * (lm >> 1), 4 * (lm & 1)));
"""
_LDS32 = """      const uint32_t* slab = reinterpret_cast<const uint32_t*>(smem + stage * kStageBytes);
      const uint32_t* wsm = slab + kSlabBytes / 4;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pa = (wm + dy) * kSlabW + 16 * i + dx + g, pb = pa + 8;
        a[i][0] = slab[swz(pa, tg)];
        a[i][1] = slab[swz(pb, tg)];
        a[i][2] = slab[swz(pa, tg + 4)];
        a[i][3] = slab[swz(pb, tg + 4)];
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int n = tap * kBN + wn * 64 + 8 * (j + t) + g;
          b[2 * t] = wsm[swz(n, tg)];
          b[2 * t + 1] = wsm[swz(n, tg + 4)];
        }
"""
VARIANTS = {
    "kernel": [],
    "no-slab": [("    if (cc + 1 < chunks)\n      load_slab(", "    if (cc < 0)\n      load_slab(")],
    "no-products": [(_PRODUCTS, "        acc[0][j][0] += a[0][0] ^ b[0];\n"
                                "        acc[1][j][1] += a[1][1] ^ b[3];\n")],
    "reciprocal": [(_QUOTIENT, "  int v = __float2int_rn(q0);\n")],
    "ieee-division": [(_QUOTIENT, "  int v = __float2int_rn(__fdiv_rn(f, sx));\n")],
    "one-block": [_BOUNDS],
    "lds32": [(_LDMATRIX, _LDS32)],
}
EXACT = ("kernel", "ieee-division", "one-block", "lds32")


def variant_source(edits) -> str:
    src = (build.CSRC / qconv.SOURCE).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not match the source once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple[str, ctypes.CDLL, str]:
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(variant_source(VARIANTS[name]))
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
    return name, lib, "; ".join(ptxas)


def check_every_bf16(name: str, lib, dev) -> None:
    """Every finite bf16 value through the variant at four ranges, against the
    plain version: the identity over 32 channels at the centre tap, unit scales."""
    import torch

    from chip_smoke import every_bf16

    x = every_bf16(dev)
    wq = torch.zeros(32, 32, 3, 3, dtype=torch.int8, device=dev)
    wq[torch.arange(32), torch.arange(32), 1, 1] = 1
    sw = torch.ones(32, device=dev)
    wt = wq.reshape(32, 1, 32, 3, 3).permute(1, 3, 4, 0, 2).contiguous()
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_conv3x3_int8: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build_variant, VARIANTS))
    dev = torch.device("cuda")
    for name, lib, ptxas in built:
        print(f"{name}: ptxas {ptxas}")
        if name in EXACT:
            check_every_bf16(name, lib, dev)
        for shape in SHAPES:
            b, ci, co, h, w = shape
            g = torch.Generator(device=dev).manual_seed(0)
            x = torch.randn(b, ci, h, w, generator=g, device=dev).to(torch.bfloat16)
            wq, sw = qconv.quantize_symmetric(0.05 * torch.randn(co, ci, 3, 3, generator=g,
                                                                 device=dev), dim=(1, 2, 3))
            sw = sw.reshape(-1)
            bias = torch.randn(co, generator=g, device=dev)
            amax = torch.linalg.vector_norm(x, float("inf")).float()
            wt = wq.reshape(co, ci // 32, 32, 3, 3).permute(1, 3, 4, 0, 2).contiguous()
            out = torch.empty(b, co, h, w, device=dev, dtype=torch.bfloat16)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                code = lib.eovax_conv3x3_int8_bf16(
                    x.data_ptr(), wt.data_ptr(), sw.data_ptr(), bias.data_ptr(), amax.data_ptr(),
                    out.data_ptr(), b, ci, co, h, w, stream)
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            for _ in range(2):
                call()
            equal = ""
            if name in EXACT:
                torch.cuda.synchronize()
                same = torch.equal(out, qconv.conv3x3_int8_plain(x, wq, sw, bias, amax))
                if not same:
                    raise AssertionError(f"{name} disagrees with the plain version at {shape}")
                equal = ", torch.equal to the plain version"
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 10
            ops = 2.0 * b * h * w * 9 * ci * co
            print(f"  {name} {list(shape)}: {ms:.4f} ms, {ops / ms / 1e9:.1f} TOP/s, "
                  f"{100 * ops / INT8_OPS * 1e3 / ms:.1f}% of the int8 bound{equal} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

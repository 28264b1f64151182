"""Where the bf16 flash-attention kernel spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/flash_attention.cu``, each the
kernel with one part taken out by a text edit of the source, and times each
with CUDA events at the main path's two shapes, [16,1024,512] and
[4,4096,512]:

- ``kernel``: the source as it is (also held against the plain version);
- ``no-loads``: K and V are loaded once, before the loop, and the loop's
  copies are dropped, so the time is that of the products, the softmax and
  the barriers (wrong results);
- ``no-products``: both wgmma sequences are dropped, so the time is that of
  the K/V copies, the softmax and the barriers (wrong results);
- ``unrolled-loader``: the tile loader fully unrolled.

Each line gives the time, TFLOP/s, and the rate of the L2 traffic the
blocks need (each block of 64 query rows reads all of K and V of its image:
B·S²·D/16 bytes), with the card's name and power limit. The variants are
built with the package's nvcc flags into ``build/ablate_flash_attention/``;
``ptxas`` registers and spills are printed per variant.

    python3 scripts/ablate_flash_attention.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import attention, build  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate_flash_attention"
SHAPES = ((16, 1024, 512), (4, 4096, 512))

_V_LOAD = "    load_tile<D>(sV, vb, j * kBK, S, tid);\n"
_K_LOAD = "    if (j + 1 < ntiles) load_tile<D>(sK, kb, (j + 1) * kBK, S, tid);\n"
_PROLOGUE = "  cp_async_commit();  // group: Q, K_0\n"
_QK = "    qk_steps(s, lo_q, lo_k, std::make_integer_sequence<int, D / 32>{});\n"
_PV = ("    pv_steps<D / 2>(acc, p, lo_v, j == 0 ? 1u : 0u, "
       "std::make_integer_sequence<int, kBK / 16>{});\n")
VARIANTS = {
    "kernel": [],
    "no-loads": [(_V_LOAD, ""), (_K_LOAD, ""),
                 (_PROLOGUE, "  load_tile<D>(sV, vb, 0, S, tid);\n" + _PROLOGUE)],
    "no-products": [(_QK, ""), (_PV, "    acc[0] += __uint_as_float(p[0][0] ^ p[3][3]);\n")],
    "unrolled-loader": [("#pragma unroll 4  // unrolled fully",
                         "#pragma unroll  // unrolled fully")],
}


def variant_source(edits) -> str:
    src = (build.CSRC / attention.SOURCE).read_text()
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
    lib.eovax_flash_attention_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 2
    lib.eovax_flash_attention_bf16.restype = ctypes.c_int
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "Used" in line and "2 barriers" in line]  # the bf16 kernels use two barriers
    spills = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes")]
    return name, lib, "; ".join(ptxas + spills)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_attention: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build_variant, VARIANTS))
    dev = torch.device("cuda")
    for name, lib, ptxas in built:
        print(f"{name}: ptxas {ptxas}")
        for b, s, d in SHAPES:
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(b, s, d, generator=g, device=dev, dtype=torch.bfloat16)
                       for _ in range(3))
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                code = lib.eovax_flash_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                      out.data_ptr(), b, s, d, None, stream)
                if code != 0:
                    raise RuntimeError(f"{name}: CUDA error {code}")

            for _ in range(3):
                call()
            if name == "kernel":
                torch.cuda.synchronize()
                ref = attention.flash_attention_plain(q, k, v).float()
                rel = (out.float() - ref).abs().max().item() / ref.abs().max().item()
                if rel > 2e-2:
                    raise AssertionError(f"kernel disagrees with the plain version: rel {rel:.3e}")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            l2_bytes = b * -(-s // 64) * 2.0 * s * d * 2
            print(f"  {name} [{b},{s},{d}] bf16: {ms:.4f} ms, {4.0 * b * s * s * d / ms / 1e9:.1f} "
                  f"TFLOP/s, L2 {l2_bytes / ms / 1e9:.2f} TB/s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

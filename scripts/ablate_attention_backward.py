"""Where the bf16 attention backward spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/flash_attention_bwd.cu``, each the
source with one part of the `wgmma` kernels changed by a text edit, and times
them with CUDA events at the pixel SR UNet's [4,16384,64] and the flow
refiner's [16,4096,128]:

- ``kernel``: the source as it is. Its wgmma kernels (Δ with the padded
  statistics, dK/dV, dQ: the wrapper's route at D = 64 and 128) are timed
  whole and each alone, beside the `mma.sync` kernels of the same library
  called at the same D (the wrapper sends them only wider widths), in turns
  (wgmma, mma.sync, wgmma, mma.sync). The two are held against each other at
  the timed shapes and against the plain version at [2,1000,D];
- ``no-exps``: the exp2 of P replaced by its argument, so the time is that of
  everything else (wrong results);
- ``no-updates``: the update products (dV += Pᵀ·dO, dK += dSᵀ·Q, dQ += dS·K)
  dropped, so the time is that of the loads, S, dP, P and dS (wrong results);
- ``groups-1`` / ``groups-2``: one / two consumer warpgroups a block in both
  kernels at both widths (the source takes two, but one for dK/dV at
  D = 128);
- ``no-setmaxnreg``: a producer warp that keeps the kernel's registers instead
  of a producer warpgroup that hands its down to the consumers (setmaxnreg),
  also with two warpgroups at both widths (``groups-2-no-setmaxnreg``);
- ``two-stages``: a ring of two streamed tiles instead of three.

Each line gives the time, the TFLOP/s of the products the kernels compute (7
of 2·B·S²·D for the whole backward, 4 for dK/dV, 3 for dQ) and the card's name
and power limit; each variant's `ptxas` registers and spills for its wgmma
kernels are printed first. A variant that the card refuses (for instance a
register count below what setmaxnreg hands out) is printed with its error.
The variants are built with the package's nvcc flags into
``build/ablate_attention_backward/``:

    python3 scripts/ablate_attention_backward.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import attention, build  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate_attention_backward"
SHAPES = ((4, 16384, 64), (16, 4096, 128))
ITERS = 10
H100_BF16_FLOPS = 989e12

_EXP = "          float pr = ex2(fmaf(s[i], scale_log2, -l2));\n"
_UPDATES = """      if constexpr (kDKV)
        rs_steps<D>(acc2, x, desc_lo(buf + L::kTileBytes, kMNLBO), it == 0 ? 1u : 0u,
                    std::make_integer_sequence<int, 4>{});
      rs_steps<D>(acc1, y, desc_lo(buf, kMNLBO), it == 0 ? 1u : 0u,
                  std::make_integer_sequence<int, 4>{});
"""
_GROUPS = "static constexpr int kGroups = kDKV && D == 128 ? 1 : 2;"
# A producer warp that keeps its registers: no setmaxnreg, and no check of it.
_NO_SETMAXNREG = [
    ("constexpr int kProducerThreads = 128;", "constexpr int kProducerThreads = 32;"),
    ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(kProducerRegs));\n', ""),
    ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(kConsumerRegs));\n', ""),
    ("    return attr.numRegs * L::kThreads >= (L::kGroups * kConsumerRegs + kProducerRegs) * 128\n",
     "    return true\n"),
]
VARIANTS = {
    "kernel": [],
    "no-exps": [(_EXP, "          float pr = fmaf(s[i], scale_log2, -l2);\n")],
    "no-updates": [(_UPDATES, "      acc1[0] += __uint_as_float(y[0][0] ^ y[3][3]);\n"
                              "      if constexpr (kDKV) acc2[0] += __uint_as_float(x[0][0] ^ x[3][3]);\n")],
    "groups-1": [(_GROUPS, "static constexpr int kGroups = 1;")],
    "groups-2": [(_GROUPS, "static constexpr int kGroups = 2;")],
    "no-setmaxnreg": _NO_SETMAXNREG,
    "groups-2-no-setmaxnreg": [(_GROUPS, "static constexpr int kGroups = 2;"), *_NO_SETMAXNREG],
    "two-stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def variant_source(edits) -> str:
    src = (build.CSRC / attention.BACKWARD_SOURCE).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not match the source once: {old!r}")
        src = src.replace(old, new)
    return src


def wgmma_ptxas(log: str) -> str:
    """The registers and spills ptxas gives the wgmma kernels, from its -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "flash_bwd_wgmma_kernel" in name and ("Used" in line or "spill" in line):
            kind = "dkdv" if "Lb1E" in name else "dq"
            width = re.search(r"ILi(\d+)E", name).group(1)
            out.append(f"D={width} {kind}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def build_variant(name: str) -> tuple[str, ctypes.CDLL, str]:
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(variant_source(VARIANTS[name]))
    so = cu.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = attention.bind_backward(ctypes.CDLL(str(so)))
    lib.eovax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eovax_cuda_error_string.restype = ctypes.c_char_p
    return name, lib, wgmma_ptxas(proc.stdout + proc.stderr)


class Backward:
    """The three launches of one route on fixed inputs, each callable alone."""

    def __init__(self, lib, route: str, q, k, v, o, lse, do):
        import torch

        self.lib, self.route = lib, route
        b, s, d = q.shape
        self.stream = torch.cuda.current_stream().cuda_stream
        self.grads = [torch.empty_like(t) for t in (q, k, v)]
        self.ptrs = [t.data_ptr() for t in (q, k, v, do)]
        if route == "wgmma":
            rows = lib.eovax_flash_attention_bwd_stats_rows(s)
            self.delta, self.lse = (torch.empty((b, rows), device=q.device) for _ in range(2))
            self.stats_args = (o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               self.delta.data_ptr(), self.lse.data_ptr(), b, s, rows, d)
            self.shape = (b, s, rows, d, d)
        else:
            self.delta, self.lse = torch.empty((b, s), device=q.device), lse
            self.stats_args = (o.data_ptr(), do.data_ptr(), self.delta.data_ptr(), b * s, d)
            self.shape = (b, s, d, d)
        self.parts = dict(zip(("stats", "dkdv", "dq"), attention._BACKWARD_PARTS[route]))

    def launch(self, part: str, *args) -> None:
        code = getattr(self.lib, f"eovax_flash_attention_bwd_{self.parts[part]}")(*args, self.stream)
        if code != 0:
            raise RuntimeError(f"{self.parts[part]}: CUDA error {code} "
                               f"({self.lib.eovax_cuda_error_string(code).decode()})")

    def stats(self) -> None:
        self.launch("stats", *self.stats_args)

    def dkdv(self) -> None:
        dq, dk, dv = self.grads
        self.launch("dkdv", *self.ptrs, self.lse.data_ptr(), self.delta.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), *self.shape)

    def dq(self) -> None:
        self.launch("dq", *self.ptrs, self.lse.data_ptr(), self.delta.data_ptr(),
                    self.grads[0].data_ptr(), *self.shape)

    def __call__(self) -> list:
        self.stats()
        self.dkdv()
        self.dq()
        return self.grads


def cuda_ms(fn, iters: int = ITERS) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def inputs(b: int, s: int, d: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, d, generator=g, device="cuda", dtype=torch.bfloat16)
                   for _ in range(4))
    o, lse = attention.flash_attention_with_lse(q, k, v)
    return q, k, v, o, lse, do


def check(lib, card: str) -> None:
    """The wgmma route of the unedited source against the plain version."""
    for d in (64, 128):
        q, k, v, o, lse, do = inputs(2, 1000, d, seed=d)
        grads = Backward(lib, "wgmma", q, k, v, o, lse, do)()
        refs = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, do)
        errs = [rel(a, r) for a, r in zip(grads, refs)]
        print(f"kernel [2,1000,{d}] bf16 against the plain version: rel dq/dk/dv "
              + " / ".join(f"{e:.3e}" for e in errs) + f" [{card}]")
        if max(errs) > 2e-2:
            raise AssertionError(f"the wgmma kernels disagree with the plain version at D = {d}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_attention_backward: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build_variant, VARIANTS))
    for name, _, ptxas in built:
        print(f"{name}: ptxas {ptxas}")
    libs = {name: lib for name, lib, _ in built}
    check(libs["kernel"], card)
    for b, s, d in SHAPES:
        label = f"[{b},{s},{d}] bf16"
        q, k, v, o, lse, do = inputs(b, s, d, seed=s + d)
        flops = 2.0 * b * s * s * d
        print(f"{label}: bound {5 * flops / H100_BF16_FLOPS * 1e3:.4f} ms (5 products of "
              f"2·B·S²·D at the bf16 peak) [{card}]")
        new = Backward(libs["kernel"], "wgmma", q, k, v, o, lse, do)
        old = Backward(libs["kernel"], "mma", q, k, v, o, lse, do)
        err = max(rel(a, r) for a, r in zip(new(), old()))
        print(f"{label}: wgmma against mma.sync kernels, max rel {err:.3e} [{card}]")
        for turn in range(2):
            for route, bwd in (("wgmma", new), ("mma.sync", old)):
                ms = cuda_ms(bwd)
                print(f"  {route} kernels (turn {turn + 1}) {label}: {ms:.4f} ms, "
                      f"{7 * flops / ms / 1e9:.1f} TFLOP/s [{card}]")
        new.stats()
        for part, n in (("dkdv", 4), ("dq", 3)):
            ms = cuda_ms(getattr(new, part))
            print(f"  wgmma {part} alone {label}: {ms:.4f} ms, {n * flops / ms / 1e9:.1f} "
                  f"TFLOP/s [{card}]")
        for name in VARIANTS:
            if name == "kernel":
                continue
            variant = Backward(libs[name], "wgmma", q, k, v, o, lse, do)
            try:
                ms = cuda_ms(variant)
                variant.stats()
                parts = {part: cuda_ms(getattr(variant, part)) for part in ("dkdv", "dq")}
            except RuntimeError as err:
                print(f"  {name} {label}: refused: {err} [{card}]")
                continue
            print(f"  {name} {label}: {ms:.4f} ms (dkdv {parts['dkdv']:.4f}, dq "
                  f"{parts['dq']:.4f}) [{card}]")
        del q, k, v, o, lse, do, new, old
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

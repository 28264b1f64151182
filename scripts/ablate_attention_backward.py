"""Where the bf16 attention backward spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/flash_attention_bwd.cu``, each the
source with one part of a kernel changed by a text edit, and times them with
CUDA events. Two sections (``--route``, both by default).

``cluster``: the cluster kernels (D split over D/128 CTAs, partial logits
summed through DSMEM) at stage 2's [16,1024,512] and the same layer at a 512²
input, [4,4096,512]:

- ``kernel``: the source as it is, timed whole and dK/dV and dQ each alone, in
  turns with the `mma.sync` kernels called at the same D (cluster, mma.sync,
  cluster, mma.sync), the two held against each other and against the plain
  version at [2,1000,512] and [2,1000,256];
- ``no-exchange``: no partial stores, cluster waits or DSMEM reads: each CTA
  forms P and dS from its own partials in registers (taking its share of the
  exps, 1/C of the tile), so the time is that of the loads and the products
  (wrong results);
- ``no-products``: S, dP and the update products dropped, so the time is that
  of the loads, the exchange and the exps (wrong results);
- ``no-updates``: the update products dropped (wrong results);
- ``full-fences``: a full ``fence.acq_rel.cluster`` before each warp's
  arrivals and waits with acquire semantics at cluster scope, instead of
  fences restricted to shared memory;
- ``release-arrive``: each warp's arrivals with release semantics, one to
  each CTA, and no fence (the kernel's first form);
- ``dkdv-two-groups``: the dK/dV kernel with two consumer warpgroups and 2
  stages, its producer a warp without setmaxnreg and 224 registers a thread
  (``__maxnreg__``), instead of one warpgroup and 3 stages (the card refuses
  the launch: 9 warps put 3 on one of an SM's four register partitions);
- ``dq-one-group``: the dQ kernel with one consumer warpgroup and 3 stages
  instead of two and 2.
Only the reduce-scatter form of the exchange is built; an all-gather of the
fp32 partials (96 KiB of DSMEM traffic a tile at D = 512 against 36) is not.

``wgmma``: the `wgmma` kernels at D = 64 and 128, at the pixel SR UNet's
[4,16384,64] and the flow refiner's [16,4096,128]:

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
and power limit; each variant's `ptxas` registers and spills for its section's
kernels are printed first, with any ptxas warning. A variant that the card
refuses (for instance a register count below what setmaxnreg hands out) is
printed with its error. The variants are built with the package's nvcc flags
into ``build/ablate_attention_backward/``:

    python3 scripts/ablate_attention_backward.py [--route cluster|wgmma]
"""

from __future__ import annotations

import argparse
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
SHAPES = {"wgmma": ((4, 16384, 64), (16, 4096, 128)),
          "cluster": ((16, 1024, 512), (4, 4096, 512))}
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
# The cluster kernels' variants (see the docstring).
_C_UPDATES = """      if constexpr (kDKV)
        rs_steps<kSlice>(acc2, x, desc_lo(buf + kSliceBytes, kMNLBO), it == 0 ? 1u : 0u,
                         std::make_integer_sequence<int, 4>{});
      rs_steps<kSlice>(acc1, y, desc_lo(buf, kMNLBO), it == 0 ? 1u : 0u,
                       std::make_integer_sequence<int, 4>{});
"""
_C_NO_UPDATES = (_C_UPDATES, "      acc1[0] += __uint_as_float(y[0][0] ^ y[3][3]);\n"
                             "      if constexpr (kDKV) acc2[0] += __uint_as_float(x[0][0] ^ x[3][3]);\n")
_C_PRODUCTS = """      ss_steps(s, lo_a1, desc_lo(buf, kKLBO), std::make_integer_sequence<int, kSlice / 16>{});
      wgmma_commit();
      ss_steps(dp, lo_a2, desc_lo(buf + kSliceBytes, kKLBO),
               std::make_integer_sequence<int, kSlice / 16>{});
      wgmma_commit();
"""
_C_NO_PRODUCTS = [(_C_PRODUCTS, """#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = (float)(it + i) * 0x1p-8f;
        dp[i] = (float)(i - it) * 0x1p-8f;
      }
"""), _C_NO_UPDATES]
# The region from the partial stores to the fragment loads, replaced by P and dS
# from this CTA's own partials (its share of the exps).
_C_EXCHANGE = ("      // 1. The partials in fragment order", "      // dV += P·dO and dK += dS·Q")
_C_LOCAL = """      uint32_t x[4][4], y[4][4];
      {
        const float* stat = reinterpret_cast<const float*>(gbase + L::kStats + st * 2 * kStatBytes);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float l2 = kDKV ? stat[8 * (i >> 2) + 2 * t + (i & 1)] : 0.f;
          const float p = i < 32 / kC ? ex2(fmaf(s[i], scale_log2, -l2)) : s[i];
          dp[i] = p * (dp[i] - l2);
          s[i] = p;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            y[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
      }

"""
# The exchange's synchronisation: full fences (fence.acq_rel.cluster before the
# relaxed arrivals, waits with acquire semantics at cluster scope) instead of
# fences restricted to shared memory; and, further back, each warp's lane 0
# arriving with release semantics on each CTA's barrier, with no fence (the
# kernel's first form).
_C_FENCE = '  asm volatile("fence.release.sync_restrict::shared::cta.cluster;\\n" ::: "memory");\n'
_C_ACQUIRE = '  asm volatile("fence.acquire.sync_restrict::shared::cluster.cluster;\\n" ::: "memory");\n'
_C_FULL_FENCES = [(_C_FENCE, '  asm volatile("fence.acq_rel.cluster;\\n" ::: "memory");\n'),
                  (_C_ACQUIRE, ""),
                  ("mbarrier.try_wait.parity.relaxed.cluster", "mbarrier.try_wait.parity.acquire.cluster")]
_C_RELEASE_ARRIVE = [*_C_FULL_FENCES[1:], (_C_FENCE, ""),
                     ("mbarrier.arrive.relaxed.cluster", "mbarrier.arrive.release.cluster")]
# Two dK/dV warpgroups (and 2 stages), with a producer warp that keeps its
# registers instead of a producer warpgroup (no setmaxnreg), and __maxnreg__
# 224 in place of __launch_bounds__, so that ptxas may give them 224 registers
# a thread (65536 / 288) instead of 168.
_C_DKDV_TWO_GROUPS = [
    ("  static constexpr int kGroups = kDKV ? 1 : 2;\n", "  static constexpr int kGroups = 2;\n"),
    ("  static constexpr int kStages = kGroups == 2 ? 2 : 3;\n"
     "  static constexpr int kThreads = kGroups * 128 + kProducerThreads;\n",
     "  static constexpr int kStages = kGroups == 2 ? 2 : 3;\n"
     "  static constexpr int kThreads = kGroups * 128 + (kDKV ? 32 : kProducerThreads);\n"),
    ("    regs_dec<kProducerRegs>();\n", "    if constexpr (!kDKV) regs_dec<kProducerRegs>();\n"),
    ("    regs_inc<kConsumerRegs>();\n", "    if constexpr (!kDKV) regs_inc<kConsumerRegs>();\n"),
    ("    if (attr.numRegs * L::kThreads < (L::kGroups * kConsumerRegs + kProducerRegs) * 128)\n"
     "      return (int)cudaErrorInvalidConfiguration;\n    cudaLaunchAttribute cattr;",
     "    if (!kDKV && attr.numRegs * L::kThreads < (L::kGroups * kConsumerRegs + kProducerRegs) * 128)\n"
     "      return (int)cudaErrorInvalidConfiguration;\n    cudaLaunchAttribute cattr;"),
    ("__global__ void __launch_bounds__(ClusterPlan<kC, kDKV>::kThreads, 1)\n    flash_bwd_cluster_kernel(",
     "__global__ void __maxnreg__(kDKV ? 224 : 168)\n    flash_bwd_cluster_kernel(")]
CLUSTER_VARIANTS = {
    "kernel": [],
    "no-exchange": [(*_C_EXCHANGE, _C_LOCAL)],
    "no-products": _C_NO_PRODUCTS,
    "no-updates": [_C_NO_UPDATES],
    "full-fences": _C_FULL_FENCES,
    "release-arrive": _C_RELEASE_ARRIVE,
    "dkdv-two-groups": _C_DKDV_TWO_GROUPS,
    "dq-one-group": [("  static constexpr int kGroups = kDKV ? 1 : 2;\n",
                      "  static constexpr int kGroups = 1;\n")],
}

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


SECTIONS = {"cluster": CLUSTER_VARIANTS, "wgmma": VARIANTS}
# The kernel whose ptxas lines each section prints.
_KERNEL = {"cluster": "flash_bwd_cluster_kernel", "wgmma": "flash_bwd_wgmma_kernel"}


def variant_source(edits) -> str:
    """The source with each edit made: (old, new) replaces text that occurs once,
    (start, end, new) the text from start up to end (each once)."""
    src = (build.CSRC / attention.BACKWARD_SOURCE).read_text()
    for edit in edits:
        anchors, new = edit[:-1], edit[-1]
        if any(src.count(a) != 1 for a in anchors):
            raise RuntimeError(f"edit does not match the source once: {anchors!r}")
        lo = src.index(anchors[0])
        hi = lo + len(anchors[0]) if len(anchors) == 1 else src.index(anchors[1])
        src = src[:lo] + new + src[hi:]
    return src


def kernel_ptxas(log: str, route: str) -> str:
    """The registers and spills ptxas gives the section's kernels (wgmma: by D;
    cluster: by CTAs a cluster, D/128), and any warning, from its -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "warning" in line.lower():
            out.append(line.strip())
        elif name and _KERNEL[route] in name and ("Used" in line or "spill" in line):
            kind = "dkdv" if "Lb1E" in name else "dq"
            n = int(re.search(r"ILi(\d+)E", name).group(1))
            width = n * 128 if route == "cluster" else n
            out.append(f"D={width} {kind}: {line.split(':', 1)[-1].strip()}")
    return "; ".join(out)


def build_variant(key: tuple[str, str]) -> tuple[tuple[str, str], ctypes.CDLL, str]:
    route, name = key
    cu = OUT_DIR / f"{route}-{name}.cu"
    cu.write_text(variant_source(SECTIONS[route][name]))
    so = cu.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if name == "kernel":
            raise RuntimeError(f"nvcc failed on {route} {name}:\n{proc.stdout}{proc.stderr}")
        return key, None, "nvcc failed: " + " | ".join(
            line for line in (proc.stdout + proc.stderr).splitlines() if "error" in line)[:2000]
    lib = attention.bind_backward(ctypes.CDLL(str(so)))
    lib.eovax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eovax_cuda_error_string.restype = ctypes.c_char_p
    return key, lib, kernel_ptxas(proc.stdout + proc.stderr, route)


class Backward:
    """The three launches of one route on fixed inputs, each callable alone."""

    def __init__(self, lib, route: str, q, k, v, o, lse, do):
        import torch

        self.lib, self.route = lib, route
        b, s, d = q.shape
        self.stream = torch.cuda.current_stream().cuda_stream
        self.grads = [torch.empty_like(t) for t in (q, k, v)]
        self.ptrs = [t.data_ptr() for t in (q, k, v, do)]
        if route in ("wgmma", "cluster"):
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


def check(lib, route: str, card: str) -> None:
    """The section's route in the unedited source against the plain version."""
    for d in ((64, 128) if route == "wgmma" else (256, 512)):
        q, k, v, o, lse, do = inputs(2, 1000, d, seed=d)
        grads = Backward(lib, route, q, k, v, o, lse, do)()
        refs = attention.flash_attention_backward_from_stats_plain(q, k, v, o, lse, do)
        errs = [rel(a, r) for a, r in zip(grads, refs)]
        print(f"kernel [2,1000,{d}] bf16 ({route}) against the plain version: rel dq/dk/dv "
              + " / ".join(f"{e:.3e}" for e in errs) + f" [{card}]")
        if max(errs) > 2e-2:
            raise AssertionError(f"the {route} kernels disagree with the plain version at D = {d}")


def section(route: str, libs: dict, card: str) -> None:
    """The section's kernels at its shapes: whole and each part alone, in turns
    with the mma.sync kernels, then every variant."""
    import torch

    check(libs["kernel"], route, card)
    if route == "cluster":
        for d in attention.CLUSTER_BACKWARD_WIDTHS:
            n = {part: attention.backward_active_clusters(d, part) for part in ("dkdv", "dq")}
            print(f"cluster plans at D = {d}: cudaOccupancyMaxActiveClusters dkdv {n['dkdv']}, "
                  f"dq {n['dq']} [{card}]")
    for b, s, d in SHAPES[route]:
        label = f"[{b},{s},{d}] bf16"
        q, k, v, o, lse, do = inputs(b, s, d, seed=s + d)
        flops = 2.0 * b * s * s * d
        print(f"{label}: bound {5 * flops / H100_BF16_FLOPS * 1e3:.4f} ms (5 products of "
              f"2·B·S²·D at the bf16 peak) [{card}]")
        new = Backward(libs["kernel"], route, q, k, v, o, lse, do)
        old = Backward(libs["kernel"], "mma", q, k, v, o, lse, do)
        err = max(rel(a, r) for a, r in zip(new(), old()))
        print(f"{label}: {route} against mma.sync kernels, max rel {err:.3e} [{card}]")
        for turn in range(2):
            for name, bwd in ((route, new), ("mma.sync", old)):
                ms = cuda_ms(bwd)
                print(f"  {name} kernels (turn {turn + 1}) {label}: {ms:.4f} ms, "
                      f"{7 * flops / ms / 1e9:.1f} TFLOP/s, "
                      f"{5 * flops / H100_BF16_FLOPS / ms * 1e5:.1f}% of the bound [{card}]")
        new.stats()
        old.stats()
        for part, n in (("dkdv", 4), ("dq", 3)):
            for turn in range(2):
                for name, bwd in ((route, new), ("mma.sync", old)):
                    ms = cuda_ms(getattr(bwd, part))
                    print(f"  {name} {part} alone (turn {turn + 1}) {label}: {ms:.4f} ms, "
                          f"{n * flops / ms / 1e9:.1f} TFLOP/s [{card}]")
        for name in SECTIONS[route]:
            if name == "kernel" or libs[name] is None:
                continue
            variant = Backward(libs[name], route, q, k, v, o, lse, do)
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


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", choices=sorted(SECTIONS), action="append",
                        help="the section(s) to run (default: cluster, then wgmma)")
    routes = parser.parse_args(argv).route or ["cluster", "wgmma"]
    if not torch.cuda.is_available():
        print("ablate_attention_backward: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    keys = [(route, name) for route in routes for name in SECTIONS[route]]
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        built = list(pool.map(build_variant, keys))
    for (route, name), _, ptxas in built:
        print(f"{route} {name}: ptxas {ptxas}")
    for route in routes:
        section(route, {name: lib for (r, name), lib, _ in built if r == route}, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

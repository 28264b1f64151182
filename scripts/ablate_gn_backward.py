"""Where the GroupNorm backward kernel spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/groupnorm.cu``, each the
backward kernel with one thing changed by a text edit of the source, and
times each with CUDA events (20 calls after 3) on GroupNorm + swish
backwards in bf16 at the 8 shapes of the stage-2 train step (12-band 256²
B=16), each on every cluster size that cuts its groups (the resident part at
most 64 KiB; at the two largest shapes also other resident lengths),
``_bwd_plan``'s marked:

- ``kernel``: the source as it is; at the two largest shapes also without
  swish (no σ(z): the time the sigmoid's arithmetic costs);
- ``min-blocks-4``: ``__launch_bounds__(kThreads, 4)`` instead of 3, so that
  four CTAs fit on an SM by registers;
- ``cluster-launch``: a one-CTA cluster launched with the cluster attribute
  (which the shared launcher leaves out at one CTA), at the shapes whose
  plan is one CTA;
- at the two largest shapes only: ``exact-math``, σ(z) from the IEEE ``expf``
  and divide (the arithmetic's share), and ``reduce-only``, step 3 (dx)
  dropped, so that the time is that of the loads, the partial sums and the
  cluster barrier (wrong results).

Beside them, ``torch.add(x, g, out=dx)``: the same 3-access traffic with no
arithmetic, the rate a streaming kernel reaches on this card. Each timed
variant but ``reduce-only`` is held against the plain backward first. Each
line has the card's name and power limit, the bytes bound (x and g read once,
dx written once) and the rate of that traffic; the last lines sum each
variant's times over one train step's 52 calls, on ``_bwd_plan``'s plans and
on the fastest plan of each shape, and the step's calls whose plan is one CTA
with and without the cluster attribute. ``ptxas`` registers and spills of the
backward kernel are printed per variant. The variants are built with the
package's nvcc flags into ``build/ablate_gn_backward/``.

    python3 scripts/ablate_gn_backward.py
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from eovax_torch.kernels import build, groupnorm  # noqa: E402

OUT_DIR = ROOT / "build" / "ablate_gn_backward"
# The train step's GroupNorm shapes and their calls a step (52 in all).
SHAPES = {(16, 128, 256, 256): 10, (16, 256, 256, 256): 1, (16, 128, 128, 128): 1,
          (16, 256, 128, 128): 8, (16, 512, 128, 128): 1, (16, 256, 64, 64): 1,
          (16, 512, 64, 64): 9, (16, 512, 32, 32): 21}
DETAIL = ((16, 128, 256, 256), (16, 256, 256, 256))
BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
RESIDENT_MAX = 64 * 1024 // 4  # bf16 elements of x and g in 64 KiB

_STEP3_START = "  // 3. dx, from shared memory where resident.\n"
_STEP3_END = "  cluster_wait();\n}\n"
VARIANTS = {
    "kernel": [],
    "min-blocks-4": [("__launch_bounds__(kThreads, 3)\n    gn_bwd_kernel(",
                      "__launch_bounds__(kThreads, 4)\n    gn_bwd_kernel(")],
    "exact-math": [("  const float sg = __fdividef(1.f, 1.f + __expf(-z));\n",
                    "  const float sg = 1.f / (1.f + expf(-z));\n")],
    "reduce-only": [],  # step 3 cut out in variant_source
    "cluster-launch": [("  if (cluster == 1) cfg.numAttrs = 0;\n", "")],
}


def variant_source(name: str) -> str:
    src = (build.CSRC / groupnorm.SOURCE).read_text()
    if name == "reduce-only":
        start, end = src.index(_STEP3_START), src.index(_STEP3_END)
        return src[:start] + src[end:]
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not match the source once: {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple[str, ctypes.CDLL, str]:
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(variant_source(name))
    so = cu.with_suffix(".so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.eovax_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eovax_cuda_error_string.restype = ctypes.c_char_p
    return name, groupnorm._bind(lib), "; ".join(bwd_ptxas(proc.stdout + proc.stderr))


def bwd_ptxas(log: str) -> list[str]:
    """The ptxas lines of the backward kernel's bf16 instances."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "gn_bwd_kernel" in line and "nv_bfloat16" in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split("info    :")[-1].strip())
    return out


def plans_of(shape) -> list:
    """_bwd_plan's plan first, then every other cluster size, resident ≤ 64 KiB;
    at the two largest shapes also the plan's cluster size with 32, 48, 96 and
    128 KiB resident, where the slice holds that much."""
    b, c, h, w = shape
    cpg, n = c // 32, h * w
    default = groupnorm._bwd_plan(b, c, 32, n, 2)
    plan = (lambda k, r: groupnorm.BwdPlan(k, cpg * n // k, r, 4 * r))
    others = [plan(k, min(cpg * n // k, RESIDENT_MAX))
              for k in groupnorm._cluster_sizes(cpg, n, 2)]
    if shape in DETAIL:
        others += [plan(default.cluster, kib * 1024 // 4) for kib in (32, 48, 96, 128)
                   if kib * 1024 // 4 <= default.slice]
    return [default] + [p for p in others if p != default]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_gn_backward: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build_variant, VARIANTS))
    for name, _, ptxas in built:
        print(f"{name}: ptxas {ptxas}")
    dev = torch.device("cuda")

    def ms_of(fn) -> float:
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    step = {}  # variant → [ms on the plan, ms on the fastest plan], summed over the step
    one_cta = {}  # variant → ms summed over the step's calls whose plan is one CTA
    for shape, calls in SHAPES.items():
        b, c, h, w = shape
        g = torch.Generator(device=dev).manual_seed(0)
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(torch.bfloat16)
        grad = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        weight = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        stats = groupnorm.group_stats_plain(x, 32, 1e-6)
        nbytes = 3.0 * x.numel() * x.element_size()
        bound_ms = nbytes / BYTES_PER_S * 1e3
        ref = groupnorm._backward_plain(grad, x, *stats, weight, bias, None, None, True)
        out = torch.empty_like(x)
        add_ms = ms_of(lambda: torch.add(x, grad, out=out))
        print(f"[{b},{c},{h},{w}] bf16 swish, {calls} a step: bound {bound_ms:.4f} ms (bytes); "
              f"torch.add(x, g, out=dx) {add_ms:.4f} ms, {nbytes / add_ms / 1e6:.0f} GB/s "
              f"[{card}]")
        plans = plans_of(shape)
        for name, lib, _ in built:
            if name in ("exact-math", "reduce-only") and shape not in DETAIL:
                continue
            times = []
            timed = plans if name in ("kernel", "min-blocks-4") else plans[:1]
            if name == "cluster-launch":
                timed = plans[:1] if plans[0].cluster == 1 else []
            for plan in timed:
                both = name == "kernel" and shape in DETAIL and plan == plans[0]
                for swish in (True, False) if both else (True,):
                    args = (grad, x, *stats, weight, bias, None, None, swish)
                    with mock.patch.object(groupnorm, "_library", lambda lib=lib: lib), \
                            mock.patch.object(groupnorm, "_bwd_plan", lambda *a, p=plan: p):
                        got = groupnorm._backward_kernel(*args)
                        torch.cuda.synchronize()
                        if swish and name != "reduce-only":
                            rel = ((got[0].float() - ref[0].float()).abs().max()
                                   / ref[0].float().abs().max()).item()
                            if rel > 1e-2:
                                raise AssertionError(f"{name} {plan}: dx rel err {rel:.3e}")
                        ms = ms_of(lambda: groupnorm._backward_kernel(*args))
                        clusters = groupnorm.active_clusters(plan, torch.bfloat16)
                    if swish:
                        times.append(ms)
                    if swish and plan.cluster == 1 and plan == plans[0] and name in (
                            "kernel", "cluster-launch"):
                        one_cta[name] = one_cta.get(name, 0.0) + calls * ms
                    print(f"  {name} {'swish' if swish else 'no-swish'} cluster {plan.cluster} "
                          f"slice {plan.slice} resident {plan.resident} ({plan.smem_bytes // 1024} "
                          f"KiB{', the plan' if plan == plans[0] else ''}; {clusters} clusters "
                          f"active): {ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s of 3-access "
                          f"traffic, {100 * bound_ms / ms:.1f}% of the bound [{card}]")
            if name in ("kernel", "min-blocks-4"):
                total = step.setdefault(name, [0.0, 0.0])
                total[0] += calls * times[0]
                total[1] += calls * min(times)
        del x, grad, out, ref
        torch.cuda.empty_cache()
    bounds = sum(calls * 3.0 * b * c * h * w * 2 / BYTES_PER_S * 1e3
                 for (b, c, h, w), calls in SHAPES.items())
    for name, (planned, best) in step.items():
        print(f"train step's 52 backward calls, {name}: {planned:.3f} ms on _bwd_plan's plans, "
              f"{best:.3f} ms on each shape's fastest plan; sum of bounds {bounds:.3f} ms "
              f"[{card}]")
    for name, ms in one_cta.items():
        print(f"train step's calls on one-CTA plans, {name}: {ms:.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

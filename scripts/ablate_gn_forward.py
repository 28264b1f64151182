"""Where the GroupNorm forward kernel spends its time, on one CUDA card.

Builds variants of ``eovax_torch/kernels/csrc/groupnorm.cu``, each the
forward kernel with one thing changed by a text edit of the source, and
times each by its device time (``torch.profiler``, 20 calls after 1) on
GroupNorm forwards in bf16 at the shapes that matter: the 8 of the stage-2
train step (12-band 256² B=16, GroupNorm + swish), the three 2-4 MiB groups
of a 512² ``reconstruct`` (GroupNorm + swish), the SR UNet's two and
[8,256,16,16] (the largest group of the warp plan; a [B, C] FiLM and swish).
``_fwd_plan``'s plan is marked on each line, the warp plan timed beside every
cluster plan where a group fits one warp:

- ``kernel``: the source as it is, on every cluster size that cuts the
  shape's groups with the resident part capped at 32, 64, 96 and 128 KiB a
  CTA (the shared memory a CTA holds; a slice past the cap is streamed);
- ``two-pass``: the variance of the resident part from the exact second
  pass Σ(x − μ)² over shared memory, with one more exchange and cluster
  barrier, instead of step 1's sums about K (which stay for the streamed
  rest);
- ``no-write``: step 4 (the apply and the write of y) cut out, so that the
  time is that of the loads, the sums and the cluster barriers (wrong
  results);
- ``no-store``: step 4's stores made conditional on a value that never
  occurs, so that step 4 reads the streamed part a second time and writes
  nothing; against ``no-write`` it gives the second read's time, against
  ``kernel`` the write's (wrong results);
- ``exact-math``: SiLU from the IEEE ``expf`` and divide instead of the
  hardware's exp2 and reciprocal;
- ``no-cluster-barrier``: the forward's cluster barriers made block
  barriers (right only for one-CTA clusters; the time a CTA waits for its
  cluster);
- ``cluster-launch``: a one-CTA cluster launched with the cluster attribute
  (the other plans as before);
- ``earlier-pair``: the two kernels the forward replaced, the per-plane
  statistics (``gn_stats_kernel``, which ``gn_channel_sums`` still runs) and
  the apply that combines a group's planes and writes y (``gn_apply_kernel``,
  kept here as text), which read x twice.

Beside them, ``torch.add(x, 1, out=y)``: the same 2-access traffic with no
arithmetic, the rate a streaming kernel reaches on this card. Each timed
variant but ``no-write`` and ``no-store`` is held against the plain forward first. Each line
has the card's name and power limit, the bytes bound (x read once, y written
once) and the share of it; the last lines sum each variant over the train
step's 52 calls, on ``_fwd_plan``'s plans and on each shape's fastest plan.
``ptxas`` registers and spills of the forward kernel are printed per
variant. The variants are built with the package's nvcc flags into
``build/ablate_gn_forward/``.

    python3 scripts/ablate_gn_forward.py
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

OUT_DIR = ROOT / "build" / "ablate_gn_forward"
# Shape → (calls in a train step, FiLM [B, C]); the train step's 52 calls, then
# the 512² reconstruct's largest groups, the SR UNet's shapes (0: not in the
# step) and a 4 KiB group, the largest the warp plan takes.
SHAPES = {(16, 128, 256, 256): (10, False), (16, 256, 256, 256): (1, False),
          (16, 128, 128, 128): (1, False), (16, 256, 128, 128): (8, False),
          (16, 512, 128, 128): (1, False), (16, 256, 64, 64): (1, False),
          (16, 512, 64, 64): (9, False), (16, 512, 32, 32): (21, False),
          (4, 128, 512, 512): (0, False), (4, 512, 256, 256): (0, False),
          (4, 256, 512, 512): (0, False), (8, 512, 64, 64): (0, True), (8, 64, 16, 16): (0, True),
          (8, 256, 16, 16): (0, True)}
BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
CAPS_KIB = (32, 64, 96, 128)

_STEP4 = ("  apply_fwd<T, kVec, false>(xs, yg, 0, resident, seg, mu, coef, p.swish);\n"
          "  apply_fwd<T, kVec, true>(xg, yg, resident, slice, seg, mu, coef, p.swish);\n")
_STORE = ("      store_vec(yp + i * V, v);\n    }\n  } else {\n"
          "    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {\n"
          "      const float2 ac = coef[")
# The exact second pass over the resident part: step 1's sums about K only over
# the streamed rest (sum_range's kShift), the CTA's Σ(x − μ)² exchanged once more.
_SUM_SHIFT = ("        acc[0] += v[j];\n        const float d = v[j] - K;\n        acc[1] += d;\n"
              "        acc[2] = fmaf(d, d, acc[2]);\n")
_SUM_SHIFT_SCALAR = ("      acc[0] += v;\n      const float d = v - K;\n      acc[1] += d;\n"
                     "      acc[2] = fmaf(d, d, acc[2]);\n")
_M2_RANGE = r'''// Step 3 over the resident [0, hi) in shared memory: Σ(x − μ)².
template <typename T, bool kVec>
__device__ __forceinline__ float m2_range(const T* xs, long hi, float mu) {
  float m2 = 0.f;
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 4
    for (long i = threadIdx.x; i < hi / V; i += kThreads) {
      float v[V];
      load_any<T, false>(xs + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - mu;
        m2 = fmaf(d, d, m2);
      }
    }
  } else {
    for (long i = threadIdx.x; i < hi; i += kThreads) {
      const float d = to_float(xs[i]) - mu;
      m2 = fmaf(d, d, m2);
    }
  }
  return m2;
}

// Step 4 over [lo, hi)'''
_STEP3 = ("  for (int q = 0; q < k; ++q) {\n    const float dk = gathered[q][1] - mu;\n"
          "    m2 += gathered[q][3] + dk * fmaf((float)slice, dk, 2.f * gathered[q][2]);\n  }\n")
_STEP3_TWO_PASS = r'''  {
    const float dk = part[1] - mu;
    float mine[1] = {m2_range<T, kVec>(xs, resident, mu)};
    block_sums(mine, red);
    if (threadIdx.x == 0)
      part_m2 = mine[0] + part[3] + dk * fmaf((float)(slice - resident), dk, 2.f * part[2]);
    cluster.sync();
    if (threadIdx.x < k)
      gathered[threadIdx.x][0] = *cluster.map_shared_rank(&part_m2, (int)threadIdx.x);
    __syncthreads();
    for (int q = 0; q < k; ++q) m2 += gathered[q][0];
  }
'''
# The apply kernel of the two-kernel forward, appended to the source for the
# earlier pair: one block per chunk of a plane combines its group's per-plane
# (mean, M2) with Chan's formula, then writes y.
_EARLIER_APPLY = r'''
namespace {
constexpr int kVecIters = 8;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
                    const float* __restrict__ m2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ ada_scale,
                    const float* __restrict__ ada_shift, int ada_stride, int C, int cpg, long n,
                    long chunk, float eps, int swish) {
  __shared__ float coef[3];
  const int plane = blockIdx.y;
  if (threadIdx.x == 0) {
    const int b = plane / C, c = plane % C;
    const float* gm_c = mean + (size_t)b * C + (c - c % cpg);
    const float* gm2_c = m2 + (size_t)b * C + (c - c % cpg);
    float gm = 0.f;
    for (int i = 0; i < cpg; ++i) gm += gm_c[i];
    gm /= (float)cpg;
    float gm2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      const float d = gm_c[i] - gm;
      gm2 += gm2_c[i] + (float)n * d * d;
    }
    const float rstd = rsqrtf(gm2 / ((float)n * (float)cpg) + eps);
    float a = rstd * gamma[c], off = beta[c];
    if (ada_scale != nullptr) {
      const float s = ada_scale[(size_t)b * ada_stride + c];
      a *= s;
      off = off * s + ada_shift[(size_t)b * ada_stride + c];
    }
    coef[0] = gm;
    coef[1] = a;
    coef[2] = off;
  }
  __syncthreads();
  const float gm = coef[0], a = coef[1], off = coef[2];
  const size_t base = (size_t)plane * n;
  const long lo = (long)blockIdx.x * chunk;
  const long hi = lo + chunk < n ? lo + chunk : n;
  if (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 4
    for (long i = lo + threadIdx.x * V; i < hi; i += kThreads * V) {
      float v[V];
      load_vec(x + base + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = fmaf(v[j] - gm, a, off);
        v[j] = swish ? t / (1.f + expf(-t)) : t;
      }
      store_vec(y + base + i, v);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float t = fmaf(to_float(x[base + i]) - gm, a, off);
      y[base + i] = from_float<T>(swish ? t / (1.f + expf(-t)) : t);
    }
  }
}
}  // namespace

extern "C" int eovax_gn_apply_bf16(const void* x, void* y, const void* mean, const void* m2,
                                   const void* gamma, const void* beta, const void* ada_scale,
                                   const void* ada_shift, int ada_stride, int B, int C, int groups,
                                   long n, float eps, int swish, void* stream) {
  using T = __nv_bfloat16;
  const long chunk = (long)kThreads * vec_n<T>() * kVecIters;
  const dim3 grid((unsigned)((n + chunk - 1) / chunk), (unsigned)(B * C));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (vectorizable<T>(x, y, n))
    gn_apply_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), f(mean), f(m2), f(gamma), f(beta),
        f(ada_scale), f(ada_shift), ada_stride, C, C / groups, n, chunk, eps, swish);
  else
    gn_apply_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), f(mean), f(m2), f(gamma), f(beta),
        f(ada_scale), f(ada_shift), ada_stride, C, C / groups, n, chunk, eps, swish);
  return (int)cudaGetLastError();
}
'''
VARIANTS = {
    "kernel": [],
    "two-pass": [
        ("template <typename T, bool kVec, bool kGlobal, bool kKeep = false>\n"
         "__device__ __forceinline__ void sum_range(",
         "template <typename T, bool kVec, bool kGlobal, bool kKeep = false, bool kShift = true>\n"
         "__device__ __forceinline__ void sum_range("),
        (_SUM_SHIFT, _SUM_SHIFT.replace("        const", "        if constexpr (kShift) {\n"
                                        "        const").replace("acc[2]);\n", "acc[2]);\n        }\n")),
        (_SUM_SHIFT_SCALAR, _SUM_SHIFT_SCALAR.replace("      const", "      if constexpr (kShift) {\n"
                                                      "      const").replace("acc[2]);\n",
                                                                          "acc[2]);\n      }\n")),
        ("// Step 4 over [lo, hi)", _M2_RANGE),
        ("  __shared__ float2 coef[kMaxSegments];\n",
         "  __shared__ float2 coef[kMaxSegments];\n  __shared__ float part_m2;\n"),
        ("sum_range<T, true, false>(xs, q0, q1, K, acc);",
         "sum_range<T, true, false, false, false>(xs, q0, q1, K, acc);"),
        ("sum_range<T, false, true, true>(xg, 0, resident, K, acc, xs);",
         "sum_range<T, false, true, true, false>(xg, 0, resident, K, acc, xs);"),
        (_STEP3, _STEP3_TWO_PASS)],
    "no-write": [(_STEP4, "")],
    "no-store": [(_STORE, _STORE.replace("      store_vec(", "      if (v[0] == -1e30f) store_vec("))],
    "exact-math": [("return __fdividef(v, 1.f + __expf(-v));", "return v / (1.f + expf(-v));")],
    "no-cluster-barrier": [
        ("  cluster.sync();\n  if (threadIdx.x < k) {\n    const float* rp",
         "  __syncthreads();\n  if (threadIdx.x < k) {\n    const float* rp"),
        ("  cluster_arrive();  // done with the other CTAs' shared memory\n  const float rstd",
         "  const float rstd"),
        ("  cluster_wait();\n}\n\n// The warp plan", "}\n\n// The warp plan")],
    "cluster-launch": [("  if (cluster == 1) cfg.numAttrs = 0;\n", "")],
    "earlier-pair": [],  # the apply kernel appended in variant_source
}


# Variants that isolate a fixed cost; also timed on a one-CTA plan.
DIAGNOSTIC = ("no-cluster-barrier", "cluster-launch")


def variant_source(name: str) -> str:
    src = (build.CSRC / groupnorm.SOURCE).read_text()
    if name == "earlier-pair":
        return src + _EARLIER_APPLY
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
    if name == "earlier-pair":
        lib.eovax_gn_apply_bf16.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                            + [ctypes.c_long, ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        lib.eovax_gn_apply_bf16.restype = ctypes.c_int
    return name, groupnorm._bind(lib), "; ".join(fwd_ptxas(proc.stdout + proc.stderr))


def fwd_ptxas(log: str) -> list[str]:
    """The ptxas lines of the forward kernel's bf16 instances."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "gn_fwd_kernel" in line and "nv_bfloat16" in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split("info    :")[-1].strip())
    return out


def plans_of(shape) -> list:
    """_fwd_plan's plan first (the warp plan where the group fits one warp), then
    every cluster size with the resident part capped at each of CAPS_KIB."""
    b, c, h, w = shape
    cpg, n = c // 32, h * w
    default = groupnorm._fwd_plan(b, c, 32, n, 2)
    plans = [default]
    for k in groupnorm._cluster_sizes(cpg, n, 2):
        for kib in CAPS_KIB:
            resident = min(cpg * n // k, kib * 1024 // 2 // 8 * 8)
            plan = groupnorm.FwdPlan(k, cpg * n // k, resident, 2 * resident)
            if plan not in plans:
                plans.append(plan)
    return plans


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ablate_gn_forward: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    built = {}
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        for name, lib, ptxas in pool.map(build_variant, VARIANTS):
            print(f"{name}: ptxas {ptxas}")
            built[name] = lib
    dev = torch.device("cuda")

    def ms_of(fn, calls: int = 20) -> float:
        """Device time of one fn(): its kernels' times summed over ``calls``. A
        trace that recorded no kernel is taken again (at most twice)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False))
            if us > 0:
                return us / 1e3 / calls
        raise RuntimeError("the profiler recorded no kernel in three traces")

    step = {}  # variant → [ms on the plan, ms on the fastest plan], summed over the step
    for shape, (calls, film) in SHAPES.items():
        b, c, h, w = shape
        g = torch.Generator(device=dev).manual_seed(0)
        x = (torch.randn(shape, generator=g, device=dev) + 0.5).to(torch.bfloat16)
        weight = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn(c, generator=g, device=dev)
        ada = (1.0 + 0.2 * torch.randn(b, c, generator=g, device=dev),
               0.2 * torch.randn(b, c, generator=g, device=dev)) if film else (None, None)
        args = (x, weight, bias, 32, 1e-6, *ada, True)
        ref = groupnorm.group_norm_plain(x, weight, bias, swish=True, ada_scale=ada[0],
                                         ada_shift=ada[1]).float()
        nbytes = 2.0 * x.numel() * x.element_size()
        bound_ms = nbytes / BYTES_PER_S * 1e3
        out = torch.empty_like(x)
        add_ms = ms_of(lambda: torch.add(x, 1, out=out))
        form = "FiLM[B,C]+swish" if film else "swish"
        print(f"[{b},{c},{h},{w}] bf16 {form}, {calls} a train step: bound {bound_ms:.4f} ms "
              f"(bytes); torch.add(x, 1, out=y) {add_ms:.4f} ms, {nbytes / add_ms / 1e6:.0f} GB/s, "
              f"{100 * bound_ms / add_ms:.1f}% of the bound [{card}]")

        def report(name, label, ms):
            print(f"  {name} {label}: {ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s of 2-access "
                  f"traffic, {100 * bound_ms / ms:.1f}% of the bound [{card}]")

        def check(name, got):
            rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
            if rel > 1e-2:
                raise AssertionError(f"{name} at {shape}: rel err {rel:.3e}")

        # The earlier pair: per-plane statistics, then the apply.
        lib = built["earlier-pair"]
        stats = torch.empty(2, b * c, device=dev, dtype=torch.float32)
        stream = torch.cuda.current_stream().cuda_stream

        def pair():
            build.check(lib, lib.eovax_gn_stats_bf16(x.data_ptr(), stats[0].data_ptr(),
                                                      stats[1].data_ptr(), b * c, h * w, stream),
                        "gn_stats")
            build.check(lib, lib.eovax_gn_apply_bf16(
                x.data_ptr(), out.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                weight.data_ptr(), bias.data_ptr(), groupnorm._ptr(ada[0]),
                groupnorm._ptr(ada[1]), c if film else 0, b, c, 32, h * w, 1e-6, 1, stream),
                "gn_apply")

        pair()
        torch.cuda.synchronize()
        check("earlier-pair", out)
        pair_ms = ms_of(pair)
        report("earlier-pair", "(gn_stats_kernel + gn_apply_kernel)", pair_ms)
        if calls:
            step.setdefault("earlier-pair", [0.0, 0.0])
            step["earlier-pair"][0] += calls * pair_ms
            step["earlier-pair"][1] += calls * pair_ms

        plans = plans_of(shape)
        for name in ("kernel", "two-pass", "exact-math", "no-write", "no-store", *DIAGNOSTIC):
            lib = built[name]
            times = []
            # The variants change the cluster kernel: timed on the first cluster plan
            # and, the diagnostic ones, on a one-CTA plan (without barriers only there).
            clustered = [q for q in plans if q.cluster > 0]
            timed = plans if name == "kernel" else clustered[:1]
            if name in DIAGNOSTIC:
                one = [q for q in clustered if q.cluster == 1][:1]
                timed = one if name == "no-cluster-barrier" else timed + [
                    q for q in one if q not in timed]
            for plan in timed:
                with mock.patch.object(groupnorm, "_library", lambda lib=lib: lib), \
                        mock.patch.object(groupnorm, "_fwd_plan", lambda *a, p=plan, **kw: p):
                    got = groupnorm._forward(*args, with_stats=False)
                    torch.cuda.synchronize()
                    if name not in ("no-write", "no-store") and (
                            name != "no-cluster-barrier" or plan.cluster == 1):
                        check(f"{name} {plan}", got)
                    ms = ms_of(lambda: groupnorm._forward(*args, with_stats=False))
                    clusters = groupnorm.active_clusters(plan, torch.bfloat16)
                times.append(ms)
                streamed = plan.slice - plan.resident
                mark = ", the plan" if plan == plans[0] else ""
                report(name, f"warp plan (a warp a group{mark})" if plan.cluster == 0 else
                       f"cluster {plan.cluster} slice {plan.slice} resident {plan.resident} "
                       f"({plan.smem_bytes // 1024} KiB, {streamed} streamed{mark}; "
                       f"{clusters} clusters active)", ms)
            if calls and name not in DIAGNOSTIC:
                total = step.setdefault(name, [0.0, 0.0])
                total[0] += calls * times[0]
                total[1] += calls * min(times)
        del x, out, ref, stats
        torch.cuda.empty_cache()
    bounds = sum(calls * 2.0 * b * c * h * w * 2 / BYTES_PER_S * 1e3
                 for (b, c, h, w), (calls, _) in SHAPES.items())
    for name, (planned, best) in step.items():
        print(f"train step's 52 forward calls, {name}: {planned:.3f} ms on _fwd_plan's plans, "
              f"{best:.3f} ms on each shape's fastest plan; sum of bounds {bounds:.3f} ms "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

// GroupNorm for Hopper (sm_90a), NCHW: the forward (normalize, affine, AdaIN,
// SiLU) in one launch, the per-(B, C) statistics of the TPU kernel's contract,
// and the backward of the forward's chain.
//
// Replaces the Pallas TPU kernel `_stats_kernel` / `gn_channel_sums` in
// eovax/kernels/groupnorm.py (pallas_call at line 70), which takes per-(B, C)
// fp32 sums and sums of squares in one streaming pass, and the apply of
// `group_norm` there (`_apply`), which the JAX package leaves to XLA.
//
// Channel sums (`gn_stats_kernel`, for `gn_channel_sums`). In NCHW a channel's
// H·W elements are contiguous, so one block reduces one (b, c) plane in one
// pass. Each thread sums x, and d = x − K and d² about K, the mean of the
// plane's first 256 elements: the E[x²] − mean² of the TPU kernel cancels when
// |mean| ≫ std, as after a conv bias, and sums about a close estimate of the
// mean do not. The block writes the plane's mean (from Σx) and M2 = Σ(x − mean)²
// (from the shifted sums); `gn_channel_sums` turns those into the TPU kernel's
// (Σx, Σx²).
//
// Forward (`gn_fwd_kernel`). y = (x − μ)·r·γ·s + β·s + t per channel, with μ,
// r the fp32 mean and rstd of the (b, group), (s, t) the optional AdaIN scale
// and shift ([C] shared or [B, C]), then the optional SiLU, rounded once.
// What bounds it: bytes. The group's statistics must be complete before its
// first output, so a kernel that streams x from device memory reads it twice
// (3 bytes of traffic per byte of x); the least is x read once and y written
// once, at [16, 128, 256, 256] bf16 537 MB, 0.16 ms at 3.35 TB/s. This design
// reads x once and keeps it on chip in between: a (b, group) is one contiguous
// run of cpg·n elements, and one thread-block cluster of k CTAs owns it (the
// grid is B·G clusters), cut into k slices on channel boundaries as the
// backward cuts it. Each CTA
//   1. copies its slice into dynamic shared memory with 1-D bulk copies
//      (cp.async.bulk), in up to kFwdChunks chunks with one mbarrier each, and
//      sums each chunk as it lands: Σx, and Σd and Σd² of d = x − K about K,
//      the mean of the slice's first 256 elements (the E[x²] − mean² of the
//      TPU kernel cancels when |mean| ≫ std, as after a conv bias);
//   2. after a cluster barrier, reads every CTA's partial sums through
//      distributed shared memory and adds them in rank order (no atomics: the
//      result is bit-identical from call to call), so every CTA holds the
//      group's mean μ;
//   3. moves each CTA's shifted sums to μ exactly,
//      Σ(x − μ)² = Σd² + 2(K − μ)Σd + m(K − μ)², and adds them in rank order
//      into the group's variance (the exact second pass over shared memory,
//      with a second cluster barrier, was slower over the train step's calls:
//      `two-pass` in scripts/ablate_gn_forward.py);
//   4. writes y from its copy with 16-byte stores, per channel
//      y = (x − μ)·a + c with a = r·γ·s and c = β·s + t, then waits at a last
//      cluster barrier, arrived at right after its last remote read, so that
//      no CTA exits while another still reads its partials.
// The channel parameters are read while the copies fly. The CTA of rank 0
// writes the group's fp32 mean and rstd, which the backward reads. A slice
// longer than the plan's resident length keeps its first part in shared memory
// and reads the rest from device memory in steps 1 and 4 (the second read
// mostly from L2): the 2-4 MiB groups of 512² and fp32 at full width. A
// group of at most 32·kWarpVecs 16-byte vectors takes the warp plan instead
// (`gn_fwd_warp_kernel`): one warp per group holds it in registers, with the
// exact two-pass variance, and writes y with no shared memory and no barrier;
// the cluster kernel's fixed costs (bulk copies, block and cluster barriers)
// made one CTA a 1 KiB group take 0.0070 ms at [8, 64, 16, 16] bf16, the warp
// 0.0030 (scripts/ablate_gn_forward.py). A ragged n (not a whole number of 16-byte
// vectors) takes scalar loads, and step 1 copies the resident part into
// shared memory itself. The plan (cluster size, slice, resident length,
// shared-memory bytes) is chosen by the wrapper (`_fwd_plan` in groupnorm.py)
// and checked here; a plan that cannot launch, by its shape or because no
// cluster of it fits on the card, returns an error. A group that no cluster
// size cuts on channel boundaries takes the pixel-split plan instead
// (`gn_fwd_split_kernel`, below the warp plan).
//
// Backward (`gn_bwd_kernel`). Replaces the JAX package's `_gn_bwd`
// (eovax/kernels/groupnorm.py:124-147, the closed-form backward of its
// `group_norm` custom_vjp, in jnp) together with the autodiff of the AdaIN and
// SiLU that follow the norm in its ResnetBlock. The port's forward fuses all
// three, so its backward is one closed form over the chain
//   x̂ = (x − μ)·r,  z = x̂·a + c  (a = γ·s, c = β·s + t),  y = SiLU(z) or z,
// with μ, r the forward's per-group mean and rstd. With g = dL/dy and
// dz = g·σ(z)·(1 + z·(1 − σ(z))) (or g without SiLU), it needs per channel
// S1 = Σ dz and S2 = Σ dz·x̂ (the wrapper turns these [B, C] sums into the
// parameter gradients: dβ = Σ_b s·S1, dγ = Σ_b s·S2, dt = S1, ds = γ·S2 + β·S1),
// then dx = k1·dz + k0 + k2·x̂ with k1 = r·a, k0 = −r·mean(a·dz) and
// k2 = −r·mean(a·dz·x̂), the means over the (b, group).
// What bounds it: bytes. x and g read once and dx written once, 3 bytes of
// traffic per byte of x: at [16, 128, 256, 256] bf16, 805 MB, 0.24 ms at
// 3.35 TB/s. The group's sums must be complete before its first dx, so a
// kernel that streams x and g from device memory reads them twice (5 bytes per
// byte of x). This design reads them once and keeps them on chip in between:
// in NCHW a (b, group) is one contiguous run of cpg·n elements, and one thread
// block cluster of k CTAs owns it (the grid is B·G clusters). The run is cut
// into k slices on channel boundaries (each plane in k/cpg parts, or cpg/k
// whole planes a CTA), so that a CTA's partial sums are per channel. Each CTA
//   1. copies its slice of x and g into dynamic shared memory with 1-D bulk
//      copies (cp.async.bulk, no tensor map), in up to kMaxChunks chunks with
//      one mbarrier each, and reduces each chunk as it lands, recomputing x̂,
//      z and σ(z) in fp32 from x (never from the forward's rounded output);
//      it leaves its per-channel S1, S2 partials in its shared memory;
//   2. after one cluster barrier, reads every CTA's partials through
//      distributed shared memory and sums them in rank order: no atomics, so
//      the result is bit-identical from call to call. The CTA that holds a
//      channel's first element writes the channel's S1 and S2;
//   3. writes dx from its shared-memory copy with 16-byte stores, then waits
//      at a last cluster barrier, arrived at right after step 2's remote
//      reads, so that no CTA exits while another still reads its partials.
// A slice longer than the plan's resident length keeps its first part in
// shared memory and reads the rest from device memory in steps 1 and 3 (the
// second read mostly from L2): fp32 at full width, and 512² training. A ragged
// n (not a whole number of 16-byte vectors) takes scalar loads, and step 1
// copies the resident part into shared memory itself. The plan (cluster size,
// slice, resident length, shared-memory bytes) is chosen by the wrapper
// (`_bwd_plan` in groupnorm.py) and checked here; a plan that cannot launch,
// by its shape or because no cluster of it fits on the card, returns an error.
// A group that no cluster size cuts on channel boundaries takes the
// pixel-split plan instead (`gn_bwd_split_kernel`).
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / (int)sizeof(T); }

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[vec_n<T>()]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec_n<T>(); ++i) v[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[vec_n<T>()]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < vec_n<T>(); ++i) e[i] = from_float<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sums of each v[i] over the block; valid in thread 0.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = 0.f;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = threadIdx.x < kWarps ? red[i * kWarps + threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    }
  }
  __syncthreads();
}

// One block per (b, c) plane of n elements: mean and M2 about the plane's mean.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ m2,
                    long n) {
  __shared__ float red[3 * kWarps];
  __shared__ float shift_s;
  const T* p = x + (size_t)blockIdx.x * n;
  const long m = n < kThreads ? n : kThreads;
  float head[1] = {threadIdx.x < m ? to_float(p[threadIdx.x]) : 0.f};
  block_sums(head, red);
  if (threadIdx.x == 0) shift_s = head[0] / (float)m;
  __syncthreads();
  const float shift = shift_s;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (kVec) {
    constexpr int V = vec_n<T>();
    const long nv = n / V;
#pragma unroll 4
    for (long i = threadIdx.x; i < nv; i += kThreads) {
      float v[V];
      load_vec(p + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = v[j] - shift;
        s0 += v[j];
        s1 += d;
        s2 = fmaf(d, d, s2);
      }
    }
  } else {
    for (long i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_float(p[i]);
      const float d = v - shift;
      s0 += v;
      s1 += d;
      s2 = fmaf(d, d, s2);
    }
  }
  float sums[3] = {s0, s1, s2};
  block_sums(sums, red);
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = sums[0] / (float)n;
    m2[blockIdx.x] = fmaxf(sums[2] - sums[1] * (sums[1] / (float)n), 0.f);
  }
}

// SiLU from the hardware's exp2 and reciprocal (__expf, __fdividef: a few ulp
// in fp32), as the backward's σ(z): the IEEE expf and divide made the apply
// compute-bound (scripts/ablate_gn_forward.py, `exact-math`).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// dL/dz from dL/dy at the pre-SiLU value z. σ(z) from the hardware's exp2 and
// reciprocal (__expf, __fdividef: a few ulp in fp32): with the IEEE expf and
// divide the kernel took 0.54 ms at [16, 128, 256, 256] bf16 on an H100 SXM
// (700 W), with these 0.41 (scripts/ablate_gn_backward.py, `exact-math`): its
// two steps evaluate σ(z) for every element.
__device__ __forceinline__ float dz_of(float g, float z, int swish) {
  if (!swish) return g;
  const float sg = __fdividef(1.f, 1.f + __expf(-z));
  return g * sg * fmaf(z, 1.f - sg, 1.f);
}

// The forward's affine chain, as the backward reads it: per-group mean and rstd
// (fp32 [B, G]), γ and β (fp32 [C]), and the optional AdaIN scale and shift
// (fp32 [C] with ada_stride 0, [B, C] with ada_stride C, or null).
struct Chain {
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  const float* ada_scale;
  const float* ada_shift;
  int ada_stride, C, cpg;
};

// (a, c) of channel ch of image b: z = x̂·a + c.
__device__ __forceinline__ float2 channel_coef(const Chain& p, int b, int ch) {
  const size_t i = (size_t)b * p.ada_stride + ch;
  const float s = p.ada_scale != nullptr ? p.ada_scale[i] : 1.f;
  const float t = p.ada_shift != nullptr ? p.ada_shift[i] : 0.f;
  return make_float2(p.gamma[ch] * s, p.beta[ch] * s + t);
}

constexpr int kMaxSegments = 64;  // channels in one CTA's slice
constexpr int kMaxChunks = 4;     // bulk copies of a slice's resident part, one mbarrier each
constexpr int kMaxCluster = 16;   // above 8 only with the non-portable cluster size

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive once and add `bytes` to the transaction count of the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One 16-byte vector from shared memory or, with kGlobal, device memory.
template <typename T, bool kGlobal>
__device__ __forceinline__ void load_any(const T* p, float (&v)[vec_n<T>()]) {
  if constexpr (kGlobal) {
    load_vec(p, v);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < vec_n<T>(); ++i) v[i] = to_float(e[i]);
  }
}

// Step 1 over the slice's elements [lo, hi): adds Σ dz and Σ dz·x̂ to t1, t2.
// xp, gp point at the slice's first element, in shared memory or, with
// kGlobal, in device memory. With kKeep (scalar loads only) each element is
// also stored at xk, gk: the copy into shared memory of a ragged slice. The
// range is shared by the block's threads, or with kLanes = 32 by one warp's.
template <typename T, bool kVec, bool kGlobal, bool kKeep = false, int kLanes = kThreads>
__device__ __forceinline__ void reduce_range(const T* xp, const T* gp, long lo, long hi,
                                             float mu, float r, float a, float c, int swish,
                                             float& t1, float& t2, T* xk = nullptr,
                                             T* gk = nullptr) {
  const int lane = kLanes == kThreads ? (int)threadIdx.x : (int)threadIdx.x % kLanes;
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 2
    for (long i = lo / V + lane; i < hi / V; i += kLanes) {
      float xv[V], gv[V];
      load_any<T, kGlobal>(xp + i * V, xv);
      load_any<T, kGlobal>(gp + i * V, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mu) * r;
        const float dz = dz_of(gv[j], fmaf(xh, a, c), swish);
        t1 += dz;
        t2 = fmaf(dz, xh, t2);
      }
    }
  } else {
    for (long i = lo + lane; i < hi; i += kLanes) {
      const T xe = xp[i], ge = gp[i];
      if constexpr (kKeep) {
        xk[i] = xe;
        gk[i] = ge;
      }
      const float xh = (to_float(xe) - mu) * r;
      const float dz = dz_of(to_float(ge), fmaf(xh, a, c), swish);
      t1 += dz;
      t2 = fmaf(dz, xh, t2);
    }
  }
}

// Step 3 over [lo, hi): dx = k1·dz + k0 + k2·x̂, rounded once, into dp (the
// slice's first element of dx in device memory).
template <typename T, bool kVec, bool kGlobal>
__device__ __forceinline__ void apply_range(const T* xp, const T* gp, T* dp, long lo, long hi,
                                            float mu, float r, float a, float c, float k1,
                                            float k0, float k2, int swish) {
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 2
    for (long i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
      float xv[V], gv[V];
      load_any<T, kGlobal>(xp + i * V, xv);
      load_any<T, kGlobal>(gp + i * V, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mu) * r;
        const float dz = dz_of(gv[j], fmaf(xh, a, c), swish);
        xv[j] = fmaf(k2, xh, fmaf(k1, dz, k0));
      }
      store_vec(dp + i * V, xv);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float xh = (to_float(xp[i]) - mu) * r;
      const float dz = dz_of(to_float(gp[i]), fmaf(xh, a, c), swish);
      dp[i] = from_float<T>(fmaf(k2, xh, fmaf(k1, dz, k0)));
    }
  }
}

// One cluster of k CTAs per (b, group), grid B·G·k. CTA `rank` owns elements
// [rank·slice, (rank + 1)·slice) of the group's contiguous run of cpg·n, the
// first `resident` of them in dynamic shared memory (x, then g).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx, Chain p,
                  float* __restrict__ s1, float* __restrict__ s2, long n, long slice,
                  long resident, int swish) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kWarps];
  __shared__ float part[2 * kMaxSegments];  // this CTA's S1 partials per channel, then S2's
  __shared__ float2 group_sums;             // Σ a·S1 and Σ a·S2 over the group
  __shared__ __align__(8) uint64_t bar[kMaxChunks];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + resident;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / cluster.num_blocks();  // b·G + group
  const int b = bg / (p.C / p.cpg);
  const int ch_base = (bg % (p.C / p.cpg)) * p.cpg;  // the group's first channel
  const long seg = slice < n ? slice : n;            // elements of one channel in the slice
  const int nseg = (int)(slice / seg);
  const int ch0 = ch_base + (int)((long)rank * slice / n);  // the slice's first channel
  const size_t off = (size_t)bg * p.cpg * n + (size_t)rank * slice;
  const T* xg = x + off;
  const T* gg = g + off;
  T* dxg = dx + off;

  // The resident part in up to kMaxChunks bulk copies each of x and g.
  constexpr int V = vec_n<T>();
  const long chunk = ((resident + kMaxChunks - 1) / kMaxChunks + V - 1) / V * V;
  if (kVec && threadIdx.x == 0 && resident > 0) {
    for (int q = 0; q * chunk < resident; ++q) mbar_init(&bar[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kVec && threadIdx.x == 0) {
    for (int q = 0; q * chunk < resident; ++q) {
      const long e0 = q * chunk;
      const uint32_t bytes = (uint32_t)((resident - e0 < chunk ? resident - e0 : chunk) * sizeof(T));
      mbar_expect_tx(&bar[q], 2 * bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bar[q]);
      bulk_load(gs + e0, gg + e0, bytes, &bar[q]);
    }
  }

  // 1. Per-channel partial sums, each resident chunk as it lands, then the
  // streamed rest.
  const float mu = p.mean[bg], r = p.rstd[bg];
  for (int j = 0; j < nseg; ++j) {
    const float2 ac = channel_coef(p, b, ch0 + j);
    const long e0 = j * seg, e1 = e0 + seg;
    const long r1 = e1 < resident ? e1 : resident, lo = e0 > resident ? e0 : resident;
    float t1 = 0.f, t2 = 0.f;
    if constexpr (kVec) {
      for (long q0 = e0; q0 < r1;) {
        const int q = (int)(q0 / chunk);
        const long q1 = (q + 1) * chunk < r1 ? (q + 1) * chunk : r1;
        mbar_wait(&bar[q], 0);
        reduce_range<T, true, false>(xs, gs, q0, q1, mu, r, ac.x, ac.y, swish, t1, t2);
        q0 = q1;
      }
    } else if (e0 < r1) {
      reduce_range<T, false, true, true>(xg, gg, e0, r1, mu, r, ac.x, ac.y, swish, t1, t2, xs,
                                         gs);
    }
    if (lo < e1) reduce_range<T, kVec, true>(xg, gg, lo, e1, mu, r, ac.x, ac.y, swish, t1, t2);
    float t[2] = {t1, t2};
    block_sums(t, red);
    if (threadIdx.x == 0) {
      part[j] = t[0];
      part[kMaxSegments + j] = t[1];
    }
  }

  // 2. Every CTA's partials, summed per channel in rank order.
  cluster.sync();
  float ga = 0.f, gx = 0.f;
  for (int cc = threadIdx.x; cc < p.cpg; cc += kThreads) {
    const long first = (long)cc * n;  // the channel's first element in the group
    const int q0 = (int)(first / slice), nq = slice < n ? (int)(n / slice) : 1;
    const int jj = (int)((first - (long)q0 * slice) / n);  // its segment in CTA q0
    float c1 = 0.f, c2 = 0.f;
    for (int q = q0; q < q0 + nq; ++q) {
      const float* rp = cluster.map_shared_rank(&part[0], q);
      c1 += rp[jj];
      c2 += rp[kMaxSegments + jj];
    }
    const int ch = ch_base + cc;
    const float a = channel_coef(p, b, ch).x;
    ga = fmaf(a, c1, ga);
    gx = fmaf(a, c2, gx);
    if (q0 == rank) {
      s1[(size_t)b * p.C + ch] = c1;
      s2[(size_t)b * p.C + ch] = c2;
    }
  }
  cluster_arrive();  // done with the other CTAs' shared memory
  float gsum[2] = {ga, gx};
  block_sums(gsum, red);
  if (threadIdx.x == 0) group_sums = make_float2(gsum[0], gsum[1]);
  __syncthreads();

  // 3. dx, from shared memory where resident.
  const float inv = 1.f / ((float)n * (float)p.cpg);
  const float k0 = -r * group_sums.x * inv, k2 = -r * group_sums.y * inv;
  for (int j = 0; j < nseg; ++j) {
    const float2 ac = channel_coef(p, b, ch0 + j);
    const float k1 = r * ac.x;
    const long e0 = j * seg, e1 = e0 + seg;
    const long r1 = e1 < resident ? e1 : resident, lo = e0 > resident ? e0 : resident;
    if (e0 < r1)
      apply_range<T, kVec, false>(xs, gs, dxg, e0, r1, mu, r, ac.x, ac.y, k1, k0, k2, swish);
    if (lo < e1)
      apply_range<T, kVec, true>(xg, gg, dxg, lo, e1, mu, r, ac.x, ac.y, k1, k0, k2, swish);
  }
  cluster_wait();
}

constexpr int kFwdChunks = 8;  // bulk copies of a forward slice's resident part

// The forward's operands besides x and y: γ and β (fp32 [C]); the optional
// AdaIN scale and shift (fp32 [C] with ada_stride 0, [B, C] with ada_stride
// C, or null); the outputs mean and rstd (fp32 [B, G], or null).
struct FwdArgs {
  const float* gamma;
  const float* beta;
  const float* ada_scale;
  const float* ada_shift;
  float* mean;
  float* rstd;
  int ada_stride, C, cpg;
  float eps;
  int swish;
};

// Step 1 over [lo, hi): adds Σx, Σ(x − K) and Σ(x − K)² to acc[0], acc[1]
// and acc[2]. xp points at the slice's first element, in shared memory or,
// with kGlobal, in device memory. With kKeep (scalar loads only) each element
// is also stored at xk: the copy into shared memory of a ragged slice.
template <typename T, bool kVec, bool kGlobal, bool kKeep = false>
__device__ __forceinline__ void sum_range(const T* xp, long lo, long hi, float K,
                                          float (&acc)[3], T* xk = nullptr) {
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 4
    for (long i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
      float v[V];
      load_any<T, kGlobal>(xp + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0] += v[j];
        const float d = v[j] - K;
        acc[1] += d;
        acc[2] = fmaf(d, d, acc[2]);
      }
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const T e = xp[i];
      if constexpr (kKeep) xk[i] = e;
      const float v = to_float(e);
      acc[0] += v;
      const float d = v - K;
      acc[1] += d;
      acc[2] = fmaf(d, d, acc[2]);
    }
  }
}

// Step 4 over [lo, hi): y = (x − μ)·a + c with (a, c) = coef[element / seg],
// then the optional SiLU, rounded once into yp (the slice's first element of y
// in device memory). xp as for sum_range.
template <typename T, bool kVec, bool kGlobal>
__device__ __forceinline__ void apply_fwd(const T* xp, T* yp, long lo, long hi, long seg,
                                          float mu, const float2* coef, int swish) {
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 4
    for (long i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
      float v[V];
      load_any<T, kGlobal>(xp + i * V, v);
      const float2 ac = coef[(uint32_t)(i * V) / (uint32_t)seg];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = fmaf(v[j] - mu, ac.x, ac.y);
        v[j] = swish ? silu(t) : t;
      }
      store_vec(yp + i * V, v);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float2 ac = coef[(uint32_t)i / (uint32_t)seg];
      const float t = fmaf(to_float(xp[i]) - mu, ac.x, ac.y);
      yp[i] = from_float<T>(swish ? silu(t) : t);
    }
  }
}

// One cluster of k CTAs per (b, group), grid B·G·k. CTA `rank` owns elements
// [rank·slice, (rank + 1)·slice) of the group's contiguous run of cpg·n, the
// first `resident` of them in dynamic shared memory.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, FwdArgs p, long n, long slice,
                  long resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[3 * kWarps];
  __shared__ float part[4];  // this CTA's Σx, K, Σ(x − K) and Σ(x − K)² of step 1
  __shared__ float gathered[kMaxCluster][4];
  __shared__ float2 coef[kMaxSegments];
  __shared__ float shift_s;
  __shared__ __align__(8) uint64_t bar[kFwdChunks];
  T* xs = reinterpret_cast<T*>(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / k;  // b·G + group
  const int b = bg / (p.C / p.cpg);
  const long seg = slice < n ? slice : n;  // elements of one channel in the slice
  const int nseg = (int)(slice / seg);
  const int ch0 = (bg % (p.C / p.cpg)) * p.cpg + (int)((long)rank * slice / n);
  const size_t off = (size_t)bg * p.cpg * n + (size_t)rank * slice;
  const T* xg = x + off;
  T* yg = y + off;

  // The resident part in up to kFwdChunks bulk copies.
  constexpr int V = vec_n<T>();
  const long chunk = ((resident + kFwdChunks - 1) / kFwdChunks + V - 1) / V * V;
  if (kVec && threadIdx.x == 0 && resident > 0) {
    for (int q = 0; q * chunk < resident; ++q) mbar_init(&bar[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kVec && threadIdx.x == 0) {
    for (int q = 0; q * chunk < resident; ++q) {
      const long e0 = q * chunk;
      const uint32_t bytes = (uint32_t)((resident - e0 < chunk ? resident - e0 : chunk) * sizeof(T));
      mbar_expect_tx(&bar[q], bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bar[q]);
    }
  }
  // This slice's channel parameters, read now and used after the statistics.
  float gamma = 0.f, beta = 0.f, s = 1.f, t = 0.f;
  if (threadIdx.x < nseg) {
    const int ch = ch0 + threadIdx.x;
    gamma = p.gamma[ch];
    beta = p.beta[ch];
    if (p.ada_scale != nullptr) {
      s = p.ada_scale[(size_t)b * p.ada_stride + ch];
      t = p.ada_shift[(size_t)b * p.ada_stride + ch];
    }
  }

  // The shift of the shifted sums: the mean of the slice's first elements.
  const long m = slice < kThreads ? slice : kThreads;
  float head[1] = {threadIdx.x < m ? to_float(xg[threadIdx.x]) : 0.f};
  block_sums(head, red);
  if (threadIdx.x == 0) shift_s = head[0] / (float)m;
  __syncthreads();
  const float K = shift_s;

  // 1. Partial sums, each resident chunk as it lands, then the streamed rest.
  float acc[3] = {0.f, 0.f, 0.f};
  if constexpr (kVec) {
    for (long q0 = 0; q0 < resident; q0 += chunk) {
      const long q1 = q0 + chunk < resident ? q0 + chunk : resident;
      mbar_wait(&bar[q0 / chunk], 0);
      sum_range<T, true, false>(xs, q0, q1, K, acc);
    }
  } else {
    sum_range<T, false, true, true>(xg, 0, resident, K, acc, xs);
  }
  sum_range<T, kVec, true>(xg, resident, slice, K, acc);
  block_sums(acc, red);
  if (threadIdx.x == 0) {
    part[0] = acc[0];
    part[1] = K;
    part[2] = acc[1];
    part[3] = acc[2];
  }

  // 2. The group's mean from every CTA's partials, in rank order.
  cluster.sync();
  if (threadIdx.x < k) {
    const float* rp = cluster.map_shared_rank(&part[0], (int)threadIdx.x);
#pragma unroll
    for (int i = 0; i < 4; ++i) gathered[threadIdx.x][i] = rp[i];
  }
  __syncthreads();
  const float count = (float)n * (float)p.cpg;
  float sum = 0.f;
  for (int q = 0; q < k; ++q) sum += gathered[q][0];
  const float mu = sum / count;

  // 3. The group's M2 in rank order: each CTA's sums about K moved to μ.
  float m2 = 0.f;
  for (int q = 0; q < k; ++q) {
    const float dk = gathered[q][1] - mu;
    m2 += gathered[q][3] + dk * fmaf((float)slice, dk, 2.f * gathered[q][2]);
  }
  cluster_arrive();  // done with the other CTAs' shared memory
  const float rstd = rsqrtf(fmaxf(m2, 0.f) / count + p.eps);

  // 4. y from shared memory where resident, per channel of the slice.
  if (threadIdx.x < nseg) coef[threadIdx.x] = make_float2(rstd * gamma * s, beta * s + t);
  if (rank == 0 && threadIdx.x == 0 && p.mean != nullptr) {
    p.mean[bg] = mu;
    p.rstd[bg] = rstd;
  }
  __syncthreads();
  apply_fwd<T, kVec, false>(xs, yg, 0, resident, seg, mu, coef, p.swish);
  apply_fwd<T, kVec, true>(xg, yg, resident, slice, seg, mu, coef, p.swish);
  cluster_wait();
}

// The warp plan for small groups: a warp per (b, group), the group in its
// lanes' registers (at most kWarpVecs 16-byte vectors a lane), the sums by
// shuffles, the exact two-pass variance from registers; no shared memory and
// no barrier. Blocks of kWarps groups.
constexpr int kWarpVecs = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y, FwdArgs p, long n,
                       int n_groups) {
  constexpr int V = vec_n<T>();
  const int bg = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);  // b·G + group
  const int lane = threadIdx.x & 31;
  if (bg >= n_groups) return;
  const int b = bg / (p.C / p.cpg);
  const int ch_base = (bg % (p.C / p.cpg)) * p.cpg;
  const long nv = (long)p.cpg * n / V;  // vectors of the group
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)bg * p.cpg * n);
  uint4* yv = reinterpret_cast<uint4*>(y + (size_t)bg * p.cpg * n);
  uint4 raw[kWarpVecs];
  float gamma[kWarpVecs], beta[kWarpVecs], s[kWarpVecs], t[kWarpVecs];
#pragma unroll
  for (int j = 0; j < kWarpVecs; ++j) {
    const long i = lane + 32L * j;
    if (i < nv) {
      raw[j] = __ldg(xv + i);
      const int ch = ch_base + (int)(i * V / n);
      gamma[j] = p.gamma[ch];
      beta[j] = p.beta[ch];
      s[j] = p.ada_scale != nullptr ? p.ada_scale[(size_t)b * p.ada_stride + ch] : 1.f;
      t[j] = p.ada_shift != nullptr ? p.ada_shift[(size_t)b * p.ada_stride + ch] : 0.f;
    }
  }
  const float count = (float)n * (float)p.cpg;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kWarpVecs; ++j) {
    if (lane + 32L * j < nv) {
      const T* e = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
      for (int q = 0; q < V; ++q) sum += to_float(e[q]);
    }
  }
  const float mu = warp_sum(sum) / count;
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < kWarpVecs; ++j) {
    if (lane + 32L * j < nv) {
      const T* e = reinterpret_cast<const T*>(&raw[j]);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float d = to_float(e[q]) - mu;
        m2 = fmaf(d, d, m2);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(m2) / count + p.eps);
  if (lane == 0 && p.mean != nullptr) {
    p.mean[bg] = mu;
    p.rstd[bg] = rstd;
  }
#pragma unroll
  for (int j = 0; j < kWarpVecs; ++j) {
    const long i = lane + 32L * j;
    if (i < nv) {
      const float a = rstd * gamma[j] * s[j], c = beta[j] * s[j] + t[j];
      const T* e = reinterpret_cast<const T*>(&raw[j]);
      float v[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float z = fmaf(to_float(e[q]) - mu, a, c);
        v[q] = p.swish ? silu(z) : z;
      }
      store_vec(reinterpret_cast<T*>(yv + i), v);
    }
  }
}

// The pixel-split plan, for a group that no cluster size cuts on channel
// boundaries (an odd cpg above 64, twice an odd cpg above 128, any cpg above
// 1024, as in GroupNorm(1, C)). CTA `rank` of the cluster owns the `len`
// elements [rank·slice, rank·slice + len) of the group's run, len = slice but
// for the last CTA's, which holds the rest. A slice starts and ends anywhere in
// a channel (on 16-byte vectors where n is a whole number of them), so a
// channel may be split between neighbouring CTAs, and a slice may hold any
// number of channels. Both kernels walk a slice's channels in windows of at
// most kWindow channels, with the window's per-channel coefficients in shared
// memory, and find an element's channel by one 32-bit division (a window spans
// less than 2³² elements). The forward needs only the group's sums, so its
// steps 1-3 are the cluster kernel's, with each CTA's own length. In the
// backward one warp reduces one channel of the window; a channel whole in the
// slice is written by its CTA, and a split one by the CTA that holds its first
// element, which adds the other CTAs' partials of it in rank order through
// distributed shared memory. The group's Σ a·S1 and Σ a·S2 are each CTA's sums
// of a·(its partials), added in rank order. No atomics: the results are
// bit-identical from call to call.
constexpr int kWindow = 64;

// Channels of one window: at most kWindow, spanning less than 2³² elements
// (the plan has n < 2³²).
__device__ __forceinline__ long window_channels(long n) {
  const long w = 0xFFFFFFFFL / n;
  return w < kWindow ? w : kWindow;
}

// Step 4 of the pixel-split forward over the slice's elements [lo, hi):
// y = (x − μ)·a + c with (a, c) = coef[(org + i) / n] for the element i, which
// lies org + i elements past the start of the window's first channel, then the
// optional SiLU. xp, yp as for apply_fwd.
template <typename T, bool kVec, bool kGlobal>
__device__ __forceinline__ void apply_fwd_window(const T* xp, T* yp, long lo, long hi, long org,
                                                 uint32_t n, float mu, const float2* coef,
                                                 int swish) {
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 4
    for (long i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
      float v[V];
      load_any<T, kGlobal>(xp + i * V, v);
      const float2 ac = coef[(uint32_t)(org + i * V) / n];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = fmaf(v[j] - mu, ac.x, ac.y);
        v[j] = swish ? silu(t) : t;
      }
      store_vec(yp + i * V, v);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float2 cf = coef[(uint32_t)(org + i) / n];
      const float t = fmaf(to_float(xp[i]) - mu, cf.x, cf.y);
      yp[i] = from_float<T>(swish ? silu(t) : t);
    }
  }
}

// Step 3 of the pixel-split backward over the slice's elements [lo, hi):
// dx = k1·dz + k0 + k2·x̂ with (a, c) = coef[(org + i) / n] and k1 = r·a, as
// apply_fwd_window finds them.
template <typename T, bool kVec, bool kGlobal>
__device__ __forceinline__ void apply_bwd_window(const T* xp, const T* gp, T* dp, long lo, long hi,
                                                 long org, uint32_t n, float mu, float r,
                                                 const float2* coef, float k0, float k2,
                                                 int swish) {
  if constexpr (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 2
    for (long i = lo / V + threadIdx.x; i < hi / V; i += kThreads) {
      float xv[V], gv[V];
      load_any<T, kGlobal>(xp + i * V, xv);
      load_any<T, kGlobal>(gp + i * V, gv);
      const float2 ac = coef[(uint32_t)(org + i * V) / n];
      const float k1 = r * ac.x;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mu) * r;
        const float dz = dz_of(gv[j], fmaf(xh, ac.x, ac.y), swish);
        xv[j] = fmaf(k2, xh, fmaf(k1, dz, k0));
      }
      store_vec(dp + i * V, xv);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float2 ac = coef[(uint32_t)(org + i) / n];
      const float xh = (to_float(xp[i]) - mu) * r;
      const float dz = dz_of(to_float(gp[i]), fmaf(xh, ac.x, ac.y), swish);
      dp[i] = from_float<T>(fmaf(k2, xh, fmaf(r * ac.x, dz, k0)));
    }
  }
}

// Where a pixel-split CTA's slice lies in its group: its first element, its
// length, the resident part's length and the channels [first, last] it touches.
struct SplitSlice {
  long start, len, res, first, last;
};

__device__ __forceinline__ SplitSlice split_slice(long span, long n, long slice, long resident,
                                                  int rank) {
  SplitSlice s;
  s.start = (long)rank * slice;
  s.len = slice < span - s.start ? slice : span - s.start;
  s.res = resident < s.len ? resident : s.len;
  s.first = s.start / n;
  s.last = (s.start + s.len - 1) / n;
  return s;
}

// The forward on the pixel-split plan: one cluster of k CTAs per (b, group),
// grid B·G·k, steps 1-4 of gn_fwd_kernel over this CTA's slice.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gn_fwd_split_kernel(const T* __restrict__ x, T* __restrict__ y, FwdArgs p, long n, long slice,
                        long resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[3 * kWarps];
  __shared__ float part[4];  // this CTA's Σx, K, Σ(x − K) and Σ(x − K)² of step 1
  __shared__ float gathered[kMaxCluster][4];
  __shared__ float2 coef[kWindow];  // (a, c) of the window's channels
  __shared__ float shift_s;
  __shared__ __align__(8) uint64_t bar[kFwdChunks];
  T* xs = reinterpret_cast<T*>(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / k;  // b·G + group
  const int b = bg / (p.C / p.cpg);
  const int ch_base = (bg % (p.C / p.cpg)) * p.cpg;  // the group's first channel
  const long span = (long)p.cpg * n;
  const SplitSlice sl = split_slice(span, n, slice, resident, rank);
  const long res = sl.res;
  const size_t off = (size_t)bg * span + sl.start;
  const T* xg = x + off;
  T* yg = y + off;

  // The resident part in up to kFwdChunks bulk copies.
  constexpr int V = vec_n<T>();
  const long chunk = ((res + kFwdChunks - 1) / kFwdChunks + V - 1) / V * V;
  if (kVec && threadIdx.x == 0 && res > 0) {
    for (int q = 0; q * chunk < res; ++q) mbar_init(&bar[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kVec && threadIdx.x == 0) {
    for (int q = 0; q * chunk < res; ++q) {
      const long e0 = q * chunk;
      const uint32_t bytes = (uint32_t)((res - e0 < chunk ? res - e0 : chunk) * sizeof(T));
      mbar_expect_tx(&bar[q], bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bar[q]);
    }
  }

  // The shift of the shifted sums: the mean of the slice's first elements.
  const long m = sl.len < kThreads ? sl.len : kThreads;
  float head[1] = {threadIdx.x < m ? to_float(xg[threadIdx.x]) : 0.f};
  block_sums(head, red);
  if (threadIdx.x == 0) shift_s = head[0] / (float)m;
  __syncthreads();
  const float K = shift_s;

  // 1. Partial sums, each resident chunk as it lands, then the streamed rest.
  float acc[3] = {0.f, 0.f, 0.f};
  if constexpr (kVec) {
    for (long e0 = 0; e0 < res; e0 += chunk) {
      const long e1 = e0 + chunk < res ? e0 + chunk : res;
      mbar_wait(&bar[e0 / chunk], 0);
      sum_range<T, true, false>(xs, e0, e1, K, acc);
    }
  } else {
    sum_range<T, false, true, true>(xg, 0, res, K, acc, xs);
  }
  sum_range<T, kVec, true>(xg, res, sl.len, K, acc);
  block_sums(acc, red);
  if (threadIdx.x == 0) {
    part[0] = acc[0];
    part[1] = K;
    part[2] = acc[1];
    part[3] = acc[2];
  }

  // 2. The group's mean from every CTA's partials, in rank order.
  cluster.sync();  // every CTA's partials are in place
  if (threadIdx.x < k) {
    const float* rp = cluster.map_shared_rank(&part[0], (int)threadIdx.x);
#pragma unroll
    for (int i = 0; i < 4; ++i) gathered[threadIdx.x][i] = rp[i];
  }
  __syncthreads();
  const float count = (float)n * (float)p.cpg;
  float sum = 0.f;
  for (int q = 0; q < k; ++q) sum += gathered[q][0];
  const float mu = sum / count;

  // 3. The group's M2 in rank order: each CTA's sums about K moved to μ, with
  // each CTA's own length.
  float m2 = 0.f;
  for (int q = 0; q < k; ++q) {
    const long lq = slice < span - (long)q * slice ? slice : span - (long)q * slice;
    const float dk = gathered[q][1] - mu;
    m2 += gathered[q][3] + dk * fmaf((float)lq, dk, 2.f * gathered[q][2]);
  }
  cluster_arrive();  // the other CTAs' partials are read
  const float rstd = rsqrtf(fmaxf(m2, 0.f) / count + p.eps);
  if (rank == 0 && threadIdx.x == 0 && p.mean != nullptr) {
    p.mean[bg] = mu;
    p.rstd[bg] = rstd;
  }

  // 4. y, a window of the slice's channels at a time, from shared memory where
  // resident.
  const long w = window_channels(n);
  for (long c0 = sl.first; c0 <= sl.last; c0 += w) {
    const int nw = (int)(sl.last + 1 - c0 < w ? sl.last + 1 - c0 : w);
    __syncthreads();  // the window before is written; a ragged slice's copy is in place
    if (threadIdx.x < nw) {
      const int ch = ch_base + (int)c0 + (int)threadIdx.x;
      float s = 1.f, t = 0.f;
      if (p.ada_scale != nullptr) {
        s = p.ada_scale[(size_t)b * p.ada_stride + ch];
        t = p.ada_shift[(size_t)b * p.ada_stride + ch];
      }
      coef[threadIdx.x] = make_float2(rstd * p.gamma[ch] * s, p.beta[ch] * s + t);
    }
    __syncthreads();
    const long org = sl.start - c0 * n;  // the slice's start past the window's
    const long lo = org > 0 ? 0 : -org;
    const long hi = nw * n - org < sl.len ? nw * n - org : sl.len;
    const long r1 = hi < res ? hi : res, lo2 = lo > res ? lo : res;
    if (lo < r1)
      apply_fwd_window<T, kVec, false>(xs, yg, lo, r1, org, (uint32_t)n, mu, coef, p.swish);
    if (lo2 < hi)
      apply_fwd_window<T, kVec, true>(xg, yg, lo2, hi, org, (uint32_t)n, mu, coef, p.swish);
  }
  cluster_wait();
}

// The backward on the pixel-split plan: one cluster of k CTAs per (b, group),
// grid B·G·k, x then g of the slice's first `resident` elements in dynamic
// shared memory.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
    gn_bwd_split_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                        Chain p, float* __restrict__ s1, float* __restrict__ s2, long n,
                        long slice, long resident, int swish) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 coef[kWindow];  // (a, c) of the window's channels
  __shared__ float2 sums[kWindow];  // this slice's (Σ dz, Σ dz·x̂) of each
  // What the other CTAs read: this slice's partials (S1, S2) of its first and
  // of its last channel, then its Σ a·S1 and Σ a·S2 over its partials.
  __shared__ float pub[6];
  __shared__ float2 group_sums;  // Σ a·S1 and Σ a·S2 over the group
  __shared__ __align__(8) uint64_t bar[kMaxChunks];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + resident;

  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / k;  // b·G + group
  const int b = bg / (p.C / p.cpg);
  const int ch_base = (bg % (p.C / p.cpg)) * p.cpg;  // the group's first channel
  const long span = (long)p.cpg * n;
  const SplitSlice sl = split_slice(span, n, slice, resident, rank);
  const long res = sl.res;
  const size_t off = (size_t)bg * span + sl.start;
  const T* xg = x + off;
  const T* gg = g + off;
  T* dxg = dx + off;

  // The resident part in up to kMaxChunks bulk copies each of x and g.
  constexpr int V = vec_n<T>();
  const long chunk = ((res + kMaxChunks - 1) / kMaxChunks + V - 1) / V * V;
  if (kVec && threadIdx.x == 0 && res > 0) {
    for (int q = 0; q * chunk < res; ++q) mbar_init(&bar[q], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kVec && threadIdx.x == 0) {
    for (int q = 0; q * chunk < res; ++q) {
      const long e0 = q * chunk;
      const uint32_t bytes = (uint32_t)((res - e0 < chunk ? res - e0 : chunk) * sizeof(T));
      mbar_expect_tx(&bar[q], 2 * bytes);
      bulk_load(xs + e0, xg + e0, bytes, &bar[q]);
      bulk_load(gs + e0, gg + e0, bytes, &bar[q]);
    }
  }

  // 1. Per-channel partial sums, a window of channels at a time, one warp a
  // channel; thread 0 folds each window in channel order.
  const float mu = p.mean[bg], r = p.rstd[bg];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long w = window_channels(n);
  float ga = 0.f, gx = 0.f;  // thread 0's Σ a·S1, Σ a·S2 over this slice's partials
  for (long c0 = sl.first; c0 <= sl.last; c0 += w) {
    const int nw = (int)(sl.last + 1 - c0 < w ? sl.last + 1 - c0 : w);
    __syncthreads();  // thread 0 has folded the window before
    if (threadIdx.x < nw)
      coef[threadIdx.x] = channel_coef(p, b, ch_base + (int)c0 + (int)threadIdx.x);
    __syncthreads();
    for (int j = warp; j < nw; j += kWarps) {
      const long cs = (c0 + j) * n - sl.start;  // the channel's first element, in the slice
      const long e0 = cs > 0 ? cs : 0, e1 = cs + n < sl.len ? cs + n : sl.len;
      const long r1 = e1 < res ? e1 : res, lo = e0 > res ? e0 : res;
      const float2 ac = coef[j];
      float t1 = 0.f, t2 = 0.f;
      if constexpr (kVec) {
        for (long q0 = e0; q0 < r1;) {
          const int q = (int)(q0 / chunk);
          const long q1 = (q + 1) * chunk < r1 ? (q + 1) * chunk : r1;
          mbar_wait(&bar[q], 0);
          reduce_range<T, true, false, false, 32>(xs, gs, q0, q1, mu, r, ac.x, ac.y, swish, t1,
                                                  t2);
          q0 = q1;
        }
      } else if (e0 < r1) {
        reduce_range<T, false, true, true, 32>(xg, gg, e0, r1, mu, r, ac.x, ac.y, swish, t1, t2,
                                               xs, gs);
      }
      if (lo < e1)
        reduce_range<T, kVec, true, false, 32>(xg, gg, lo, e1, mu, r, ac.x, ac.y, swish, t1, t2);
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) sums[j] = make_float2(t1, t2);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < nw; ++j) {
        const long cc = c0 + j;
        const float2 t = sums[j];
        ga = fmaf(coef[j].x, t.x, ga);
        gx = fmaf(coef[j].x, t.y, gx);
        if (cc * n >= sl.start && (cc + 1) * n <= sl.start + sl.len) {  // whole in this slice
          s1[(size_t)b * p.C + ch_base + cc] = t.x;
          s2[(size_t)b * p.C + ch_base + cc] = t.y;
        }
        if (cc == sl.first) {
          pub[0] = t.x;
          pub[1] = t.y;
        }
        if (cc == sl.last) {
          pub[2] = t.x;
          pub[3] = t.y;
        }
      }
      pub[4] = ga;
      pub[5] = gx;
    }
  }

  // 2. The group's sums from every CTA's, in rank order; the sums of a split
  // channel that starts in this slice, from this CTA's partial and those of
  // the CTAs after it, in rank order.
  cluster.sync();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (int q = 0; q < k; ++q) {
      const float* rp = cluster.map_shared_rank(&pub[0], q);
      t1 += rp[4];
      t2 += rp[5];
    }
    group_sums = make_float2(t1, t2);
    const long end = (sl.last + 1) * n;  // one past the last channel's last element
    if (sl.last * n >= sl.start && end > sl.start + sl.len) {
      float c1 = pub[2], c2 = pub[3];
      for (int q = rank + 1; q < k && (long)q * slice < end; ++q) {
        const float* rp = cluster.map_shared_rank(&pub[0], q);
        c1 += rp[0];
        c2 += rp[1];
      }
      s1[(size_t)b * p.C + ch_base + sl.last] = c1;
      s2[(size_t)b * p.C + ch_base + sl.last] = c2;
    }
  }
  cluster_arrive();  // done with the other CTAs' shared memory
  if (kVec) {  // every resident chunk has landed (each warp waited only for its channels')
    for (int q = 0; q * chunk < res; ++q) mbar_wait(&bar[q], 0);
  }

  // 3. dx, a window of channels at a time, from shared memory where resident.
  const float inv = 1.f / ((float)n * (float)p.cpg);
  float k0 = 0.f, k2 = 0.f;
  for (long c0 = sl.first; c0 <= sl.last; c0 += w) {
    const int nw = (int)(sl.last + 1 - c0 < w ? sl.last + 1 - c0 : w);
    __syncthreads();  // the window before is written; group_sums is in place
    if (c0 == sl.first) {
      k0 = -r * group_sums.x * inv;
      k2 = -r * group_sums.y * inv;
    }
    if (threadIdx.x < nw)
      coef[threadIdx.x] = channel_coef(p, b, ch_base + (int)c0 + (int)threadIdx.x);
    __syncthreads();
    const long org = sl.start - c0 * n;  // the slice's start past the window's
    const long lo = org > 0 ? 0 : -org;
    const long hi = nw * n - org < sl.len ? nw * n - org : sl.len;
    const long r1 = hi < res ? hi : res, lo2 = lo > res ? lo : res;
    if (lo < r1)
      apply_bwd_window<T, kVec, false>(xs, gs, dxg, lo, r1, org, (uint32_t)n, mu, r, coef, k0, k2,
                                       swish);
    if (lo2 < hi)
      apply_bwd_window<T, kVec, true>(xg, gg, dxg, lo2, hi, org, (uint32_t)n, mu, r, coef, k0, k2,
                                      swish);
  }
  cluster_wait();
}

// Vectors need n to be a whole number of 16-byte vectors and x, y 16-byte aligned.
template <typename T>
bool vectorizable(const void* x, const void* y, long n) {
  return n % vec_n<T>() == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0;
}

template <typename T>
int launch_stats(const void* x, float* mean, float* m2, int planes, long n, cudaStream_t stream) {
  if (planes <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  if (vectorizable<T>(x, x, n))
    gn_stats_kernel<T, true><<<planes, kThreads, 0, stream>>>(xt, mean, m2, n);
  else
    gn_stats_kernel<T, false><<<planes, kThreads, 0, stream>>>(xt, mean, m2, n);
  return (int)cudaGetLastError();
}

Chain make_chain(const void* mean, const void* rstd, const void* gamma, const void* beta,
                 const void* ada_scale, const void* ada_shift, int ada_stride, int C, int groups) {
  return Chain{static_cast<const float*>(mean),      static_cast<const float*>(rstd),
               static_cast<const float*>(gamma),     static_cast<const float*>(beta),
               static_cast<const float*>(ada_scale), static_cast<const float*>(ada_shift),
               ada_stride,                            C,
               C / groups};
}

// The wrapper's plan, checked: `cluster` (a power of two up to kMaxCluster)
// slices of the group's cpg·n elements, each a whole number of planes or a
// whole fraction of one plane, at most kMaxSegments channels a slice, or with
// `split` the pixel-split plan's slices (`slice` elements each but the last,
// which holds the rest and at least one element; n below 2³²); the first
// `resident` elements of a slice of each of `operands` tensors (the forward's
// x; the backward's x and g) in `smem` bytes of shared memory; with 16-byte
// vectors, slice and resident whole vectors.
template <typename T>
bool plan_ok(int cpg, long n, int cluster, long slice, long resident, int smem, bool vec,
             int operands, bool split) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) return false;
  const long span = (long)cpg * n;
  if (split) {
    if (n > 0xFFFFFFFFL || slice <= 0 || slice * cluster < span || slice * (cluster - 1) >= span)
      return false;
  } else {
    if (slice <= 0 || slice * cluster != span) return false;
    if (slice % n != 0 && n % slice != 0) return false;
    if (slice / (slice < n ? slice : n) > kMaxSegments) return false;
  }
  if (resident < 0 || resident > slice || (long)smem != operands * resident * (long)sizeof(T))
    return false;
  return !vec || (slice % vec_n<T>() == 0 && resident % vec_n<T>() == 0);
}

cudaLaunchConfig_t cluster_config(unsigned clusters, int cluster, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// An error code of a runtime call, with the runtime's last error cleared: a
// refused plan must not fail the library's next launch, whose check reads it.
int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

// How many clusters of `cluster` CTAs with `smem` bytes of dynamic shared
// memory the current card holds at once (cudaOccupancyMaxActiveClusters) of a
// cluster kernel, into *count. Sets the kernel's attributes first: 16-CTA
// clusters allowed, shared memory preferred over L1, and the dynamic shared
// memory the plan asks for. CUDA holds a function's attributes per device, so
// the attributes set and the answers are kept per (device, kernel), the device
// the current one (the wrappers enter the input's device); a mutex guards the
// tables, which host threads driving several cards share.
int active_clusters(const void* kernel, int cluster, int smem, int* count) {
  constexpr int kCache = 256, kKernels = 128;
  struct Answer { int device; const void* kernel; int cluster, smem, count; };
  struct Attrs { int device; const void* kernel; int smem; };
  static Answer answers[kCache];
  static Attrs attrs[kKernels];
  static int n_answers = 0, n_attrs = 0;
  static std::mutex mutex;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return refused(err);
  const std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < n_answers; ++i) {
    const Answer& a = answers[i];
    if (a.device == device && a.kernel == kernel && a.cluster == cluster && a.smem == smem) {
      *count = a.count;
      return 0;
    }
  }
  int at = 0;
  while (at < n_attrs && !(attrs[at].device == device && attrs[at].kernel == kernel)) ++at;
  if (at == kKernels) return (int)cudaErrorInvalidValue;
  if (at == n_attrs) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return refused(err);
    attrs[n_attrs++] = Attrs{device, kernel, 0};
  }
  if (smem > attrs[at].smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return refused(err);
    attrs[at].smem = smem;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  if (err != cudaSuccess) return refused(err);
  if (n_answers < kCache) answers[n_answers++] = Answer{device, kernel, cluster, smem, *count};
  return 0;
}

// Launch `kernel` as `clusters` clusters of `cluster` CTAs with `smem` bytes of
// dynamic shared memory, or refuse a plan of which no cluster fits on the card.
// A one-CTA cluster launches without the cluster attribute (the grid's implicit
// clusters are one CTA each): with it the forward took 0.0214 ms at
// [16, 512, 32, 32] bf16, without 0.0200 (scripts/ablate_gn_forward.py).
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), unsigned clusters, int cluster, int smem,
                    cudaStream_t stream, Args... args) {
  int active = 0;
  const int code = active_clusters(reinterpret_cast<const void*>(kernel), cluster, smem, &active);
  if (code != 0) return code;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(clusters, cluster, smem, stream, &attr);
  if (cluster == 1) cfg.numAttrs = 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

bool shape_ok(int B, int C, int groups, long n, int cluster) {
  return B > 0 && C > 0 && groups > 0 && C % groups == 0 && n > 0 &&
         (long)B * groups * cluster <= 0x7fffffffL;
}

// The forward in one launch, on the wrapper's plan.
template <typename T>
int launch_fwd(const void* x, void* y, const void* gamma, const void* beta, const void* ada_scale,
               const void* ada_shift, int ada_stride, void* mean, void* rstd, int B, int C,
               int groups, long n, float eps, int swish, int cluster, long slice, long resident,
               int smem, int split, cudaStream_t stream) {
  if (!shape_ok(B, C, groups, n, cluster > 0 ? cluster : 1)) return (int)cudaErrorInvalidValue;
  const FwdArgs p{static_cast<const float*>(gamma),
                  static_cast<const float*>(beta),
                  static_cast<const float*>(ada_scale),
                  static_cast<const float*>(ada_shift),
                  static_cast<float*>(mean),
                  static_cast<float*>(rstd),
                  ada_stride,
                  C,
                  C / groups,
                  eps,
                  swish};
  const bool vec = vectorizable<T>(x, y, n);
  if (cluster == 0) {  // the warp plan: the group whole in one warp's vectors
    const long span = (long)p.cpg * n;
    if (!vec || split || slice != span || resident != span || smem != 0 ||
        span > 32L * kWarpVecs * vec_n<T>())
      return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((B * groups + kWarps - 1) / kWarps);
    gn_fwd_warp_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), p, n, B * groups);
    return (int)cudaGetLastError();
  }
  if (!plan_ok<T>(p.cpg, n, cluster, slice, resident, smem, vec, 1, split != 0))
    return (int)cudaErrorInvalidValue;
  const auto kernel = split ? (vec ? gn_fwd_split_kernel<T, true> : gn_fwd_split_kernel<T, false>)
                            : (vec ? gn_fwd_kernel<T, true> : gn_fwd_kernel<T, false>);
  return launch_clusters(kernel, (unsigned)(B * groups), cluster, smem, stream,
                         static_cast<const T*>(x), static_cast<T*>(y), p, n, slice, resident);
}

// The backward in one launch, on the wrapper's plan.
template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
               const void* gamma, const void* beta, const void* ada_scale, const void* ada_shift,
               int ada_stride, void* s1, void* s2, int B, int C, int groups, long n, int swish,
               int cluster, long slice, long resident, int smem, int split, cudaStream_t stream) {
  if (!shape_ok(B, C, groups, n, cluster)) return (int)cudaErrorInvalidValue;
  const Chain p = make_chain(mean, rstd, gamma, beta, ada_scale, ada_shift, ada_stride, C, groups);
  const bool vec = vectorizable<T>(x, g, n) && vectorizable<T>(dx, dx, n);
  if (!plan_ok<T>(p.cpg, n, cluster, slice, resident, smem, vec, 2, split != 0))
    return (int)cudaErrorInvalidValue;
  const auto kernel = split ? (vec ? gn_bwd_split_kernel<T, true> : gn_bwd_split_kernel<T, false>)
                            : (vec ? gn_bwd_kernel<T, true> : gn_bwd_kernel<T, false>);
  return launch_clusters(kernel, (unsigned)(B * groups), cluster, smem, stream,
                         static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
                         p, static_cast<float*>(s1), static_cast<float*>(s2), n, slice, resident,
                         swish);
}

// cudaOccupancyMaxActiveClusters of the forward's (fwd) or the backward's
// cluster kernel, its vectorized (vec != 0) or scalar instance, on the
// channel-boundary or (split != 0) the pixel-split plan, for a plan's cluster
// size and shared-memory bytes.
template <typename T>
int clusters_of(bool fwd, int cluster, int smem, int vec, int split, int* count) {
  const void* kernels[2][2][2] = {
      {{reinterpret_cast<const void*>(gn_bwd_kernel<T, false>),
        reinterpret_cast<const void*>(gn_bwd_kernel<T, true>)},
       {reinterpret_cast<const void*>(gn_bwd_split_kernel<T, false>),
        reinterpret_cast<const void*>(gn_bwd_split_kernel<T, true>)}},
      {{reinterpret_cast<const void*>(gn_fwd_kernel<T, false>),
        reinterpret_cast<const void*>(gn_fwd_kernel<T, true>)},
       {reinterpret_cast<const void*>(gn_fwd_split_kernel<T, false>),
        reinterpret_cast<const void*>(gn_fwd_split_kernel<T, true>)}}};
  return active_clusters(kernels[fwd ? 1 : 0][split ? 1 : 0][vec ? 1 : 0], cluster, smem, count);
}

}  // namespace

extern "C" {

// x: contiguous [planes, n] (NCHW with planes = B·C, n = H·W); mean, m2: fp32 [planes].
int eovax_gn_stats_bf16(const void* x, void* mean, void* m2, int planes, long n, void* stream) {
  return launch_stats<__nv_bfloat16>(x, static_cast<float*>(mean), static_cast<float*>(m2),
                                     planes, n, static_cast<cudaStream_t>(stream));
}

int eovax_gn_stats_f32(const void* x, void* mean, void* m2, int planes, long n, void* stream) {
  return launch_stats<float>(x, static_cast<float*>(mean), static_cast<float*>(m2), planes, n,
                             static_cast<cudaStream_t>(stream));
}

// Forward. x, y: contiguous [B, C, n]; gamma, beta: fp32 [C]; ada_scale, ada_shift:
// fp32 [C] (ada_stride 0) or [B, C] (ada_stride C), or both null; mean, rstd: fp32
// [B, groups] outputs, or both null. cluster, slice, resident, smem, split: the plan
// (see plan_ok), or cluster 0 for the warp plan (slice and resident the group's cpg·n
// elements, at most 32·kWarpVecs 16-byte vectors, smem 0, split 0; x and y 16-byte
// aligned).
int eovax_gn_fwd_bf16(const void* x, void* y, const void* gamma, const void* beta,
                      const void* ada_scale, const void* ada_shift, int ada_stride, void* mean,
                      void* rstd, int B, int C, int groups, long n, float eps, int swish,
                      int cluster, long slice, long resident, int smem, int split, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, y, gamma, beta, ada_scale, ada_shift, ada_stride, mean, rstd,
                                   B, C, groups, n, eps, swish, cluster, slice, resident, smem,
                                   split, static_cast<cudaStream_t>(stream));
}

int eovax_gn_fwd_f32(const void* x, void* y, const void* gamma, const void* beta,
                     const void* ada_scale, const void* ada_shift, int ada_stride, void* mean,
                     void* rstd, int B, int C, int groups, long n, float eps, int swish,
                     int cluster, long slice, long resident, int smem, int split, void* stream) {
  return launch_fwd<float>(x, y, gamma, beta, ada_scale, ada_shift, ada_stride, mean, rstd, B, C,
                           groups, n, eps, swish, cluster, slice, resident, smem, split,
                           static_cast<cudaStream_t>(stream));
}

// Backward. x, g, dx: contiguous [B, C, n] in one dtype; mean, rstd: fp32 [B, groups];
// gamma, beta: fp32 [C]; ada_scale, ada_shift as for the apply, or both null; s1, s2:
// fp32 [B, C] outputs, Σ dz and Σ dz·x̂ per plane. cluster, slice, resident, smem,
// split: the plan (see plan_ok).
int eovax_gn_bwd_bf16(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
                      const void* gamma, const void* beta, const void* ada_scale,
                      const void* ada_shift, int ada_stride, void* s1, void* s2, int B, int C,
                      int groups, long n, int swish, int cluster, long slice, long resident,
                      int smem, int split, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dx, mean, rstd, gamma, beta, ada_scale, ada_shift,
                                   ada_stride, s1, s2, B, C, groups, n, swish, cluster, slice,
                                   resident, smem, split, static_cast<cudaStream_t>(stream));
}

int eovax_gn_bwd_f32(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
                     const void* gamma, const void* beta, const void* ada_scale,
                     const void* ada_shift, int ada_stride, void* s1, void* s2, int B, int C,
                     int groups, long n, int swish, int cluster, long slice, long resident,
                     int smem, int split, void* stream) {
  return launch_bwd<float>(x, g, dx, mean, rstd, gamma, beta, ada_scale, ada_shift, ada_stride,
                           s1, s2, B, C, groups, n, swish, cluster, slice, resident, smem, split,
                           static_cast<cudaStream_t>(stream));
}

// cudaOccupancyMaxActiveClusters of the forward's (fwd != 0) or the backward's
// vectorized (vec != 0) or scalar instance, on the channel-boundary or
// (split != 0) the pixel-split plan, for a plan's cluster size and
// shared-memory bytes, into *count.
int eovax_gn_clusters_bf16(int fwd, int cluster, int smem, int vec, int split, int* count) {
  return clusters_of<__nv_bfloat16>(fwd != 0, cluster, smem, vec, split, count);
}

int eovax_gn_clusters_f32(int fwd, int cluster, int smem, int vec, int split, int* count) {
  return clusters_of<float>(fwd != 0, cluster, smem, vec, split, count);
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

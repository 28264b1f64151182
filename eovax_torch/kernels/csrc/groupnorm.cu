// GroupNorm for Hopper (sm_90a), NCHW: statistics, then one fused normalize /
// affine / AdaIN / SiLU pass; and the backward of that chain.
//
// Replaces the Pallas TPU kernel `_stats_kernel` / `gn_channel_sums` in
// eovax/kernels/groupnorm.py (pallas_call at line 70), which takes per-(B, C)
// fp32 sums and sums of squares in one streaming pass, and the apply of
// `group_norm` there (`_apply`), which the JAX package leaves to XLA. Forward
// and, below, its backward.
//
// What bounds it on the H100: bytes. One GroupNorm reads x twice (once per
// kernel) and writes y once, a few FLOPs per element: at [4, 128, 512, 512]
// bf16 the least traffic (x read once, y written once) is 537 MB, 0.16 ms at
// 3.35 TB/s. The design streams x with 16-byte loads and keeps every
// intermediate but two fp32 numbers per (b, c) out of device memory.
//
// Statistics (`gn_stats_kernel`). In NCHW a channel's H·W elements are
// contiguous, so one block reduces one (b, c) plane in one pass. Each thread
// sums x, and d = x − K and d² about K, the mean of the plane's first 256
// elements: the E[x²] − mean² of the TPU kernel cancels when |mean| ≫ std, as
// after a conv bias, and sums about a close estimate of the mean do not. The block writes the plane's mean (from
// Σx) and M2 = Σ(x − mean)² (from the shifted sums); `gn_channel_sums` turns
// those into the TPU kernel's (Σx, Σx²).
//
// Apply (`gn_apply_kernel`). A block normalizes one chunk of one plane. It
// first combines its group's channel (mean, M2) pairs with Chan's formula
// (equal counts), then computes y = (x − mean)·(rstd·γ·s) + (β·s + t) in fp32,
// with (s, t) the optional AdaIN scale and shift ([C] shared or [B, C]), then
// the optional SiLU, and rounds once to the input type.
//
// Backward (`gn_bwd_reduce_kernel`, `gn_bwd_apply_kernel`). The JAX package
// differentiates `group_norm` with the closed form `_gn_bwd` (line 124 there)
// in jnp, and AdaIN and SiLU by autodiff outside it; the port's forward fuses
// all three, so its backward is one closed form over the chain
//   x̂ = (x − μ)·r,  z = x̂·a + c  (a = γ·s, c = β·s + t),  y = SiLU(z) or z,
// with μ, r the forward's per-group mean and rstd. Both kernels recompute x̂,
// z and σ(z) in fp32 from x, and never read the forward's rounded output.
// With g = dL/dy and dz = g·σ(z)·(1 + z·(1 − σ(z))) (or g without SiLU):
//   - the reduction, one block per (b, c) plane, writes S1 = Σ dz and
//     S2 = Σ dz·x̂ (the wrapper turns these [B, C] sums into the parameter
//     gradients: dβ = Σ_b s·S1, dγ = Σ_b s·S2, dt = S1, ds = γ·S2 + β·S1);
//   - the apply, laid out as the forward's, first combines its group's sums
//     into the two per-group means of `_gn_bwd`, of a·dz and of a·dz·x̂, then
//     writes dx = r·(a·dz − mean(a·dz) − x̂·mean(a·dz·x̂)), rounded once.
// As in the forward's apply, thread 0 of a block works out the block's
// coefficients from the per-group and per-channel vectors, so no tensor op
// runs between the two launches.
// What bounds it: bytes. x and g are read twice and dx written once, 5 bytes
// of traffic per byte of x (the least is 3: x and g read once, dx written
// once): at [16, 128, 256, 256] bf16, 1.34 GB, 0.40 ms at 3.35 TB/s. Only two
// fp32 numbers per plane go to device memory in between.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecIters = 8;  // 16-byte vectors per thread per apply block

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

// Sum of `v` over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (threadIdx.x < 32) {
    v = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  return v;
}

// One block per (b, c) plane of n elements: mean and M2 about the plane's mean.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean, float* __restrict__ m2,
                    long n) {
  __shared__ float red[kThreads / 32];
  __shared__ float shift_s;
  const T* p = x + (size_t)blockIdx.x * n;
  const long m = n < kThreads ? n : kThreads;
  const float head = block_sum(threadIdx.x < m ? to_float(p[threadIdx.x]) : 0.f, red);
  if (threadIdx.x == 0) shift_s = head / (float)m;
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
  s0 = block_sum(s0, red);
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = s0 / (float)n;
    m2[blockIdx.x] = fmaxf(s2 - s1 * (s1 / (float)n), 0.f);
  }
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// grid (chunks of one plane, B·C planes). y = (x − mean)·a + c, then SiLU.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
                    const float* __restrict__ m2, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ ada_scale,
                    const float* __restrict__ ada_shift, int ada_stride, int C, int cpg, long n,
                    long chunk, float eps, int swish) {
  __shared__ float coef[3];  // mean, a, c of this block's channel
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
        v[j] = swish ? silu(t) : t;
      }
      store_vec(y + base + i, v);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float t = fmaf(to_float(x[base + i]) - gm, a, off);
      y[base + i] = from_float<T>(swish ? silu(t) : t);
    }
  }
}

// dL/dz from dL/dy at the pre-SiLU value z.
__device__ __forceinline__ float dz_of(float g, float z, int swish) {
  if (!swish) return g;
  const float sg = 1.f / (1.f + expf(-z));
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

__device__ __forceinline__ float ada_s(const Chain& p, int b, int c) {
  return p.ada_scale != nullptr ? p.ada_scale[(size_t)b * p.ada_stride + c] : 1.f;
}

// (μ, r, a, c) of plane b·C + ch: x̂ = (x − μ)·r, z = x̂·a + c.
__device__ __forceinline__ float4 plane_coef(const Chain& p, int plane) {
  const int b = plane / p.C, ch = plane % p.C;
  const int grp = b * (p.C / p.cpg) + ch / p.cpg;
  const float s = ada_s(p, b, ch);
  const float t = p.ada_shift != nullptr ? p.ada_shift[(size_t)b * p.ada_stride + ch] : 0.f;
  return make_float4(p.mean[grp], p.rstd[grp], p.gamma[ch] * s, p.beta[ch] * s + t);
}

// One block per (b, c) plane of n elements: S1 = Σ dz and S2 = Σ dz·x̂.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g, Chain p,
                         float* __restrict__ s1, float* __restrict__ s2, long n, int swish) {
  __shared__ float red[kThreads / 32];
  __shared__ float4 coef_s;
  const int plane = blockIdx.x;
  if (threadIdx.x == 0) coef_s = plane_coef(p, plane);
  __syncthreads();
  const float mu = coef_s.x, r = coef_s.y, a = coef_s.z, c = coef_s.w;
  const T* xp = x + (size_t)plane * n;
  const T* gp = g + (size_t)plane * n;
  float t1 = 0.f, t2 = 0.f;
  if (kVec) {
    constexpr int V = vec_n<T>();
    const long nv = n / V;
#pragma unroll 2
    for (long i = threadIdx.x; i < nv; i += kThreads) {
      float xv[V], gv[V];
      load_vec(xp + i * V, xv);
      load_vec(gp + i * V, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mu) * r;
        const float dz = dz_of(gv[j], fmaf(xh, a, c), swish);
        t1 += dz;
        t2 = fmaf(dz, xh, t2);
      }
    }
  } else {
    for (long i = threadIdx.x; i < n; i += kThreads) {
      const float xh = (to_float(xp[i]) - mu) * r;
      const float dz = dz_of(to_float(gp[i]), fmaf(xh, a, c), swish);
      t1 += dz;
      t2 = fmaf(dz, xh, t2);
    }
  }
  t1 = block_sum(t1, red);
  t2 = block_sum(t2, red);
  if (threadIdx.x == 0) {
    s1[plane] = t1;
    s2[plane] = t2;
  }
}

// grid (chunks of one plane, B·C planes). dx = k1·dz + k0 + k2·x̂ with
// k1 = r·a, k0 = −r·mean(a·dz), k2 = −r·mean(a·dz·x̂) over the plane's group.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                        Chain p, const float* __restrict__ s1, const float* __restrict__ s2,
                        long n, long chunk, int swish) {
  __shared__ float coef[7];  // μ, r, a, c, k1, k0, k2 of this block's plane
  const int plane = blockIdx.y;
  if (threadIdx.x == 0) {
    const float4 pc = plane_coef(p, plane);
    const int b = plane / p.C, first = plane - plane % p.cpg;  // the group's first plane
    float ga = 0.f, gx = 0.f;
    for (int i = 0; i < p.cpg; ++i) {
      const int ch = (first + i) % p.C;
      const float ai = p.gamma[ch] * ada_s(p, b, ch);
      ga = fmaf(ai, s1[first + i], ga);
      gx = fmaf(ai, s2[first + i], gx);
    }
    const float inv = 1.f / ((float)n * (float)p.cpg);
    coef[0] = pc.x;
    coef[1] = pc.y;
    coef[2] = pc.z;
    coef[3] = pc.w;
    coef[4] = pc.y * pc.z;
    coef[5] = -pc.y * ga * inv;
    coef[6] = -pc.y * gx * inv;
  }
  __syncthreads();
  const float mu = coef[0], r = coef[1], a = coef[2], c = coef[3];
  const float k1 = coef[4], k0 = coef[5], k2 = coef[6];
  const size_t base = (size_t)plane * n;
  const long lo = (long)blockIdx.x * chunk;
  const long hi = lo + chunk < n ? lo + chunk : n;
  if (kVec) {
    constexpr int V = vec_n<T>();
#pragma unroll 2
    for (long i = lo + threadIdx.x * V; i < hi; i += kThreads * V) {
      float xv[V], gv[V];
      load_vec(x + base + i, xv);
      load_vec(g + base + i, gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xv[j] - mu) * r;
        const float dz = dz_of(gv[j], fmaf(xh, a, c), swish);
        xv[j] = fmaf(k2, xh, fmaf(k1, dz, k0));
      }
      store_vec(dx + base + i, xv);
    }
  } else {
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      const float xh = (to_float(x[base + i]) - mu) * r;
      const float dz = dz_of(to_float(g[base + i]), fmaf(xh, a, c), swish);
      dx[base + i] = from_float<T>(fmaf(k2, xh, fmaf(k1, dz, k0)));
    }
  }
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

template <typename T>
int launch_apply(const void* x, void* y, const float* mean, const float* m2, const float* gamma,
                 const float* beta, const float* ada_scale, const float* ada_shift,
                 int ada_stride, int B, int C, int groups, long n, float eps, int swish,
                 cudaStream_t stream) {
  if (B <= 0 || C <= 0 || groups <= 0 || C % groups != 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const long chunk = (long)kThreads * vec_n<T>() * kVecIters;
  const dim3 grid((unsigned)((n + chunk - 1) / chunk), (unsigned)(B * C));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int cpg = C / groups;
  if (vectorizable<T>(x, y, n))
    gn_apply_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, yt, mean, m2, gamma, beta, ada_scale, ada_shift, ada_stride, C, cpg, n, chunk, eps,
        swish);
  else
    gn_apply_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, yt, mean, m2, gamma, beta, ada_scale, ada_shift, ada_stride, C, cpg, n, chunk, eps,
        swish);
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

template <typename T>
int launch_bwd_reduce(const void* x, const void* g, const Chain& p, float* s1, float* s2, int B,
                      long n, int swish, cudaStream_t stream) {
  const int planes = B * p.C;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (vectorizable<T>(x, g, n))
    gn_bwd_reduce_kernel<T, true><<<planes, kThreads, 0, stream>>>(xt, gt, p, s1, s2, n, swish);
  else
    gn_bwd_reduce_kernel<T, false><<<planes, kThreads, 0, stream>>>(xt, gt, p, s1, s2, n, swish);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_apply(const void* x, const void* g, void* dx, const Chain& p, const float* s1,
                     const float* s2, int B, long n, int swish, cudaStream_t stream) {
  const long chunk = (long)kThreads * vec_n<T>() * kVecIters;
  const dim3 grid((unsigned)((n + chunk - 1) / chunk), (unsigned)(B * p.C));
  if (grid.y > 65535u) return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (vectorizable<T>(x, g, n) && vectorizable<T>(dx, dx, n))
    gn_bwd_apply_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, gt, dxt, p, s1, s2, n, chunk,
                                                                 swish);
  else
    gn_bwd_apply_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, gt, dxt, p, s1, s2, n,
                                                                  chunk, swish);
  return (int)cudaGetLastError();
}

// Both passes of the backward, on one stream.
template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
               const void* gamma, const void* beta, const void* ada_scale, const void* ada_shift,
               int ada_stride, void* s1, void* s2, int B, int C, int groups, long n, int swish,
               cudaStream_t stream) {
  if (B <= 0 || C <= 0 || groups <= 0 || C % groups != 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const Chain p = make_chain(mean, rstd, gamma, beta, ada_scale, ada_shift, ada_stride, C, groups);
  float* s1f = static_cast<float*>(s1);
  float* s2f = static_cast<float*>(s2);
  const int code = launch_bwd_reduce<T>(x, g, p, s1f, s2f, B, n, swish, stream);
  if (code != 0) return code;
  return launch_bwd_apply<T>(x, g, dx, p, s1f, s2f, B, n, swish, stream);
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

// x, y: contiguous [B, C, n]; mean, m2: fp32 [B·C] from eovax_gn_stats_*; gamma, beta:
// fp32 [C]; ada_scale, ada_shift: fp32 [C] (ada_stride 0) or [B, C] (ada_stride C), or
// both null.
int eovax_gn_apply_bf16(const void* x, void* y, const void* mean, const void* m2,
                        const void* gamma, const void* beta, const void* ada_scale,
                        const void* ada_shift, int ada_stride, int B, int C, int groups, long n,
                        float eps, int swish, void* stream) {
  return launch_apply<__nv_bfloat16>(
      x, y, static_cast<const float*>(mean), static_cast<const float*>(m2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(ada_scale), static_cast<const float*>(ada_shift), ada_stride, B,
      C, groups, n, eps, swish, static_cast<cudaStream_t>(stream));
}

int eovax_gn_apply_f32(const void* x, void* y, const void* mean, const void* m2,
                       const void* gamma, const void* beta, const void* ada_scale,
                       const void* ada_shift, int ada_stride, int B, int C, int groups, long n,
                       float eps, int swish, void* stream) {
  return launch_apply<float>(
      x, y, static_cast<const float*>(mean), static_cast<const float*>(m2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(ada_scale), static_cast<const float*>(ada_shift), ada_stride, B,
      C, groups, n, eps, swish, static_cast<cudaStream_t>(stream));
}

// Backward. x, g, dx: contiguous [B, C, n] in one dtype; mean, rstd: fp32 [B, groups];
// gamma, beta: fp32 [C]; ada_scale, ada_shift as for the apply, or both null; s1, s2:
// fp32 [B, C] outputs, Σ dz and Σ dz·x̂ per plane.
int eovax_gn_bwd_bf16(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
                      const void* gamma, const void* beta, const void* ada_scale,
                      const void* ada_shift, int ada_stride, void* s1, void* s2, int B, int C,
                      int groups, long n, int swish, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dx, mean, rstd, gamma, beta, ada_scale, ada_shift,
                                   ada_stride, s1, s2, B, C, groups, n, swish,
                                   static_cast<cudaStream_t>(stream));
}

int eovax_gn_bwd_f32(const void* x, const void* g, void* dx, const void* mean, const void* rstd,
                     const void* gamma, const void* beta, const void* ada_scale,
                     const void* ada_shift, int ada_stride, void* s1, void* s2, int B, int C,
                     int groups, long n, int swish, void* stream) {
  return launch_bwd<float>(x, g, dx, mean, rstd, gamma, beta, ada_scale, ada_shift, ada_stride,
                           s1, s2, B, C, groups, n, swish, static_cast<cudaStream_t>(stream));
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// GroupNorm forward for Hopper (sm_90a), NCHW: statistics, then one fused
// normalize / affine / AdaIN / SiLU pass.
//
// Replaces the Pallas TPU kernel `_stats_kernel` / `gn_channel_sums` in
// eovax/kernels/groupnorm.py (pallas_call at line 70), which takes per-(B, C)
// fp32 sums and sums of squares in one streaming pass, and the apply of
// `group_norm` there (`_apply`), which the JAX package leaves to XLA. Forward
// only, as the port's inference path needs.
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

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

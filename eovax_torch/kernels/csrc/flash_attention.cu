// Single-head, unmasked flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// eovax/kernels/attention.py (pallas_call at line 83): softmax(q·kᵀ/√D)·v for
// q, k, v of shape [B, S, D], fp32 logits, an online softmax with fp32
// running max and sum, an fp32 P·V accumulator, and the output cast to the
// input type. Forward only, as the TPU kernel is.
//
// What bounds it on the H100: the EO-VAE mid-block attention has D = 512 and
// S = (res/8)². At 512² input and B = 4 one call is 4·B·S²·D = 137 GFLOP
// against 67 MB of q/k/v/o, about 2000 FLOP per byte: compute-bound, with a
// floor of about 0.14 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design (bf16). D = 512 is what makes this kernel unlike the usual flash
// kernels: the fp32 output accumulator of 64 query rows is 128 KB, far more
// than one warp's registers, and a 64 × 512 bf16 tile is 64 KB of shared
// memory. So a block of 16 warps owns 64 query rows and splits them two ways:
//   - warp w covers rows 16·(w % 4) .. +15 and column group c = w / 4;
//   - for S = Q·Kᵀ over a tile of 64 keys, column group c computes keys
//     16c .. 16c+15, so the row max needs one exchange through shared memory;
//   - for O += P·V, column group c owns output columns c·D/4 .. +D/4, so the
//     fp32 accumulator is 16 rows × 128 columns per warp: 64 registers a
//     thread at D = 512.
// P goes through shared memory as bf16 so that every warp of a row group
// reads the whole 16 × 64 P tile. Q (64 × D), K and V (64 × D each) sit in
// shared memory (about 205 KB at D = 512, one block per SM); K_{j+1} is
// fetched with cp.async while P·V_j runs, and V_{j+1} while Q·K_{j+1}ᵀ runs.
// Products are mma.sync m16n8k16 bf16 → fp32 with ldmatrix operand loads.
// The last query and key tiles are masked, so any S works. Row sums are kept
// per thread over its own columns and reduced once at the end.
//
// The fp32 variant (FULL_PRECISION) is a plain FMA kernel: 8 warps × 4 query
// rows, lane j scores key j of a 32-key tile, lane l owns columns l + 32i.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- bf16 path

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;            // bf16 row padding: 16 bytes, no bank conflicts

template <int D>
struct Layout {
  static constexpr int LD = D + kPad;     // row stride of the Q, K, V tiles
  static constexpr int LDP = kBK + kPad;  // row stride of the P tile
  static constexpr int kQ = kBQ * LD;
  static constexpr int kKV = kBK * LD;
  static constexpr int kP = kBQ * LDP;
  static constexpr size_t bytes =
      (size_t)(kQ + 2 * kKV + kP) * sizeof(__nv_bfloat16) + 4 * kBQ * sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a · b for one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows row0 .. row0+63 of a [S, D] matrix into shared memory (stride LD);
// rows at or beyond S are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int S, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + r * Layout<D>::LD + col, src + (size_t)(ok ? gr : 0) * D + col, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                      float scale_log2) {
  using L = Layout<D>;
  constexpr int kCols = D / 4;     // output columns per column group
  constexpr int kNO = kCols / 8;   // m16n8 output tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + L::kQ;
  __nv_bfloat16* sV = sK + L::kKV;
  __nv_bfloat16* sP = sV + L::kKV;
  float* sRed = reinterpret_cast<float*>(sP + L::kP);  // [4 column groups][kBQ rows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  load_tile<D>(sQ, qb, q0, S, tid);
  load_tile<D>(sK, kb, 0, S, tid);
  cp_async_commit();  // group: Q, K_0
  load_tile<D>(sV, vb, 0, S, tid);
  cp_async_commit();  // group: V_0

  float acc[kNO][4];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (log2 units)
  float l_i[2] = {0.f, 0.f};              // running sum over this thread's columns

  const int row_a = 16 * wr + g, row_b = row_a + 8;  // rows of this thread in the block
  const int ntiles = (S + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_1();  // Q and K_j have landed; V_j may still be in flight
    __syncthreads();

    // S tile: rows 16·wr .. +15, keys 16·wc .. +15 of this tile.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, sQ + (16 * wr + (lane & 15)) * L::LD + kk + (lane >> 4) * 8);
      ldsm_x4(b, sK + (16 * wc + (lane & 7) + (lane >> 4) * 8) * L::LD + kk + ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }

    const int key0 = j * kBK + 16 * wc + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (key0 + nt * 8 + (e & 1) < S) ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    if (t == 0) {
      sRed[wc * kBQ + row_a] = mx[0];
      sRed[wc * kBQ + row_b] = mx[1];
    }
    __syncthreads();  // every warp is done with K_j: refill its buffer

    if (j + 1 < ntiles) load_tile<D>(sK, kb, (j + 1) * kBK, S, tid);
    cp_async_commit();

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      float m_new = fmaxf(fmaxf(sRed[row], sRed[kBQ + row]),
                          fmaxf(sRed[2 * kBQ + row], sRed[3 * kBQ + row]));
      m_new = fmaxf(m_new, m_i[r]);  // finite: every tile has a valid key
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[nt][e] - m_i[e >> 1]);
        rs[e >> 1] += p[e];
      }
      const int col = 16 * wc + nt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(sP + row_a * L::LDP + col) = __floats2bfloat162_rn(p[0], p[1]);
      *reinterpret_cast<__nv_bfloat162*>(sP + row_b * L::LDP + col) = __floats2bfloat162_rn(p[2], p[3]);
    }
    l_i[0] = l_i[0] * alpha[0] + rs[0];
    l_i[1] = l_i[1] * alpha[1] + rs[1];
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait_1();  // V_j has landed; K_{j+1} may still be in flight
    __syncthreads();    // and P is complete

    // O[rows of wr, columns of wc] += P[rows of wr, 0:64] · V_j[0:64, columns of wc]
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, sP + (16 * wr + (lane & 15)) * L::LDP + kk + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kNO; i += 2) {
        uint32_t b[4];
        const int n0 = wc * kCols + i * 8;
        ldsm_x4_trans(b, sV + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LD + n0 + (lane >> 4) * 8);
        mma_bf16(acc[i], a, b[0], b[1]);
        mma_bf16(acc[i + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with V_j and P: refill V

    if (j + 1 < ntiles) load_tile<D>(sV, vb, (j + 1) * kBK, S, tid);
    cp_async_commit();
  }

  // Full row sums: over the four lanes of a quad, then over the four column groups.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(kFull, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(kFull, l_i[r], 2);
  }
  if (t == 0) {
    sRed[wc * kBQ + row_a] = l_i[0];
    sRed[wc * kBQ + row_b] = l_i[1];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    inv[r] = 1.f / (sRed[row] + sRed[kBQ + row] + sRed[2 * kBQ + row] + sRed[3 * kBQ + row]);
  }

  __nv_bfloat16* ob = o + base;
  const int ga = q0 + row_a, gb = q0 + row_b;
#pragma unroll
  for (int i = 0; i < kNO; ++i) {
    const int col = wc * kCols + i * 8 + 2 * t;
    if (ga < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ga * D + col) =
          __floats2bfloat162_rn(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    if (gb < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)gb * D + col) =
          __floats2bfloat162_rn(acc[i][2] * inv[1], acc[i][3] * inv[1]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                float scale_log2, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B);
  flash_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, scale_log2);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int kFRows = 4;                  // query rows per warp
constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kFBQ = kFRows * kFWarps;     // query rows per block
constexpr int kFBK = 32;                   // keys per tile: one per lane

template <int D>
constexpr size_t f32_bytes() {
  return (size_t)(kFBQ * D + kFBK * (D + 1) + kFBK * D) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kFThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, float scale_log2) {
  constexpr int kNC = D / 32;  // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [kFBQ][D]
  float* sK = sQ + kFBQ * D;                   // [kFBK][D + 1]: lane j reads row j
  float* sV = sK + kFBK * (D + 1);             // [kFBK][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kFBQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int i = tid; i < kFBQ * D; i += kFThreads) {
    const int r = i / D;
    sQ[i] = (q0 + r < S) ? qb[(size_t)q0 * D + i] : 0.f;
  }

  float acc[kFRows][kNC];
  float m_i[kFRows], l_i[kFRows];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = 0; j0 < S; j0 += kFBK) {
    __syncthreads();  // the previous tile is consumed (and Q is visible)
    for (int i = tid; i < kFBK * D; i += kFThreads) {
      const int r = i / D, c = i % D;
      const bool ok = j0 + r < S;
      sK[r * (D + 1) + c] = ok ? kb[(size_t)j0 * D + i] : 0.f;
      sV[i] = ok ? vb[(size_t)j0 * D + i] : 0.f;
    }
    __syncthreads();

    float s[kFRows] = {};
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kFRows; ++r) s[r] = fmaf(sQ[(warp * kFRows + r) * D + d], kd, s[r]);
    }
    const bool valid = j0 + lane < S;
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const float x = valid ? s[r] * scale_log2 : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = exp2f(m_i[r] - m_new);
      const float p = exp2f(x - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      l_i[r] = l_i[r] * alpha + ps;
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }
    for (int jj = 0; jj < kFBK; ++jj) {
      float pj[kFRows];
#pragma unroll
      for (int r = 0; r < kFRows; ++r) pj[r] = __shfl_sync(kFull, s[r], jj);
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const float vv = sV[jj * D + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kFRows; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
      }
    }
  }

  float* ob = o + base;
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int row = q0 + warp * kFRows + r;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < kNC; ++c) ob[(size_t)row * D + lane + 32 * c] = acc[r][c] / l_i[r];
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
               float scale_log2, cudaStream_t stream) {
  const size_t bytes = f32_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kFBQ - 1) / kFBQ, B);
  flash_f32_kernel<D><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, scale_log2);
  return (int)cudaGetLastError();
}

float scale_log2_for(int D) { return (float)(1.0 / sqrt((double)D)) * kLog2e; }

}  // namespace

extern "C" {

// q, k, v, o: contiguous [B, S, D] bf16 on the current device. D in {64, 128, 256, 512}.
int eovax_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                               int D, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale_log2_for(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_bf16<64>(q, k, v, o, B, S, sl2, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, S, sl2, st);
    case 256: return launch_bf16<256>(q, k, v, o, B, S, sl2, st);
    case 512: return launch_bf16<512>(q, k, v, o, B, S, sl2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o: contiguous [B, S, D] fp32 on the current device. D in {64, 128, 256, 512}.
int eovax_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                              int D, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale_log2_for(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_f32<64>(q, k, v, o, B, S, sl2, st);
    case 128: return launch_f32<128>(q, k, v, o, B, S, sl2, st);
    case 256: return launch_f32<256>(q, k, v, o, B, S, sl2, st);
    case 512: return launch_f32<512>(q, k, v, o, B, S, sl2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

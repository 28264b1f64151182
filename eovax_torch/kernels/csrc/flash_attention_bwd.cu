// Single-head, unmasked flash attention backward for Hopper (sm_90a).
//
// The gradient of flash_attention.cu's forward, softmax(q·kᵀ/√D)·v over
// [B, S, D]: the TPU kernel it replaces (`_flash_kernel` / `flash_attention` in
// eovax/kernels/attention.py, pallas_call at line 83) has no backward; the JAX
// trainer differentiates `sdpa_auto`'s einsum, whose gradient this computes
// without its [B, S, S] buffers. The probabilities are recomputed from the
// forward's row statistics: lse, each row's log-sum-exp of the scaled logits in
// log2 units, so that P = exp2(q·kᵀ·scale·log2(e) − lse).
//
// FlashAttention-2's split, with no atomics, so that two calls give the same
// bits:
//   (a) flash_bwd_delta_kernel: Δ = rowsum(dO ∘ O) in fp32, [B, S], a warp a row.
//   (b) flash_bwd_*_kernel<true>: a block owns 64 keys and one chunk of 64
//       columns of dK and dV (the grid's z), and loops over the query tiles:
//       Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over the whole D, in pieces of 64 columns;
//       Pᵀ = exp2(Sᵀ·scale·log2(e) − lse), dSᵀ = Pᵀ ∘ (dPᵀ − Δ); then
//       dV += Pᵀ·dO and dK += dSᵀ·Q on the block's chunk; dK times the scale.
//   (c) flash_bwd_*_kernel<false>: a block owns 64 queries and one chunk of dQ
//       and loops over the key tiles in the same way: S = Q·Kᵀ, dP = dO·Vᵀ,
//       P, dS, dQ += dS·K; dQ times the scale.
// (b) and (c) are one kernel: rows A1, A2 (K, V or Q, dO) against the streamed
// tiles B1, B2 (Q, dO or K, V); dS·B1 goes to the first output, P·B2 (dK/dV
// only) to the second, and the statistics belong to the streamed columns (dK/dV)
// or to the rows (dQ).
//
// Why column chunks: at D = 512 the dK and dV accumulators of 64 keys are
// 256 KiB of fp32, more than a block's registers and shared memory. So a block
// keeps 64 output columns, and every D above 64 recomputes S and dP for each
// chunk (the D-split forward does the same with its logits): slow at
// D = 512, and right at every D. The pieces of D are taken in the order that
// ends with the block's own chunk, whose Q/dO (or K/V) tiles then stay in
// shared memory for the update products.
//
// bf16: a block of four warps (16 rows each) runs `mma.sync` m16n8k16 with
// fp32 accumulators; operands come from shared memory by `ldmatrix` (the update
// products' B operands by `ldmatrix.trans`), rows padded to 144 bytes so that
// the eight rows of a matrix fall on distinct banks; P and dS are rounded to
// bf16 as the A operands of the update products (P before dV as the tensor-op
// backward and the JAX autodiff round it; dS because the tensor cores take
// bf16), dP stays fp32. Each stage (the four 64 × 64 pieces) is copied with
// cp.async while the stage before is multiplied: two stages, 72 KiB.
// fp32 (FULL_PRECISION): an FMA kernel in the forward's fp32 layout, 8 warps ×
// 4 rows, lane j scoring streamed row j of a 32-row tile, lane l owning output
// columns l and l + 32 of the chunk.
//
// D is any multiple of 64 (the wrapper widens the others as the forward
// does); any S, the last tiles masked (rows past S zero-filled, their
// probabilities 0); the batch on the grid's y (at most 65535 a launch).
//
// Plain C interface, loaded with ctypes. Each entry point launches one kernel
// on the given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- Δ = rowsum(dO ∘ O)

constexpr int kDeltaWarps = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kDeltaWarps * 32)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* ob = o + row * D;
  const T* db = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_float(ob[d]), to_float(db[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long long rows, int D,
                 cudaStream_t stream) {
  const long long blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, kDeltaWarps * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 path

constexpr int kRows = 64;      // rows a block: keys (dK/dV) or queries (dQ)
constexpr int kCols = 64;      // streamed rows a tile: queries (dK/dV) or keys (dQ)
constexpr int kPiece = 64;     // columns of d a stage, and output columns a block
constexpr int kThreads = 128;  // four warps of 16 rows
constexpr int kLD = kPiece + 8;           // shared row stride (elements): 144 bytes
constexpr int kTileBytes = kRows * kLD * 2;
constexpr int kStageBytes = 4 * kTileBytes;  // A1, A2, B1, B2
constexpr int kSmemBytes = 2 * kStageBytes;  // two stages
static_assert(kRows == kCols, "A and B pieces share one loader");

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool pred) {
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[16 × 8] += a[16 × 16] · b[16 × 8]: a the m16n8k16 A fragment (a[0] row
// lane/4, columns 2·(lane % 4) + {0, 1}; a[1] the row 8 below; a[2], a[3] the
// columns 8 further), b0/b1 the B fragment (rows 2·(lane % 4) + {0, 1} and 8
// below, column lane/4); d[0], d[1] row lane/4, columns 2·(lane % 4) + {0, 1},
// d[2], d[3] the row 8 below.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows row0 .. row0+63, columns d0 .. d0+63 of a [S, D] matrix into the piece
// at shared address dst ([64 rows][kLD]); rows at or beyond S are zero-filled.
__device__ __forceinline__ void load_piece(uint32_t dst, const __nv_bfloat16* src, int row0,
                                           int S, int D, int d0, int tid) {
#pragma unroll
  for (int c = 0; c < kRows * kPiece / 8 / kThreads; ++c) {
    const int i = tid + c * kThreads;
    const int r = i / (kPiece / 8), ch = i % (kPiece / 8);
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + (r * kLD + ch * 8) * 2, src + (size_t)(ok ? gr : 0) * D + d0 + ch * 8, ok);
  }
}

// acc[n] += A·Bᵀ over one piece: A this warp's 16 rows of the piece at sA, B the
// 64 streamed rows of the piece at sB (n-tile n: streamed rows 8n .. 8n+7).
__device__ __forceinline__ void gemm_abt(float (&acc)[8][4], uint32_t sA, uint32_t sB, int warp,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < kPiece / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + ((16 * warp + (lane & 15)) * kLD + 16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int np = 0; np < kCols / 16; ++np) {
      uint32_t b[4];  // n-tiles 2np (b[0], b[1]) and 2np + 1 (b[2], b[3])
      ldmatrix_x4(b, sB + ((16 * np + (lane & 7) + (lane >> 4) * 8) * kLD + 16 * kk +
                           ((lane >> 3) & 1) * 8) * 2);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[n] += X·B: X this warp's 16 rows × 64 streamed columns in registers (the
// A fragments of its 4 k-steps), B the piece at sB read as [streamed][column]
// (n-tile n: output columns 8n .. 8n+7).
__device__ __forceinline__ void gemm_xb(float (&acc)[8][4], const uint32_t (&x)[kCols / 16][4],
                                        uint32_t sB, int lane) {
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk)
#pragma unroll
    for (int np = 0; np < kPiece / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sB + ((16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD + 16 * np +
                                 (lane >> 4) * 8) * 2);
      mma_bf16(acc[2 * np], x[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], x[kk], b[2], b[3]);
    }
}

// The accumulators of n-tiles 2kk, 2kk + 1 as the A fragment of k-step kk.
__device__ __forceinline__ void to_a_fragments(const float (&c)[8][4],
                                               uint32_t (&x)[kCols / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kCols / 16; ++kk) {
    x[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    x[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    x[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    x[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The pieces of d in the order that ends with the chunk at c0: c0 + 64, ...,
// wrapping round.
__device__ __forceinline__ int piece_d0(int p, int c0, int npieces) {
  int i = c0 / kPiece + 1 + p;
  if (i >= npieces) i -= npieces;
  return i * kPiece;
}

// kDKV: a1 = K, a2 = V, b1 = Q, b2 = dO; out1 = dK, out2 = dV.
// dQ:   a1 = Q, a2 = dO, b1 = K, b2 = V; out1 = dQ (out2 unused).
template <bool kDKV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ a1,
                          const __nv_bfloat16* __restrict__ a2,
                          const __nv_bfloat16* __restrict__ b1,
                          const __nv_bfloat16* __restrict__ b2, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ out1,
                          __nv_bfloat16* __restrict__ out2, int S, int D, float scale_log2,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kPiece;  // this block's output columns [c0, c0 + 64)
  const size_t base = (size_t)blockIdx.y * S * D;
  a1 += base;
  a2 += base;
  b1 += base;
  b2 += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;
  const int npieces = D / kPiece;
  const int total = (S + kCols - 1) / kCols * npieces;  // stages: (tile, piece)

  auto load_stage = [&](int st) {
    const int j0 = st / npieces * kCols, d0 = piece_d0(st % npieces, c0, npieces);
    const uint32_t dst = sbase + (st & 1) * kStageBytes;
    load_piece(dst, a1, r0, S, D, d0, tid);
    load_piece(dst + kTileBytes, a2, r0, S, D, d0, tid);
    load_piece(dst + 2 * kTileBytes, b1, j0, S, D, d0, tid);
    load_piece(dst + 3 * kTileBytes, b2, j0, S, D, d0, tid);
  };

  // dQ: the statistics of this thread's rows g, g + 8 (0 past S: never stored).
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (!kDKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * warp + g + 8 * h;
      if (row < S) {
        row_lse[h] = lse[row];
        row_delta[h] = delta[row];
      }
    }
  }

  float acc1[8][4], acc2[8][4];  // dK, dV (or dQ) of this warp's rows, the chunk's columns
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = acc2[n][e] = 0.f;
  float s[8][4], dp[8][4];

  load_stage(0);
  cp_async_commit();
  for (int st = 0; st < total; ++st) {
    const int p = st % npieces;
    if (st + 1 < total) load_stage(st + 1);
    cp_async_commit();  // group: stage st + 1 (empty after the last)
    cp_async_wait<1>();
    __syncthreads();  // stage st is in place
    const uint32_t buf = sbase + (st & 1) * kStageBytes;
    if (p == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    gemm_abt(s, buf, buf + 2 * kTileBytes, warp, lane);
    gemm_abt(dp, buf + kTileBytes, buf + 3 * kTileBytes, warp, lane);
    if (p == npieces - 1) {  // the tile's logits are whole; the stage holds the chunk
      const int j0 = st / npieces * kCols;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + 8 * n + 2 * t + (e & 1);
          const bool ok = col < S;
          const float l2 = kDKV ? (ok ? lse[col] : 0.f) : row_lse[e >> 1];
          const float dl = kDKV ? (ok ? delta[col] : 0.f) : row_delta[e >> 1];
          const float pr = ok ? exp2f(s[n][e] * scale_log2 - l2) : 0.f;
          s[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - dl);
        }
      uint32_t x[kCols / 16][4];
      to_a_fragments(dp, x);
      gemm_xb(acc1, x, buf + 2 * kTileBytes, lane);  // += dS·B1
      if (kDKV) {
        to_a_fragments(s, x);
        gemm_xb(acc2, x, buf + 3 * kTileBytes, lane);  // dV += P·dO
      }
    }
    __syncthreads();  // every warp is done with stage st before st + 2 is copied over it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + g + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const size_t at = (size_t)base + (size_t)row * D + c0 + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out1 + at) =
          __floats2bfloat162_rn(acc1[n][2 * h] * scale, acc1[n][2 * h + 1] * scale);
      if (kDKV)
        *reinterpret_cast<__nv_bfloat162*>(out2 + at) =
            __floats2bfloat162_rn(acc2[n][2 * h], acc2[n][2 * h + 1]);
    }
  }
}

template <bool kDKV>
int launch_bwd_bf16(const void* a1, const void* a2, const void* b1, const void* b2,
                    const float* lse, const float* delta, void* out1, void* out2, int B, int S,
                    int D, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<kDKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kRows - 1) / kRows, B, D / kPiece);
  flash_bwd_bf16_kernel<kDKV><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const __nv_bfloat16*>(a2),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2), lse, delta,
      static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2), S, D,
      scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int kFRows = 4;               // rows per warp
constexpr int kFWarps = 8;
constexpr int kFThreads = kFWarps * 32;
constexpr int kFR = kFRows * kFWarps;   // rows a block
constexpr int kFC = 32;                 // streamed rows a tile: one per lane
constexpr int kFNC = kPiece / 32;       // output columns per lane
// sA1, sA2 [kFR][kPiece] (read as broadcasts); sB1, sB2 [kFC][kPiece + 1] (lane j
// reads row j).
constexpr int kFSmemFloats = 2 * kFR * kPiece + 2 * kFC * (kPiece + 1);
static_assert(kFSmemFloats * 4 <= 48 * 1024, "static shared memory of one block");

template <bool kDKV>
__global__ void __launch_bounds__(kFThreads)
    flash_bwd_f32_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                         const float* __restrict__ b1, const float* __restrict__ b2,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ out1, float* __restrict__ out2, int S, int D,
                         float scale_log2, float scale) {
  __shared__ float sm[kFSmemFloats];
  float* sA1 = sm;
  float* sA2 = sA1 + kFR * kPiece;
  float* sB1 = sA2 + kFR * kPiece;
  float* sB2 = sB1 + kFC * (kPiece + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kFR;
  const int c0 = blockIdx.z * kPiece;
  const size_t base = (size_t)blockIdx.y * S * D;
  a1 += base;
  a2 += base;
  b1 += base;
  b2 += base;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;
  const int npieces = D / kPiece;

  float row_lse[kFRows], row_delta[kFRows];
#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int row = r0 + warp * kFRows + r;
    row_lse[r] = !kDKV && row < S ? lse[row] : 0.f;
    row_delta[r] = !kDKV && row < S ? delta[row] : 0.f;
  }
  float acc1[kFRows][kFNC] = {}, acc2[kFRows][kFNC] = {};

  for (int j0 = 0; j0 < S; j0 += kFC) {
    float s[kFRows] = {}, dp[kFRows] = {};
    for (int p = 0; p < npieces; ++p) {
      const int d0 = piece_d0(p, c0, npieces);
      __syncthreads();  // the piece before is consumed
      for (int i = tid; i < kFR * kPiece; i += kFThreads) {
        const int r = i / kPiece, c = i % kPiece;
        const bool ok = r0 + r < S;
        sA1[i] = ok ? a1[(size_t)(r0 + r) * D + d0 + c] : 0.f;
        sA2[i] = ok ? a2[(size_t)(r0 + r) * D + d0 + c] : 0.f;
      }
      for (int i = tid; i < kFC * kPiece; i += kFThreads) {
        const int r = i / kPiece, c = i % kPiece;
        const bool ok = j0 + r < S;
        sB1[r * (kPiece + 1) + c] = ok ? b1[(size_t)(j0 + r) * D + d0 + c] : 0.f;
        sB2[r * (kPiece + 1) + c] = ok ? b2[(size_t)(j0 + r) * D + d0 + c] : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < kPiece; ++d) {
        const float x1 = sB1[lane * (kPiece + 1) + d], x2 = sB2[lane * (kPiece + 1) + d];
#pragma unroll
        for (int r = 0; r < kFRows; ++r) {
          s[r] = fmaf(sA1[(warp * kFRows + r) * kPiece + d], x1, s[r]);
          dp[r] = fmaf(sA2[(warp * kFRows + r) * kPiece + d], x2, dp[r]);
        }
      }
    }
    // The last piece was the chunk's: sB1, sB2 hold its columns.
    const bool ok = j0 + lane < S;
    const float col_lse = kDKV && ok ? lse[j0 + lane] : 0.f;
    const float col_delta = kDKV && ok ? delta[j0 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      const float l2 = kDKV ? col_lse : row_lse[r], dl = kDKV ? col_delta : row_delta[r];
      const float pr = ok ? exp2f(s[r] * scale_log2 - l2) : 0.f;
      s[r] = pr;
      dp[r] = pr * (dp[r] - dl);
    }
    for (int jj = 0; jj < kFC; ++jj) {
      float pj[kFRows], dsj[kFRows];
#pragma unroll
      for (int r = 0; r < kFRows; ++r) {
        dsj[r] = __shfl_sync(kFull, dp[r], jj);
        pj[r] = kDKV ? __shfl_sync(kFull, s[r], jj) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kFNC; ++c) {
        const float x1 = sB1[jj * (kPiece + 1) + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < kFRows; ++r) acc1[r][c] = fmaf(dsj[r], x1, acc1[r][c]);
        if (kDKV) {
          const float x2 = sB2[jj * (kPiece + 1) + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kFRows; ++r) acc2[r][c] = fmaf(pj[r], x2, acc2[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kFRows; ++r) {
    const int row = r0 + warp * kFRows + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kFNC; ++c) {
      const size_t at = base + (size_t)row * D + c0 + lane + 32 * c;
      out1[at] = acc1[r][c] * scale;
      if (kDKV) out2[at] = acc2[r][c];
    }
  }
}

template <bool kDKV>
int launch_bwd_f32(const void* a1, const void* a2, const void* b1, const void* b2,
                   const float* lse, const float* delta, void* out1, void* out2, int B, int S,
                   int D, float scale, cudaStream_t stream) {
  dim3 grid((S + kFR - 1) / kFR, B, D / kPiece);
  flash_bwd_f32_kernel<kDKV><<<grid, kFThreads, 0, stream>>>(
      static_cast<const float*>(a1), static_cast<const float*>(a2),
      static_cast<const float*>(b1), static_cast<const float*>(b2), lse, delta,
      static_cast<float*>(out1), static_cast<float*>(out2), S, D, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int S, int D, int Dscale) {
  return B <= 0 || B > 65535 || S <= 0 || D <= 0 || D % kPiece != 0 || D / kPiece > 65535 ||
         Dscale <= 0 || Dscale > D;
}

float scale_for(int Dscale) { return (float)(1.0 / sqrt((double)Dscale)); }

}  // namespace

extern "C" {

// o, dout: contiguous [rows, D] in the entry's dtype; delta: [rows] fp32.
int eovax_flash_attention_bwd_delta_bf16(const void* o, const void* dout, float* delta,
                                         long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return launch_delta<__nv_bfloat16>(o, dout, delta, rows, D, static_cast<cudaStream_t>(stream));
}

int eovax_flash_attention_bwd_delta_f32(const void* o, const void* dout, float* delta,
                                        long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  return launch_delta<float>(o, dout, delta, rows, D, static_cast<cudaStream_t>(stream));
}

// q, k, v, dout, dk, dv: contiguous [B, S, D] in the entry's dtype on the current
// device, D a multiple of 64 (columns past the true width zero in q, k, v and
// dout); lse, delta: [B, S] fp32 (the forward's row statistics, and Δ). The
// logits are scaled by 1/√Dscale, as the forward scaled them.
int eovax_flash_attention_bwd_dkdv_bf16(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, int B, int S, int D, int Dscale,
                                        void* stream) {
  if (bad_shape(B, S, D, Dscale)) return (int)cudaErrorInvalidValue;
  return launch_bwd_bf16<true>(k, v, q, dout, lse, delta, dk, dv, B, S, D, scale_for(Dscale),
                               static_cast<cudaStream_t>(stream));
}

// As eovax_flash_attention_bwd_dkdv_bf16, for dq.
int eovax_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      void* dq, int B, int S, int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale)) return (int)cudaErrorInvalidValue;
  return launch_bwd_bf16<false>(q, dout, k, v, lse, delta, dq, nullptr, B, S, D,
                                scale_for(Dscale), static_cast<cudaStream_t>(stream));
}

int eovax_flash_attention_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int B, int S, int D, int Dscale,
                                       void* stream) {
  if (bad_shape(B, S, D, Dscale)) return (int)cudaErrorInvalidValue;
  return launch_bwd_f32<true>(k, v, q, dout, lse, delta, dk, dv, B, S, D, scale_for(Dscale),
                              static_cast<cudaStream_t>(stream));
}

int eovax_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     void* dq, int B, int S, int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale)) return (int)cudaErrorInvalidValue;
  return launch_bwd_f32<false>(q, dout, k, v, lse, delta, dq, nullptr, B, S, D,
                               scale_for(Dscale), static_cast<cudaStream_t>(stream));
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

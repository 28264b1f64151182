// Single-head, unmasked flash attention backward for Hopper (sm_90a).
//
// The gradient of flash_attention.cu's forward, softmax(q·kᵀ/√D)·v over
// [B, S, D], which replaces the TPU kernel `_flash_kernel` / `flash_attention`
// (eovax/kernels/attention.py:28-100, pallas_call at line 83). That kernel has
// no backward: the JAX trainer differentiates `sdpa_auto`'s einsum
// (attention.py:103-128), whose gradient this computes without its [B, S, S]
// buffers. The probabilities are recomputed from the forward's row statistics:
// lse, each row's log-sum-exp of the scaled logits in log2 units, so that
// P = exp2(q·kᵀ·scale·log2(e) − lse).
//
// FlashAttention-2's split, with no atomics, so that two calls give the same
// bits:
//   (a) Δ = rowsum(dO ∘ O) in fp32, a warp a row: flash_bwd_delta_kernel
//       ([B, S]) or, for the wgmma kernels, flash_bwd_stats_kernel, which also
//       copies lse, both into [B, Sp] buffers padded to kStatsAlign rows (Δ 0
//       and lse +∞ past S, so that a padded column's probability is 0).
//   (b) dK/dV: a block owns a tile of keys and loops over the query tiles:
//       Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; Pᵀ = exp2(Sᵀ·scale·log2(e) − lse),
//       dSᵀ = Pᵀ ∘ (dPᵀ − Δ); dV += Pᵀ·dO, dK += dSᵀ·Q; dK times the scale.
//   (c) dQ: a block owns a tile of queries and loops over the key tiles in the
//       same way: S = Q·Kᵀ, dP = dO·Vᵀ, P, dS, dQ += dS·K; dQ times the scale.
// (b) and (c) are one kernel body: resident rows A1, A2 (K, V or Q, dO) against
// the streamed tiles B1, B2 (Q, dO or K, V); dS·B1 goes to the first output,
// P·B2 (dK/dV only) to the second, and the statistics belong to the streamed
// columns (dK/dV) or to the resident rows (dQ).
//
// What bounds it on the H100: the tensor cores, and beside them the exps. The
// least work is 5 products of 2·B·S²·D (dP, dV, dK; dQ and the logits once),
// but the split computes 7: the dQ kernel recomputes S and dP. Each kernel also
// takes B·S² exp2s on the SMs' special-function units, 16 a clock an SM: at
// [4,16384,64] the 2·B·S² exps alone are about 0.55 ms, near the 0.69 ms that
// the 5 products take at the bf16 peak.
//
// bf16 at D = 64 and 128 (the pixel SR UNet, the flow refiner, the SR latent
// UNet; wider widths that the wrapper pads to them): flash_bwd_wgmma_kernel.
//   - Two consumer warpgroups a block (one in dK/dV at D = 128), each owning
//     64 resident rows, and a producer warpgroup. The resident rows (A1, A2)
//     are loaded once by TMA and stay in shared memory for the whole loop; the
//     streamed tiles of 64 rows (B1, B2, and in dK/dV their lse and Δ by a bulk
//     copy) come through a ring of kStages stages, each with a full and an
//     empty mbarrier. One thread of the producer issues every copy; its
//     warpgroup keeps 24 registers (setmaxnreg), the consumers take 240.
//   - Every product is `wgmma` (the only path to the card's tensor-core rate):
//     S and dP as m64n64k16 with both operands in shared memory (K-major);
//     P and dS, formed in registers and rounded to bf16, are the register A
//     operand of the update products m64nDk16, whose B is the streamed tile
//     read MN-major (no transposing copy), as the forward's P·V.
//   - The 7 products against 5: the split keeps its two kernels so that no
//     atomics are needed; the dQ kernel's recompute is 2 of its 3 products.
//     The exps: each consumer computes P while its dP product is in flight,
//     and the block's two warpgroups interleave on the SM, one's exps beside
//     the other's products.
//   - Shared memory holds every tile in wgmma's 128-byte swizzle layout, as
//     TMA writes it: [D/64 column blocks][64 rows][128 bytes], 1024-aligned.
//   - Rows past S arrive zero-filled (TMA's out-of-bounds fill); padded
//     columns of dK/dV have lse = +∞ (P = 0); the dQ kernel masks the keys of
//     its last tile past S.
//
// bf16 at D = 256 and 512 (stage 2's mid-block attention at 512 channels, and
// D = 192 widened): flash_bwd_cluster_kernel, D split over a thread-block
// cluster of D/128 CTAs along the grid's x, each CTA the D = 128 block above on
// its own 128 columns (resident tiles, streamed tiles by TMA through an
// mbarrier ring, one producer warpgroup, setmaxnreg 24/240, every product on
// wgmma). Each CTA computes its partial S_c and dP_c over its columns once per
// (row tile, streamed tile); the cluster sums them through distributed shared
// memory as a reduce-scatter (CTA r sums, in rank order, the rows held by warps
// r·4/C .. of every CTA's warpgroup, and forms their P and dS in bf16), then
// an all-gather of those bf16 rows hands every CTA the register A operands of
// its own update products. See the section's own notes below.
//
// bf16 above D = 512 (the D-split forward's widths): flash_bwd_bf16_kernel, a block of
// four warps (16 rows each) owning 64 rows and one chunk of 64 output columns
// (the grid's z), `mma.sync` m16n8k16 with fp32 accumulators, operands from
// shared memory by `ldmatrix` (the update products' B by `ldmatrix.trans`),
// rows padded to 144 bytes; every stage copies its four 64 × 64 pieces with
// cp.async (two stages, 72 KiB). At D = 512 the dK and dV accumulators of 64
// keys are 256 KiB of fp32, more than a block's registers and shared memory,
// so every D above 64 recomputes S and dP for each 64-column chunk (8× at
// D = 512), the chunk's own piece of D last so that its tiles stay in shared
// memory for the update products.
// fp32 (FULL_PRECISION): an FMA kernel in the forward's fp32 layout, 8 warps ×
// 4 rows, lane j scoring streamed row j of a 32-row tile, lane l owning output
// columns l and l + 32 of the chunk.
//
// P is rounded to bf16 before dV (as the tensor-op backward and the JAX
// autodiff round it) and dS because the tensor cores take bf16; dP stays fp32.
// D is any multiple of 64 (the wrapper widens the others as the forward does);
// any S, the last tiles masked; the batch on the grid's y (at most 65535 a
// launch).
//
// Plain C interface, loaded with ctypes. Each entry point launches one kernel
// on the given stream and returns cudaGetLastError() (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <utility>

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

// ---------------------------------------------------------------- bf16, D ≤ 128: wgmma

namespace wg {

constexpr int kTile = 64;          // rows of a warpgroup's resident tile and of a streamed tile
constexpr int kStages = 3;         // streamed tiles in flight
// setmaxnreg moves registers between whole warpgroups, so the producer is a
// warpgroup (one thread of it issues the copies): ptxas gives the kernel
// 65536 / threads registers a thread, the producer hands its down to 24 and
// the consumers take up to 240.
constexpr int kProducerThreads = 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kAtomBytes = 8 * 128;   // one 128-byte swizzle atom: 8 rows × 128 bytes
constexpr int kColBytes = 64 * 128;   // 64 columns of d of a 64-row tile: 8 atoms
constexpr int kStatBytes = kTile * 4;  // lse (or Δ) of a streamed tile

// A block at width D of the dK/dV (kDKV) or the dQ kernel: its consumer
// warpgroups (two, but one for dK/dV at D = 128: with two, ptxas has 168
// registers a thread, and its 128 accumulator registers spilled), its threads,
// and its shared memory from a 1024-byte aligned base: the resident tiles (A1
// of each warpgroup, then A2 of each), the ring of stages (B1, B2, then in
// dK/dV the tile's lse and Δ), the mbarriers (full and empty a stage, and one
// for the resident tiles).
template <int D, bool kDKV>
struct Plan {
  static constexpr int kGroups = kDKV && D == 128 ? 1 : 2;
  static constexpr int kThreads = kGroups * 128 + kProducerThreads;
  static constexpr int kTileBytes = kTile * D * 2;  // a 64 × D bf16 tile
  static constexpr int kResBytes = 2 * kGroups * kTileBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr int kBars = kResBytes + kStages * kStageBytes;
  static constexpr size_t bytes = kBars + (2 * kStages + 1) * 8 + 1024;  // + the alignment
  // Registers of the block's warps after setmaxnreg: within an SM's 65536.
  static_assert((kGroups * kConsumerRegs + kProducerRegs) * 128 <= 65536, "registers");
  static_assert(bytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival, and `bytes` more for the copies that complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Until the barrier's phase of this parity has completed (acquire). A wait of
// more than 2^34 clocks (seconds) traps, so that a fault in the pipeline is a
// launch error and not a card that never finishes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// A 64 × 64 box of a [B, S, D] bf16 tensor map (d0, row0, batch) into shared
// memory at dst, in the 128-byte swizzle; rows past S are zero-filled.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int d0, int row0,
                                        int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(row0), "r"(batch), "r"(bar)
      : "memory");
}

// All D/64 column blocks of the rows row0 .. row0+63 into the tile at dst.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int row0,
                                         int batch, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_box(dst + c * kColBytes, map, 64 * c, row0, batch, bar);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of a wgmma operand register across
// the wgmma fence, commit and wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

__device__ __forceinline__ void fence_all(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fence_operand(r[i][j]);
}

// Shared-memory matrix descriptors with the 128-byte swizzle, as in
// flash_attention.cu: bits 0-13 the start address, 16-29 LBO, 32-45 SBO (16-byte
// units), 62-63 the layout (1: 128-byte swizzle); the high word is the same for
// every operand.
//   K-major (S and dP, both operands): SBO 1024 bytes between 8-row groups; a
//   k-step of 16 columns of d moves the start 32 bytes inside the atom row.
//   MN-major (the update products' B, the streamed tile read as [k = row][n =
//   d]): LBO kColBytes between 64-column blocks of d, SBO 1024 bytes between
//   8-row groups; a k-step of 16 rows moves the start two atoms.
constexpr uint32_t kKLBO = 16;
constexpr uint32_t kMNLBO = kColBytes;
constexpr uint32_t kDescHi = (kAtomBytes >> 4) | (1u << 30);
__host__ __device__ constexpr int k_step(int kk) {
  return ((16 * kk) / 64 * kColBytes + (16 * kk) % 64 * 2) / 16;
}
constexpr int kMNStep = 2 * kAtomBytes / 16;

__device__ __forceinline__ uint32_t desc_lo(uint32_t smem, uint32_t lbo_bytes) {
  return ((smem & 0x3FFFF) >> 4) | ((lbo_bytes >> 4) << 16);
}

#define EOVAX_F8(d, i)                                                                       \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define EOVAX_F32(d, i) \
  EOVAX_F8(d, i), EOVAX_F8(d, (i) + 8), EOVAX_F8(d, (i) + 16), EOVAX_F8(d, (i) + 24)

// d[64 × 64] = A[64 × 16] · B[16 × 64] (+ d if accumulate), both K-major bf16 in
// shared memory at lo_a + OA and lo_b + OB (16-byte units), fp32 d.
// d[4j + 2h + e]: row 16·warp + lane/4 + 8h, column 8j + 2·(lane % 4) + e.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t lo_a, uint32_t lo_b,
                                         uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 la, lb;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 la, %32, %36;\n"
      "add.u32 lb, %33, %37;\n"
      "mov.b64 da, {la, %35};\n"
      "mov.b64 db, {lb, %35};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      : EOVAX_F32(d, 0)
      : "r"(lo_a), "r"(lo_b), "r"(accumulate), "r"(kDescHi), "n"(OA), "n"(OB));
}

// d[64 × N] += A[64 × 16] · B[16 × N] (d overwritten where !accumulate): A bf16
// in registers, for each warp's 16 rows the m16n8k16 A fragment (a[0] row
// lane/4, columns 2·(lane % 4) + {0, 1}; a[1] the row 8 below; a[2], a[3] the
// columns 8 further), B MN-major bf16 at lo_b + OB (imm-trans-b = 1); d laid
// out as in wgmma_ss.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  template <int OB>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 lb;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.u32 lb, %36, %39;\n"
        "mov.b64 db, {lb, %38};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n"
        "}\n"
        : EOVAX_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(accumulate),
          "r"(kDescHi), "n"(OB));
  }
};

template <>
struct WgmmaRS<128> {
  template <int OB>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 lb;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "add.u32 lb, %68, %71;\n"
        "mov.b64 db, {lb, %70};\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n"
        "}\n"
        : EOVAX_F32(d, 0), EOVAX_F32(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(accumulate),
          "r"(kDescHi), "n"(OB));
  }
};

#undef EOVAX_F32
#undef EOVAX_F8

// d = A·Bᵀ over all of D: D/16 k-steps, the first overwriting d.
template <int... K>
__device__ __forceinline__ void ss_steps(float (&d)[32], uint32_t lo_a, uint32_t lo_b,
                                         std::integer_sequence<int, K...>) {
  (wgmma_ss<k_step(K), k_step(K)>(d, lo_a, lo_b, K == 0 ? 0u : 1u), ...);
}

// acc += X·B over the 64 streamed rows: 4 k-steps; where `first`, the first
// overwrites acc.
template <int N, int... K>
__device__ __forceinline__ void rs_steps(float (&acc)[N / 2], const uint32_t (&x)[4][4],
                                         uint32_t lo_b, uint32_t first,
                                         std::integer_sequence<int, K...>) {
  (WgmmaRS<N>::template run<K * kMNStep>(acc, x[K], lo_b, K == 0 ? 1u - first : 1u), ...);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// kDKV: A1 = K, A2 = V, B1 = Q, B2 = dO; out1 = dK, out2 = dV; the statistics
//       of the streamed columns come with each stage.
// dQ:   A1 = Q, A2 = dO, B1 = K, B2 = V; out1 = dQ (out2 unused); the
//       statistics of the resident rows are read once.
// lse and delta are [B, Sp] (Sp a multiple of kStatsAlign, padded as
// flash_bwd_stats_kernel pads them); the maps are [B, S, D] bf16.
template <int D, bool kDKV>
__global__ void __launch_bounds__(Plan<D, kDKV>::kThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap a1_map,
                           const __grid_constant__ CUtensorMap a2_map,
                           const __grid_constant__ CUtensorMap b1_map,
                           const __grid_constant__ CUtensorMap b2_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ out1, __nv_bfloat16* __restrict__ out2,
                           int S, int Sp, float scale_log2, float scale) {
  using L = Plan<D, kDKV>;
  constexpr int kGroups = L::kGroups;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle is a function of the address
  const unsigned char* gbase = smem + (base - raw);
  const uint32_t sRes = base, sStages = base + L::kResBytes, bars = base + L::kBars;
  const uint32_t res_bar = bars + 16 * kStages;
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (kStages + st); };

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kGroups * kTile;  // the block's first resident row
  const int batch = blockIdx.y;
  const int ntiles = (S + kTile - 1) / kTile;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kGroups * 128);
    }
    mbar_init(res_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kGroups * 128) {
    // The producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kGroups * 128) {
      mbar_expect_tx(res_bar, L::kResBytes);
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        tma_tile<D>(sRes + w * L::kTileBytes, &a1_map, r0 + kTile * w, batch, res_bar);
        tma_tile<D>(sRes + (kGroups + w) * L::kTileBytes, &a2_map, r0 + kTile * w, batch,
                    res_bar);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(st), (it / kStages - 1) & 1);
        const uint32_t buf = sStages + st * L::kStageBytes;
        mbar_expect_tx(full_bar(st), 2 * L::kTileBytes + (kDKV ? 2 * kStatBytes : 0));
        tma_tile<D>(buf, &b1_map, it * kTile, batch, full_bar(st));
        tma_tile<D>(buf + L::kTileBytes, &b2_map, it * kTile, batch, full_bar(st));
        if (kDKV) {
          const size_t at = (size_t)batch * Sp + (size_t)it * kTile;
          bulk_copy(buf + 2 * L::kTileBytes, lse + at, kStatBytes, full_bar(st));
          bulk_copy(buf + 2 * L::kTileBytes + kStatBytes, delta + at, kStatBytes, full_bar(st));
        }
      }
    }
  } else {
    // A consumer warpgroup: 64 resident rows against every streamed tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int grp = tid / 128, warp = tid % 128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int row0 = r0 + kTile * grp;
    const uint32_t lo_a1 = desc_lo(sRes + grp * L::kTileBytes, kKLBO);
    const uint32_t lo_a2 = desc_lo(sRes + (kGroups + grp) * L::kTileBytes, kKLBO);

    // dQ: the statistics of this thread's rows g, g + 8 (lse +∞ past S: P = 0).
    float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
    if (!kDKV) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t at = (size_t)batch * Sp + row0 + 16 * warp + g + 8 * h;
        row_lse[h] = lse[at];
        row_delta[h] = delta[at];
      }
    }

    float acc1[D / 2], acc2[D / 2];  // written first by the first tile's products (acc2: dK/dV)
    mbar_wait(res_bar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      const uint32_t buf = sStages + st * L::kStageBytes;
      mbar_wait(full_bar(st), (it / kStages) & 1);

      float s[32], dp[32];
      fence_all(s);
      fence_all(dp);
      wgmma_fence();
      ss_steps(s, lo_a1, desc_lo(buf, kKLBO), std::make_integer_sequence<int, D / 16>{});
      wgmma_commit();
      ss_steps(dp, lo_a2, desc_lo(buf + L::kTileBytes, kKLBO),
               std::make_integer_sequence<int, D / 16>{});
      wgmma_commit();
      wgmma_wait<1>();  // S is done; dP may be in flight
      fence_all(s);

      // Register i of s and dp: row g + 8·((i >> 1) & 1), column
      // 8·(i >> 2) + 2t + (i & 1) of the streamed tile.
      const float* stat = reinterpret_cast<const float*>(gbase + (buf - base) + 2 * L::kTileBytes);
      const int valid = S - it * kTile;  // streamed columns below S in this tile
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
          const float l2 = kDKV ? stat[col] : row_lse[e >> 1];
          float pr = ex2(fmaf(s[i], scale_log2, -l2));
          if (!kDKV && col >= valid) pr = 0.f;  // keys past S
          s[i] = pr;
        }

      wgmma_wait<0>();  // dP is done
      fence_all(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, col = 8 * j + 2 * t + (e & 1);
          const float dl = kDKV ? stat[kTile + col] : row_delta[e >> 1];
          dp[i] = s[i] * (dp[i] - dl);
        }
      // P (dK/dV) and dS rounded to bf16 as the A fragments of the 4 k-steps of
      // the update products: registers 8kk .. 8kk+7 hold columns 16kk .. 16kk+15.
      uint32_t x[4][4], y[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (kDKV) x[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          y[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

      fence_all(acc1);
      if constexpr (kDKV) {
        fence_all(acc2);
        fence_all(x);
      }
      fence_all(y);
      wgmma_fence();
      if constexpr (kDKV)
        rs_steps<D>(acc2, x, desc_lo(buf + L::kTileBytes, kMNLBO), it == 0 ? 1u : 0u,
                    std::make_integer_sequence<int, 4>{});
      rs_steps<D>(acc1, y, desc_lo(buf, kMNLBO), it == 0 ? 1u : 0u,
                  std::make_integer_sequence<int, 4>{});
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc1);
      if constexpr (kDKV) fence_all(acc2);
      mbar_arrive(empty_bar(st));  // this thread is done with the stage
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * warp + g + 8 * h;
      if (row >= S) continue;
      const size_t at = ((size_t)batch * S + row) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out1 + at + 8 * j) =
            __floats2bfloat162_rn(acc1[4 * j + 2 * h] * scale, acc1[4 * j + 2 * h + 1] * scale);
        if (kDKV)
          *reinterpret_cast<__nv_bfloat162*>(out2 + at + 8 * j) =
              __floats2bfloat162_rn(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query,
// so that the library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [B, S, D] bf16 tensor as TMA boxes of 64 columns × 64 rows × 1 batch row
// with the 128-byte swizzle; rows past S read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int B, int S, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once an instance: the shared memory above 48 KB, and a check that the kernel
// was given the registers that setmaxnreg hands from the producer to the
// consumers (with fewer, setmaxnreg.inc would wait for ever).
template <int D, bool kDKV>
cudaError_t configure() {
  static const cudaError_t status = [] {
    using L = Plan<D, kDKV>;
    auto kernel = flash_bwd_wgmma_kernel<D, kDKV>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::bytes);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * L::kThreads >= (L::kGroups * kConsumerRegs + kProducerRegs) * 128
               ? cudaSuccess
               : cudaErrorInvalidConfiguration;
  }();
  return status;
}

template <int D, bool kDKV>
int launch(const void* a1, const void* a2, const void* b1, const void* b2, const float* lse,
           const float* delta, void* out1, void* out2, int B, int S, int Sp, float scale,
           cudaStream_t stream) {
  const cudaError_t err = configure<D, kDKV>();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[4];
  const void* srcs[4] = {a1, a2, b1, b2};
  for (int i = 0; i < 4; ++i)
    if (!encode(&maps[i], srcs[i], B, S, D)) return (int)cudaErrorInvalidValue;
  using L = Plan<D, kDKV>;
  dim3 grid((S + L::kGroups * kTile - 1) / (L::kGroups * kTile), B);
  flash_bwd_wgmma_kernel<D, kDKV><<<grid, L::kThreads, L::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, static_cast<__nv_bfloat16*>(out1),
      static_cast<__nv_bfloat16*>(out2), S, Sp, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// Rows of the padded statistics: a multiple of the wgmma kernels' resident rows
// a block, so that every row and streamed tile they read lies inside.
constexpr int kStatsAlign = 2 * wg::kTile;
static_assert(kStatsAlign % (wg::Plan<64, false>::kGroups * wg::kTile) == 0 &&
                  kStatsAlign % (wg::Plan<64, true>::kGroups * wg::kTile) == 0 &&
                  kStatsAlign % (wg::Plan<128, false>::kGroups * wg::kTile) == 0 &&
                  kStatsAlign % (wg::Plan<128, true>::kGroups * wg::kTile) == 0,
              "padded statistics cover every block's rows");

// Δ = rowsum(dO ∘ O) and a copy of lse into [B, Sp] buffers, Δ 0 and lse +∞ on
// the rows from S to Sp; a warp a row.
__global__ void __launch_bounds__(kDeltaWarps * 32)
    flash_bwd_stats_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ delta_p, float* __restrict__ lse_p, long long rows,
                           int S, int Sp, int D) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long batch = row / Sp;
  const int i = (int)(row % Sp);
  float acc = 0.f;
  if (i < S) {
    const long long src = batch * S + i;
    const __nv_bfloat162* ob = reinterpret_cast<const __nv_bfloat162*>(o + src * D);
    const __nv_bfloat162* db = reinterpret_cast<const __nv_bfloat162*>(dout + src * D);
    for (int d = lane; d < D / 2; d += 32) {
      const float2 a = __bfloat1622float2(ob[d]), b = __bfloat1622float2(db[d]);
      acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) {
    delta_p[row] = acc;
    lse_p[row] = i < S ? lse[batch * S + i] : INFINITY;
  }
}

// ---------------------------------------------------------------- bf16, D = 256 and 512: clusters
//
// D is split over a cluster of kC = D/128 CTAs along the grid's x: rank r owns
// columns 128r .. 128r+127 of every operand and gradient. A CTA is the D = 128
// wgmma block above on its own columns: 64 resident rows of A1, A2 a consumer
// warpgroup, the streamed 64-row tiles of B1, B2 (in dK/dV with their lse and Δ)
// through the mbarrier ring from one thread of a producer warpgroup, S and dP as
// m64n64k16 SS over its 128 columns, the update products m64n128k16 RS into its
// 128 columns. A call issues the D = 128 kernels' 7 products of 2·B·S²·D, with
// no recompute per column chunk.
//
// The exchange, once a streamed tile and warpgroup, through distributed shared
// memory in two rounds (a reduce-scatter of the fp32 partials, then an
// all-gather of bf16 P and dS):
//   1. each consumer thread stores its 32 + 32 fp32 partials of S and dP in its
//      CTA's partial buffer in fragment order (16-byte chunk q of thread u at
//      (q·128 + u)·16: neighbouring threads, neighbouring addresses); then
//      lane 0 of each warp fences (a release to the cluster of this CTA's
//      shared memory) and arrives on every CTA's part_full barrier;
//   2. CTA r forms the fragments of warps r·W .. r·W + W − 1 (W = 4/kC): each of
//      its threads takes one such thread u and 8/kC of its chunk pairs (S, dP),
//      reads them from the kC CTAs (ld.shared::cluster), sums them in rank order,
//      forms P = exp2(S·scale·log2 e − lse) and dS = P∘(dP − Δ), and stores them
//      in bf16 in its own P/dS buffer as u's A-fragment registers; then each
//      warp fences and arrives on every CTA's pds_full barrier;
//   3. each consumer thread loads its dS (and in dK/dV P) fragments from the CTA
//      that formed them: every CTA updates with the same bits.
// A wait acquires at cluster scope what the fence and the arrivals released.
// At D = 512 a CTA reads 24 KiB of its peers' partials and 12 KiB of their P and
// dS a tile, against 96 KiB for an all-gather of the partials, and takes a
// quarter of the exps. No buffer is doubled: a CTA rewrites its partials only
// after its pds_full wait of the tile (every peer has read them by then), and
// its P/dS only after its part_full wait of the next tile (every peer has
// loaded them before arriving there). Every CTA of a cluster runs the same
// tiles, so the masks agree: rows past S are TMA's zero fill, lse is +∞ past S
// in the padded statistics, and the dQ kernel zeroes P for the keys past S.
//
// Shared memory, from a 1024-aligned base (the same offset in every CTA, so one
// address names a buffer in each): the resident tiles, the ring, the streamed
// tiles' lse and Δ (dK/dV), then a warpgroup's 32 KiB partial buffer and its
// P/dS (16 KiB in dK/dV, 8 in dQ). dK/dV keeps one consumer warpgroup and 3
// stages, 179 KiB: ptxas gives a 384-thread block 168 registers a thread, and
// a second warpgroup's dK and dV accumulators beside S and dP spilled there.
// dQ has two, so that one's exchange runs beside the other's products, and
// gives up a stage for them: 2 stages, 210 KiB (3 would need 243).
// What bounds it: each tile's two rounds of the exchange, which a CTA's one
// (dK/dV) or two (dQ) warpgroups wait for in turn, more than the tensor cores:
// without the exchange the kernels take about a third of the time. Full
// cluster-scope fences, arrivals with release semantics to each CTA, and
// pushes of every chunk by st.async onto the receiver's barrier were each
// slower than the fences restricted to shared memory used here (PERF.md §6
// PR 26, scripts/ablate_attention_backward.py).

namespace cl {

using namespace wg;

constexpr int kSlice = 128;                      // columns of D a CTA owns
constexpr int kSliceBytes = kTile * kSlice * 2;  // a 64 × 128 bf16 tile
constexpr int kPartBytes = 16 * 128 * 16;        // a warpgroup's S and dP partials, fp32
constexpr int kFragBytes = 4 * 128 * 16;         // a warpgroup's P (or dS) A fragments, bf16

template <int kC, bool kDKV>
struct ClusterPlan {
  static constexpr int kW = 4 / kC;  // warps of a warpgroup whose fragments a CTA forms
  static constexpr int kGroups = kDKV ? 1 : 2;
  static constexpr int kStages = kGroups == 2 ? 2 : 3;
  static constexpr int kThreads = kGroups * 128 + kProducerThreads;
  static constexpr int kResBytes = 2 * kGroups * kSliceBytes;
  static constexpr int kStageBytes = 2 * kSliceBytes;
  static constexpr int kStats = kResBytes + kStages * kStageBytes;  // lse, Δ a stage (dK/dV)
  static constexpr int kPdsBytes = (kDKV ? 2 : 1) * kFragBytes;
  static constexpr int kPart = kStats + kStages * 2 * kStatBytes;
  static constexpr int kPds = kPart + kGroups * kPartBytes;
  static constexpr int kBars = kPds + kGroups * kPdsBytes;
  // full and empty a stage, the resident tiles', part_full and pds_full a warpgroup
  static constexpr int kNumBars = 2 * kStages + 1 + 2 * kGroups;
  static constexpr size_t bytes = kBars + kNumBars * 8 + 1024;  // + the alignment
  static_assert(kC == 2 || kC == 4, "a cluster of 2 or 4 CTAs");
  static_assert((kGroups * kConsumerRegs + kProducerRegs) * 128 <= 65536, "registers");
  static_assert(bytes <= 232448, "shared memory of one block");
};

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of the same offset in the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Lane 0 of a warp, after __syncwarp: a fence releasing to the cluster what the
// warp stored in this CTA's shared memory, then one relaxed arrival on `bar` (a
// shared::cta address) in each of the cluster's kC CTAs. The fence is
// restricted to shared memory (a full fence.acq_rel.cluster took a sixth of
// the kernel's time); the warp's earlier reads of its peers' buffers are
// ordered before it by their data: what they read went into what it stored.
template <int kC>
__device__ __forceinline__ void release_to_cluster(uint32_t bar) {
  asm volatile("fence.release.sync_restrict::shared::cta.cluster;\n" ::: "memory");
#pragma unroll
  for (int r = 0; r < kC; ++r)
    asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                     peer(bar, r))
                 : "memory");
}

__device__ __forceinline__ bool try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.relaxed.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// As mbar_wait (the trap included), then a fence acquiring from the cluster's
// shared memory what the arrivals released.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  if (!try_wait_cluster(bar, parity)) {
    const long long start = clock64();
    while (!try_wait_cluster(bar, parity))
      if (clock64() - start > (1ll << 34)) __trap();
  }
  asm volatile("fence.acquire.sync_restrict::shared::cluster.cluster;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld_peer_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void ld_peer_u4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void st_f4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

__device__ __forceinline__ void st_u2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b) : "memory");
}

// Every thread of the cluster arrives (release) and waits for the others (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Columns d0 .. d0+127 of rows row0 .. row0+63 into the 64 × 128 tile at dst.
__device__ __forceinline__ void tma_slice(uint32_t dst, const CUtensorMap* map, int d0, int row0,
                                          int batch, uint32_t bar) {
  tma_box(dst, map, d0, row0, batch, bar);
  tma_box(dst + kColBytes, map, d0 + 64, row0, batch, bar);
}

// kDKV: A1 = K, A2 = V, B1 = Q, B2 = dO; out1 = dK, out2 = dV.
// dQ:   A1 = Q, A2 = dO, B1 = K, B2 = V; out1 = dQ (out2 unused).
// The maps are [B, S, kC·128] bf16 in 64 × 64 boxes; lse and delta [B, Sp],
// padded as flash_bwd_stats_kernel pads them.
template <int kC, bool kDKV>
__global__ void __launch_bounds__(ClusterPlan<kC, kDKV>::kThreads, 1)
    flash_bwd_cluster_kernel(const __grid_constant__ CUtensorMap a1_map,
                             const __grid_constant__ CUtensorMap a2_map,
                             const __grid_constant__ CUtensorMap b1_map,
                             const __grid_constant__ CUtensorMap b2_map,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ out1, __nv_bfloat16* __restrict__ out2,
                             int S, int Sp, float scale_log2, float scale) {
  using L = ClusterPlan<kC, kDKV>;
  constexpr int kGroups = L::kGroups, kStages = L::kStages, kW = L::kW;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  const unsigned char* gbase = smem + (base - raw);
  const uint32_t sRes = base, sStages = base + L::kResBytes, bars = base + L::kBars;
  const uint32_t res_bar = bars + 16 * kStages;
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (kStages + st); };
  auto part_bar = [&](int grp) { return bars + 8 * (2 * kStages + 1 + grp); };
  auto pds_bar = [&](int grp) { return bars + 8 * (2 * kStages + 1 + kGroups + grp); };

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const int c0 = kSlice * (int)rank;                 // this CTA's columns of D
  const int r0 = blockIdx.x / kC * kGroups * kTile;  // the cluster's first resident row
  const int batch = blockIdx.y;
  const int ntiles = (S + kTile - 1) / kTile;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), kGroups * 128);
    }
    mbar_init(res_bar, 1);
    for (int grp = 0; grp < kGroups; ++grp) {
      mbar_init(part_bar(grp), 4 * kC);  // each warp of the warpgroup in each CTA
      mbar_init(pds_bar(grp), 4 * kC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are initialised before a peer arrives on them

  if (tid >= kGroups * 128) {
    // The producer warpgroup: one thread issues every copy of this CTA's columns.
    regs_dec<kProducerRegs>();
    if (tid == kGroups * 128) {
      mbar_expect_tx(res_bar, L::kResBytes);
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        tma_slice(sRes + w * kSliceBytes, &a1_map, c0, r0 + kTile * w, batch, res_bar);
        tma_slice(sRes + (kGroups + w) * kSliceBytes, &a2_map, c0, r0 + kTile * w, batch,
                  res_bar);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty_bar(st), (it / kStages - 1) & 1);
        const uint32_t buf = sStages + st * L::kStageBytes;
        mbar_expect_tx(full_bar(st), 2 * kSliceBytes + (kDKV ? 2 * kStatBytes : 0));
        tma_slice(buf, &b1_map, c0, it * kTile, batch, full_bar(st));
        tma_slice(buf + kSliceBytes, &b2_map, c0, it * kTile, batch, full_bar(st));
        if (kDKV) {
          const size_t at = (size_t)batch * Sp + (size_t)it * kTile;
          const uint32_t stats = base + L::kStats + st * 2 * kStatBytes;
          bulk_copy(stats, lse + at, kStatBytes, full_bar(st));
          bulk_copy(stats + kStatBytes, delta + at, kStatBytes, full_bar(st));
        }
      }
    }
  } else {
    // A consumer warpgroup: 64 resident rows, this CTA's 128 columns.
    regs_inc<kConsumerRegs>();
    const int grp = tid / 128, ctid = tid % 128, warp = ctid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = r0 + kTile * grp;
    const uint32_t lo_a1 = desc_lo(sRes + grp * kSliceBytes, kKLBO);
    const uint32_t lo_a2 = desc_lo(sRes + (kGroups + grp) * kSliceBytes, kKLBO);
    const uint32_t part = base + L::kPart + grp * kPartBytes;
    const uint32_t pds = base + L::kPds + grp * L::kPdsBytes;
    const uint32_t pbar = part_bar(grp), dbar = pds_bar(grp);
    uint32_t part_at[kC];  // this warpgroup's partial buffer in each CTA
#pragma unroll
    for (int r = 0; r < kC; ++r) part_at[r] = peer(part, r);
    const uint32_t frags = peer(pds, warp / kW);  // where this thread's P and dS are formed

    // The thread su whose P and dS this thread forms, and its first chunk pair.
    const int su = 32 * kW * (int)rank + ctid % (32 * kW);
    const int sq = ctid / (32 * kW);
    const int scol = 2 * (su % 4);  // su's first column in an 8-column chunk
    // dQ: the statistics of su's rows (lse +∞ past S: P = 0).
    float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
    if (!kDKV) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t at = (size_t)batch * Sp + row0 + 16 * (su / 32) + su % 32 / 4 + 8 * h;
        row_lse[h] = lse[at];
        row_delta[h] = delta[at];
      }
    }

    float acc1[kSlice / 2], acc2[kSlice / 2];  // written first by the first tile's products
    mbar_wait(res_bar, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % kStages;
      const uint32_t buf = sStages + st * L::kStageBytes;
      mbar_wait(full_bar(st), (it / kStages) & 1);

      // This CTA's partial S and dP over its columns.
      float s[32], dp[32];
      fence_all(s);
      fence_all(dp);
      wgmma_fence();
      ss_steps(s, lo_a1, desc_lo(buf, kKLBO), std::make_integer_sequence<int, kSlice / 16>{});
      wgmma_commit();
      ss_steps(dp, lo_a2, desc_lo(buf + kSliceBytes, kKLBO),
               std::make_integer_sequence<int, kSlice / 16>{});
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(s);
      fence_all(dp);

      // 1. The partials in fragment order: chunk q of s at q, of dp at 8 + q.
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        st_f4(part + (q * 128 + ctid) * 16, s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
        st_f4(part + ((8 + q) * 128 + ctid) * 16, dp[4 * q], dp[4 * q + 1], dp[4 * q + 2],
              dp[4 * q + 3]);
      }
      __syncwarp();
      if (lane == 0) release_to_cluster<kC>(pbar);
      wait_cluster(pbar, it & 1);

      // 2. su's chunk pairs sq, sq + kC, ... summed over the cluster in rank
      // order; their P and dS in bf16 (register i of chunk q: row
      // 16·(su/32) + su%32/4 + 8·(i >> 1), column 8q + scol + (i & 1)).
      const float* stat = reinterpret_cast<const float*>(gbase + L::kStats + st * 2 * kStatBytes);
      const int valid = S - it * kTile;  // streamed rows below S in this tile
#pragma unroll
      for (int k = 0; k < 8 / kC; ++k) {
        const int q = sq + kC * k;
        const uint32_t at_s = (q * 128 + su) * 16, at_dp = ((8 + q) * 128 + su) * 16;
        float4 sv = ld_peer_f4(part_at[0] + at_s), dv = ld_peer_f4(part_at[0] + at_dp);
#pragma unroll
        for (int r = 1; r < kC; ++r) {
          const float4 a = ld_peer_f4(part_at[r] + at_s), b = ld_peer_f4(part_at[r] + at_dp);
          sv.x += a.x;
          sv.y += a.y;
          sv.z += a.z;
          sv.w += a.w;
          dv.x += b.x;
          dv.y += b.y;
          dv.z += b.z;
          dv.w += b.w;
        }
        const float sx[4] = {sv.x, sv.y, sv.z, sv.w}, dx[4] = {dv.x, dv.y, dv.z, dv.w};
        float pr[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * q + scol + (e & 1);
          const float l2 = kDKV ? stat[col] : row_lse[e >> 1];
          const float dl = kDKV ? stat[kTile + col] : row_delta[e >> 1];
          float p = ex2(fmaf(sx[e], scale_log2, -l2));
          if (!kDKV && col >= valid) p = 0.f;  // keys past S
          pr[e] = p;
          ds[e] = p * (dx[e] - dl);
        }
        // Chunk q is su's A-fragment registers 2q and 2q + 1 (k-step q/2).
        const uint32_t at = (q / 2 * 128 + su) * 16 + q % 2 * 8;
        st_u2(pds + at, pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]));
        if (kDKV) st_u2(pds + kFragBytes + at, pack_bf16(pr[0], pr[1]), pack_bf16(pr[2], pr[3]));
      }
      __syncwarp();
      if (lane == 0) release_to_cluster<kC>(dbar);
      wait_cluster(dbar, it & 1);

      // 3. This thread's dS (and P) fragments from the CTA that formed them.
      uint32_t x[4][4], y[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ld_peer_u4(y[kk], frags + (kk * 128 + ctid) * 16);
        if (kDKV) ld_peer_u4(x[kk], frags + kFragBytes + (kk * 128 + ctid) * 16);
      }

      // dV += P·dO and dK += dS·Q, or dQ += dS·K, over this CTA's columns.
      fence_all(acc1);
      if constexpr (kDKV) {
        fence_all(acc2);
        fence_all(x);
      }
      fence_all(y);
      wgmma_fence();
      if constexpr (kDKV)
        rs_steps<kSlice>(acc2, x, desc_lo(buf + kSliceBytes, kMNLBO), it == 0 ? 1u : 0u,
                         std::make_integer_sequence<int, 4>{});
      rs_steps<kSlice>(acc1, y, desc_lo(buf, kMNLBO), it == 0 ? 1u : 0u,
                       std::make_integer_sequence<int, 4>{});
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc1);
      if constexpr (kDKV) fence_all(acc2);
      mbar_arrive(empty_bar(st));  // this thread is done with the stage
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * warp + g + 8 * h;
      if (row >= S) continue;
      const size_t at = ((size_t)batch * S + row) * (kC * kSlice) + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out1 + at + 8 * j) =
            __floats2bfloat162_rn(acc1[4 * j + 2 * h] * scale, acc1[4 * j + 2 * h + 1] * scale);
        if (kDKV)
          *reinterpret_cast<__nv_bfloat162*>(out2 + at + 8 * j) =
              __floats2bfloat162_rn(acc2[4 * j + 2 * h], acc2[4 * j + 2 * h + 1]);
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still read its shared memory
}

// An error code of a runtime call, with the runtime's last error cleared.
int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <int kC, bool kDKV>
cudaLaunchConfig_t cluster_config(dim3 grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kC;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(ClusterPlan<kC, kDKV>::kThreads);
  cfg.dynamicSmemBytes = ClusterPlan<kC, kDKV>::bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once a device and instance: the shared memory above 48 KB, the check that the
// kernel has the registers setmaxnreg hands out (as wg::configure), and
// cudaOccupancyMaxActiveClusters of its clusters, into *count.
template <int kC, bool kDKV>
int occupancy(int* count) {
  using L = ClusterPlan<kC, kDKV>;
  constexpr int kDevices = 64;
  static int known[kDevices] = {};  // 1 + the count, once asked
  static std::mutex mutex;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return refused(err);
  if (device < 0 || device >= kDevices) return (int)cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> lock(mutex);
  if (known[device] == 0) {
    const auto kernel = flash_bwd_cluster_kernel<kC, kDKV>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return refused(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return refused(err);
    if (attr.numRegs * L::kThreads < (L::kGroups * kConsumerRegs + kProducerRegs) * 128)
      return (int)cudaErrorInvalidConfiguration;
    cudaLaunchAttribute cattr;
    const cudaLaunchConfig_t cfg = cluster_config<kC, kDKV>(dim3(kC), nullptr, &cattr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return refused(err);
    known[device] = 1 + n;
  }
  *count = known[device] - 1;
  return 0;
}

template <int kC, bool kDKV>
int launch(const void* a1, const void* a2, const void* b1, const void* b2, const float* lse,
           const float* delta, void* out1, void* out2, int B, int S, int Sp, float scale,
           cudaStream_t stream) {
  using L = ClusterPlan<kC, kDKV>;
  int active = 0;
  const int code = occupancy<kC, kDKV>(&active);
  if (code != 0) return code;
  if (active < 1) return (int)cudaErrorLaunchOutOfResources;  // no cluster fits: no fallback
  CUtensorMap maps[4];
  const void* srcs[4] = {a1, a2, b1, b2};
  for (int i = 0; i < 4; ++i)
    if (!encode(&maps[i], srcs[i], B, S, kC * kSlice)) return (int)cudaErrorInvalidValue;
  const dim3 grid(kC * ((S + L::kGroups * kTile - 1) / (L::kGroups * kTile)), B);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<kC, kDKV>(grid, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_bwd_cluster_kernel<kC, kDKV>, maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(out1), static_cast<__nv_bfloat16*>(out2), S, Sp,
      scale * kLog2e, scale);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace cl

static_assert(kStatsAlign % (cl::ClusterPlan<2, false>::kGroups * wg::kTile) == 0 &&
                  kStatsAlign % (cl::ClusterPlan<2, true>::kGroups * wg::kTile) == 0,
              "padded statistics cover every cluster's rows");

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

// The rows Sp of the padded statistics of eovax_flash_attention_bwd_stats_bf16
// for a sequence of S.
int eovax_flash_attention_bwd_stats_rows(int S) {
  return (S + kStatsAlign - 1) / kStatsAlign * kStatsAlign;
}

// o, dout: contiguous [B, S, D] bf16; lse: [B, S] fp32 (the forward's row
// statistics); delta_p, lse_p: [B, Sp] fp32, Sp from
// eovax_flash_attention_bwd_stats_rows: Δ and lse, padded for the wgmma kernels.
int eovax_flash_attention_bwd_stats_bf16(const void* o, const void* dout, const float* lse,
                                         float* delta_p, float* lse_p, int B, int S, int Sp,
                                         int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || D % 64 != 0 || Sp < S || Sp % kStatsAlign != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Sp;
  const long long blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_stats_kernel<<<(unsigned)blocks, kDeltaWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, delta_p,
      lse_p, rows, S, Sp, D);
  return (int)cudaGetLastError();
}

// The wgmma kernels, D in {64, 128}: q, k, v, dout, dk, dv as for
// eovax_flash_attention_bwd_dkdv_bf16, each 16-byte aligned; lse_p, delta_p the
// padded statistics of eovax_flash_attention_bwd_stats_bf16.
int eovax_flash_attention_bwd_dkdv_wgmma_bf16(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse_p,
                                              const float* delta_p, void* dk, void* dv, int B,
                                              int S, int Sp, int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale) || Sp < S || Sp % kStatsAlign != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = scale_for(Dscale);
  switch (D) {
    case 64: return wg::launch<64, true>(k, v, q, dout, lse_p, delta_p, dk, dv, B, S, Sp, scale, st);
    case 128: return wg::launch<128, true>(k, v, q, dout, lse_p, delta_p, dk, dv, B, S, Sp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int eovax_flash_attention_bwd_dq_wgmma_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse_p,
                                            const float* delta_p, void* dq, int B, int S, int Sp,
                                            int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale) || Sp < S || Sp % kStatsAlign != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = scale_for(Dscale);
  switch (D) {
    case 64: return wg::launch<64, false>(q, dout, k, v, lse_p, delta_p, dq, nullptr, B, S, Sp, scale, st);
    case 128: return wg::launch<128, false>(q, dout, k, v, lse_p, delta_p, dq, nullptr, B, S, Sp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The cluster kernels, D in {256, 512} (clusters of D/128 CTAs): arguments as
// for the wgmma entries.
int eovax_flash_attention_bwd_dkdv_cluster_bf16(const void* q, const void* k, const void* v,
                                                const void* dout, const float* lse_p,
                                                const float* delta_p, void* dk, void* dv, int B,
                                                int S, int Sp, int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale) || Sp < S || Sp % kStatsAlign != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = scale_for(Dscale);
  switch (D) {
    case 256: return cl::launch<2, true>(k, v, q, dout, lse_p, delta_p, dk, dv, B, S, Sp, scale, st);
    case 512: return cl::launch<4, true>(k, v, q, dout, lse_p, delta_p, dk, dv, B, S, Sp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int eovax_flash_attention_bwd_dq_cluster_bf16(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse_p,
                                              const float* delta_p, void* dq, int B, int S,
                                              int Sp, int D, int Dscale, void* stream) {
  if (bad_shape(B, S, D, Dscale) || Sp < S || Sp % kStatsAlign != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = scale_for(Dscale);
  switch (D) {
    case 256: return cl::launch<2, false>(q, dout, k, v, lse_p, delta_p, dq, nullptr, B, S, Sp, scale, st);
    case 512: return cl::launch<4, false>(q, dout, k, v, lse_p, delta_p, dq, nullptr, B, S, Sp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// cudaOccupancyMaxActiveClusters of the cluster kernel of width D (256 or 512),
// dK/dV (dkdv != 0) or dQ, on the current device, into *count.
int eovax_flash_attention_bwd_cluster_occupancy(int D, int dkdv, int* count) {
  if (count == nullptr) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 256: return dkdv ? cl::occupancy<2, true>(count) : cl::occupancy<2, false>(count);
    case 512: return dkdv ? cl::occupancy<4, true>(count) : cl::occupancy<4, false>(count);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

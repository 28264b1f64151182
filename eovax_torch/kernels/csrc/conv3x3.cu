// 3×3 stride-1 SAME convolution with bias for Hopper (sm_90a), NCHW input and
// output.
//
// Replaces the Pallas TPU kernel `_kernel` / `_conv3x3_pallas` / `conv3x3` in
// eovax/kernels/conv3x3.py (pallas_call at line 112): the conv as nine tap
// matrix products into an fp32 accumulator, the bias (in the input type)
// added in fp32, and one rounding to the input type. The same entry points
// compute the data gradient of the backward (`_bwd` there, line 186): the
// conv of the output gradient with the flipped, in/out-transposed weights and
// no bias (a null bias pointer).
//
// What bounds it on the H100: operations. A ResnetBlock conv at
// [4, 512, 256, 256] 512→256 is 2·B·H·W·9·Ci·Co = 618 GFLOP against 403 MB
// of input and output, about 1,500 FLOP per byte, far above the card's ~295:
// the least time is 0.63 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design (bf16): an implicit GEMM on `wgmma`, out[p, co] = Σ_tap Σ_ci
// x[p + δ_tap, ci] · W_tap[ci, co], with M = pixels, N = Co, K = 9·Ci. No
// im2col and no padded copy exist in device memory.
//   - A block owns 4 output rows × 64 columns of one image × 128 output
//     channels and runs two warpgroups; each owns 2 rows, i.e. two
//     m64n128 accumulators (128 fp32 registers a thread). Each chunk's
//     weights serve 256 pixels: at 128 the block needed about one byte from
//     L2 for every 128 FLOP, which the weight loads could not keep up with.
//   - Both operands sit in shared memory in the no-swizzle core-matrix
//     layout, channels innermost: the halo slab of x (6 rows × 66 columns)
//     as [8-channel group][slab pixel][8 channels], the weights of all nine
//     taps as [tap][8-channel group][co][8 channels]. An 8-pixel core matrix
//     is then 128 contiguous bytes for any starting pixel, so a tap (dy, dx)
//     is only an offset of ((r + dy)·66 + dx)·16 bytes in the A descriptor,
//     and every tap reads the same slab. Descriptors: LBO = the stride
//     between 8-channel groups (K), SBO = 128 bytes between 8-row groups;
//     the offsets are compile-time immediates added inside the asm.
//   - N = 128 a instruction: with both operands in shared memory, an
//     m64n64k16 reads 4 KB in the ~31 cycles its products take, above the
//     SM's 128 bytes a cycle; m64n128k16 reads 6 KB in ~61 cycles.
//   - K is walked in chunks of 16 input channels through a ring of 4 stages
//     (4 × 49,536 bytes, one block an SM): while chunk j is computed, the
//     loads of chunk j + 2 are in flight. With two stages of 32 channels the
//     loads of one chunk had only one chunk of products to hide behind.
//   - Loads: the weights (laid out [3, 3, Ci/8, Co, 8] by the wrapper) with
//     16-byte cp.async, 2 KB contiguous per (tap, group). NCHW keeps pixels
//     contiguous, so the slab is read as 16-byte vectors of 8 pixels of one
//     channel, two channels at a time, interleaved into 32-bit words with
//     __byte_perm on the way to shared memory; the halo columns, images
//     whose width is not a multiple of 8, and the border (zeros) go apart.
//     A chunk's slab is loaded into registers one iteration before it is
//     stored, so its latency hides behind a chunk of products too.
//   - fence.proxy.async after the threads' shared-memory writes (st.shared
//     and cp.async) and before the barrier: wgmma reads through the async
//     proxy. One barrier a chunk; `wgmma.wait_group 1` keeps one chunk of
//     products in flight across it.
//   - The accumulators are never zeroed: the first product of the first
//     chunk uses scale-d = 0. A zeroing move that meets the wgmma outputs
//     at the loop head made ptxas serialize the wgmma (warning C7515).
//   - Epilogue: bias in fp32, one rounding to bf16, the tile staged in
//     shared memory as [co][64 pixels], written with 16-byte stores.
// Left out (the next redesign): TMA halo and weight loads with mbarriers and
// warp specialisation, setmaxnreg, a persistent grid (each block's first
// two chunks and its epilogue are not overlapped), clusters, fusing the
// residual add or the next GroupNorm. The block stays load-then-compute.
//
// The fp32 variant (FULL_PRECISION) is a plain FMA kernel on weights laid
// out [3, 3, Co, Ci]: a block owns 16 output channels × 8 × 32 pixels, one
// pixel per thread, and walks the input channels in chunks of 8 through
// shared memory.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kBN = 128;                         // output channels per block (wgmma N)
constexpr int kTW = 64;                          // output columns per block (wgmma M)
constexpr int kWGRows = 2;                       // output rows per warpgroup
constexpr int kWarpgroups = 2;
constexpr int kTH = kWarpgroups * kWGRows;       // output rows per block
constexpr int kThreads = kWarpgroups * 128;
constexpr int kKC = 16;                          // input channels per K chunk: one k-step
constexpr int kStages = 4;                       // K chunks in flight in shared memory
constexpr int kKG = kKC / 8;                     // 8-channel groups per chunk
constexpr int kSlabRows = kTH + 2, kSlabW = kTW + 2;
constexpr int kSlabPix = kSlabRows * kSlabW;
constexpr int kWBytes = 9 * kKG * kBN * 16;      // one chunk's weights: 36,864
constexpr int kSlabBytes = kKG * kSlabPix * 16;  // one chunk's slab
constexpr int kStageBytes = kWBytes + kSlabBytes;
constexpr size_t kSmemBytes = kStages * (size_t)kStageBytes;
constexpr int kEpiLD = kTW + 8;                  // epilogue row stride (elements): 144 bytes
constexpr int kWCopies = 9 * kKG * kBN;          // 16-byte copies a chunk
constexpr int kWPerThread = kWCopies / kThreads;
constexpr int kSlabItems = (kKC / 2) * kSlabRows * (kTW / 8);  // channel pairs × rows × vectors
constexpr int kSlabPerThread = (kSlabItems + kThreads - 1) / kThreads;
constexpr int kHaloItems = (kKC / 2) * kSlabRows * 2;          // channel pairs × rows × 2 columns
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert((size_t)kTH * kBN * kEpiLD * 2 <= kSmemBytes, "epilogue tile fits the stages");
static_assert(kWCopies % kThreads == 0, "even split");
static_assert(kHaloItems <= kThreads, "one halo item a thread at most");

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool pred) {
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's most recent cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// Keeps the compiler from moving accesses of an accumulator register across
// the wgmma fence, commit and wait.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// Shared-memory matrix descriptors, no swizzle: bits 0-13 the start address,
// 16-29 LBO (the stride between core matrices along K), 32-45 SBO (along M
// or N), all in 16-byte units. Both operands here have SBO = 128 bytes, so a
// descriptor is a 32-bit low word (address and LBO) and a constant high word.
constexpr uint32_t kDescHi = 128 >> 4;

__device__ __forceinline__ uint32_t desc_lo(uint32_t smem, uint32_t lbo_bytes) {
  return ((smem & 0x3FFFF) >> 4) | ((lbo_bytes >> 4) << 16);
}

// d[64 × 128] = A[64 × 16] · B[16 × 128] (+ d if accumulate), bf16 operands from
// shared memory, fp32 d. The descriptors are lo_a + OA and lo_b + OB (offsets in
// 16-byte units), added here so that only the two base words stay live.
// d[4j + 2h + e]: row 16·warp + lane/4 + 8h, column 8j + 2·(lane % 4) + e.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint32_t lo_a, uint32_t lo_b,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 la, lb;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "add.u32 la, %64, %68;\n"
      "add.u32 lb, %65, %69;\n"
      "mov.b64 da, {la, %67};\n"
      "mov.b64 db, {lb, %67};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(lo_a), "r"(lo_b), "r"(accumulate), "r"(kDescHi), "n"(OA), "n"(OB));
}

struct ConvShape {
  int Ci, Co, H, W, tiles_w;
};

// Weights of chunk ci0 (all nine taps, channels co0 .. co0+127) into the stage
// at sW with cp.async: copy i lands at byte 16·i, [tap][group][co][8]. Channels
// at or beyond Co are zero-filled.
__device__ __forceinline__ void load_weights(uint32_t sW, const __nv_bfloat16* wt,
                                             const ConvShape& s, int co0, int ci0, int tid) {
  const int groups = s.Ci / 8;
#pragma unroll
  for (int k = 0; k < kWPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int co = i % kBN, gg = ci0 / 8 + (i / kBN) % kKG, tap = i / (kBN * kKG);
    const bool ok = co0 + co < s.Co;
    const __nv_bfloat16* src = wt + (((size_t)tap * groups + gg) * s.Co + (ok ? co0 + co : 0)) * 8;
    cp_async16(sW + 16 * i, src, ok);
  }
}

// Slab item i → (channel pair in its group, slab row, 8-pixel vector, group).
// The four pairs of a group take neighbouring lanes, then the rows.
__device__ __forceinline__ void slab_item(int i, int& cpl, int& r, int& v, int& g) {
  cpl = i & 3;
  int rest = i >> 2;
  r = rest % kSlabRows;
  rest /= kSlabRows;
  v = rest & 7;
  g = rest >> 3;
}

// Halo item i → (channel pair in its group, slab row, slab column 0 or 65, group).
__device__ __forceinline__ void halo_item(int i, int& cpl, int& r, int& col, int& g) {
  cpl = i & 3;
  int rest = i >> 2;
  r = rest % kSlabRows;
  rest /= kSlabRows;
  col = (rest & 1) ? kSlabW - 1 : 0;
  g = rest >> 1;
}

// Pixels x .. x+7 of one image row (x ≥ 0, a multiple of 8), zero at and past W.
// One 16-byte load when W is a multiple of 8 (then the 8 are all in or all out).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int x, int W, bool vec) {
  if (vec) return x < W ? __ldg(reinterpret_cast<const uint4*>(row + x)) : make_uint4(0, 0, 0, 0);
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = x + 2 * e < W ? __ldg(r + x + 2 * e) : 0;
    const uint32_t hi = x + 2 * e + 1 < W ? __ldg(r + x + 2 * e + 1) : 0;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct SlabRegs {
  uint4 a[kSlabPerThread], b[kSlabPerThread];  // 8 pixels of channels 2p and 2p + 1
  uint32_t halo;                               // one pixel of both channels
};

// The slab of chunk ci0 into registers, zero outside the image.
__device__ __forceinline__ void load_slab(SlabRegs& regs, const __nv_bfloat16* xb,
                                          const ConvShape& s, int ci0, int y0, int x0, int tid) {
  const size_t plane = (size_t)s.H * s.W;
  const bool vec = (s.W & 7) == 0 && (reinterpret_cast<uintptr_t>(xb) & 15) == 0;
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int cpl, r, v, g;
    slab_item(tid + k * kThreads, cpl, r, v, g);
    const int c = ci0 + 8 * g + 2 * cpl, y = y0 - 1 + r;
    regs.a[k] = regs.b[k] = make_uint4(0, 0, 0, 0);
    if (tid + k * kThreads < kSlabItems && y >= 0 && y < s.H) {
      const __nv_bfloat16* row = xb + (size_t)c * plane + (size_t)y * s.W;
      regs.a[k] = load8(row, x0 + 8 * v, s.W, vec);
      regs.b[k] = load8(row + plane, x0 + 8 * v, s.W, vec);
    }
  }
  regs.halo = 0;
  if (tid < kHaloItems) {
    int cpl, r, col, g;
    halo_item(tid, cpl, r, col, g);
    const int c = ci0 + 8 * g + 2 * cpl, y = y0 - 1 + r, xx = x0 - 1 + col;
    if (y >= 0 && y < s.H && xx >= 0 && xx < s.W) {
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(xb) + (size_t)c * plane + (size_t)y * s.W + xx;
      regs.halo = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + plane) << 16);
    }
  }
}

// The registers of load_slab into the slab at sX: [group][slab pixel][8 channels].
__device__ __forceinline__ void store_slab(unsigned char* sX, const SlabRegs& regs, int tid) {
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    if (kSlabItems % kThreads != 0 && tid + k * kThreads >= kSlabItems) break;
    int cpl, r, v, g;
    slab_item(tid + k * kThreads, cpl, r, v, g);
    unsigned char* base = sX + (g * kSlabPix + r * kSlabW + 1 + 8 * v) * 16 + cpl * 4;
    const uint32_t a[4] = {regs.a[k].x, regs.a[k].y, regs.a[k].z, regs.a[k].w};
    const uint32_t b[4] = {regs.b[k].x, regs.b[k].y, regs.b[k].z, regs.b[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<uint32_t*>(base + (2 * e) * 16) = __byte_perm(a[e], b[e], 0x5410);
      *reinterpret_cast<uint32_t*>(base + (2 * e + 1) * 16) = __byte_perm(a[e], b[e], 0x7632);
    }
  }
  if (tid < kHaloItems) {
    int cpl, r, col, g;
    halo_item(tid, cpl, r, col, g);
    *reinterpret_cast<uint32_t*>(sX + (g * kSlabPix + r * kSlabW + col) * 16 + cpl * 4) =
        regs.halo;
  }
}

// Product I of a chunk: tap I / kWGRows, row I % kWGRows of this warpgroup. The
// tap moves A by whole slab pixels. The first product of the first chunk
// overwrites the accumulator: it is never zeroed by other instructions, which
// would serialize the wgmma pipeline.
template <int I>
__device__ __forceinline__ void mma_step(float (&acc)[kWGRows][64], uint32_t lo_a, uint32_t lo_b,
                                         bool first) {
  constexpr int rr = I % kWGRows, tap = I / kWGRows, dy = tap / 3, dx = tap % 3;
  wgmma_m64n128k16<(rr + dy) * kSlabW + dx, tap * kKG * kBN>(acc[rr], lo_a, lo_b,
                                                             (tap == 0 && first) ? 0u : 1u);
}

template <int... I>
__device__ __forceinline__ void mma_steps(float (&acc)[kWGRows][64], uint32_t lo_a, uint32_t lo_b,
                                          bool first, std::integer_sequence<int, I...>) {
  (mma_step<I>(acc, lo_a, lo_b, first), ...);
}

// This warpgroup's products of one chunk: 9 taps × kWGRows rows of m64n128k16,
// committed as one group.
__device__ __forceinline__ void mma_chunk(float (&acc)[kWGRows][64], uint32_t stage, int wg,
                                          bool first) {
  const uint32_t lo_b = desc_lo(stage, kBN * 16);
  const uint32_t lo_a = desc_lo(stage + kWBytes + wg * kWGRows * kSlabW * 16, kSlabPix * 16);
#pragma unroll
  for (int rr = 0; rr < kWGRows; ++rr)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[rr][i]);
  wgmma_fence();
  mma_steps(acc, lo_a, lo_b, first, std::make_integer_sequence<int, 9 * kWGRows>{});
  wgmma_commit();
#pragma unroll
  for (int rr = 0; rr < kWGRows; ++rr)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[rr][i]);
}

__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        ConvShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_u = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x, wg = tid / 128;
  const int co0 = blockIdx.x * kBN;
  const int y0 = (blockIdx.y / s.tiles_w) * kTH, x0 = (blockIdx.y % s.tiles_w) * kTW;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * s.Ci * s.H * s.W;

  float acc[kWGRows][64];  // written first by the first chunk's wgmma

  // A ring of kStages chunks: chunk c lives in stage c % kStages. Iteration j
  // computes chunk j and refills the stage of chunk j − 2 with chunk j + 2: its
  // weights by cp.async, its slab from the registers loaded one iteration
  // before; then it loads chunk j + 3's slab into the registers.
  const int nchunks = s.Ci / kKC;
  SlabRegs regs;
#pragma unroll
  for (int c = 0; c < kStages - 2; ++c) {
    if (c < nchunks) {
      load_weights(smem_u + c * kStageBytes, wt, s, co0, c * kKC, tid);
      load_slab(regs, xb, s, c * kKC, y0, x0, tid);
      store_slab(smem + c * kStageBytes + kWBytes, regs, tid);
    }
    cp_async_commit();
  }
  if (kStages - 2 < nchunks) load_slab(regs, xb, s, (kStages - 2) * kKC, y0, x0, tid);

  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<kStages - 3>();  // this thread's copies of chunk j have landed
    fence_proxy_async();
    __syncthreads();  // chunk j is in place, and every warpgroup is done with chunk j − 2
    mma_chunk(acc, smem_u + (j % kStages) * kStageBytes, wg, j == 0);
    const int refill = j + kStages - 2;
    if (refill < nchunks) {
      const int stage = (refill % kStages) * kStageBytes;
      load_weights(smem_u + stage, wt, s, co0, refill * kKC, tid);
      store_slab(smem + stage + kWBytes, regs, tid);
      if (refill + 1 < nchunks) load_slab(regs, xb, s, (refill + 1) * kKC, y0, x0, tid);
    }
    cp_async_commit();
    wgmma_wait<1>();  // this warpgroup's chunk j − 1 is done
  }
  wgmma_wait<0>();
  __syncthreads();  // every wgmma has read its operands: the stages become the epilogue tile

  // Tile t = output row y0 + t as [co][64 pixels], rows kEpiLD apart.
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane % 4) + e;
      const float bv =
          bias != nullptr && co0 + n < s.Co ? __bfloat162float(bias[co0 + n]) : 0.f;
#pragma unroll
      for (int rr = 0; rr < kWGRows; ++rr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * warp + lane / 4 + 8 * h;
          tile[((wg * kWGRows + rr) * kBN + n) * kEpiLD + m] =
              __float2bfloat16(acc[rr][4 * j + 2 * h + e] + bv);
        }
    }
  __syncthreads();

  const bool vec = (s.W & 7) == 0;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * s.Co * s.H * s.W;
  for (int i = tid; i < kTH * kBN * (kTW / 8); i += kThreads) {
    const int q = i % (kTW / 8), n = (i / (kTW / 8)) % kBN, t = i / (kBN * (kTW / 8));
    const int y = y0 + t, co = co0 + n, xx = x0 + 8 * q;
    if (y >= s.H || co >= s.Co || xx >= s.W) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(tile + (t * kBN + n) * kEpiLD + 8 * q);
    __nv_bfloat16* dst = ob + ((size_t)co * s.H + y) * s.W + xx;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (xx + e < s.W) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int kFCo = 16;             // output channels per block
constexpr int kFTH = 8, kFTW = 32;   // output rows × columns per block: one pixel per thread
constexpr int kFCi = 8;              // input channels per chunk
constexpr int kFThreads = kFTH * kFTW;
constexpr int kFSlabH = kFTH + 2, kFSlabW = kFTW + 2;

__global__ void __launch_bounds__(kFThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ out, ConvShape s) {
  __shared__ float xs[kFCi][kFSlabH][kFSlabW];
  __shared__ float ws[kFCi][9][kFCo];
  const int tid = threadIdx.x, tx = tid % kFTW, ty = tid / kFTW;
  const int co0 = blockIdx.x * kFCo;
  const int y0 = (blockIdx.y / s.tiles_w) * kFTH, x0 = (blockIdx.y % s.tiles_w) * kFTW;
  const size_t plane = (size_t)s.H * s.W;
  const float* xb = x + (size_t)blockIdx.z * s.Ci * plane;

  float acc[kFCo];
#pragma unroll
  for (int i = 0; i < kFCo; ++i) acc[i] = 0.f;

  for (int ci0 = 0; ci0 < s.Ci; ci0 += kFCi) {
    for (int i = tid; i < kFCi * kFSlabH * kFSlabW; i += kFThreads) {
      const int c = i / (kFSlabH * kFSlabW), r = (i / kFSlabW) % kFSlabH, col = i % kFSlabW;
      const int y = y0 - 1 + r, xx = x0 - 1 + col;
      const bool ok = ci0 + c < s.Ci && y >= 0 && y < s.H && xx >= 0 && xx < s.W;
      xs[c][r][col] = ok ? xb[(size_t)(ci0 + c) * plane + (size_t)y * s.W + xx] : 0.f;
    }
    for (int i = tid; i < kFCi * 9 * kFCo; i += kFThreads) {
      const int c = i / (9 * kFCo), tap = (i / kFCo) % 9, co = i % kFCo;
      const bool ok = ci0 + c < s.Ci && co0 + co < s.Co;
      ws[c][tap][co] = ok ? wt[((size_t)tap * s.Co + co0 + co) * s.Ci + ci0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kFCi; ++c)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float xv = xs[c][ty + tap / 3][tx + tap % 3];
#pragma unroll
        for (int co = 0; co < kFCo; ++co) acc[co] = fmaf(ws[c][tap][co], xv, acc[co]);
      }
    __syncthreads();
  }

  const int y = y0 + ty, xx = x0 + tx;
  if (y >= s.H || xx >= s.W) return;
  float* ob = out + (size_t)blockIdx.z * s.Co * plane + (size_t)y * s.W + xx;
#pragma unroll
  for (int co = 0; co < kFCo; ++co)
    if (co0 + co < s.Co)
      ob[(size_t)(co0 + co) * plane] = acc[co] + (bias != nullptr ? bias[co0 + co] : 0.f);
}

// Grid (channel blocks, pixel tiles, batch): y and z are limited to 65535.
bool grid_fits(long tiles, int B) { return tiles <= 65535L && B <= 65535; }

}  // namespace

extern "C" {

// x: contiguous [B, Ci, H, W] bf16; wt: contiguous [3, 3, Ci/8, Co, 8] bf16; bias: [Co] bf16
// or null (no bias);
// out: contiguous [B, Co, H, W] bf16. Ci must be a multiple of 16 (the K chunk).
int eovax_conv3x3_bf16(const void* x, const void* wt, const void* bias, void* out, int B, int Ci,
                       int Co, int H, int W, void* stream) {
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0 || Ci % kKC != 0)
    return (int)cudaErrorInvalidValue;
  ConvShape s{Ci, Co, H, W, (W + kTW - 1) / kTW};
  const long tiles = (long)((H + kTH - 1) / kTH) * s.tiles_w;
  const long blocks_x = (Co + kBN - 1) / kBN;
  if (!grid_fits(tiles, B)) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks_x, (unsigned)tiles, (unsigned)B);
  conv3x3_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), s);
  return (int)cudaGetLastError();
}

// The same contract in fp32 with wt: contiguous [3, 3, Co, Ci]; any Ci.
int eovax_conv3x3_f32(const void* x, const void* wt, const void* bias, void* out, int B, int Ci,
                      int Co, int H, int W, void* stream) {
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  ConvShape s{Ci, Co, H, W, (W + kFTW - 1) / kFTW};
  const long tiles = (long)((H + kFTH - 1) / kFTH) * s.tiles_w;
  const long blocks_x = (Co + kFCo - 1) / kFCo;
  if (!grid_fits(tiles, B)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks_x, (unsigned)tiles, (unsigned)B);
  conv3x3_f32_kernel<<<grid, kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<const float*>(bias),
      static_cast<float*>(out), s);
  return (int)cudaGetLastError();
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Single-head, unmasked flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// eovax/kernels/attention.py (pallas_call at line 83): softmax(q·kᵀ/√D)·v for
// q, k, v of shape [B, S, D], fp32 logits, an online softmax with fp32
// running max and sum, an fp32 P·V accumulator, and the output cast to the
// input type. Where the caller passes an `lse` buffer of [B, S] fp32, each
// kernel also writes every row's log-sum-exp of the scaled logits in log2
// units, m + log2(l) of its running max m (log2 units) and sum l: the row
// statistics from which the backward (flash_attention_bwd.cu) recomputes the
// probabilities as exp2(q·kᵀ·log2(e)/√D − lse). Each kernel is built twice, by
// its template flag kLse: the inference path passes null and launches the
// variant without the write, whose code is that of a forward with no lse.
//
// What bounds it on the H100: operations. The EO-VAE mid-block attention has
// D = 512 and S = (res/8)². At 512² input and B = 4 one call is 4·B·S²·D =
// 137 GFLOP against 67 MB of q/k/v/o, about 2000 FLOP per byte: the least
// time is 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// What bounds this design: L2. At D = 512 the fp32 output accumulator of 64
// query rows is 128 KB, half of an SM's register file, so a block owns at
// most 64 rows and streams all of K and V of its image from L2: B·S²·D/16
// bytes a call, 2.15 GB at [4,4096,512] (64 FLOP per byte). At the 5.5-7
// TB/s an H100's L2 is commonly measured to deliver, that is 0.31-0.39 ms
// (an estimate, not measured on this card).
//
// Design (bf16). A block of two warpgroups (256 threads) owns 64 query rows.
// Both products are `wgmma.mma_async` with fp32 accumulators in registers,
// and the warpgroups split D:
//   - Q·Kᵀ over a tile of 64 keys: warpgroup c computes the partial logits
//     over d in [c·D/2, (c+1)·D/2) as m64n64k16 with both operands from
//     shared memory (D/32 k-steps), writes them to shared memory (16 KB) and,
//     after a named barrier, adds the other warpgroup's. Both then hold the
//     same logits and the same online-softmax statistics. A row lives in the
//     4 lanes of a quad, so its max and sum take two shuffles.
//   - P stays in registers: the m64n64 accumulator, rounded pairwise to
//     bf16, is the register A operand of the next wgmma (registers 8k .. 8k+7
//     of the accumulator hold columns 16k .. 16k+15, the A fragment of k-step
//     k).
//   - O += P·V: warpgroup c owns output columns [c·D/2, (c+1)·D/2), one
//     m64n(D/2)k16 a k-step with A from registers and V from shared memory as
//     an MN-major operand (imm-trans-b = 1): m64n256 at D = 512, 128 fp32
//     registers a thread.
//   - Shared memory holds one 64 × D tile each of Q, K and V, all three in
//     one layout: [D/64 column blocks][64 rows][128 bytes] with wgmma's
//     128-byte swizzle (16-byte chunk c of a row's 128 bytes at c ^ (row % 8)).
//     Q and K are read K-major (SBO 1024 bytes between 8-row groups; a
//     k-step moves the start 32 bytes inside the atom row), V MN-major (LBO
//     8 KB between 64-column blocks, SBO 1024 bytes between 8-key groups).
//     With it consecutive threads copy consecutive 16-byte chunks of a row,
//     so a warp reads whole 128-byte lines of K and V without bank conflicts.
//     (The no-swizzle core-matrix layout, 16-byte rows of 8 d, let a warp
//     read only 64 bytes of a line conflict-free; its loads reached less than
//     half the L2 rate.) With the two partial-logit buffers that is 230,400
//     bytes at D = 512, alignment included: one block an SM.
//   - V_j is loaded while Q·K_jᵀ and the softmax run, K_{j+1} while P·V_j
//     runs; fence.proxy.async after the copies land and before the barrier
//     that hands a tile to wgmma.
//   - No accumulator is zeroed: the first k-step of every Q·Kᵀ and of the
//     first tile's P·V uses scale-d = 0, and the output is rescaled only from
//     the second tile on. (Zeroing moves that meet the wgmma outputs made
//     ptxas serialize the wgmma of the conv3x3 kernel, warning C7515.)
//   - Epilogue: divide by the row sum, one rounding to bf16, the tile staged
//     in the freed Q and K buffers and written with 16-byte stores.
//   The last query and key tiles are masked (rows past S zero-filled, keys
//   past S at −∞ before the max), so any S works.
// Left out, in the order of the next redesign: a 2-block cluster sharing each
// K/V tile (it halves the L2 traffic above); TMA loads with mbarriers, warp
// specialisation and setmaxnreg; a second K/V stage (no room in shared memory
// at D = 512 without the cluster); ping-pong of softmax and products between
// warpgroups (at D = 512 a tile's products outweigh its softmax by far).
// They were left out so that the wgmma path could be brought up and pinned
// on its own first.
//
// The fp32 variant (FULL_PRECISION) is a plain FMA kernel: 8 warps × 4 query
// rows, lane j scores key j of a 32-key tile, lane l owns columns l + 32i.
//
// D above 512 takes the D-split variants (bf16 and fp32, below each path):
// the output cut into chunks of 512 columns on the grid's z, each block
// recomputing the logits over D in stages of 512 columns.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- bf16 path

constexpr int kBQ = 64;           // query rows per block: the M of every wgmma
constexpr int kBK = 64;           // keys per tile: the N of Q·Kᵀ
constexpr int kThreads = 256;     // two warpgroups
constexpr int kPart = kBQ * kBK;  // floats of one warpgroup's partial logits
constexpr int kAtomBytes = 8 * 128;  // one 128-byte swizzle atom: 8 rows × 128 bytes
constexpr int kColBytes = 64 * 128;  // 64 columns of d of all 64 rows of a tile: 8 atoms

template <int D>
struct Smem {
  static constexpr int kTile = kBQ * D * 2;  // bytes of a 64 × D bf16 tile
  static constexpr int kEpiLD = D + 8;       // epilogue row stride (elements)
  // + 1024: the tiles are aligned to 1024 bytes inside the dynamic shared memory
  static constexpr size_t bytes = 3 * (size_t)kTile + 2 * kPart * sizeof(float) + 1024;
};

// Byte offset of column d (a multiple of 8) in a tile.
__host__ __device__ constexpr int col_offset(int d) { return d / 64 * kColBytes + d % 64 * 2; }
static_assert(Smem<512>::bytes <= 232448, "shared memory of one block");
static_assert(kBQ * Smem<512>::kEpiLD * 2 <= 2 * Smem<512>::kTile, "epilogue tile fits Q and K");

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

// Both warpgroups meet at named barrier 1; like __syncthreads it orders their
// shared-memory accesses.
__device__ __forceinline__ void warpgroups_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
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

// Shared-memory matrix descriptors with the 128-byte swizzle: bits 0-13 the
// start address, 16-29 LBO, 32-45 SBO (all in 16-byte units), 62-63 the layout
// (1: 128-byte swizzle). The low word (address and LBO) is built once a block;
// the high word (SBO and layout) is the same for all three operands.
//   Q, K (K-major): SBO = 1024 bytes between 8-row groups; LBO is not used, as
//   a k-step's 32 bytes of a row lie inside its 128-byte atom row.
//   V (MN-major): LBO = kColBytes between 64-column blocks of d (N), SBO = 1024
//   bytes between 8-key groups (K).
constexpr uint32_t kQKLBO = 16;
constexpr uint32_t kVLBO = kColBytes;
constexpr uint32_t kDescHi = (kAtomBytes >> 4) | (1u << 30);
// Descriptor offsets (16-byte units) of k-step kk: 16 columns of d for Q·Kᵀ,
// 16 keys (two atoms) for P·V.
__host__ __device__ constexpr int qk_step(int kk) { return col_offset(16 * kk) / 16; }
constexpr int kPVStep = 2 * kAtomBytes / 16;

__device__ __forceinline__ uint32_t desc_lo(uint32_t smem, uint32_t lbo_bytes) {
  return ((smem & 0x3FFFF) >> 4) | ((lbo_bytes >> 4) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

#define EOVAX_F8(d, i)                                                                       \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define EOVAX_F32(d, i) \
  EOVAX_F8(d, i), EOVAX_F8(d, (i) + 8), EOVAX_F8(d, (i) + 16), EOVAX_F8(d, (i) + 24)

// d[64 × 64] = A[64 × 16] · B[16 × 64] (+ d if accumulate): A (Q) and B (K)
// K-major bf16 in shared memory, fp32 d. The descriptors are lo_a + OA and
// lo_b + OB (16-byte units), added here so that only the base words stay live.
// d[4j + 2h + e]: row 16·warp + lane/4 + 8h, column 8j + 2·(lane % 4) + e.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint32_t lo_a, uint32_t lo_b,
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

// d[64 × N] = A[64 × 16] · B[16 × N] (+ d if accumulate): A bf16 in registers,
// for each warp's 16 rows the m16n8k16 A fragment (a[0] row lane/4, columns
// 2·(lane % 4) + {0, 1}; a[1] the row 8 below; a[2], a[3] the columns 8
// further), B the MN-major bf16 V tile at lo_b + OB (imm-trans-b = 1). d is
// laid out as in wgmma_ss_m64n64k16.
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<32> {
  template <int OB>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 lb;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "add.u32 lb, %20, %23;\n"
        "mov.b64 db, {lb, %22};\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, db, p, 1, 1, 1;\n"
        "}\n"
        : EOVAX_F8(d, 0), EOVAX_F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(accumulate),
          "r"(kDescHi), "n"(OB));
  }
};

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

template <>
struct WgmmaRS<256> {
  template <int OB>
  static __device__ __forceinline__ void run(float (&d)[128], const uint32_t (&a)[4],
                                             uint32_t lo_b, uint32_t accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        ".reg .b32 lb;\n"
        ".reg .b64 db;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "add.u32 lb, %132, %135;\n"
        "mov.b64 db, {lb, %134};\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, db, p, 1, 1, 1;\n"
        "}\n"
        : EOVAX_F32(d, 0), EOVAX_F32(d, 32), EOVAX_F32(d, 64), EOVAX_F32(d, 96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(lo_b), "r"(accumulate),
          "r"(kDescHi), "n"(OB));
  }
};

#undef EOVAX_F32
#undef EOVAX_F8

// This warpgroup's partial logits of one key tile: its half of d in D/32
// k-steps, the first overwriting s.
template <int... K>
__device__ __forceinline__ void qk_steps(float (&s)[32], uint32_t lo_q, uint32_t lo_k,
                                         std::integer_sequence<int, K...>) {
  (wgmma_ss_m64n64k16<qk_step(K), qk_step(K)>(s, lo_q, lo_k, K == 0 ? 0u : 1u), ...);
}

// O += P·V_j over the 64 keys of a tile: 4 k-steps; on the first tile the
// first k-step overwrites the accumulator.
template <int N, int... K>
__device__ __forceinline__ void pv_steps(float (&acc)[N / 2], const uint32_t (&p)[kBK / 16][4],
                                         uint32_t lo_v, uint32_t first,
                                         std::integer_sequence<int, K...>) {
  (WgmmaRS<N>::template run<K * kPVStep>(acc, p[K], lo_v, K == 0 ? 1u - first : 1u), ...);
}

// Rows row0 .. row0+63 of a [S, D] matrix into the tile at shared address dst
// (1024-byte aligned), laid out [D/64 column blocks][64 rows][128 bytes] with
// the 16-byte chunk c of a row's 128 bytes at c ^ (row % 8): the 128-byte
// swizzle of wgmma. Rows at or beyond S are zero-filled. Consecutive threads
// copy consecutive chunks of a row, so a warp reads whole 128-byte lines and
// each 8-lane phase writes one atom row, 128 bytes on distinct banks.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0, int S,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll 4  // unrolled fully, the hoisted addresses made the D = 512 kernel spill
  for (int c = 0; c < kBQ * kChunks / kThreads; ++c) {
    const int i = tid + c * kThreads;
    const int r = i / kChunks, ch = i % kChunks;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(dst + ch / 8 * kColBytes + r * 128 + ((ch ^ r) & 7) * 16,
               src + (size_t)(ok ? gr : 0) * D + ch * 8, ok);
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, float scale_log2) {
  using L = Smem<D>;
  constexpr int kAcc = D / 4;  // fp32 output registers a thread: 64 rows × D/2 columns / 128
  extern __shared__ __align__(16) unsigned char smem[];
  // The swizzle is a function of the address: the tiles start on 1024 bytes.
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* tiles = smem + (sQ - raw);
  const uint32_t sK = sQ + L::kTile, sV = sK + L::kTile;

  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * S * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  load_tile<D>(sQ, q + base, q0, S, tid);
  load_tile<D>(sK, kb, 0, S, tid);
  cp_async_commit();  // group: Q, K_0

  const uint32_t half = col_offset(wg * D / 2);
  const uint32_t lo_q = desc_lo(sQ + half, kQKLBO);
  const uint32_t lo_k = desc_lo(sK + half, kQKLBO);
  const uint32_t lo_v = desc_lo(sV + half, kVLBO);
  // Partial logits, [warpgroup][8][128 threads][4 floats]: each thread's own
  // fragment order, so thread i of one warpgroup reads what thread i of the
  // other wrote.
  float4* part = reinterpret_cast<float4*>(tiles + 3 * L::kTile);
  float4* mine = part + wg * (kPart / 4) + t128;
  const float4* theirs = part + (1 - wg) * (kPart / 4) + t128;

  float acc[kAcc];                        // written first by the first tile's P·V
  float m_i[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 units)
  float l_i[2] = {0.f, 0.f};              // running sum over this thread's columns

  const int ntiles = (S + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // K_j (and Q) have landed
    fence_proxy_async();
    __syncthreads();  // K_j is in place; both warpgroups are done with V_{j-1} and the partials
    load_tile<D>(sV, vb, j * kBK, S, tid);
    cp_async_commit();  // group: V_j

    float s[32];  // written first by the first k-step
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    wgmma_fence();
    qk_steps(s, lo_q, lo_k, std::make_integer_sequence<int, D / 32>{});
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);

#pragma unroll
    for (int i = 0; i < 8; ++i)
      mine[i * 128] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    warpgroups_sync();  // both partials are written, both warpgroups are done with K_j
    if (j + 1 < ntiles) load_tile<D>(sK, kb, (j + 1) * kBK, S, tid);
    cp_async_commit();  // group: K_{j+1} (empty after the last tile)

    // The full logits (own + other's: the same sum in both warpgroups), masked and in log2 units.
    const int key0 = j * kBK + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = theirs[i * 128];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * i + e;  // column 8i + 2t + (e & 1), row g + 8·(e >> 1)
        const float y = key0 + 8 * i + (e & 1) < S ? (s[r] + xs[e]) * scale_log2 : -INFINITY;
        s[r] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);  // finite: every tile has a valid key
      alpha[h] = exp2f(m_i[h] - m_new);
      m_i[h] = m_new;
    }
    // P as the A fragments of the 4 k-steps of P·V: registers 8kk + 2r, +1 of
    // s are row g + 8·(r & 1), columns 16kk + 8·(r >> 1) + 2t, +1.
    uint32_t p[kBK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = exp2f(s[8 * kk + 2 * r] - m_i[r & 1]);
        const float p1 = exp2f(s[8 * kk + 2 * r + 1] - m_i[r & 1]);
        rs[r & 1] += p0 + p1;
        p[kk][r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * alpha[h] + rs[h];
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }

    cp_async_wait<1>();  // V_j has landed; K_{j+1} may be in flight
    fence_proxy_async();
    __syncthreads();  // V_j is in place
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(p[kk][r]);
    wgmma_fence();
    pv_steps<D / 2>(acc, p, lo_v, j == 0 ? 1u : 0u, std::make_integer_sequence<int, kBK / 16>{});
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
  }

  // Full row sums over the quad; both warpgroups hold the same.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    inv[h] = 1.f / l;
    // The row statistics, once a row: warpgroup 0, the quad's first lane.
    const int row = q0 + 16 * warp + g + 8 * h;
    if (kLse && wg == 0 && t == 0 && row < S)
      lse[(size_t)blockIdx.y * S + row] = m_i[h] + log2f(l);
  }

  // Every Q·Kᵀ is done and no copy is in flight: the output tile is staged in
  // the Q and K buffers as [64 rows][kEpiLD], then written 16 bytes at a time.
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(tiles);
#pragma unroll
  for (int jj = 0; jj < kAcc / 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h, col = wg * (D / 2) + 8 * jj + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(staged + row * L::kEpiLD + col) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * h] * inv[h], acc[4 * jj + 2 * h + 1] * inv[h]);
    }
  __syncthreads();

  __nv_bfloat16* ob = o + base;
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(staged + r * L::kEpiLD + 8 * c);
  }
}

template <int D, bool kLse>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                float scale_log2, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B);
  flash_bf16_kernel<D, kLse><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                float scale_log2, cudaStream_t stream) {
  return lse != nullptr ? launch_bf16<D, true>(q, k, v, o, lse, B, S, scale_log2, stream)
                        : launch_bf16<D, false>(q, k, v, o, lse, B, S, scale_log2, stream);
}

// ------------------------------------------------------- bf16, D above 512
//
// D above 512 (the wrapper pads D to Dp, a multiple of 64, with zero columns,
// and passes the true D's 1/√D): no tile of width D fits in shared memory
// beside the others, and no thread holds 64 rows of D/2 fp32 output columns.
// So the grid's z cuts the output into chunks of kSplitCols columns, and a
// block owns 64 query rows of one chunk. It runs the online softmax over all
// key tiles, as flash_bf16_kernel does, but for each key tile it accumulates
// the logits over d in stages of kSplitCols columns: the stage's columns of Q
// and of the key tile are copied into the Q and K tiles, each warpgroup adds
// its half of the stage's k-steps to its partial logits (the wgmma
// accumulator carries them across stages), and after the last stage the two
// halves are added as in flash_bf16_kernel. P·V then covers only the block's
// chunk of V. Every chunk recomputes the full logits, and Q is read again
// for every key tile: the cost of a simple kernel that is right at any D.
// Columns past Dp are zero-filled in V and never stored.
constexpr int kSplitCols = 512;

// Rows row0 .. row0+63, columns col0 .. col0+kSplitCols-1 of a [S, ld] matrix
// into the tile at shared address dst, laid out as load_tile lays them out;
// rows at or beyond S and columns at or beyond ld are zero-filled.
__device__ __forceinline__ void load_tile_cols(uint32_t dst, const __nv_bfloat16* src, int row0,
                                               int S, int ld, int col0, int tid) {
  constexpr int kChunks = kSplitCols / 8;
#pragma unroll 4
  for (int c = 0; c < kBQ * kChunks / kThreads; ++c) {
    const int i = tid + c * kThreads;
    const int r = i / kChunks, ch = i % kChunks;
    const int gr = row0 + r, gc = col0 + ch * 8;
    const bool ok = gr < S && gc < ld;
    cp_async16(dst + ch / 8 * kColBytes + r * 128 + ((ch ^ r) & 7) * 16,
               src + (ok ? (size_t)gr * ld + gc : 0), ok);
  }
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_split_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int S, int Dp, float scale_log2) {
  constexpr int DC = kSplitCols;
  using L = Smem<DC>;
  constexpr int kAcc = DC / 4;  // fp32 output registers a thread: 64 rows × DC/2 columns / 128
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  unsigned char* tiles = smem + (sQ - raw);
  const uint32_t sK = sQ + L::kTile, sV = sK + L::kTile;

  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int c0 = blockIdx.z * DC;  // this block's output columns [c0, c0 + DC)
  const size_t base = (size_t)blockIdx.y * S * Dp;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  const uint32_t lo_q = desc_lo(sQ, kQKLBO);
  const uint32_t lo_k = desc_lo(sK, kQKLBO);
  const uint32_t lo_v = desc_lo(sV + col_offset(wg * DC / 2), kVLBO);
  float4* part = reinterpret_cast<float4*>(tiles + 3 * L::kTile);
  float4* mine = part + wg * (kPart / 4) + t128;
  const float4* theirs = part + (1 - wg) * (kPart / 4) + t128;

  float acc[kAcc];                        // written first by the first tile's P·V
  float m_i[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 units)
  float l_i[2] = {0.f, 0.f};              // running sum over this thread's columns

  const int ntiles = (S + kBK - 1) / kBK;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // both warpgroups are done with V_{j-1}, the partials and the last stage
    load_tile_cols(sV, vb, j * kBK, S, Dp, c0, tid);
    cp_async_commit();  // group: V_j

    // The partial logits over this warpgroup's half of each stage's k-steps.
    float s[32];  // written first by the first k-step
    for (int d0 = 0; d0 < Dp; d0 += DC) {
      if (d0 > 0) __syncthreads();  // both warpgroups are done with the stage before
      load_tile_cols(sQ, qb, q0, S, Dp, d0, tid);
      load_tile_cols(sK, kb, j * kBK, S, Dp, d0, tid);
      cp_async_commit();  // group: the stage's Q and K
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // the stage (and, at the first, V_j) is in place
      const int half = (Dp - d0 < DC ? Dp - d0 : DC) / 32;  // k-steps of each warpgroup
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(s[i]);
      wgmma_fence();
      for (int kk = wg * half; kk < (wg + 1) * half; ++kk) {
        const uint32_t off = qk_step(kk);
        wgmma_ss_m64n64k16<0, 0>(s, lo_q + off, lo_k + off, d0 > 0 || kk > wg * half ? 1u : 0u);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i)
      mine[i * 128] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    warpgroups_sync();  // both partials are written

    // The full logits (own + other's: the same sum in both warpgroups), masked and in log2 units.
    const int key0 = j * kBK + 2 * t;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = theirs[i * 128];
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * i + e;  // column 8i + 2t + (e & 1), row g + 8·(e >> 1)
        const float y = key0 + 8 * i + (e & 1) < S ? (s[r] + xs[e]) * scale_log2 : -INFINITY;
        s[r] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m_i[h], mx[h]);  // finite: every tile has a valid key
      alpha[h] = exp2f(m_i[h] - m_new);
      m_i[h] = m_new;
    }
    uint32_t p[kBK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = exp2f(s[8 * kk + 2 * r] - m_i[r & 1]);
        const float p1 = exp2f(s[8 * kk + 2 * r + 1] - m_i[r & 1]);
        rs[r & 1] += p0 + p1;
        p[kk][r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * alpha[h] + rs[h];
    if (j > 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }

    // O += P·V_j over this block's chunk (V_j landed with the first stage).
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fence_operand(p[kk][r]);
    wgmma_fence();
    pv_steps<DC / 2>(acc, p, lo_v, j == 0 ? 1u : 0u, std::make_integer_sequence<int, kBK / 16>{});
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) fence_operand(acc[i]);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    inv[h] = 1.f / l;
    // The row statistics, once a row: the first chunk's warpgroup 0, the quad's first lane.
    const int row = q0 + 16 * warp + g + 8 * h;
    if (kLse && blockIdx.z == 0 && wg == 0 && t == 0 && row < S)
      lse[(size_t)blockIdx.y * S + row] = m_i[h] + log2f(l);
  }

  // The output chunk staged in the Q and K tiles as [64 rows][kEpiLD], then
  // its columns below Dp written 16 bytes at a time.
  __syncthreads();  // both warpgroups are done with the last stage's Q and K
  __nv_bfloat16* staged = reinterpret_cast<__nv_bfloat16*>(tiles);
#pragma unroll
  for (int jj = 0; jj < kAcc / 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h, col = wg * (DC / 2) + 8 * jj + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(staged + row * L::kEpiLD + col) = __floats2bfloat162_rn(
          acc[4 * jj + 2 * h] * inv[h], acc[4 * jj + 2 * h + 1] * inv[h]);
    }
  __syncthreads();

  __nv_bfloat16* ob = o + base;
  constexpr int kChunks = DC / 8;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (q0 + r < S && c0 + 8 * c < Dp)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * Dp + c0 + 8 * c) =
          *reinterpret_cast<const uint4*>(staged + r * L::kEpiLD + 8 * c);
  }
}

template <bool kLse>
int launch_bf16_split(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int S, int Dp, float scale_log2, cudaStream_t stream) {
  const size_t bytes = Smem<kSplitCols>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_split_kernel<kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B, (Dp + kSplitCols - 1) / kSplitCols);
  flash_bf16_split_kernel<kLse><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, Dp,
      scale_log2);
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

template <int D, bool kLse>
__global__ void __launch_bounds__(kFThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int S, float scale_log2) {
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
      if (kLse && lane == 0) lse[(size_t)blockIdx.y * S + row] = m_i[r] + log2f(l_i[r]);
    }
  }
}

template <int D, bool kLse>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               float scale_log2, cudaStream_t stream) {
  const size_t bytes = f32_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kFBQ - 1) / kFBQ, B);
  flash_f32_kernel<D, kLse><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
               float scale_log2, cudaStream_t stream) {
  return lse != nullptr ? launch_f32<D, true>(q, k, v, o, lse, B, S, scale_log2, stream)
                        : launch_f32<D, false>(q, k, v, o, lse, B, S, scale_log2, stream);
}

// D above 512 in fp32: flash_f32_kernel over a chunk of kSplitCols output
// columns a block (the grid's z), its logits summed over d in pieces of
// kSplitCols columns of the query rows and of the key tile, each staged in
// shared memory. Lane l owns columns c0 + l + 32i of the chunk.
constexpr size_t f32_split_bytes() {
  return (size_t)(kFBQ * kSplitCols + kFBK * (kSplitCols + 1) + kFBK * kSplitCols) *
         sizeof(float);
}

template <bool kLse>
__global__ void __launch_bounds__(kFThreads)
    flash_f32_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int S, int Dp, float scale_log2) {
  constexpr int P = kSplitCols;  // columns of d a piece, and output columns a block
  constexpr int kNC = P / 32;    // output columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [kFBQ][P]
  float* sK = sQ + kFBQ * P;                   // [kFBK][P + 1]: lane j reads row j
  float* sV = sK + kFBK * (P + 1);             // [kFBK][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kFBQ;
  const int c0 = blockIdx.z * P;  // this block's output columns [c0, c0 + P)
  const size_t base = (size_t)blockIdx.y * S * Dp;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

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
    float s[kFRows] = {};
    for (int d0 = 0; d0 < Dp; d0 += P) {
      const int w = Dp - d0 < P ? Dp - d0 : P;
      __syncthreads();  // the piece before (and the tile before's V) is consumed
      for (int i = tid; i < kFBQ * P; i += kFThreads) {
        const int r = i / P, c = i % P;
        sQ[i] = (q0 + r < S && c < w) ? qb[(size_t)(q0 + r) * Dp + d0 + c] : 0.f;
        sK[r * (P + 1) + c] = (j0 + r < S && c < w) ? kb[(size_t)(j0 + r) * Dp + d0 + c] : 0.f;
        if (d0 == 0)
          sV[i] = (j0 + r < S && c0 + c < Dp) ? vb[(size_t)(j0 + r) * Dp + c0 + c] : 0.f;
      }
      __syncthreads();
      for (int d = 0; d < w; ++d) {
        const float kd = sK[lane * (P + 1) + d];
#pragma unroll
        for (int r = 0; r < kFRows; ++r) s[r] = fmaf(sQ[(warp * kFRows + r) * P + d], kd, s[r]);
      }
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
        const float vv = sV[jj * P + lane + 32 * c];
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
      for (int c = 0; c < kNC; ++c) {
        const int col = c0 + lane + 32 * c;
        if (col < Dp) ob[(size_t)row * Dp + col] = acc[r][c] / l_i[r];
      }
      if (kLse && blockIdx.z == 0 && lane == 0)
        lse[(size_t)blockIdx.y * S + row] = m_i[r] + log2f(l_i[r]);
    }
  }
}

template <bool kLse>
int launch_f32_split(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                     int S, int Dp, float scale_log2, cudaStream_t stream) {
  const size_t bytes = f32_split_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_split_kernel<kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kFBQ - 1) / kFBQ, B, (Dp + kSplitCols - 1) / kSplitCols);
  flash_f32_split_kernel<kLse><<<grid, kFThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, S, Dp, scale_log2);
  return (int)cudaGetLastError();
}

float scale_log2_for(int D) { return (float)(1.0 / sqrt((double)D)) * kLog2e; }

}  // namespace

extern "C" {

// q, k, v, o: contiguous [B, S, D] bf16 on the current device. D in {64, 128, 256, 512};
// wider D: eovax_flash_attention_split_bf16. lse: null, or [B, S] fp32 for the rows'
// log-sum-exp in log2 units.
int eovax_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                               int D, float* lse, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale_log2_for(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_bf16<64>(q, k, v, o, lse, B, S, sl2, st);
    case 128: return launch_bf16<128>(q, k, v, o, lse, B, S, sl2, st);
    case 256: return launch_bf16<256>(q, k, v, o, lse, B, S, sl2, st);
    case 512: return launch_bf16<512>(q, k, v, o, lse, B, S, sl2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o: contiguous [B, S, D] fp32 on the current device. D in {64, 128, 256, 512};
// wider D: eovax_flash_attention_split_f32. lse as in eovax_flash_attention_bf16.
int eovax_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                              int D, float* lse, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale_log2_for(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_f32<64>(q, k, v, o, lse, B, S, sl2, st);
    case 128: return launch_f32<128>(q, k, v, o, lse, B, S, sl2, st);
    case 256: return launch_f32<256>(q, k, v, o, lse, B, S, sl2, st);
    case 512: return launch_f32<512>(q, k, v, o, lse, B, S, sl2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o: contiguous [B, S, Dp] in the entry's dtype on the current device,
// Dp a multiple of 64 above 512; the columns from D on are zero in q and k. The
// logits are scaled by 1/√D. lse as in eovax_flash_attention_bf16.
int eovax_flash_attention_split_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                     int S, int Dp, int D, float* lse, void* stream) {
  if (B <= 0 || S <= 0 || Dp <= 512 || Dp % 64 != 0 || D <= 0 || D > Dp)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lse != nullptr ? launch_bf16_split<true>(q, k, v, o, lse, B, S, Dp, scale_log2_for(D), st)
                        : launch_bf16_split<false>(q, k, v, o, lse, B, S, Dp, scale_log2_for(D), st);
}

int eovax_flash_attention_split_f32(const void* q, const void* k, const void* v, void* o, int B,
                                    int S, int Dp, int D, float* lse, void* stream) {
  if (B <= 0 || S <= 0 || Dp <= 512 || Dp % 64 != 0 || D <= 0 || D > Dp)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return lse != nullptr ? launch_f32_split<true>(q, k, v, o, lse, B, S, Dp, scale_log2_for(D), st)
                        : launch_f32_split<false>(q, k, v, o, lse, B, S, Dp, scale_log2_for(D), st);
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

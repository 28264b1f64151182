// int8 (W8A8) 3×3 stride-1 SAME convolution with bias for Hopper (sm_90a), NCHW
// input and output.
//
// Replaces no Pallas kernel: the JAX package runs its int8 conv in XLA
// (`_int8_conv3x3_core` and `_int8_conv_prequant` in eovax/kernels/qconv.py,
// lines 47 and 114: an int8 conv_general_dilated with int32 accumulation).
// PyTorch has no int8 convolution on CUDA, so the port's W8A8 serving path
// needs this one. With sx = max(amax, 1e-12) / 127 read from device memory (the
// dynamic abs-max of x, or a calibrated range):
//
//   xq          = clip(round_half_even(float(x) / sx), -127, 127)     (int8)
//   acc[b,co,p] = Σ_tap Σ_ci xq · wq                                    (int32, exact)
//   out[b,co,p] = T(float(acc) · (sx · w_scale[co]) + bias[co])        (fp32, one rounding to T)
//
// in the JAX package's order of operations. The quotient is the IEEE one (see
// `quantize`), the rounding half to even (as torch.round and jnp.round), and
// the epilogue's multiply and add stay apart (__fmul_rn, __fadd_rn: nvcc would
// contract a*b+c into one FMA), so the kernel equals its plain version bit for
// bit.
//
// What bounds it on the H100: operations. At [4, 512, 256, 256] 512→256 it is
// 2·B·H·W·9·Ci·Co = 618 G integer operations against 403 MB of bf16 input and
// output: the least time is 0.312 ms at the 1,979 TOP/s dense int8 tensor-core
// peak (0.120 ms for the bytes).
//
// Design: the bf16 kernel's (csrc/conv3x3.cu, whose header says why each part
// is as it is) with s8 operands: an implicit GEMM on
// `wgmma.mma_async m64n128k32.s32.s8.s8`, M = pixels, N = Co, K = 9·Ci.
//   - A wgmma core matrix is 8 rows × 16 bytes for both types: 16 channels in
//     s8 where bf16 has 8. A 32-channel s8 chunk therefore fills the bytes of
//     the bf16 kernel's 16-channel chunk, and its shared-memory layout carries
//     over byte for byte: no swizzle, channels innermost (8-bit operands must
//     be K-major, and both are), the halo slab (6 rows × 66 columns) as
//     [16-channel group][slab pixel][16 channels], the weights of all nine
//     taps as [tap][16-channel group][co][16 channels]; LBO = the group
//     stride, SBO = 128 bytes; a tap (dy, dx) is the offset
//     ((r + dy)·66 + dx)·16 bytes in the A descriptor. One k32 instruction
//     does twice the operations of the bf16 kernel's k16 on the same 6 KB of
//     operands, at twice the rate.
//   - A block owns 4 output rows × 64 columns of one image × 128 output
//     channels: two warpgroups, each 2 rows, i.e. two m64n128 int32
//     accumulators (128 registers a thread); one block an SM.
//   - K is walked in chunks of 32 input channels through a ring of 4 stages
//     (4 × 49,536 bytes). Iteration j issues chunk j's 18 products a
//     warpgroup and commits them. While they run, it copies chunk j + 2's
//     weights (16-byte cp.async, laid out [3, 3, Ci/16, Co, 16] by the
//     wrapper, so a (tap, group) is Co·16 contiguous bytes) into the stage of
//     chunk j − 2, quantizes chunk j + 2's slab from the registers loaded one
//     iteration before and stores it there, and loads chunk j + 3's slab into
//     the registers; then it waits for chunk j − 1's products
//     (`wgmma.wait_group 1`). So the quantization's ALU work and the slab's
//     global loads run under the asynchronous products. fence.proxy.async
//     before the one barrier a chunk: wgmma reads through the async proxy.
//   - The slab is read as 8-byte vectors of 4 pixels of one channel (bf16,
//     where W is a multiple of 8; element loads otherwise), 16 lanes to a
//     row's 128-byte line. A thread holds 3
//     items of 4 channels × 4 pixels (24 registers: items of 8 pixels made
//     ptxas spill beside the accumulators); quantized, an item becomes 4 words
//     of 4 channels, one word a pixel, packed with __byte_perm. The halo
//     columns go apart.
//   - The accumulators are never zeroed: the first product of the first chunk
//     uses scale-d = 0 (a zeroing move inside the pipeline makes ptxas
//     serialize the wgmma, warning C7515).
//   - Epilogue: the rescale and bias in fp32, one rounding to T, the tile
//     staged in the freed stages as [co][64 pixels] and written with 16-byte
//     stores where the width allows.
//   - The fp32 entry point runs the same kernel; its slab is read element by
//     element and quantized as it is loaded (its 48 values a thread raw would
//     not fit beside the accumulators). Correct, not tuned.
// Left out (later work): TMA loads with mbarriers and warp specialisation, a
// persistent grid (each block's first two chunks and its epilogue are not
// overlapped), the abs-max fused into the kernel before, the int8 weight
// layout cached across calls, a narrower tile for 16²-32² planes.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kBN = 128;                         // output channels per block (wgmma N)
constexpr int kTW = 64;                          // output columns per block (wgmma M)
constexpr int kWGRows = 2;                       // output rows per warpgroup
constexpr int kWarpgroups = 2;
constexpr int kTH = kWarpgroups * kWGRows;       // output rows per block
constexpr int kThreads = kWarpgroups * 128;
constexpr int kKC = 32;                          // input channels per K chunk: one k32 step
constexpr int kStages = 4;                       // K chunks in flight in shared memory
constexpr int kKG = kKC / 16;                    // 16-channel groups per chunk
constexpr int kSlabRows = kTH + 2, kSlabW = kTW + 2;
constexpr int kSlabPix = kSlabRows * kSlabW;     // 396
constexpr int kWBytes = 9 * kKG * kBN * 16;      // one chunk's weights: 36,864
constexpr int kSlabBytes = kKG * kSlabPix * 16;  // one chunk's slab: 12,672
constexpr int kStageBytes = kWBytes + kSlabBytes;
constexpr size_t kSmemBytes = kStages * (size_t)kStageBytes;
constexpr int kQuads = kKC / 4;                  // 4-channel words of a chunk's slab pixel
constexpr int kSlabItems = kQuads * kSlabRows * (kTW / 4);     // quads × rows × 4-pixel runs
constexpr int kSlabPerThread = kSlabItems / kThreads;
constexpr int kHaloItems = kQuads * kSlabRows * 2;             // quads × rows × 2 columns
static_assert(kSmemBytes <= 232448, "shared memory of one block");
static_assert(kThreads == kKG * kBN, "a thread copies the nine taps of one (group, co) a chunk");
static_assert(kSlabItems % kThreads == 0, "even split of the slab");
static_assert(kHaloItems <= kThreads, "one halo item a thread at most");
static_assert(kStages >= 3, "the ring refills the stage of chunk j - 2");

struct Shape {
  int Ci, Co, H, W, tiles_w;
  bool vec;  // bf16, W % 8 == 0 and x 16-byte aligned: the interior by 8-byte vectors
};

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
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptors, no swizzle: bits 0-13 the start address,
// 16-29 LBO (the stride between core matrices along K), 32-45 SBO (along M
// or N), all in 16-byte units. Both operands here have SBO = 128 bytes, so a
// descriptor is a 32-bit low word (address and LBO) and a constant high word.
constexpr uint32_t kDescHi = 128 >> 4;

__device__ __forceinline__ uint32_t desc_lo(uint32_t smem, uint32_t lbo_bytes) {
  return ((smem & 0x3FFFF) >> 4) | ((lbo_bytes >> 4) << 16);
}

// d[64 × 128] = A[64 × 32] · B[32 × 128] (+ d if accumulate), s8 operands from
// shared memory, s32 d. The descriptors are lo_a + OA and lo_b + OB (offsets in
// 16-byte units), added here so that only the two base words stay live.
// d[4j + 2h + e]: row 16·warp + lane/4 + 8h, column 8j + 2·(lane % 4) + e.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint32_t lo_a, uint32_t lo_b,
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
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(lo_a), "r"(lo_b), "r"(accumulate), "r"(kDescHi), "n"(OA), "n"(OB));
}

// The quantization step and what `quantize` needs of it.
struct Quant {
  float sx, rsx, lim;
};

__device__ __forceinline__ Quant make_quant(float amax) {
  Quant q;
  q.sx = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  q.rsx = __frcp_rn(q.sx);
  q.lim = __fmul_rn(127.0f, q.sx);
  return q;
}

// One value quantized: clip(round_half_even(f / sx), -127, 127) in the low byte
// of the result. The IEEE quotient f / sx is the product with the correctly
// rounded reciprocal plus one FMA correction (Markstein's theorem: exact while
// the remainder does not underflow, which holds wherever |f / sx| ≥ 0.5). f is
// first clamped to ±fl(127·sx): that keeps the product finite, and a value it
// moves has a quotient that rounds to ±127 with the clamp and without. The
// rounding adds 1.5·2^23: in [2^23, 2^24) the ulp is 1, so the sum's round to
// nearest even is the quotient's, and its low byte is that integer as an s8.
// chip_smoke.py and scripts/ablate_conv3x3_int8.py hold it against the plain
// version's IEEE division on every finite bf16 value at four ranges.
__device__ __forceinline__ uint32_t quantize(float f, const Quant& q) {
  f = fminf(fmaxf(f, -q.lim), q.lim);
  const float q0 = __fmul_rn(f, q.rsx);
  const float t = __fmaf_rn(__fmaf_rn(-q0, q.sx, f), q.rsx, q0);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// The low bytes of a, b, c, d as one word (a in the lowest byte: channel order).
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// A bf16 is the top half of its fp32: pixel 2e of a word is its low half.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Weights of chunk ci0 (all nine taps, channels co0 .. co0+127) into the stage
// at sW with cp.async: copy i = tid + k·kThreads lands at byte 16·i,
// [tap][group][co][16], so thread tid copies the nine taps k of group
// tid / kBN and channel tid % kBN. Channels at or beyond Co are zero-filled.
__device__ __forceinline__ void load_weights(uint32_t sW, const int8_t* wt, const Shape& s,
                                             int co0, int ci0, int tid) {
  const int co = co0 + tid % kBN;
  const bool ok = co < s.Co;
  const int8_t* src = wt + ((size_t)(ci0 / 16 + tid / kBN) * s.Co + (ok ? co : 0)) * 16;
  const size_t tap = (size_t)(s.Ci / 16) * s.Co * 16;
#pragma unroll
  for (int k = 0; k < 9; ++k) cp_async16(sW + 16 * (tid + k * kThreads), src + k * tap, ok);
}

// Slab item i → (4-channel quad in its group, slab row, 4-pixel run, group).
// The 16 runs of a slab row take neighbouring lanes, so that a half-warp's
// 8-byte loads of one channel read one 128-byte line; then the quads, rows
// and groups. (With the quads and rows in the lanes, each load instruction
// touched 32 lines, and the kernel took 1.19× as long.)
__device__ __forceinline__ void slab_item(int i, int& qg, int& r, int& v, int& g) {
  v = i & 15;
  int rest = i >> 4;
  qg = rest & 3;
  rest >>= 2;
  r = rest % kSlabRows;
  g = rest / kSlabRows;
}

// Halo item i → (quad in its group, slab row, slab column 0 or 65, group).
__device__ __forceinline__ void halo_item(int i, int& qg, int& r, int& col, int& g) {
  qg = i & 3;
  int rest = i >> 2;
  r = rest % kSlabRows;
  rest /= kSlabRows;
  col = (rest & 1) ? kSlabW - 1 : 0;
  g = rest >> 1;
}

// Pixels x .. x+3 of one bf16 image row (x ≥ 0, a multiple of 4), zero at and
// past W. One 8-byte load when W is a multiple of 8 (then the 4 are all in or
// all out).
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* row, int x, int W, bool vec) {
  if (vec) return x < W ? __ldg(reinterpret_cast<const uint2*>(row + x)) : make_uint2(0, 0);
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  uint32_t w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t lo = x + 2 * e < W ? __ldg(r + x + 2 * e) : 0;
    const uint32_t hi = x + 2 * e + 1 < W ? __ldg(r + x + 2 * e + 1) : 0;
    w[e] = lo | (hi << 16);
  }
  return make_uint2(w[0], w[1]);
}

template <typename T>
struct SlabRegs;

// bf16: the values as loaded (24 registers); they are quantized when they are
// stored. With items of 8 pixels the prefetch took 34 registers and ptxas
// spilled beside the 128 accumulators.
template <>
struct SlabRegs<__nv_bfloat16> {
  uint2 px[kSlabPerThread][4];  // 4 pixels of each of an item's 4 channels
  uint32_t halo[2];             // one pixel of the 4 channels
};

// fp32: quantized as they are loaded, 4 words of 4 channels an item.
template <>
struct SlabRegs<float> {
  uint32_t words[kSlabPerThread][4];
  uint32_t halo;
};

// The slab of chunk ci0 into registers, zero outside the image.
__device__ __forceinline__ void load_slab(SlabRegs<__nv_bfloat16>& regs, const __nv_bfloat16* xb,
                                          const Shape& s, int ci0, int y0, int x0, int tid,
                                          const Quant&) {
  const size_t plane = (size_t)s.H * s.W;
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int qg, r, v, g;
    slab_item(tid + k * kThreads, qg, r, v, g);
    const int y = y0 - 1 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) regs.px[k][c] = make_uint2(0, 0);
    if (y >= 0 && y < s.H) {
      const __nv_bfloat16* row = xb + (size_t)(ci0 + 16 * g + 4 * qg) * plane + (size_t)y * s.W;
#pragma unroll
      for (int c = 0; c < 4; ++c) regs.px[k][c] = load4(row + c * plane, x0 + 4 * v, s.W, s.vec);
    }
  }
  regs.halo[0] = regs.halo[1] = 0;
  if (tid < kHaloItems) {
    int qg, r, col, g;
    halo_item(tid, qg, r, col, g);
    const int y = y0 - 1 + r, xx = x0 - 1 + col;
    if (y >= 0 && y < s.H && xx >= 0 && xx < s.W) {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(xb) +
                                (size_t)(ci0 + 16 * g + 4 * qg) * plane + (size_t)y * s.W + xx;
      regs.halo[0] = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + plane) << 16);
      regs.halo[1] = (uint32_t)__ldg(p + 2 * plane) | ((uint32_t)__ldg(p + 3 * plane) << 16);
    }
  }
}

__device__ __forceinline__ void load_slab(SlabRegs<float>& regs, const float* xb, const Shape& s,
                                          int ci0, int y0, int x0, int tid, const Quant& q) {
  const size_t plane = (size_t)s.H * s.W;
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int qg, r, v, g;
    slab_item(tid + k * kThreads, qg, r, v, g);
    const int y = y0 - 1 + r;
#pragma unroll
    for (int p = 0; p < 4; ++p) regs.words[k][p] = 0;
    if (y >= 0 && y < s.H) {
      const float* row = xb + (size_t)(ci0 + 16 * g + 4 * qg) * plane + (size_t)y * s.W;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int xx = x0 + 4 * v + p;
        uint32_t b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b[c] = quantize(xx < s.W ? __ldg(row + c * plane + xx) : 0.f, q);
        regs.words[k][p] = pack4(b[0], b[1], b[2], b[3]);
      }
    }
  }
  regs.halo = 0;
  if (tid < kHaloItems) {
    int qg, r, col, g;
    halo_item(tid, qg, r, col, g);
    const int y = y0 - 1 + r, xx = x0 - 1 + col;
    if (y >= 0 && y < s.H && xx >= 0 && xx < s.W) {
      const float* p = xb + (size_t)(ci0 + 16 * g + 4 * qg) * plane + (size_t)y * s.W + xx;
      regs.halo = pack4(quantize(__ldg(p), q), quantize(__ldg(p + plane), q),
                        quantize(__ldg(p + 2 * plane), q), quantize(__ldg(p + 3 * plane), q));
    }
  }
}

// Byte offset of quad qg's word at slab pixel (r, col) of group g in a stage's
// slab: [group][slab pixel][16 channels].
__device__ __forceinline__ int slab_offset(int qg, int r, int col, int g) {
  return (g * kSlabPix + r * kSlabW + col) * 16 + qg * 4;
}

// The registers of load_slab into the slab at sX, quantized here (bf16).
__device__ __forceinline__ void store_slab(unsigned char* sX, const SlabRegs<__nv_bfloat16>& regs,
                                           int tid, const Quant& q) {
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int qg, r, v, g;
    slab_item(tid + k * kThreads, qg, r, v, g);
    unsigned char* base = sX + slab_offset(qg, r, 1 + 4 * v, g);
    const uint2* px = regs.px[k];
    const uint32_t w[4][2] = {{px[0].x, px[0].y}, {px[1].x, px[1].y}, {px[2].x, px[2].y},
                              {px[3].x, px[3].y}};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      *reinterpret_cast<uint32_t*>(base + (2 * e) * 16) =
          pack4(quantize(lo_bf16(w[0][e]), q), quantize(lo_bf16(w[1][e]), q),
                quantize(lo_bf16(w[2][e]), q), quantize(lo_bf16(w[3][e]), q));
      *reinterpret_cast<uint32_t*>(base + (2 * e + 1) * 16) =
          pack4(quantize(hi_bf16(w[0][e]), q), quantize(hi_bf16(w[1][e]), q),
                quantize(hi_bf16(w[2][e]), q), quantize(hi_bf16(w[3][e]), q));
    }
  }
  if (tid < kHaloItems) {
    int qg, r, col, g;
    halo_item(tid, qg, r, col, g);
    *reinterpret_cast<uint32_t*>(sX + slab_offset(qg, r, col, g)) =
        pack4(quantize(lo_bf16(regs.halo[0]), q), quantize(hi_bf16(regs.halo[0]), q),
              quantize(lo_bf16(regs.halo[1]), q), quantize(hi_bf16(regs.halo[1]), q));
  }
}

// The registers of load_slab into the slab at sX (fp32: already quantized).
__device__ __forceinline__ void store_slab(unsigned char* sX, const SlabRegs<float>& regs, int tid,
                                           const Quant&) {
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int qg, r, v, g;
    slab_item(tid + k * kThreads, qg, r, v, g);
    unsigned char* base = sX + slab_offset(qg, r, 1 + 4 * v, g);
#pragma unroll
    for (int p = 0; p < 4; ++p) *reinterpret_cast<uint32_t*>(base + p * 16) = regs.words[k][p];
  }
  if (tid < kHaloItems) {
    int qg, r, col, g;
    halo_item(tid, qg, r, col, g);
    *reinterpret_cast<uint32_t*>(sX + slab_offset(qg, r, col, g)) = regs.halo;
  }
}

// Product I of a chunk: tap I / kWGRows, row I % kWGRows of this warpgroup. The
// tap moves A by whole slab pixels. The first product of the first chunk
// overwrites the accumulator: it is never zeroed by other instructions, which
// would serialize the wgmma pipeline.
template <int I>
__device__ __forceinline__ void mma_step(int (&acc)[kWGRows][64], uint32_t lo_a, uint32_t lo_b,
                                         bool first) {
  constexpr int rr = I % kWGRows, tap = I / kWGRows, dy = tap / 3, dx = tap % 3;
  wgmma_m64n128k32<(rr + dy) * kSlabW + dx, tap * kKG * kBN>(acc[rr], lo_a, lo_b,
                                                             (tap == 0 && first) ? 0u : 1u);
}

template <int... I>
__device__ __forceinline__ void mma_steps(int (&acc)[kWGRows][64], uint32_t lo_a, uint32_t lo_b,
                                          bool first, std::integer_sequence<int, I...>) {
  (mma_step<I>(acc, lo_a, lo_b, first), ...);
}

// This warpgroup's products of one chunk: 9 taps × kWGRows rows of
// m64n128k32, committed as one group.
__device__ __forceinline__ void mma_chunk(int (&acc)[kWGRows][64], uint32_t stage, int wg,
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

__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ w_scale, const float* __restrict__ bias,
                        const float* __restrict__ amax, T* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t smem_u = (uint32_t)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x, wg = tid / 128;
  const int co0 = blockIdx.x * kBN;
  const int y0 = (blockIdx.y / s.tiles_w) * kTH, x0 = (blockIdx.y % s.tiles_w) * kTW;
  const T* xb = x + (size_t)blockIdx.z * s.Ci * s.H * s.W;
  const Quant q = make_quant(__ldg(amax));

  int acc[kWGRows][64];  // written first by the first chunk's wgmma

  // A ring of kStages chunks: chunk c lives in stage c % kStages. Iteration j
  // computes chunk j and refills the stage of chunk j − 2 with chunk j + 2: its
  // weights by cp.async, its slab quantized from the registers loaded one
  // iteration before, both while chunk j's products run; then it loads chunk
  // j + 3's slab into the registers.
  const int nchunks = s.Ci / kKC;
  SlabRegs<T> regs;
#pragma unroll
  for (int c = 0; c < kStages - 2; ++c) {
    if (c < nchunks) {
      load_weights(smem_u + c * kStageBytes, wt, s, co0, c * kKC, tid);
      load_slab(regs, xb, s, c * kKC, y0, x0, tid, q);
      store_slab(smem + c * kStageBytes + kWBytes, regs, tid, q);
    }
    cp_async_commit();
  }
  if (kStages - 2 < nchunks) load_slab(regs, xb, s, (kStages - 2) * kKC, y0, x0, tid, q);

  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<kStages - 3>();  // this thread's copies of chunk j have landed
    fence_proxy_async();
    __syncthreads();  // chunk j is in place, and every warpgroup is done with chunk j − 2
    mma_chunk(acc, smem_u + (j % kStages) * kStageBytes, wg, j == 0);
    const int refill = j + kStages - 2;
    if (refill < nchunks) {
      const int stage = (refill % kStages) * kStageBytes;
      load_weights(smem_u + stage, wt, s, co0, refill * kKC, tid);
      store_slab(smem + stage + kWBytes, regs, tid, q);
      if (refill + 1 < nchunks) load_slab(regs, xb, s, (refill + 1) * kKC, y0, x0, tid, q);
    }
    cp_async_commit();
    wgmma_wait<1>();  // this warpgroup's chunk j − 1 is done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int rr = 0; rr < kWGRows; ++rr)
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[rr][i]);
  __syncthreads();  // every wgmma has read its operands: the stages become the epilogue tile

  // Tile t = output row y0 + t as [co][64 pixels], rows kEpiLD apart (16 bytes
  // of padding).
  constexpr int kVE = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int kEpiLD = kTW + kVE;
  static_assert((size_t)kTH * kBN * kEpiLD * sizeof(T) <= kSmemBytes, "epilogue tile fits");
  T* tile = reinterpret_cast<T*>(smem);
  const int warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane % 4) + e, co = co0 + n;
      float scale = 0.f, b = 0.f;
      if (co < s.Co) {
        scale = __fmul_rn(q.sx, __ldg(w_scale + co));
        b = bias != nullptr ? __ldg(bias + co) : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kWGRows; ++rr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 16 * warp + lane / 4 + 8 * h;
          const float a = __int2float_rn(acc[rr][4 * j + 2 * h + e]);
          const float v = __fadd_rn(__fmul_rn(a, scale), b);
          from_float(v, tile + ((wg * kWGRows + rr) * kBN + n) * kEpiLD + m);
        }
    }
  __syncthreads();

  constexpr int kRowVecs = kTW / kVE;
  const bool vec_out = s.W % kVE == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  T* ob = out + (size_t)blockIdx.z * s.Co * s.H * s.W;
  for (int i = tid; i < kTH * kBN * kRowVecs; i += kThreads) {
    const int v = i % kRowVecs, n = (i / kRowVecs) % kBN, t = i / (kBN * kRowVecs);
    const int y = y0 + t, co = co0 + n, xx = x0 + kVE * v;
    if (y >= s.H || co >= s.Co || xx >= s.W) continue;
    const T* src = tile + (t * kBN + n) * kEpiLD + kVE * v;
    T* dst = ob + ((size_t)co * s.H + y) * s.W + xx;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVE && xx + e < s.W; ++e) dst[e] = src[e];
    }
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* w_scale, const void* bias, const void* amax,
           void* out, int B, int Ci, int Co, int H, int W, void* stream, bool vec_capable) {
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0 || Ci % kKC != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{Ci, Co, H, W, (W + kTW - 1) / kTW,
          vec_capable && W % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  const long tiles = (long)((H + kTH - 1) / kTH) * s.tiles_w;
  if (tiles > 65535L || B > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Co + kBN - 1) / kBN), (unsigned)tiles, (unsigned)B);
  conv3x3_int8_kernel<T><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wt), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const float*>(amax), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous [B, Ci, H, W] bf16; wt: contiguous [3, 3, Ci/16, Co, 16] int8; w_scale: [Co]
// fp32; bias: [Co] fp32 or null; amax: one fp32 (the activations' range) on the device;
// out: contiguous [B, Co, H, W] bf16. Ci must be a multiple of 32 (the K chunk).
int eovax_conv3x3_int8_bf16(const void* x, const void* wt, const void* w_scale, const void* bias,
                            const void* amax, void* out, int B, int Ci, int Co, int H, int W,
                            void* stream) {
  return launch<__nv_bfloat16>(x, wt, w_scale, bias, amax, out, B, Ci, Co, H, W, stream, true);
}

// The same contract with x and out fp32 (the slab read element by element).
int eovax_conv3x3_int8_f32(const void* x, const void* wt, const void* w_scale, const void* bias,
                           const void* amax, void* out, int B, int Ci, int Co, int H, int W,
                           void* stream) {
  return launch<float>(x, wt, w_scale, bias, amax, out, B, Ci, Co, H, W, stream, false);
}

const char* eovax_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

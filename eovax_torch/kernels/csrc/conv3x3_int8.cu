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
// `quantize`), the rounding __float2int_rn (half to even, as torch.round and
// jnp.round), and the epilogue's multiply and add stay apart (__fmul_rn,
// __fadd_rn: nvcc would contract a*b+c into one FMA), so the kernel equals its
// plain version bit for bit.
//
// What bounds it on the H100: operations. At [4, 512, 256, 256] 512→256 it is
// 2·B·H·W·9·Ci·Co = 618 G integer operations against 403 MB of bf16 input and
// output: the least time is 0.312 ms at the 1,979 TOP/s dense int8 tensor-core
// peak (0.120 ms for the bytes).
//
// Design (a first, simple kernel): an implicit GEMM on mma.sync
// m16n8k32.s32.s8.s8.s32, M = pixels, N = Co, K = 9·Ci.
//   - A block owns 4 output rows × 32 columns of one image (128 pixels) × 128
//     output channels; 8 warps, each 32 pixels (one row) × 64 channels, i.e.
//     2 × 8 m16n8 accumulators (64 int32 registers a thread).
//   - K is walked in chunks of 32 input channels (one k32 step a tap) through
//     two stages of shared memory (2 × 43,392 bytes: two blocks an SM). A stage
//     holds the chunk's int8 halo slab (6 rows × 34 columns) as [pixel][32
//     channels] and its weights of all nine taps as [tap][co][32 channels]:
//     both K-major, so ldmatrix.x4 (16-byte rows of 16 channels) gives the
//     fragments as they are, one instruction a 16×32 A tile or two 8×32 B
//     tiles, and a tap (dy, dx) is an offset in the slab. The two 16-byte
//     halves of a 32-byte row swap where bit 2 of its pixel (or co) is set, so
//     the eight rows an ldmatrix phase reads fall in distinct banks.
//     (scripts/ablate_conv3x3_int8.py times it with 32-bit shared loads in
//     place of ldmatrix, `lds32`.)
//   - The weights (laid out [Ci/32, 3, 3, Co, 32] int8 by the wrapper) arrive
//     with 16-byte cp.async, issued before the chunk's products. The slab is
//     quantized as it is loaded: a thread reads 8 pixels of 4 channels
//     (16-byte vectors for bf16 where the width is a multiple of 8; element
//     loads otherwise, and for fp32), quantizes them, and writes 8 words of 4
//     channels. No int8 copy of x exists in device memory.
//   - Epilogue: the rescale and bias in fp32, one rounding, the tile staged in
//     shared memory as [co][128 pixels] and written with 16-byte stores where
//     the width allows.
// Left out (later work): wgmma with s8 operands (k32 an instruction, both
// operands K-major, as the slab already is), TMA loads with mbarriers and warp
// specialisation, overlap of the slab's loads with the products of the chunk
// before, the weight layout cached across calls.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 4, kTW = 32;                       // output rows × columns per block
constexpr int kBM = kTH * kTW;                         // pixels per block (GEMM M)
constexpr int kBN = 128;                               // output channels per block (GEMM N)
constexpr int kKC = 32;                                // input channels per K chunk
constexpr int kThreads = 256;                          // 8 warps: 4 along M × 2 along N
constexpr int kSlabRows = kTH + 2, kSlabW = kTW + 2;
constexpr int kSlabPix = kSlabRows * kSlabW;           // 204
constexpr int kSlabBytes = kSlabPix * kKC;             // 6,528
constexpr int kWBytes = 9 * kBN * kKC;                 // 36,864
constexpr int kStageBytes = kSlabBytes + kWBytes;      // 43,392
constexpr int kStages = 2;
constexpr int kSmemBytes = kStages * kStageBytes;      // 86,784: two blocks an SM
constexpr int kQuads = kKC / 4;                        // 4-channel words of a slab pixel
constexpr int kVecItems = kQuads * kSlabRows * (kTW / 8);  // 8-pixel runs of the interior
constexpr int kHaloItems = kQuads * kSlabRows * 2;         // the halo columns
constexpr int kSlabItems = kVecItems + kHaloItems;
constexpr int kWCopies = 9 * kBN * 2;                  // 16-byte copies of a chunk's weights
static_assert(kWCopies % kThreads == 0, "even split of the weight copies");
static_assert(kStageBytes % 16 == 0, "16-byte aligned stages");

struct Shape {
  int Ci, Co, H, W, tiles_w;
  bool vec;  // bf16, W % 8 == 0 and x 16-byte aligned: the interior by 16-byte vectors
};

// Word w (4 channels) of row r (a slab pixel or an output channel) of 32 bytes,
// the 16-byte halves swapped where bit 2 of r is set.
__device__ __forceinline__ int swz(int r, int w) { return r * 8 + (w ^ (((r >> 2) & 1) << 2)); }

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool pred) {
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// One value quantized: clip(round_half_even(f / sx), -127, 127) as a byte, with
// rsx = __frcp_rn(sx). The IEEE quotient f / sx is the product with the correctly
// rounded reciprocal plus one FMA correction (Markstein's theorem: exact while the
// remainder does not underflow, which holds wherever |f / sx| ≥ 0.5, and f is first
// clamped to ±128·sx so the product cannot overflow; beyond it the result clips to
// ±127 either way). scripts/ablate_conv3x3_int8.py times it against __fdiv_rn
// (`ieee-division`) and holds both against the plain version on every finite bf16
// value, as chip_smoke.py phase 16 does the kernel.
__device__ __forceinline__ uint32_t quantize(float f, float sx, float rsx) {
  const float lim = 128.0f * sx;
  f = fminf(fmaxf(f, -lim), lim);
  const float q0 = __fmul_rn(f, rsx);
  int v = __float2int_rn(__fmaf_rn(__fmaf_rn(-q0, sx, f), rsx, q0));
  v = max(-127, min(127, v));
  return static_cast<uint32_t>(v) & 0xffu;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }

// The weights of K chunk `cc` for output channels co0.. into a stage: [tap][co][32].
__device__ __forceinline__ void load_weights(const int8_t* __restrict__ wt, uint32_t smem_w,
                                             int cc, int co0, const Shape& s, int tid) {
#pragma unroll
  for (int k = 0; k < kWCopies / kThreads; ++k) {
    const int i = tid + k * kThreads;
    const int half = i & 1, col = (i >> 1) % kBN, tap = i / (2 * kBN);
    const bool ok = co0 + col < s.Co;
    const int8_t* src = wt + (((size_t)cc * 9 + tap) * s.Co + (ok ? co0 + col : 0)) * kKC + half * 16;
    cp_async16(smem_w + (tap * kBN + col) * kKC + ((half ^ ((col >> 2) & 1)) * 16), src, ok);
  }
}

// The halo slab of K chunk `cc` (channels ci0..ci0+31, rows y0-1.., columns x0-1..),
// quantized, into a stage as [pixel][8 words of 4 channels]. Zeros outside the image.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ xb, uint32_t* slab, int ci0,
                                          int y0, int x0, float sx, const Shape& s, int tid) {
  const size_t plane = (size_t)s.H * s.W;
  const float rsx = __frcp_rn(sx);
  for (int i = tid; i < kSlabItems; i += kThreads) {
    if (i < kVecItems) {
      const int v = i % (kTW / 8), r = (i / (kTW / 8)) % kSlabRows, q = i / ((kTW / 8) * kSlabRows);
      const int y = y0 - 1 + r, xs = x0 + 8 * v;
      uint32_t words[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) words[p] = 0;
      if (y >= 0 && y < s.H && xs < s.W) {
        const T* base = xb + (size_t)(ci0 + 4 * q) * plane + (size_t)y * s.W + xs;
        bool done = false;
        if constexpr (sizeof(T) == 2) {
          if (s.vec) {  // 8 bf16 pixels in one 16-byte load a channel
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const uint4 u = __ldg(reinterpret_cast<const uint4*>(base + c * plane));
              const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {  // a bf16 is the top half of its fp32
                words[2 * j] |= quantize(__uint_as_float(h[j] << 16), sx, rsx) << (8 * c);
                words[2 * j + 1] |= quantize(__uint_as_float(h[j] & 0xffff0000u), sx, rsx) << (8 * c);
              }
            }
            done = true;
          }
        }
        if (!done) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int p = 0; p < 8; ++p)
              if (xs + p < s.W) words[p] |= quantize(to_float(base[c * plane + p]), sx, rsx) << (8 * c);
        }
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) slab[swz(r * kSlabW + 1 + 8 * v + p, q)] = words[p];
    } else {
      const int h = i - kVecItems;
      const int side = h & 1, r = (h >> 1) % kSlabRows, q = (h >> 1) / kSlabRows;
      const int y = y0 - 1 + r, xx = side ? x0 + kTW : x0 - 1;
      uint32_t word = 0;
      if (y >= 0 && y < s.H && xx >= 0 && xx < s.W) {
        const T* base = xb + (size_t)(ci0 + 4 * q) * plane + (size_t)y * s.W + xx;
#pragma unroll
        for (int c = 0; c < 4; ++c) word |= quantize(to_float(base[c * plane]), sx, rsx) << (8 * c);
      }
      slab[swz(r * kSlabW + (side ? kSlabW - 1 : 0), q)] = word;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wt,
                        const float* __restrict__ w_scale, const float* __restrict__ bias,
                        const float* __restrict__ amax, T* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's output row, its half of the channels
  const int g = lane >> 2, tg = lane & 3;
  const int co0 = blockIdx.x * kBN;
  const int y0 = (blockIdx.y / s.tiles_w) * kTH, x0 = (blockIdx.y % s.tiles_w) * kTW;
  const T* xb = x + (size_t)blockIdx.z * s.Ci * s.H * s.W;
  const float sx = __fdiv_rn(fmaxf(__ldg(amax), 1e-12f), 127.0f);
  const uint32_t smem_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = s.Ci / kKC;
  load_weights(wt, smem_base + kSlabBytes, 0, co0, s, tid);
  cp_async_commit();
  load_slab(xb, reinterpret_cast<uint32_t*>(smem), 0, y0, x0, sx, s, tid);

  for (int cc = 0; cc < chunks; ++cc) {
    cp_async_wait_all();
    __syncthreads();  // chunk cc is in its stage; every warp is done with chunk cc - 1
    const int stage = cc & 1, next = stage ^ 1;
    if (cc + 1 < chunks) {
      load_weights(wt, smem_base + next * kStageBytes + kSlabBytes, cc + 1, co0, s, tid);
      cp_async_commit();
    }
    // ldmatrix.x4 addresses: lane l gives row l % 8 of matrix l / 8; A's four
    // matrices are (rows 0-7 | 8-15) × (k 0-15 | 16-31), B's two n8 tiles × the k halves.
    const int lr = lane & 7, lm = lane >> 3;
    const uint32_t sa = smem_base + stage * kStageBytes, sb = sa + kSlabBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], sa + 4 * swz((wm + dy) * kSlabW + 16 * i + dx + lr + 8 * (lm & 1),
                                   4 * (lm >> 1)));
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, sb + 4 * swz(tap * kBN + wn * 64 + 8 * j + lr + 8 * (lm >> 1), 4 * (lm & 1)));
        mma_s8(acc[0][j], a[0], b[0], b[1]);
        mma_s8(acc[1][j], a[1], b[0], b[1]);
        mma_s8(acc[0][j + 1], a[0], b[2], b[3]);
        mma_s8(acc[1][j + 1], a[1], b[2], b[3]);
      }
    }
    if (cc + 1 < chunks)
      load_slab(xb, reinterpret_cast<uint32_t*>(smem + next * kStageBytes), (cc + 1) * kKC, y0, x0,
                sx, s, tid);
  }

  // Epilogue: fp32 rescale and bias, one rounding, the tile staged as [co][pixel].
  constexpr int kLD = kBM + 16 / sizeof(T);  // row stride (elements): 16 bytes of padding
  static_assert((size_t)kBN * kLD * sizeof(T) <= (size_t)kSmemBytes, "epilogue tile fits");
  __syncthreads();  // every warp is done with the stages
  T* tile = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = wn * 64 + 8 * j + 2 * tg + e, co = co0 + n;
      float scale = 0.f, b = 0.f;
      if (co < s.Co) {
        scale = __fmul_rn(sx, __ldg(w_scale + co));
        b = bias != nullptr ? __ldg(bias + co) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int m = wm * kTW + 16 * i + g + 8 * hi;
          const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * hi + e]), scale), b);
          from_float(v, tile + n * kLD + m);
        }
    }
  }
  __syncthreads();
  constexpr int kVE = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int kRowVecs = kTW / kVE;
  const size_t plane = (size_t)s.H * s.W;
  T* ob = out + (size_t)blockIdx.z * s.Co * plane;
  const bool vec_out = (s.W % kVE == 0) && ((reinterpret_cast<uintptr_t>(out) & 15) == 0);
  for (int i = tid; i < kBN * kTH * kRowVecs; i += kThreads) {
    const int v = i % kRowVecs, r = (i / kRowVecs) % kTH, n = i / (kRowVecs * kTH);
    const int co = co0 + n, y = y0 + r, xs = x0 + v * kVE;
    if (co >= s.Co || y >= s.H || xs >= s.W) continue;
    const T* src = tile + n * kLD + r * kTW + v * kVE;
    T* dst = ob + (size_t)co * plane + (size_t)y * s.W + xs;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int p = 0; p < kVE && xs + p < s.W; ++p) dst[p] = src[p];
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
  cudaError_t err = cudaFuncSetAttribute(conv3x3_int8_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Co + kBN - 1) / kBN), (unsigned)tiles, (unsigned)B);
  conv3x3_int8_kernel<T><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wt), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<const float*>(amax), static_cast<T*>(out), s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous [B, Ci, H, W] bf16; wt: contiguous [Ci/32, 3, 3, Co, 32] int8; w_scale: [Co]
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

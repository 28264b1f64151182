// 3×3 stride-1 SAME convolution with bias for Hopper (sm_90a), NCHW input,
// output and weights laid out [3, 3, Co, Ci].
//
// Replaces the Pallas TPU kernel `_kernel` / `_conv3x3_pallas` / `conv3x3` in
// eovax/kernels/conv3x3.py (pallas_call at line 112): the conv as nine tap
// matrix products into an fp32 accumulator, the bias (in the input type)
// added in fp32, and one rounding to the input type. Forward only.
//
// What bounds it on the H100: operations. A ResnetBlock conv at
// [4, 128, 512, 512] 128→128 is 2·B·H·W·9·Ci·Co = 309 GFLOP against 537 MB
// of input and output, about 580 FLOP per byte, above the card's ~295: the
// least time is 0.31 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design (bf16): an implicit GEMM, out[co, p] = Σ_tap Σ_ci W_tap[co, ci] ·
// x[ci, p + δ_tap], with M = Co, N = pixels, K = 9·Ci. No im2col and no
// padded copy exist in device memory.
//   - A block owns 64 output channels × 128 pixels (2 rows × 64 columns of
//     one image) and walks K in chunks of 16 input channels. For a chunk it
//     holds the weights of all nine taps, [tap][co][ci], and the halo slab of
//     x, 4 rows × 66 columns, as [pixel][ci]: channels innermost, so that a
//     tap's shift moves whole 48-byte pixel rows and every ldmatrix address
//     stays 16-byte aligned. The slab's border zeros are written in the load.
//   - NCHW keeps pixels, not channels, contiguous, so the slab is transposed
//     on its way to shared memory: each thread loads the same pixel of two
//     neighbouring channels and stores them as one 32-bit word. The next
//     chunk's slab is loaded into registers, and its weights are copied with
//     cp.async, while the tensor cores work on this chunk (two stages).
//   - Four warps; warp w computes all 64 channels × pixels 32w .. 32w+31 of
//     the tile with mma.sync m16n8k16 bf16 → fp32, operands by ldmatrix:
//     per tap 4 A and 2 B ldmatrix.x4 feed 16 products.
//   - Two blocks fit on an SM (79 KB of shared memory each).
//
// The fp32 variant (FULL_PRECISION) is a plain FMA kernel: a block owns 16
// output channels × 8 × 32 pixels, one pixel per thread, and walks the input
// channels in chunks of 8 through shared memory.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- bf16 path

constexpr int kBM = 64;                      // output channels per block
constexpr int kTH = 2, kTW = 64;             // output rows × columns per block
constexpr int kKC = 16;                      // input channels per K chunk
constexpr int kLD = kKC + 8;                 // smem row stride (elements): 48 bytes
constexpr int kSlabW = kTW + 2;
constexpr int kSlabPix = (kTH + 2) * kSlabW;  // 264
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWElems = 9 * kBM * kLD;       // one chunk's weights
constexpr int kStage = kWElems + kSlabPix * kLD;
constexpr size_t kSmemBytes = 2 * (size_t)kStage * sizeof(__nv_bfloat16);  // 80,640
// Slab items: (channel pair, slab row, column) with columns padded to 9 groups of 8.
constexpr int kSlabColGroups = (kSlabW + 7) / 8;
constexpr int kSlabItems = (kKC / 2) * (kTH + 2) * kSlabColGroups * 8;  // 2304
constexpr int kSlabPerThread = kSlabItems / kThreads;                   // 18
constexpr int kWCopies = 9 * kBM * (kKC / 8);                           // 16-byte copies: 1152
constexpr int kWPerThread = kWCopies / kThreads;                        // 9
static_assert(kSlabItems % kThreads == 0 && kWCopies % kThreads == 0, "even split");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

struct ConvShape {
  int Ci, Co, H, W, tiles_w;
};

// Weights of chunk ci0 (all nine taps, channels co0 .. co0+63) into sW with cp.async;
// channels at or beyond Co are zero-filled.
__device__ __forceinline__ void load_weights(__nv_bfloat16* sW, const __nv_bfloat16* wt,
                                             const ConvShape& s, int co0, int ci0, int tid) {
#pragma unroll
  for (int k = 0; k < kWPerThread; ++k) {
    const int i = tid + k * kThreads;
    const int half = i & 1, co = (i >> 1) % kBM, tap = i / (2 * kBM);
    const bool ok = co0 + co < s.Co;
    const __nv_bfloat16* src =
        wt + ((size_t)tap * s.Co + (ok ? co0 + co : 0)) * s.Ci + ci0 + half * 8;
    cp_async16(sW + (tap * kBM + co) * kLD + half * 8, src, ok);
  }
}

// Slab item i → (channel pair, slab row, slab column). Lanes 0-3 take four channel
// pairs and lanes 4·k take column k of a group of 8, so the 32-bit stores of a warp
// fall in 32 distinct banks.
__device__ __forceinline__ void slab_item(int i, int& cp, int& r, int& col) {
  const int cp_lo = i & 3, cc = (i >> 2) & 7, rest = i >> 5;
  const int cg = rest % kSlabColGroups, rr = rest / kSlabColGroups;
  r = rr % (kTH + 2);
  cp = (rr / (kTH + 2)) * 4 + cp_lo;
  col = cg * 8 + cc;
}

// The slab of chunk ci0 into registers: two bf16 of neighbouring channels per word,
// zero outside the image.
__device__ __forceinline__ void load_slab(uint32_t (&regs)[kSlabPerThread],
                                          const __nv_bfloat16* xb, const ConvShape& s, int ci0,
                                          int y0, int x0, int tid) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
  const size_t plane = (size_t)s.H * s.W;
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int cp, r, col;
    slab_item(tid + k * kThreads, cp, r, col);
    const int y = y0 - 1 + r, xx = x0 - 1 + col;
    uint32_t word = 0;
    if (col < kSlabW && y >= 0 && y < s.H && xx >= 0 && xx < s.W) {
      const size_t off = (size_t)(ci0 + 2 * cp) * plane + (size_t)y * s.W + xx;
      word = (uint32_t)__ldg(xs + off) | ((uint32_t)__ldg(xs + off + plane) << 16);
    }
    regs[k] = word;
  }
}

__device__ __forceinline__ void store_slab(__nv_bfloat16* sX,
                                           const uint32_t (&regs)[kSlabPerThread], int tid) {
#pragma unroll
  for (int k = 0; k < kSlabPerThread; ++k) {
    int cp, r, col;
    slab_item(tid + k * kThreads, cp, r, col);
    if (col < kSlabW)
      *reinterpret_cast<uint32_t*>(sX + (r * kSlabW + col) * kLD + 2 * cp) = regs[k];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        ConvShape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.x * kBM;
  const int y0 = (blockIdx.y / s.tiles_w) * kTH, x0 = (blockIdx.y % s.tiles_w) * kTW;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * s.Ci * s.H * s.W;
  const int wrow = warp >> 1, wcol = (warp & 1) * 32;  // this warp's output pixels

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  uint32_t slab[kSlabPerThread];
  load_weights(smem, wt, s, co0, 0, tid);
  cp_async_commit();
  load_slab(slab, xb, s, 0, y0, x0, tid);
  store_slab(smem + kWElems, slab, tid);
  cp_async_wait_all();
  __syncthreads();

  const int nchunks = s.Ci / kKC;
  for (int j = 0; j < nchunks; ++j) {
    const __nv_bfloat16* sW = smem + (j & 1) * kStage;
    const __nv_bfloat16* sX = sW + kWElems;
    __nv_bfloat16* nW = smem + ((j + 1) & 1) * kStage;
    const bool more = j + 1 < nchunks;
    if (more) {
      load_weights(nW, wt, s, co0, (j + 1) * kKC, tid);
      cp_async_commit();
      load_slab(slab, xb, s, (j + 1) * kKC, y0, x0, tid);
    }

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(a[mi], sW + (tap * kBM + mi * 16 + (lane & 15)) * kLD + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        const int px = wcol + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(b, sX + ((wrow + dy) * kSlabW + px + dx) * kLD + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }

    if (more) store_slab(nW + kWElems, slab, tid);
    cp_async_wait_all();
    __syncthreads();
  }

  // acc[mi][ni][e]: channel co0 + 16·mi + g (+8 for e ≥ 2), pixel column wcol + 8·ni + 2t (+1 for odd e).
  const int g = lane >> 2, t = lane & 3;
  const int y = y0 + wrow;
  if (y >= s.H) return;
  __nv_bfloat16* ob = out + (size_t)blockIdx.z * s.Co * s.H * s.W + (size_t)y * s.W;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + mi * 16 + g + 8 * h;
      if (co >= s.Co) continue;
      const float bv = __bfloat162float(bias[co]);
      __nv_bfloat16* orow = ob + (size_t)co * s.H * s.W;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int xx = x0 + wcol + ni * 8 + 2 * t + e;
          if (xx < s.W) orow[xx] = __float2bfloat16(acc[mi][ni][2 * h + e] + bv);
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
    if (co0 + co < s.Co) ob[(size_t)(co0 + co) * plane] = acc[co] + bias[co0 + co];
}

// Grid (channel blocks, pixel tiles, batch): y and z are limited to 65535.
bool grid_fits(long tiles, int B) { return tiles <= 65535L && B <= 65535; }

}  // namespace

extern "C" {

// x: contiguous [B, Ci, H, W] bf16; wt: contiguous [3, 3, Co, Ci] bf16; bias: [Co] bf16;
// out: contiguous [B, Co, H, W] bf16. Ci must be a multiple of 16.
int eovax_conv3x3_bf16(const void* x, const void* wt, const void* bias, void* out, int B, int Ci,
                       int Co, int H, int W, void* stream) {
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0 || Ci % kKC != 0)
    return (int)cudaErrorInvalidValue;
  ConvShape s{Ci, Co, H, W, (W + kTW - 1) / kTW};
  const long tiles = (long)((H + kTH - 1) / kTH) * s.tiles_w;
  const long blocks_x = (Co + kBM - 1) / kBM;
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

// The same contract in fp32; any Ci.
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

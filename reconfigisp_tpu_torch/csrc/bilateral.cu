// Bilateral filter over NHWC float32 images with per-image parameters.
//
// Replaces the TPU kernel reconfigisp_tpu/ops/pallas_kernels.py:
// bilateral_pallas (body _bilateral_kernel).  Same function, not the same
// blocking: per image n with params (p0, p1, p2) in [0, 1],
//   r = clip(floor(7 p0), 0, 6) + 1,  sigma_c = 1 + 99 p1,  sigma_s = 1 + 99 p2
// and on the 0..255 scale, over the (2r+1)^2 window of the reflect-padded
// frame (numpy 'reflect': the edge pixel is not repeated),
//   w   = exp(-(dy^2 + dx^2) / 2 sigma_s^2) * exp(-(tap - centre)^2 / 2 sigma_c^2)
//   out = clip(sum(w tap) / max(sum(w), 1e-8) / 255, 0, 1).
//
// Design.  A block serves one image (blockIdx.z), whose radius it reads on
// the device, and switches once into a body templated on the radius R and
// the channels C, so every tap loop but the one over column offsets unrolls
// and the staged halo is R pixels, not 7.  The block stages its 64x32 output
// tile and that halo in shared memory (reflecting the indices itself, so no
// padded copy of the frame goes through device memory).  Each of its 8x32
// threads owns a column of kRows = 8 output pixels, all C channels.  For
// each column offset dx (a loop) it reads the kRows + 2R taps of its column
// from shared memory once, in order, and each tap feeds every output row
// whose window holds it: shared loads per tap and channel fall from 1 to
// (8 + 2R) / (8 (2R + 1)), and only one tap is live in registers at a time.
// Each output sums its taps with dx outer and dy inner, as the plain form.
//
// One exponent per tap.  Both weights are one power of two,
//   w = exp2(-kc d^2 - ks (dy^2 + dx^2)),
//   kc = log2(e) / (2 sigma_c^2),  ks = log2(e) / (2 sigma_s^2),
// one factor each per block.  The tile holds every value times sqrt(kc), so
// the exponent is fma(d', -d', -(dy^2 + dx^2) ks) with d' the difference of
// two staged values, the offset's integer times ks once per dx and dy, and
// the output is divided by sqrt(kc) at the end.  ex2.approx.ftz (relative
// error near 2^-22) runs on the special-function units.  A tap and channel
// costs FADD, FFMA, MUFU.EX2, an FFMA into num and an FADD into den, and no
// spatial table.  The centre's weight is exp2(0) = 1 exactly, so den >= 1:
// flushing tiny weights to zero cannot change the result.  Against the
// plain form's two expf the error stays under 2e-6.
//
// Bound on the H100.  The colour weight is symmetric, w(p, q) = w(q, p), and
// 1 at the centre, so the function needs ((2r+1)^2 - 1) / 2 distinct exps
// per pixel and channel; it reads and writes each pixel once.  At r = 4 on
// 512x512x3 tiles that is 40 exps per output value against 8 bytes moved:
// the exp, issued on the special-function units at 16 per clock per SM
// (against 128 FP32 lanes), is the limit, not the bytes
// (chip_smoke.bilateral_bound).  This kernel issues all (2r+1)^2 exps, one
// per tap, 81 per value at r = 4, so it can come no nearer than twice that
// bound; the SASS of each body holds kRows (2R+1) C MUFU.EX2, one column
// offset's (chip_smoke.py, phase 2).  The other half of a pixel's exps are
// its partners' in other lanes or beyond the warp.  Sharing only what a
// thread owns, its centre (weight 1) and the pairs of its own 8 rows at
// dx = 0, saves 4.6 % of the exps at r = 4: measured without gain there, it
// is left out (PERF.md, the bilateral variants).
//
// Registers: 2 kRows C accumulators, kRows C centres and the 2R + 1 offset
// terms of one column, 128 at C = 3 under __launch_bounds__(256, 2), no
// spills; 43 KB of static shared memory.  Shared loads: a warp reads 32
// neighbouring pixels of one tile row, C words apart, so no two lanes share
// a bank at C = 1 or 3.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 7;
constexpr int kRows = 8;                      // output rows a thread owns
constexpr int kBlockW = 32;                   // threads across: one column each
constexpr int kBlockH = 8;                    // threads down
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kOutW = kBlockW;                // 32 output columns a block
constexpr int kOutH = kBlockH * kRows;        // 64 output rows
constexpr int kTileFloats = (kOutH + 2 * kMaxR) * (kOutW + 2 * kMaxR) * 3;
constexpr float kLog2e = 1.4426950408889634f;

// numpy 'reflect' index for i in [-kMaxR, n - 1 + kMaxR] (needs n > kMaxR).
// Positions further out are read only by threads outside the frame, which
// write nothing; the clamp keeps their loads in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One block's 64x32 output tile of image `img` at radius R; the tile's
// origin is (oy0, ox0).
template <int C, int R>
__device__ __forceinline__ void bilateral_tile(const float* __restrict__ img,
                                               float* __restrict__ dst,
                                               float* __restrict__ tile, int h,
                                               int w, int oy0, int ox0,
                                               float kc, float ks) {
  constexpr int kTileW = kOutW + 2 * R, kTileH = kOutH + 2 * R;
  constexpr int kPitch = kTileW * C;
  constexpr int kTaps = kRows + 2 * R;        // taps of one column offset
  // taps are staged times sqrt(kc), so a tap's colour term is -d^2
  const float scale = __fsqrt_rn(kc);
  const int tid = threadIdx.y * kBlockW + threadIdx.x;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i % kTileW;
    const float* src = img + (static_cast<size_t>(reflect(oy0 - R + ty, h)) * w +
                              reflect(ox0 - R + tx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      tile[ty * kPitch + tx * C + c] = __fmul_rn(src[c] * 255.f, scale);
  }
  __syncthreads();

  // tile row of tap j is row0 + j, for output row i and row offset j - i - R
  const int row0 = threadIdx.y * kRows, col = threadIdx.x;
  float centre[kRows][C], num[kRows][C], den[kRows][C];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      centre[i][c] = tile[(row0 + i + R) * kPitch + (col + R) * C + c];
      num[i][c] = 0.f;
      den[i][c] = 0.f;
    }
  }
#pragma unroll 1
  for (int dx = -R; dx <= R; ++dx) {
    // -(dy^2 + dx^2) ks, the integer exact in float and rounded once
    float neg_space[2 * R + 1];
#pragma unroll
    for (int dy = -R; dy <= R; ++dy)
      neg_space[dy + R] = __fmul_rn(-static_cast<float>(dy * dy + dx * dx), ks);
    const float* column = tile + row0 * kPitch + (col + R + dx) * C;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      float tap[C];
#pragma unroll
      for (int c = 0; c < C; ++c) tap[c] = column[j * kPitch + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int dy = j - i - R;
        if (dy < -R || dy > R) continue;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float d = __fsub_rn(tap[c], centre[i][c]);
          const float wgt = ex2(__fmaf_rn(d, -d, neg_space[dy + R]));
          num[i][c] = __fmaf_rn(wgt, tap[c], num[i][c]);
          den[i][c] = __fadd_rn(den[i][c], wgt);
        }
      }
    }
  }

  const int ox = ox0 + col;
  if (ox >= w) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int oy = oy0 + row0 + i;
    if (oy >= h) break;
    float* out = dst + (static_cast<size_t>(oy) * w + ox) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[c] = fminf(
          fmaxf(num[i][c] / fmaxf(den[i][c], 1e-8f) / scale / 255.f, 0.f), 1.f);
  }
}

// R = 0: each image's radius from its params (the library's kernels).
// R > 0: that radius alone, for per-body counts (BILATERAL_BODY_KERNELS).
template <int C, int R>
__global__ void __launch_bounds__(kThreads, 2)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ params,
                 float* __restrict__ out, int h, int w) {
  __shared__ float tile[kTileFloats];

  const int n = blockIdx.z;
  // Parameter arithmetic rounded step by step, as the JAX and PyTorch forms
  // compute it (no FMA contraction), so the radius is decided as they do.
  const float p0 = params[3 * n], p1 = params[3 * n + 1], p2 = params[3 * n + 2];
  const int radius =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(p0, 7.f)), 0.f), 6.f)) + 1;
  const float sc = __fadd_rn(1.f, __fmul_rn(99.f, p1));
  const float ss = __fadd_rn(1.f, __fmul_rn(99.f, p2));
  const float kc = __fmul_rn(kLog2e, __fdiv_rn(0.5f, __fmul_rn(sc, sc)));
  const float ks = __fmul_rn(kLog2e, __fdiv_rn(0.5f, __fmul_rn(ss, ss)));

  const int oy0 = blockIdx.y * kOutH, ox0 = blockIdx.x * kOutW;
  const size_t plane = static_cast<size_t>(n) * h * w * C;
  const float* img = x + plane;
  float* dst = out + plane;
  if constexpr (R > 0) {
    bilateral_tile<C, R>(img, dst, tile, h, w, oy0, ox0, kc, ks);
  } else {
    switch (radius) {  // uniform over the block: no divergence
      case 1: bilateral_tile<C, 1>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      case 2: bilateral_tile<C, 2>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      case 3: bilateral_tile<C, 3>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      case 4: bilateral_tile<C, 4>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      case 5: bilateral_tile<C, 5>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      case 6: bilateral_tile<C, 6>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
      default: bilateral_tile<C, 7>(img, dst, tile, h, w, oy0, ox0, kc, ks); break;
    }
  }
}

#ifdef BILATERAL_BODY_KERNELS
#define BILATERAL_BODIES(C)                                                     \
  template __global__ void bilateral_kernel<C, 1>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 2>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 3>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 4>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 5>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 6>(const float*, const float*, float*, int, int); \
  template __global__ void bilateral_kernel<C, 7>(const float*, const float*, float*, int, int);
BILATERAL_BODIES(1)
BILATERAL_BODIES(3)
#undef BILATERAL_BODIES
#endif

}  // namespace

// x, out: (n, h, w, c) float32 contiguous; params: (n, 3) float32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bilateral_forward(const float* x, const float* params, float* out,
                                 int n, int h, int w, int c, void* stream) {
  if (n < 1 || n > 65535 || h <= kMaxR || w <= kMaxR) return cudaErrorInvalidValue;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kOutW - 1) / kOutW, (h + kOutH - 1) / kOutH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    bilateral_kernel<3, 0><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else if (c == 1) {
    bilateral_kernel<1, 0><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

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
// Design.  One thread computes one output pixel for all C channels.  A
// 32x8 block stages its tile plus a 7-pixel halo in shared memory (12 KB at
// C = 3), with the reflection done by index arithmetic, so no padded copy of
// the frame goes through device memory.  The block derives r and the two
// 1/(2 sigma^2) from its own image's params row (no host sync in the
// wrapper), puts the 225 spatial weights in a shared table, and loops over
// dy, dx in [-r, r] only, so the cost follows each image's radius.
//
// Bound on the H100.  The colour weight is symmetric, w(p, q) = w(q, p), and
// 1 at the centre, so the function needs ((2r+1)^2 - 1) / 2 distinct exps
// per pixel and channel, and a few FP32 operations per tap; it reads and
// writes each pixel once.  At r = 4 (the default init) on 512x512x3 tiles
// that is 40 exps per output value against 8 bytes moved: the exp, issued on
// the special-function units at 16 per clock per SM (against 128 FP32
// lanes), is the limit, not the bytes (chip_smoke.bilateral_bound_ms).  This
// kernel still computes all (2r+1)^2 exps, one per tap, so it can reach at
// most half of that bound.  The design keeps every tap in shared memory so
// device memory is touched once; `expf` (not `__expf`) keeps the result
// within 2e-5 of the plain form.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 7;
constexpr int kTaps = 2 * kMaxR + 1;          // 15
constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kTileW = kBlockW + 2 * kMaxR;   // 46
constexpr int kTileH = kBlockH + 2 * kMaxR;   // 22

// numpy 'reflect' index for i in [-kMaxR, n - 1 + kMaxR] (needs n > kMaxR).
// Positions further out are read only by threads outside the frame, which
// write nothing; the clamp keeps their loads in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const float* __restrict__ x, const float* __restrict__ params,
                 float* __restrict__ out, int h, int w) {
  __shared__ float tile[kTileH][kTileW * C];
  __shared__ float w_space[kTaps * kTaps];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * kBlockW + threadIdx.x;

  // Parameter arithmetic rounded step by step, as the JAX and PyTorch forms
  // compute it (no FMA contraction).
  const float p0 = params[3 * n], p1 = params[3 * n + 1], p2 = params[3 * n + 2];
  const int radius =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(p0, 7.f)), 0.f), 6.f)) + 1;
  const float sc = __fadd_rn(1.f, __fmul_rn(99.f, p1));
  const float ss = __fadd_rn(1.f, __fmul_rn(99.f, p2));
  const float inv2sc2 = __fdiv_rn(0.5f, __fmul_rn(sc, sc));
  const float inv2ss2 = __fdiv_rn(0.5f, __fmul_rn(ss, ss));

  for (int i = tid; i < kTaps * kTaps; i += kThreads) {
    const int dy = i / kTaps - kMaxR, dx = i % kTaps - kMaxR;
    w_space[i] = expf(-static_cast<float>(dy * dy + dx * dx) * inv2ss2);
  }

  const int y0 = blockIdx.y * kBlockH - kMaxR;
  const int x0 = blockIdx.x * kBlockW - kMaxR;
  const float* img = x + static_cast<size_t>(n) * h * w * C;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i % kTileW;
    const float* src =
        img + (static_cast<size_t>(reflect(y0 + ty, h)) * w + reflect(x0 + tx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) tile[ty][tx * C + c] = src[c] * 255.f;
  }
  __syncthreads();

  const int oy = blockIdx.y * kBlockH + threadIdx.y;
  const int ox = blockIdx.x * kBlockW + threadIdx.x;
  if (oy >= h || ox >= w) return;

  const int cy = threadIdx.y + kMaxR, cx = threadIdx.x + kMaxR;
  float centre[C], num[C], den[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    centre[c] = tile[cy][cx * C + c];
    num[c] = 0.f;
    den[c] = 0.f;
  }
  for (int dy = -radius; dy <= radius; ++dy) {
    const float* row = &tile[cy + dy][0];
    const float* ws_row = &w_space[(dy + kMaxR) * kTaps + kMaxR];
    for (int dx = -radius; dx <= radius; ++dx) {
      const float ws = ws_row[dx];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float tap = row[(cx + dx) * C + c];
        const float d = tap - centre[c];
        const float wgt = ws * expf(-(d * d) * inv2sc2);
        num[c] += wgt * tap;
        den[c] += wgt;
      }
    }
  }
  float* dst = out + ((static_cast<size_t>(n) * h + oy) * w + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    dst[c] = fminf(fmaxf(num[c] / fmaxf(den[c], 1e-8f) / 255.f, 0.f), 1.f);
}

}  // namespace

// x, out: (n, h, w, c) float32 contiguous; params: (n, 3) float32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int bilateral_forward(const float* x, const float* params, float* out,
                                 int n, int h, int w, int c, void* stream) {
  if (n < 1 || n > 65535 || h <= kMaxR || w <= kMaxR) return cudaErrorInvalidValue;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    bilateral_kernel<3><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else if (c == 1) {
    bilateral_kernel<1><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

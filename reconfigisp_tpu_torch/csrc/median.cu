// Window median over NHWC float32 images, one radius for the whole batch.
//
// Replaces the TPU kernel reconfigisp_tpu/ops/pallas_kernels.py:
// median_pallas (body _median_kernel).  It computes the function of the JAX
// package's reference form, reconfigisp_tpu/ops/denoise.py:_median_jnp, not
// the TPU's 14-pass value bisection: with r = clip(floor(7 p), 0, 6) + 1
// taken from params[0] for every image, over the (2r+1)^2 window of the
// reflect-padded frame (numpy 'reflect': the edge pixel is not repeated),
//   out = clip(the (K/2)-th smallest of the K = (2r+1)^2 taps, 0, 1)
// on the [0, 1] scale.  The result is one of the input values, so the kernel
// and the plain form agree bit for bit.
//
// Design.  One thread computes one output pixel for all C channels.  A 32x8
// block stages its tile plus a 7-pixel halo in shared memory (12 KB at
// C = 3), reflecting the indices itself, as csrc/bilateral.cu does.  The
// tile holds each value's order-preserving 32-bit key (sign bit flipped for
// non-negatives, all bits for negatives), so unsigned order is float order.
// The selection bisects on the key: 32 passes, each counting the taps whose
// key is <= mid, end on the exact key of the K/2-th smallest tap.  The TPU
// kernel's value bisection was a workaround for VMEM and lane layout; here
// every pass rereads the K taps from shared memory, and nothing else goes
// through device memory.  The radius is read from params[0] on the device,
// so the wrapper needs no host sync.
//
// Bound on the H100.  The function reads and writes each value once and
// needs at least K - 1 comparisons per pixel and channel: at r = 4 that is
// 80 comparisons against 8 bytes, about even between the FP32 rate and the
// memory rate (chip_smoke.median_bound_ms).  This kernel does 32 K compares
// and 32 K shared-memory loads per pixel and channel, so the shared-memory
// port (32 words per clock per SM) bounds it, far above the function's
// bound; a selection with fewer passes is work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 7;
constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kTileW = kBlockW + 2 * kMaxR;   // 46
constexpr int kTileH = kBlockH + 2 * kMaxR;   // 22

// numpy 'reflect' index for i in [-kMaxR, n - 1 + kMaxR] (needs n > kMaxR);
// the clamp keeps loads for pixels outside the frame in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ uint32_t float_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, const float* __restrict__ params,
              float* __restrict__ out, int h, int w) {
  __shared__ uint32_t tile[kTileH][kTileW * C];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * kBlockW + threadIdx.x;
  // one radius for the batch, from the first image's parameter (rounded as
  // the JAX and PyTorch forms compute it: no FMA contraction)
  const int radius =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[0], 7.f)), 0.f), 6.f)) + 1;

  const int y0 = blockIdx.y * kBlockH - kMaxR;
  const int x0 = blockIdx.x * kBlockW - kMaxR;
  const float* img = x + static_cast<size_t>(n) * h * w * C;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i % kTileW;
    const float* src =
        img + (static_cast<size_t>(reflect(y0 + ty, h)) * w + reflect(x0 + tx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) tile[ty][tx * C + c] = float_key(src[c]);
  }
  __syncthreads();

  const int oy = blockIdx.y * kBlockH + threadIdx.y;
  const int ox = blockIdx.x * kBlockW + threadIdx.x;
  if (oy >= h || ox >= w) return;

  const int cy = threadIdx.y + kMaxR, cx = threadIdx.x + kMaxR;
  const int taps = (2 * radius + 1) * (2 * radius + 1);
  const int rank = taps / 2 + 1;  // the median is the rank-th smallest
  uint32_t lo[C], hi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    lo[c] = 0u;
    hi[c] = 0xffffffffu;
  }
  // invariant: the rank-th smallest key lies in [lo, hi]
  for (int pass = 0; pass < 32; ++pass) {
    uint32_t mid[C];
    int count[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mid[c] = lo[c] + ((hi[c] - lo[c]) >> 1);
      count[c] = 0;
    }
    for (int dy = -radius; dy <= radius; ++dy) {
      const uint32_t* row = &tile[cy + dy][0];
      for (int dx = -radius; dx <= radius; ++dx) {
#pragma unroll
        for (int c = 0; c < C; ++c) count[c] += row[(cx + dx) * C + c] <= mid[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (count[c] >= rank) {
        hi[c] = mid[c];
      } else {
        lo[c] = mid[c] + 1u;
      }
    }
  }
  float* dst = out + ((static_cast<size_t>(n) * h + oy) * w + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = fminf(fmaxf(key_float(lo[c]), 0.f), 1.f);
}

}  // namespace

// x, out: (n, h, w, c) float32 contiguous; params: (n, 1) float32, of which
// only params[0] is read.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int median_forward(const float* x, const float* params, float* out,
                              int n, int h, int w, int c, void* stream) {
  if (n < 1 || n > 65535 || h <= kMaxR || w <= kMaxR) return cudaErrorInvalidValue;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    median_kernel<3><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else if (c == 1) {
    median_kernel<1><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

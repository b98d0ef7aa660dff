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
// Design.  A thread computes a 2x2 block of output pixels, their C channels
// in turn; a block of 16x16 threads covers 32x32 pixels.  It stages its tile
// plus a 7-pixel halo in shared memory (26 KB at C = 3), reflecting the
// indices itself, as csrc/bilateral.cu does.  The tile holds each value's
// order-preserving 32-bit key (sign bit flipped for non-negatives, all bits
// for negatives), so unsigned order is float order.  The radius is read
// from params[0] on the device, so the wrapper needs no host sync; it is
// uniform over the batch, so the switch into the body templated on it does
// not diverge.
//
// r <= 4: selection networks in registers.  The four windows of a 2x2 block
// share the (2r)^2 taps of rows and columns -r+1..r; each adds its own row
// of S = 2r+1 and column of S-1 taps.  The median, index k = K/2 of the
// window's K = S^2 taps, lies among the shared taps' ranks lo..hi, with
// lo = max(0, k - (2S-1)) and hi = min(k, (2r)^2 - 1), and is rank
// k - lo + 1 of those ranks merged with the own taps.  So:
//  1. the shared taps' keys, read once from the tile, fill the first of
//     N = 2^ceil(log2 (2r)^2) slots, the rest hold 0xffffffff, the largest
//     key; Batcher's odd-even merge sort over the N slots leaves ranks
//     lo..hi in place;
//  2. per pixel, the same for its 2S-1 own taps, all sorted;
//  3. rank j of two sorted lists A and B is the least, over i + j' = j, of
//     max(A_i, B_j'): one max and one min per term.
// Every loop is unrolled on compile-time indices and each comparator is one
// unsigned min and one max.  The compiler folds every comparator against a
// pad and drops every one whose outputs are not read.  Integer min/max per
// 2x2 block and channel (tests/test_torch_windowed.py mirrors the networks
// and counts them; chip_smoke.py counts them in the SASS):
//   r = 1, K =  9:  114, 28.5 per value (one window alone:   40)
//   r = 2, K = 25:  412, 103 per value                      (202)
//   r = 3, K = 49:  952, 238 per value                      (590)
//   r = 4, K = 81: 1724, 431 per value                     (1324)
// The SASS holds these or a few fewer (1700 at r = 4): the compiler folds
// a little more.  The networks do not depend on the data: ties and runs of
// exact 0 or 1 cost nothing extra.  ptxas (CUDA 12.8) gives the kernel 80
// registers at C = 1 and 3, set by the r = 4 body, and no spills: 3 blocks
// per SM.  Radii 5-7 bisect: their networks would start from 100-196 live
// shared keys, more than 128 registers hold beside the rest (not built).
//
// r >= 5: a bisection on the key from the shared tile, for each pixel.  32
// passes, each counting the taps whose key is <= mid, end on the exact key
// of the K/2-th smallest tap; every pass rereads the K taps from shared
// memory.
//
// Bound on the H100.  The function reads and writes each value once and
// needs at least K - 1 comparisons per pixel and channel: at r = 4 that is
// 80 comparisons against 8 bytes, about even between the FP32 rate and the
// memory rate (chip_smoke.median_bound_ms).  The networks do 431 integer
// min/max per value at r = 4, which run at 64 per clock per SM, so that
// pipe bounds the kernel.  The first kernel bisected at every radius, 32 K
// compares and 32 K shared loads per value, and the shared-memory port
// bounded it at 200 times the function's bound.  Sorting column windows
// once per block and merging them with pruned networks (Adams, ACM TOG
// 40(4), 2021) would share more work between neighbouring pixels.
//
// Shared memory.  The tile's row pitch is 48 pixels, 16 mod 32 words at
// C = 1 and 3: a warp's two rows of 16 neighbouring pixels then fall in
// distinct banks in the bisection.  The network's loads, 2 pixels apart,
// take two wavefronts; there are 33 of them per value at r = 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 7;
constexpr int kMaxNetworkR = 4;  // larger radii bisect
constexpr int kBlockW = 16;      // threads; each computes a 2x2 block of pixels
constexpr int kBlockH = 16;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kOutW = 2 * kBlockW;            // 32 output pixels a block
constexpr int kOutH = 2 * kBlockH;            // 32
constexpr int kTileW = kOutW + 2 * kMaxR;     // 46
constexpr int kTileH = kOutH + 2 * kMaxR;     // 46
// row pitch in pixels: 16 mod 32 words at C = 1 and 3, so that the two rows
// of 16 pixels a warp reads in a bisection fall in distinct banks
constexpr int kPitch = 48;

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

__host__ __device__ constexpr int slots(int k) { return k <= 1 ? 1 : 2 * slots((k + 1) / 2); }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// One merge step of Batcher's odd-even merge sort over N slots: comparators
// (a, a + D) inside each merge of two sorted runs of P, then the next step.
// The steps are (P, D) = (1, 1), (2, 2), (2, 1), (4, 4), (4, 2), (4, 1), ...
template <int N, int P, int D>
__device__ __forceinline__ void merge_step(uint32_t (&t)[N]) {
#pragma unroll
  for (int j = D % P; j + D < N; j += 2 * D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int a = i + j, b = i + j + D;
      if (b < N && a / (2 * P) == b / (2 * P)) {
        const uint32_t lo = min(t[a], t[b]);
        t[b] = max(t[a], t[b]);
        t[a] = lo;
      }
    }
  }
  if constexpr (D > 1) {
    merge_step<N, P, D / 2>(t);
  } else if constexpr (2 * P < N) {
    merge_step<N, 2 * P, 2 * P>(t);
  }
}

// The 2x2 pixels with top-left (0, 0) of one channel.  `tile` points at the
// top-left pixel's key; rows are `pitch` words apart, columns C.
template <int C, int R>
__device__ __forceinline__ void median_network(const uint32_t* tile, int pitch,
                                               uint32_t (&med)[2][2]) {
  constexpr int S = 2 * R + 1, K = S * S, k = K / 2;  // median: index k
  // common to the four windows: rows and columns -R+1 .. R
  constexpr int M = 2 * R, CM = M * M, NA = slots(CM);
  // each window's own taps: one row of S and one column of S - 1
  constexpr int U = 2 * S - 1, NU = slots(U);
  // the median lies among the common taps' sorted ranks lo..hi; merged
  // with the U own taps it is rank KP (from 1)
  constexpr int lo = cmax(0, k - U), hi = cmin(k, CM - 1), AL = hi - lo + 1;
  constexpr int KP = k - lo + 1;
  uint32_t a[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    a[i] = i < CM ? tile[(i / M - R + 1) * pitch + (i % M - R + 1) * C] : 0xffffffffu;
  }
  merge_step<NA, 1, 1>(a);
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int ey = y ? R + 1 : -R, ex = x ? R + 1 : -R;  // the extra row, column
      uint32_t u[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        u[i] = i < S ? tile[ey * pitch + (x - R + i) * C]
             : i < U ? tile[(i - S - R + 1) * pitch + ex * C]
                     : 0xffffffffu;
      }
      merge_step<NU, 1, 1>(u);
      // rank KP of two sorted lists A' = a[lo..hi] and u: the least, over
      // i + j = KP, of max(A'_i, u_j), where A'_0 and u_0 lie below all
      uint32_t m = 0xffffffffu;
#pragma unroll
      for (int i = cmax(0, KP - U); i <= cmin(KP, AL); ++i) {
        const uint32_t t = i == 0 ? u[KP - 1]
                         : i == KP ? a[lo + i - 1]
                                   : max(a[lo + i - 1], u[KP - i - 1]);
        m = min(m, t);
      }
      med[y][x] = m;
    }
  }
}

// The rank-th smallest key of one pixel's window in each channel, by 32
// passes of a bisection that count the taps at or below mid.
template <int C, int R>
__device__ __forceinline__ void median_bisect(const uint32_t* tile, int pitch,
                                              uint32_t (&lo)[C]) {
  constexpr int S = 2 * R + 1, K = S * S;
  constexpr int rank = K / 2 + 1;  // the median is the rank-th smallest
  uint32_t hi[C];
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
    // rows of the window in a loop: unrolled, the K loads would be hoisted
    // out of the passes into registers, which spill
#pragma unroll 1
    for (int dy = -R; dy <= R; ++dy) {
      const uint32_t* row = tile + dy * pitch;
#pragma unroll
      for (int dx = -R; dx <= R; ++dx) {
#pragma unroll
        for (int c = 0; c < C; ++c) count[c] += row[dx * C + c] <= mid[c];
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
}

__device__ __forceinline__ float key_out(uint32_t k) {
  return fminf(fmaxf(key_float(k), 0.f), 1.f);
}

// The block's 32x32 pixels from its staged tile; (oy0, ox0) is the block's
// first pixel and `out` points at it.
template <int C, int R>
__device__ __forceinline__ void median_tile(const uint32_t* tile, float* out,
                                            int h, int w, int oy0, int ox0) {
  constexpr int pitch = kPitch * C;
  if constexpr (R <= kMaxNetworkR) {
    // the thread's 2x2 block; one channel at a time, so that only one
    // channel's keys are live
    const int ty = 2 * threadIdx.y, tx = 2 * threadIdx.x;
    if (oy0 + ty >= h || ox0 + tx >= w) return;
    const uint32_t* corner = tile + (ty + kMaxR) * pitch + (tx + kMaxR) * C;
#pragma unroll 1
    for (int c = 0; c < C; ++c) {
      uint32_t med[2][2];
      median_network<C, R>(corner + c, pitch, med);
#pragma unroll
      for (int y = 0; y < 2; ++y) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if (oy0 + ty + y < h && ox0 + tx + x < w) {
            out[((ty + y) * w + tx + x) * C + c] = key_out(med[y][x]);
          }
        }
      }
    }
  } else {
    // each pixel alone; the thread's four lie 16 apart, so that a warp reads
    // neighbouring pixels
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int ty = threadIdx.y + (i >> 1) * kBlockH, tx = threadIdx.x + (i & 1) * kBlockW;
      if (oy0 + ty < h && ox0 + tx < w) {
        uint32_t med[C];
        median_bisect<C, R>(tile + (ty + kMaxR) * pitch + (tx + kMaxR) * C, pitch, med);
#pragma unroll
        for (int c = 0; c < C; ++c) out[(ty * w + tx) * C + c] = key_out(med[c]);
      }
    }
  }
}

// R = 0: the radius comes from params[0] (the library's kernels).  R > 0:
// that radius alone, for per-body instruction counts (MEDIAN_BODY_KERNELS).
template <int C, int R>
__global__ void __launch_bounds__(kThreads, 2)
median_kernel(const float* __restrict__ x, const float* __restrict__ params,
              float* __restrict__ out, int h, int w) {
  __shared__ uint32_t tile[kTileH][kPitch * C];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * kBlockW + threadIdx.x;
  const int oy0 = blockIdx.y * kOutH, ox0 = blockIdx.x * kOutW;
  const float* img = x + static_cast<size_t>(n) * h * w * C;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i % kTileW;
    const float* src = img + (static_cast<size_t>(reflect(oy0 - kMaxR + ty, h)) * w +
                              reflect(ox0 - kMaxR + tx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) tile[ty][tx * C + c] = float_key(src[c]);
  }
  __syncthreads();

  const uint32_t* t = &tile[0][0];
  float* dst = out + ((static_cast<size_t>(n) * h + oy0) * w + ox0) * C;
  if constexpr (R > 0) {
    median_tile<C, R>(t, dst, h, w, oy0, ox0);
  } else {
    // one radius for the batch, from the first image's parameter (rounded as
    // the JAX and PyTorch forms compute it: no FMA contraction)
    const int radius =
        static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[0], 7.f)), 0.f), 6.f)) + 1;
    switch (radius) {
      case 1: median_tile<C, 1>(t, dst, h, w, oy0, ox0); break;
      case 2: median_tile<C, 2>(t, dst, h, w, oy0, ox0); break;
      case 3: median_tile<C, 3>(t, dst, h, w, oy0, ox0); break;
      case 4: median_tile<C, 4>(t, dst, h, w, oy0, ox0); break;
      case 5: median_tile<C, 5>(t, dst, h, w, oy0, ox0); break;
      case 6: median_tile<C, 6>(t, dst, h, w, oy0, ox0); break;
      default: median_tile<C, 7>(t, dst, h, w, oy0, ox0); break;
    }
  }
}

#ifdef MEDIAN_BODY_KERNELS
#define MEDIAN_BODIES(C)                                                        \
  template __global__ void median_kernel<C, 1>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 2>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 3>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 4>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 5>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 6>(const float*, const float*, float*, int, int); \
  template __global__ void median_kernel<C, 7>(const float*, const float*, float*, int, int);
MEDIAN_BODIES(1)
MEDIAN_BODIES(3)
#undef MEDIAN_BODIES
#endif

}  // namespace

// x, out: (n, h, w, c) float32 contiguous; params: (n, 1) float32, of which
// only params[0] is read.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int median_forward(const float* x, const float* params, float* out,
                              int n, int h, int w, int c, void* stream) {
  if (n < 1 || n > 65535 || h <= kMaxR || w <= kMaxR) return cudaErrorInvalidValue;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kOutW - 1) / kOutW, (h + kOutH - 1) / kOutH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3) {
    median_kernel<3, 0><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else if (c == 1) {
    median_kernel<1, 0><<<grid, block, 0, s>>>(x, params, out, h, w);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

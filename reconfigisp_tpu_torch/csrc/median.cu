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
// 2x2 block and channel (tests/test_torch_windowed_median.py mirrors the
// networks and counts them; tests/test_torch_cuda_build.py holds the SASS
// to them):
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
// memory rate (benchmark/lib/counts.py, kernel_bound_s).  The networks do
// 431 integer min/max per value at r = 4, which run at 64 per clock per
// SM, so that pipe bounds the kernel.  The first kernel bisected at every
// radius, 32 K compares and 32 K shared loads per value, and the
// shared-memory port bounded it at 200 times the function's bound.  Sorting column windows
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

// ------------------------------------------------------------------ backward
//
// The gradient of the function above for a cotangent g of its output, in
// two kernels that never use float atomics; params get exactly 0, since
// the radius comes from a floor.  It replaces no TPU kernel: the JAX package
// differentiates _median_jnp (_median_taps' tie-split form) under jax.vjp,
// and its custom_vjp has no backward kernel.  It replaces the plain form's
// autograd on the card (ops/kernels/_vjp.py), which under a CUDA graph
// capture stacked the taps of all seven radii, 679, with a kthvalue, an
// equality mask and a sum each, and ran their backward: a slice's zero
// fill, copy and add a tap.
//
// Per image, with the window |d|_inf <= r about p and its tap q = R(p + d)
// (R the reflection), m_p the (K/2 + 1)-th smallest of the K = (2r+1)^2
// taps before the clip, c_p the number of taps equal to m_p under float ==
// (so +0 and -0 tie) and k_p the clip's mask (1 inside (0, 1), 1/2 at an
// exact 0 or 1, as ops/nn.clip's maximum and minimum split a tie, 0
// outside):
//   A_p  = g_p k_p / c_p                        (an IEEE division)
//   gx_s = sum of A_p over every (p, d) with R(p + d) = s and x_s == m_p.
//
//   stats   a block a 16 x 16 tile of one channel, a thread a value: the
//           tile's keys and an R halo staged in shared memory; m_p by the
//           forward's selection networks at r <= 4 (median_network, a 2x2
//           block of pixels each for a quarter of the threads) and by its
//           bisection above (median_bisect, a pixel a thread); c_p by
//           comparing the K taps with m_p; -> (m_p, A_p), a float2 a
//           value.  Each image's first block writes its gp, 0.
//   gather  kQuarters threads a value, each over a quarter of the K offsets
//           in row-major order.  The scatter of A_p onto its taps becomes a
//           gather at the value's reflection preimages p, R(p + d) = s:
//           along each axis s - d, and where s is within r of an edge also
//           -s - d (s >= 1) and 2 (n - 1) - s - d (s <= n - 2).  A preimage
//           adds its A_p where x_s == m_p.  The quarters join as
//           ((q0 + q2) + (q1 + q3)).
// Every sum runs in an order fixed by the shapes, so two calls, and a
// captured replay, agree bit for bit; a value that takes a single share
// gets A_p exactly, as the plain form's autograd gives it.  Like the
// forward, both kernels read the radius from params[0] on the device and
// switch once into bodies templated on R (and on C in the gather), so one
// capture serves every radius.  The stats pass takes one channel a block,
// so C is only a stride there and one kernel serves C = 1 and 3.  The grids
// follow the frame: at the search step's 4 x 48^2 x 3 the stats pass has
// 108 blocks of 256 threads and the gather 432, where the forward's 32 x 32
// tiles give 16 blocks; a 12 MP frame takes the same path.
//
// Bound on the H100 (tools/time_kernels.py, BACKWARD_BOUNDS): x and g read
// and gx written once; the selection's K - 1 comparisons a value again (the
// op keeps no residuals), K to count the ties and K to find the windows
// whose median the value is, 3 K - 1 a value.  At the search step's shape
// and r = 4 that is about 0.1 us, bytes and comparisons about even; launch
// and latency bound the two passes there instead (27,648 values, about 7
// warps an SM).  PERF.md gives their times beside the plain autograd's.

namespace {

constexpr int kStatsSide = 16;                          // stats: a tile's pixels a side
constexpr int kStatsThreads = kStatsSide * kStatsSide;  // a thread a value
constexpr int kGatherThreads = 256;                     // gather: kQuarters threads a value
constexpr int kQuarters = 4;

// The batch's radius from params[0], rounded as the forward rounds it.
__device__ __forceinline__ int batch_radius(const float* __restrict__ params) {
  return static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[0], 7.f)), 0.f), 6.f)) + 1;
}

// The cotangent through ops/nn.clip(m, 0, 1): whole inside, halved at an
// exact bound, where maximum or minimum splits a tie, 0 outside.
__device__ __forceinline__ float clip_cotangent(float g, float m) {
  return (m > 0.f && m < 1.f) ? g : (m == 0.f || m == 1.f) ? __fmul_rn(g, 0.5f) : 0.f;
}

// One channel's 16 x 16 tile with its top-left pixel at (oy0, ox0) -> (m, A)
// of each of its values.
template <int R>
__device__ __forceinline__ void stats_body(const float* __restrict__ img,
                                           const float* __restrict__ gimg,
                                           float2* __restrict__ ma, uint32_t* tile,
                                           uint32_t* medk, int h, int w, int C, int c,
                                           int oy0, int ox0) {
  constexpr int kSide = kStatsSide + 2 * R;
  const int tid = threadIdx.x;
  for (int i = tid; i < kSide * kSide; i += kStatsThreads) {
    const int ty = i / kSide, tx = i % kSide;
    tile[ty * kPitch + tx] = float_key(
        img[(static_cast<size_t>(reflect(oy0 - R + ty, h)) * w + reflect(ox0 - R + tx, w)) * C +
            c]);
  }
  __syncthreads();
  const int ty = tid / kStatsSide, tx = tid % kStatsSide;
  const uint32_t* own = tile + (ty + R) * kPitch + tx + R;  // this value's tap at d = 0
  uint32_t key;
  if constexpr (R <= kMaxNetworkR) {
    if (tid < kStatsThreads / 4) {
      const int by = 2 * (tid / (kStatsSide / 2)), bx = 2 * (tid % (kStatsSide / 2));
      uint32_t med[2][2];
      median_network<1, R>(tile + (by + R) * kPitch + bx + R, kPitch, med);
#pragma unroll
      for (int y = 0; y < 2; ++y) {
#pragma unroll
        for (int x = 0; x < 2; ++x) medk[(by + y) * kStatsSide + bx + x] = med[y][x];
      }
    }
    __syncthreads();
    key = medk[tid];
  } else {
    uint32_t lo[1];
    median_bisect<1, R>(own, kPitch, lo);
    key = lo[0];
  }
  const int py = oy0 + ty, px = ox0 + tx;
  if (py >= h || px >= w) return;
  const float m = key_float(key);
  int count = 0;
#pragma unroll 1
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) count += key_float(own[dy * kPitch + dx]) == m;
  }
  const size_t v = (static_cast<size_t>(py) * w + px) * C + c;
  ma[v] = make_float2(m, __fdiv_rn(clip_cotangent(gimg[v], m), static_cast<float>(count)));
}

// blockIdx.x: a 16 x 16 tile of image blockIdx.y, channel blockIdx.z.
__global__ void __launch_bounds__(kStatsThreads)
median_bwd_stats(const float* __restrict__ x, const float* __restrict__ params,
                 const float* __restrict__ g, float2* __restrict__ ma, float* __restrict__ gp,
                 int h, int w, int C) {
  __shared__ uint32_t tile[(kStatsSide + 2 * kMaxR) * kPitch];
  __shared__ uint32_t medk[kStatsThreads];
  const int n = blockIdx.y, c = blockIdx.z;
  const int tiles_x = (w + kStatsSide - 1) / kStatsSide;
  const int oy0 = blockIdx.x / tiles_x * kStatsSide, ox0 = blockIdx.x % tiles_x * kStatsSide;
  const size_t plane = static_cast<size_t>(n) * h * w * C;
  if (blockIdx.x == 0 && c == 0 && threadIdx.x == 0) gp[n] = 0.f;
  switch (batch_radius(params)) {  // uniform over the grid
#define MEDIAN_STATS(R)                                                                \
  case R:                                                                              \
    stats_body<R>(x + plane, g + plane, ma + plane, tile, medk, h, w, C, c, oy0, ox0); \
    break;
    MEDIAN_STATS(1) MEDIAN_STATS(2) MEDIAN_STATS(3) MEDIAN_STATS(4)
    MEDIAN_STATS(5) MEDIAN_STATS(6)
    default: MEDIAN_STATS(7)
#undef MEDIAN_STATS
  }
}

// The value's gather over its quarter of the offsets -> its part of gx.
template <int C, int R>
__device__ __forceinline__ float gather_body(const float* __restrict__ img,
                                             const float2* __restrict__ ma, int h, int w,
                                             int v, int quarter) {
  constexpr int kSide = 2 * R + 1, kCount = kSide * kSide;
  constexpr int kChunk = (kCount + kQuarters - 1) / kQuarters;
  const int c = v % C, sx = v / C % w, sy = v / C / w;
  const float xs = img[v];
  const int k1 = min((quarter + 1) * kChunk, kCount);
  float acc = 0.f;
  for (int k = quarter * kChunk; k < k1; ++k) {
    const int dy = k / kSide - R, dx = k % kSide - R;
    // each p with R(p + d) = s: s - d, and the reflections -s - d (s >= 1)
    // and 2 (n - 1) - s - d (s <= n - 2)
    const int rows[3] = {sy - dy, sy >= 1 ? -sy - dy : -1, sy <= h - 2 ? 2 * h - 2 - sy - dy : -1};
    const int cols[3] = {sx - dx, sx >= 1 ? -sx - dx : -1, sx <= w - 2 ? 2 * w - 2 - sx - dx : -1};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (rows[i] < 0 || rows[i] >= h) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (cols[j] < 0 || cols[j] >= w) continue;
        const float2 q = ma[(static_cast<size_t>(rows[i]) * w + cols[j]) * C + c];
        if (q.x == xs) acc = __fadd_rn(acc, q.y);
      }
    }
  }
  return acc;
}

// blockIdx.x: kGatherThreads / kQuarters values of image blockIdx.y.
template <int C>
__global__ void __launch_bounds__(kGatherThreads)
median_bwd_gather(const float* __restrict__ x, const float* __restrict__ params,
                  const float2* __restrict__ ma, float* __restrict__ gx, int h, int w) {
  const int n = blockIdx.y, tid = threadIdx.x;
  const size_t plane = static_cast<size_t>(n) * h * w * C;
  const int v = (blockIdx.x * kGatherThreads + tid) / kQuarters;
  const int quarter = tid % kQuarters;
  const bool on = v < h * w * C;  // every lane joins the shuffles below
  float acc = 0.f;
  if (on) {
    switch (batch_radius(params)) {
#define MEDIAN_GATHER(R)                                                   \
  case R:                                                                  \
    acc = gather_body<C, R>(x + plane, ma + plane, h, w, v, quarter);      \
    break;
      MEDIAN_GATHER(1) MEDIAN_GATHER(2) MEDIAN_GATHER(3) MEDIAN_GATHER(4)
      MEDIAN_GATHER(5) MEDIAN_GATHER(6)
      default: MEDIAN_GATHER(7)
#undef MEDIAN_GATHER
    }
  }
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 2));
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 1));
  if (on && quarter == 0) gx[plane + v] = acc;
}

int stats_tiles(int h, int w) {
  return ((h + kStatsSide - 1) / kStatsSide) * ((w + kStatsSide - 1) / kStatsSide);
}

int gather_blocks(int h, int w, int c) {
  const long long threads = static_cast<long long>(h) * w * c * kQuarters;
  return static_cast<int>((threads + kGatherThreads - 1) / kGatherThreads);
}

// The median has no launch groups: `group` is 1.  A frame's thread indices
// stay within int.
bool backward_operands(int n, int h, int w, int c, int group) {
  return n >= 1 && n <= 65535 && h > kMaxR && w > kMaxR && (c == 1 || c == 3) &&
         group == 1 && static_cast<long long>(h) * w * c * kQuarters < (1LL << 31);
}

}  // namespace

// Bytes of scratch median_backward needs at these operands, (m, A) a value;
// 0 for operands it does not take.
extern "C" long long median_backward_scratch(int n, int h, int w, int c, int group) {
  if (!backward_operands(n, h, w, c, group)) return 0;
  return static_cast<long long>(sizeof(float2)) * n * h * w * c;
}

// x, g, gx: (n, h, w, c) float32 contiguous; params, gp: (n, 1) float32, of
// which only params[0] is read; scratch: median_backward_scratch(n, h, w, c,
// 1) bytes, 8-byte aligned; group: 1.  Launches on `stream`, stores the
// number of launches in *launches and returns the CUDA error code (0 on
// success).
extern "C" int median_backward(const float* x, const float* params, const float* g,
                               float* gx, float* gp, void* scratch, int n, int h, int w,
                               int c, int group, int* launches, void* stream) {
  *launches = 0;
  if (!backward_operands(n, h, w, c, group)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* ma = static_cast<float2*>(scratch);
  const dim3 stats(stats_tiles(h, w), n, c);
  median_bwd_stats<<<stats, kStatsThreads, 0, st>>>(x, params, g, ma, gp, h, w, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gather(gather_blocks(h, w, c), n);
  if (c == 3) {
    median_bwd_gather<3><<<gather, kGatherThreads, 0, st>>>(x, params, ma, gx, h, w);
  } else {
    median_bwd_gather<1><<<gather, kGatherThreads, 0, st>>>(x, params, ma, gx, h, w);
  }
  *launches = 2;
  return static_cast<int>(cudaGetLastError());
}

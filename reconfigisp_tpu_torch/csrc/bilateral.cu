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

// ------------------------------------------------------------------ backward
//
// The gradient of the function above for a cotangent g of its output, for
// x and params, in three kernels that never use float atomics.  It replaces
// no TPU kernel: the JAX package differentiates _bilateral_jnp under
// jax.vjp, and its custom_vjp has no backward kernel.  It replaces the plain
// form's autograd on the card (ops/kernels/_vjp.py), which under a CUDA
// graph capture visited all 225 taps at MAX_R, a dozen elementwise kernels
// each way a tap.
//
// Per image, on the 0..255 scale X = 255 x, with kc = 1 / (2 sigma_c^2) and
// ks = 1 / (2 sigma_s^2), the window |d|_inf <= r about p and its tap
// q = R(p + d) (R the reflection):
//   w_pd = exp(-|d|^2 ks) exp(-(X_q - X_p)^2 kc),  Y_p = sum_d w_pd X_q / sum_d w_pd.
// With m the clip's mask (1 inside, 1/2 at an exact bound, as ops/nn.clip's
// maximum and minimum split a tie), A_p = g_p m_p / (255 D_p) (D_p the
// denominator), t_pd = A_p (X_q - Y_p) w_pd (the weight's gradient times
// the weight) and B_pd = 2 kc (X_q - X_p) t_pd:
//   gX_p += sum_d B_pd                    the centre's term,
//   gX_q += A_p w_pd - B_pd               the tap's term,
// gx = 255 gX; kc's gradient is -sum t_pd (X_q - X_p)^2 and ks's
// -sum t_pd |d|^2, so through sigma = 1 + 99 p params[:, 1] and [:, 2] get
// 99 sum t d^2 / sigma^3 with d^2 the colour's and the space's; params[:, 0]
// gets exactly 0, since the radius comes from a floor.
//
//   stats   a thread a value: N and D over the image's own window in the
//           plain form's order and arithmetic (column offset outer, row
//           offset inner; expf of the space term and of the colour term,
//           each rounded, then their product, w X_q and the two sums; no
//           FMA), so Y, and the clip's mask at an exact bound, are the
//           plain form's; -> (A, Y), a float2 a value.
//   gather  kQuarters threads a value, each over a quarter of the image's
//           offsets in that order.  The scatter of the tap's term becomes a
//           gather at the value's reflection preimages p, R(p + d) = s:
//           along each axis s - d, and where s is within r of an edge also
//           -s - d and 2 (n - 1) - s - d.  The weight is symmetric, w(s, -d)
//           = w(s - d, d), so where s - d lies in the frame one expf serves
//           the centre's term at -d and the tap's term from s - d: one expf
//           an offset in the interior, one more for each reflected preimage
//           near an edge.  The quarters join as ((q0 + q2) + (q1 + q3)).
//           The centre's terms also give the value's sums of t d^2 (colour)
//           and t |d|^2 (space), which the block adds by a fixed tree in
//           float64.
//   params  a block an image: its gather blocks' sums in a fixed order.
// Every sum runs in an order fixed by the shapes, so two calls, and a
// captured replay, agree bit for bit.  Like the forward, the kernels read
// each image's radius and sigmas on the device and switch once into bodies
// templated on C and R, so a capture records them once for any radii.  A
// block serves one image and the grids follow the frame: at the search
// step's 4 x 48^2 x 3 the stats pass has 216 blocks of 128 threads and the
// gather 432 of 256 over the card's 132 SMs, where the forward's 64 x 32
// tiles give 8 blocks; a 12 MP frame takes the same path.
//
// Bound on the H100 (chip_smoke.bilateral_backward_bound): the forward's
// ((2r+1)^2 - 1) / 2 distinct exps a value again and 13 operations a tap
// more for the gradient; above r = 1 the exps bound it, 0.6 us at the
// search step's shape and r = 4.  This design takes (2r+1)^2 expf a value
// in the stats pass and as many in the gather, each several instructions
// around one MUFU.EX2, so it can come no nearer than a few times that
// bound.  At the search step's size latency bounds it instead: 27,648
// values are about 7 warps an SM in the stats pass, each thread a chain of
// (2r+1)^2 dependent adds.  PERF.md gives its times beside the plain
// autograd's.

namespace {

constexpr int kStatsThreads = 128;               // stats: a thread a value
constexpr int kGatherThreads = 256;              // gather: kQuarters threads a value
constexpr int kQuarters = 4;
constexpr int kParamsThreads = 256;
constexpr int kMaxTaps = (2 * kMaxR + 1) * (2 * kMaxR + 1);
constexpr float kInv255 = 1.f / 255.f;           // torch's CUDA y / 255: y * this

// An image's radius and its 1 / (2 sigma^2), colour and space, rounded as
// the plain form rounds them (0.5 / s^2 is 0.5 times the rounded 1 / s^2).
struct Image {
  int r;
  float kc, ks;
};

__device__ __forceinline__ float sigma_of(float p01) {
  return __fadd_rn(1.f, __fmul_rn(99.f, p01));
}

__device__ __forceinline__ Image image_of(const float* __restrict__ params, int n) {
  const float p0 = params[3 * n];
  const float sc = sigma_of(params[3 * n + 1]), ss = sigma_of(params[3 * n + 2]);
  Image im;
  im.r = static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(p0, 7.f)), 0.f), 6.f)) + 1;
  im.kc = __fdiv_rn(0.5f, __fmul_rn(sc, sc));
  im.ks = __fdiv_rn(0.5f, __fmul_rn(ss, ss));
  return im;
}

// The space weights expf(-|d|^2 ks) of the (2R+1)^2 offsets, column offset
// outer, as the plain form rounds them.
template <int R>
__device__ __forceinline__ void space_table(float* __restrict__ ws, float ks) {
  constexpr int kSide = 2 * R + 1;
  for (int i = threadIdx.x; i < kSide * kSide; i += blockDim.x) {
    const int dx = i / kSide - R, dy = i % kSide - R;
    ws[i] = expf(__fmul_rn(-static_cast<float>(dx * dx + dy * dy), ks));
  }
  __syncthreads();
}

// The colour weight times the space weight, as the plain form rounds it.
__device__ __forceinline__ float weight(float ws, float d, float kc) {
  return __fmul_rn(ws, expf(__fmul_rn(-__fmul_rn(d, d), kc)));
}

template <int C, int R>
__device__ __forceinline__ void stats_body(const float* __restrict__ img,
                                           const float* __restrict__ gimg,
                                           float2* __restrict__ ay, float* __restrict__ ws,
                                           int h, int w, const Image& im) {
  constexpr int kSide = 2 * R + 1;
  space_table<R>(ws, im.ks);
  const int v = blockIdx.x * kStatsThreads + threadIdx.x;
  if (v >= h * w * C) return;
  const int c = v % C, px = v / C % w, py = v / C / w;
  const float xc = __fmul_rn(img[v], 255.f);
  float num = 0.f, den = 0.f;
#pragma unroll 1
  for (int dx = -R; dx <= R; ++dx) {
    const float* col = img + reflect(px + dx, w) * C + c;
#pragma unroll
    for (int dy = -R; dy <= R; ++dy) {
      const float tap =
          __fmul_rn(col[static_cast<size_t>(reflect(py + dy, h)) * w * C], 255.f);
      const float wgt = weight(ws[(dx + R) * kSide + dy + R], __fsub_rn(tap, xc), im.kc);
      num = __fadd_rn(num, __fmul_rn(wgt, tap));
      den = __fadd_rn(den, wgt);
    }
  }
  // the centre's weight is 1, so den >= 1 and the plain form's clip of den
  // to 1e-8 never binds
  const float y = __fdiv_rn(num, den);
  const float out = __fmul_rn(y, kInv255);
  const float m = (out > 0.f && out < 1.f) ? 1.f : (out == 0.f || out == 1.f) ? 0.5f : 0.f;
  ay[v] = make_float2(__fdiv_rn(__fmul_rn(__fmul_rn(gimg[v], m), kInv255), den), y);
}

template <int C>
__global__ void __launch_bounds__(kStatsThreads)
bilateral_bwd_stats(const float* __restrict__ x, const float* __restrict__ params,
                    const float* __restrict__ g, float2* __restrict__ ay, int h, int w) {
  __shared__ float ws[kMaxTaps];
  const int n = blockIdx.y;
  const Image im = image_of(params, n);
  const size_t plane = static_cast<size_t>(n) * h * w * C;
  switch (im.r) {  // uniform over the block
#define BILATERAL_STATS(R)                                                   \
  case R:                                                                    \
    stats_body<C, R>(x + plane, g + plane, ay + plane, ws, h, w, im);        \
    break;
    BILATERAL_STATS(1) BILATERAL_STATS(2) BILATERAL_STATS(3) BILATERAL_STATS(4)
    BILATERAL_STATS(5) BILATERAL_STATS(6)
    default: BILATERAL_STATS(7)
#undef BILATERAL_STATS
  }
}

// The value's gather over its quarter of the offsets -> its part of gX
// (before the quarters join) and the sums of t d^2 (colour) and t |d|^2
// (space) of its centre's terms.
template <int C, int R>
__device__ __forceinline__ float gather_body(const float* __restrict__ img,
                                             const float2* __restrict__ ay,
                                             const float* __restrict__ ws, int h, int w,
                                             float kc, int v, int quarter, double& ec,
                                             double& es) {
  constexpr int kSide = 2 * R + 1, kCount = kSide * kSide;
  constexpr int kChunk = (kCount + kQuarters - 1) / kQuarters;
  const int c = v % C, sx = v / C % w, sy = v / C / w;
  const float xs = __fmul_rn(img[v], 255.f);
  const float2 own = ay[v];                    // (A, Y) of this value
  const float kc2 = __fmul_rn(2.f, kc);
  const int k1 = min((quarter + 1) * kChunk, kCount);
  float acc = 0.f;
  for (int k = quarter * kChunk; k < k1; ++k) {
    const int dx = k / kSide - R, dy = k % kSide - R;
    const float wsd = ws[k];
    const int ny = sy - dy, nx = sx - dx;
    // the centre's term at -d, whose tap is R(s - d)
    const float u =
        __fmul_rn(img[(static_cast<size_t>(reflect(ny, h)) * w + reflect(nx, w)) * C + c], 255.f);
    const float du = __fsub_rn(u, xs);
    const float wu = weight(wsd, du, kc);
    const float t = __fmul_rn(__fmul_rn(own.x, __fsub_rn(u, own.y)), wu);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(kc2, du), t));
    ec += static_cast<double>(t) * static_cast<double>(__fmul_rn(du, du));
    es += static_cast<double>(t) * static_cast<double>(dx * dx + dy * dy);
    // the tap's term from each p with R(p + d) = s: s - d, and the
    // reflections -s - d (s >= 1) and 2 (n - 1) - s - d (s <= n - 2)
    const int rows[3] = {ny, sy >= 1 ? -sy - dy : -1, sy <= h - 2 ? 2 * h - 2 - sy - dy : -1};
    const int cols[3] = {nx, sx >= 1 ? -sx - dx : -1, sx <= w - 2 ? 2 * w - 2 - sx - dx : -1};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (rows[i] < 0 || rows[i] >= h) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (cols[j] < 0 || cols[j] >= w) continue;
        const size_t p = (static_cast<size_t>(rows[i]) * w + cols[j]) * C + c;
        // s - d in the frame is u's pixel, and its weight is wu
        const float xp = (i == 0 && j == 0) ? u : __fmul_rn(img[p], 255.f);
        const float dp = __fsub_rn(xs, xp);
        const float wp = (i == 0 && j == 0) ? wu : weight(wsd, dp, kc);
        const float2 q = ay[p];
        const float aw = __fmul_rn(q.x, wp);
        const float b = __fmul_rn(__fmul_rn(kc2, dp), __fmul_rn(aw, __fsub_rn(xs, q.y)));
        acc = __fadd_rn(acc, __fsub_rn(aw, b));
      }
    }
  }
  return acc;
}

// blockIdx.x: kGatherThreads / kQuarters values of image blockIdx.y; the
// block's sums for the params go to partial[(n, block)], colour then space.
template <int C>
__global__ void __launch_bounds__(kGatherThreads)
bilateral_bwd_gather(const float* __restrict__ x, const float* __restrict__ params,
                     const float2* __restrict__ ay, float* __restrict__ gx,
                     double* __restrict__ partial, int h, int w) {
  __shared__ float ws[kMaxTaps];
  __shared__ double red[2][kGatherThreads];
  const int n = blockIdx.y, tid = threadIdx.x;
  const Image im = image_of(params, n);
  const size_t plane = static_cast<size_t>(n) * h * w * C;
  const int v = (blockIdx.x * kGatherThreads + tid) / kQuarters;
  const int quarter = tid % kQuarters;
  const bool on = v < h * w * C;   // every lane joins the shuffles below
  const float* img = x + plane;
  const float2* ayi = ay + plane;
  float acc = 0.f;
  double ec = 0.0, es = 0.0;
  switch (im.r) {
#define BILATERAL_GATHER(R)                                                            \
  case R:                                                                              \
    space_table<R>(ws, im.ks);                                                         \
    if (on) acc = gather_body<C, R>(img, ayi, ws, h, w, im.kc, v, quarter, ec, es);   \
    break;
    BILATERAL_GATHER(1) BILATERAL_GATHER(2) BILATERAL_GATHER(3) BILATERAL_GATHER(4)
    BILATERAL_GATHER(5) BILATERAL_GATHER(6)
    default: BILATERAL_GATHER(7)
#undef BILATERAL_GATHER
  }
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 2));
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 1));
  if (on && quarter == 0) gx[plane + v] = __fmul_rn(acc, 255.f);
  red[0][tid] = ec;
  red[1][tid] = es;
  __syncthreads();
  for (int half = kGatherThreads / 2; half > 0; half /= 2) {
    if (tid < half) {
      red[0][tid] += red[0][tid + half];
      red[1][tid] += red[1][tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const size_t at = 2 * (static_cast<size_t>(n) * gridDim.x + blockIdx.x);
    partial[at] = red[0][0];
    partial[at + 1] = red[1][0];
  }
}

// A block an image: the gather blocks' sums in a fixed order, chained to
// params[:, 1] and [:, 2]; 0 for the radius's.
__global__ void __launch_bounds__(kParamsThreads)
bilateral_bwd_params(const float* __restrict__ params, const double* __restrict__ partial,
                     float* __restrict__ gp, int blocks) {
  __shared__ double red[2][kParamsThreads];
  const int n = blockIdx.x, tid = threadIdx.x;
  double ec = 0.0, es = 0.0;
  for (int i = tid; i < blocks; i += kParamsThreads) {
    ec += partial[2 * (static_cast<size_t>(n) * blocks + i)];
    es += partial[2 * (static_cast<size_t>(n) * blocks + i) + 1];
  }
  red[0][tid] = ec;
  red[1][tid] = es;
  __syncthreads();
  for (int half = kParamsThreads / 2; half > 0; half /= 2) {
    if (tid < half) {
      red[0][tid] += red[0][tid + half];
      red[1][tid] += red[1][tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const double sc = sigma_of(params[3 * n + 1]), ss = sigma_of(params[3 * n + 2]);
    gp[3 * n] = 0.f;
    gp[3 * n + 1] = static_cast<float>(red[0][0] * 99.0 / (sc * sc * sc));
    gp[3 * n + 2] = static_cast<float>(red[1][0] * 99.0 / (ss * ss * ss));
  }
}

int gather_blocks(int h, int w, int c) {
  const long long threads = static_cast<long long>(h) * w * c * kQuarters;
  return static_cast<int>((threads + kGatherThreads - 1) / kGatherThreads);
}

// The scratch's parts, each from a 256-byte boundary: (A, Y) a value, and
// the gather blocks' two float64 sums.
struct BwdScratch {
  float2* ay;
  double* partial;
};

size_t bwd_up(size_t bytes) { return (bytes + 255) / 256 * 256; }

size_t bwd_scratch_layout(int n, int h, int w, int c, char* base, BwdScratch* out) {
  const size_t ay = bwd_up(sizeof(float2) * n * h * w * c);
  const size_t partial = bwd_up(2 * sizeof(double) * n * gather_blocks(h, w, c));
  if (out != nullptr) {
    *out = {reinterpret_cast<float2*>(base), reinterpret_cast<double*>(base + ay)};
  }
  return ay + partial;
}

// The bilateral has no launch groups: `group` is 1.  A frame's thread
// indices stay within int.
bool backward_operands(int n, int h, int w, int c, int group) {
  return n >= 1 && n <= 65535 && h > kMaxR && w > kMaxR && (c == 1 || c == 3) &&
         group == 1 && static_cast<long long>(h) * w * c * kQuarters < (1LL << 31);
}

}  // namespace

// Bytes of scratch bilateral_backward needs at these operands, 0 for
// operands it does not take.
extern "C" long long bilateral_backward_scratch(int n, int h, int w, int c, int group) {
  if (!backward_operands(n, h, w, c, group)) return 0;
  return static_cast<long long>(bwd_scratch_layout(n, h, w, c, nullptr, nullptr));
}

// x, g, gx: (n, h, w, c) float32 contiguous; params, gp: (n, 3) float32;
// scratch: bilateral_backward_scratch(n, h, w, c, 1) bytes, 256-byte
// aligned; group: 1.  Launches on `stream`, stores the number of launches
// in *launches and returns the CUDA error code (0 on success).
extern "C" int bilateral_backward(const float* x, const float* params, const float* g,
                                  float* gx, float* gp, void* scratch, int n, int h, int w,
                                  int c, int group, int* launches, void* stream) {
  *launches = 0;
  if (!backward_operands(n, h, w, c, group)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BwdScratch sc;
  bwd_scratch_layout(n, h, w, c, static_cast<char*>(scratch), &sc);
  const int values = h * w * c, blocks = gather_blocks(h, w, c);
  const dim3 stats((values + kStatsThreads - 1) / kStatsThreads, n);
  const dim3 gather(blocks, n);
  if (c == 3) {
    bilateral_bwd_stats<3><<<stats, kStatsThreads, 0, st>>>(x, params, g, sc.ay, h, w);
  } else {
    bilateral_bwd_stats<1><<<stats, kStatsThreads, 0, st>>>(x, params, g, sc.ay, h, w);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c == 3) {
    bilateral_bwd_gather<3><<<gather, kGatherThreads, 0, st>>>(x, params, sc.ay, gx,
                                                               sc.partial, h, w);
  } else {
    bilateral_bwd_gather<1><<<gather, kGatherThreads, 0, st>>>(x, params, sc.ay, gx,
                                                               sc.partial, h, w);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bilateral_bwd_params<<<n, kParamsThreads, 0, st>>>(params, sc.partial, gp, blocks);
  *launches = 3;
  return static_cast<int>(cudaGetLastError());
}

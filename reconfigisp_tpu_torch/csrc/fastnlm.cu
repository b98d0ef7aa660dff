// Fast non-local means over NHWC float32 images.
//
// Replaces the TPU kernel reconfigisp_tpu/ops/pallas_kernels.py:
// fastnlm_pallas (body _fastnlm_kernel).  It computes the function of the
// JAX package's reference form, reconfigisp_tpu/ops/denoise.py:_fastnlm_jnp,
// border rule included.  With the block radius b = clip(floor(7 p0), 0, 6) + 1
// from params[0] for the whole batch, and per image n the search radius
// s = clip(floor(7 p1), 0, 6) + 1 and the decay h = 1 + 99 p2, on the 0..255
// scale x~ = 255 x and for every search offset o with max(|oy|, |ox|) <= s:
//   D_o(q) = (x~(reflect(q + o)) - x~(q))^2 on the H x W frame,
//   S_o    = the sum of D_o over the (2b+1)^2 box, whose reflect padding
//            applies to the field D_o itself,
//   w_o    = exp(-S_o / ((2b+1)^2 h^2)),
//   out    = clip(sum_o w_o x~(reflect(p + o)) / max(sum_o w_o, 1e-8) / 255, 0, 1).
// The Pallas kernel boxes differences of the reflect-padded image instead,
// so near every frame edge it differs from this form (and from this kernel).
//
// Design.  A block of 256 threads computes a 32x32 tile of output pixels,
// all C channels.  It stages x~ over the tile plus a 14-pixel halo (b + s <=
// 14) in shared memory, indexed by the unreflected frame coordinate and
// filled from the reflected one, with two tables that map every position of
// the box's reach to the staged index of its reflection.  The block radius
// is uniform over the batch: the kernel reads it on the device and switches
// into a body templated on it, so every box loop unrolls into registers.
// Per offset, in the JAX form's order (ox outer, oy inner, each image's own
// s only), two phases, each ended by a barrier:
//   A. an item is 16 adjacent columns (8 at C = 1) of one row of the box's
//      reach, in one channel: 6 (32 + 2b) items at C = 3, so that nearly
//      every warp has one.  Thread t takes item t (at C = 3 and b >= 6 the
//      first threads also take item t + 256).  It forms the 16 + 2b
//      differences D from the staged image in registers and writes the 16
//      horizontal sums of 2b+1 of them to shared memory; the staged words
//      of its D centres are set once, before the offset loop.
//   B. every thread owns 4 rows of one output column: it forms the 4
//      vertical sums of 2b+1 horizontal sums, turns each into
//      w = exp2(S * scale), with 1 / (2b+1)^2, 1 / h^2 and log2(e) folded
//      into one factor per image, and adds it into num and den in registers.
// Every box is a sum of its own 2b+1 terms, never a running sum: D reaches
// 255^2, and a sliding window's subtraction would leave an absolute error
// near ulp(sum) where the sum should be near 0.  window_sums forms a run's
// windows from one pivot's prefix and suffix sums instead, 2b + 2G adds for G
// windows where direct sums take 2b G.  Row pitches are padded to 1 mod 8
// words, so the shared accesses of both phases are free of bank conflicts
// inside the frame.  The only division per value is num / den at the end.
// Sums run in another order than the plain form's (horizontal first, by
// pivot), and exp2 with one scale replaces expf of a quotient; both stay
// within 5e-5 of it (tests/test_torch_windowed.py emulates this arithmetic
// on the CPU).  One buffer of horizontal sums and two barriers per offset:
// a double-buffered form, phase A of offset i+1 beside phase B of offset i
// behind one barrier, measured slower on the H100 (PERF.md).
//
// Bound on the H100.  Per pixel and channel and per offset the function
// needs the difference and its square, the separable box and one exp with
// the operations around it; the interior is symmetric (the box of D_o at p
// is the box of D_-o at p + o), so ((2s+1)^2 - 1) / 2 distinct boxes and
// exps, and the exps bound it (chip_smoke.fastnlm_bound).  This kernel
// computes every offset's box, so it can reach at most about half of that
// bound.  The symmetry is left out: under the border rule it fails within
// b + s pixels of every frame edge, and every 512^2 serving tile has such a
// ring; and the partner p + o belongs to another thread, often another
// block, so its weight would need shared num and den accumulators or the
// weights recomputed over an s-wide halo, which at tiles that fit in shared
// memory eats much of the saving.  At b = 4 and C = 3 the kernel moves about
// 9 shared-memory words and issues about 14 FP32 operations and one exp per
// value and offset, with the address arithmetic beside them: the issue rate
// and the shared-memory port bound it, not the exps.  ptxas: 124 registers
// at C = 3 (94 at C = 1), no spills; 62,616 bytes of shared memory a block
// at C = 3; so the registers allow 2 blocks (16 warps) per SM.  PERF.md
// gives its times on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 7;                          // largest b and largest s
constexpr int kHalo = 2 * kMaxR;                  // reach of b + s
constexpr int kTile = 32;                         // output tile, kTile^2 pixels
constexpr int kRows = 4;                          // phase B: rows per thread
constexpr int kThreads = kTile * kTile / kRows;   // 256
constexpr int kStaged = kTile + 2 * kHalo;        // 60 staged rows and columns
constexpr int kReach = kTile + 2 * kMaxR;         // 46 positions a box reaches
constexpr float kLog2e = 1.4426950408889634f;

// Phase A's item: kRun<C>() adjacent columns of one row of the box's reach,
// in one channel.  Its items are numbered channel by channel, then row by
// row: the kTile / kRun<C>() runs of a row are adjacent.
template <int C> __host__ __device__ constexpr int kRun() { return C == 1 ? 8 : 16; }
template <int B, int C> __host__ __device__ constexpr int kItems() {
  return C * (kTile + 2 * B) * (kTile / kRun<C>());
}

// a row pitch of at least `words`, 1 mod 8: the rows of a warp's items then
// fall in distinct banks modulo 8 (odd modulo 16), and its runs, kRun<C>() * C
// words apart, fill the rest
__host__ __device__ constexpr int pitch(int words) { return words + (9 - words % 8) % 8; }
template <int C> __host__ __device__ constexpr int stage_pitch() { return pitch(kStaged * C); }
template <int C> __host__ __device__ constexpr int sums_pitch() { return pitch(kTile * C); }
template <int C> __host__ __device__ constexpr int sums_words() { return kReach * sums_pitch<C>(); }

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kStaged * stage_pitch<C>() + sums_words<C>()) +
         sizeof(int) * 2 * kReach;
}

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

// exp2 on the special-function unit; a result below 2^-126 flushes to 0,
// which no sum of weights can tell from a subnormal
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// out[m] = v[m] + ... + v[m + 2B] for m < N: every window is a sum of its own
// 2B+1 terms, never a running sum with a subtraction.  The windows go in
// groups of up to 2B+1 that all hold one pivot p (the group's last window
// starts there): a suffix sum of v[m .. p-1] and a prefix sum of v[p ..
// m+2B] make each, in 2B + 2G adds for a group of G windows, not 2B G.
// All terms are D values, never negative, so the order leaves the error
// relative to the window's own sum.
template <int N, int B>
__device__ __forceinline__ void window_sums(const float (&v)[N + 2 * B], float (&out)[N]) {
  constexpr int L = 2 * B + 1;
#pragma unroll
  for (int g = 0; g < N; g += L) {
    const int p = (g + L < N ? g + L : N) - 1;
#pragma unroll
    for (int i = 1; i < L; ++i) {   // suffix sums, right to left
      const int m = p - i;
      if (m >= g) out[m] = (i == 1) ? v[m] : v[m] + out[m + 1];
    }
    float pre = v[p];
#pragma unroll
    for (int i = 0; i < L; ++i) {   // prefix sums; window m ends at p + i
      if (i > 0) pre += v[p + i];
      const int m = p + i - (L - 1);
      if (m >= g && m < p) out[m] += pre;
    }
    out[p] = pre;
  }
}

// Phase A: the N horizontal box sums of one item for offset word `toff`,
// into dst[m * C]; centre(j) is the staged word of D column j's centre.
template <int N, int B, int C, typename Centre>
__device__ __forceinline__ void row_sums(const float* __restrict__ stage, Centre centre,
                                         int toff, float* __restrict__ dst) {
  float d[N + 2 * B], sum[N];
#pragma unroll
  for (int j = 0; j < N + 2 * B; ++j) {
    const int at = centre(j);
    const float t = stage[at + toff] - stage[at];
    d[j] = t * t;
  }
  window_sums<N, B>(d, sum);
#pragma unroll
  for (int m = 0; m < N; ++m) dst[m * C] = sum[m];
}

// Where phase A's item `it` reads and writes: the staged word of its row
// and channel, its first column's entry in the column table, and its first
// word in the horizontal sums.
struct Item {
  int row;
  const int* cols;
  int dst;
};

template <int B, int C>
__device__ __forceinline__ Item phase_a_item(int it, const int* __restrict__ srow,
                                             const int* __restrict__ scol) {
  constexpr int W = kRun<C>(), runs = kTile / W, per_channel = (kTile + 2 * B) * runs;
  const int c = it / per_channel, row = it % per_channel / runs, run = it % runs;
  return {srow[row + kMaxR - B] * stage_pitch<C>() + c, scol + run * W + kMaxR - B,
          row * sums_pitch<C>() + run * W * C + c};
}

// Phase B: the vertical box sums of one thread's kRows pixels from the
// horizontal sums at `sums`, their weights, and num and den.
template <int B, int C>
__device__ __forceinline__ void accumulate(const float* __restrict__ sums,
                                           const float* __restrict__ tap,
                                           float neg_scale, float (&num)[kRows][C],
                                           float (&den)[kRows][C]) {
  constexpr int HP = sums_pitch<C>(), SP = stage_pitch<C>();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float hs[kRows + 2 * B], box[kRows];
#pragma unroll
    for (int m = 0; m < kRows + 2 * B; ++m) hs[m] = sums[m * HP + c];
    window_sums<kRows, B>(hs, box);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float wgt = exp2_ftz(box[r] * neg_scale);
      num[r][c] += wgt * tap[r * SP + c];
      den[r][c] += wgt;
    }
  }
}

// Everything after the staging, for block radius B.
template <int B, int C>
__device__ __forceinline__ void nlm_tile(const float* __restrict__ stage,
                                         float* __restrict__ sums,
                                         const int* __restrict__ srow,
                                         const int* __restrict__ scol, int s,
                                         float neg_scale, float* __restrict__ dst,
                                         int h, int w, int oy0, int ox0) {
  constexpr int SP = stage_pitch<C>(), HP = sums_pitch<C>();
  const int tid = threadIdx.x;

  // phase A: item tid, its D centres' staged words held in registers; where
  // the items outnumber the threads (C = 3, B >= 6), the first few threads
  // also take item tid + kThreads, reading its columns from the table
  constexpr int W = kRun<C>(), items = kItems<B, C>();
  static_assert(items <= 2 * kThreads, "at most two phase-A items per thread");
  const bool a_on = tid < items;
  const Item a = phase_a_item<B, C>(a_on ? tid : 0, srow, scol);
  int a_ctr[W + 2 * B];
#pragma unroll
  for (int j = 0; j < W + 2 * B; ++j) a_ctr[j] = a.row + a.cols[j] * C;
  const bool a2_on = tid + kThreads < items;
  const Item a2 = phase_a_item<B, C>(a2_on ? tid + kThreads : 0, srow, scol);

  // phase B's pixels: rows by .. by + kRows - 1 of column bx of the tile
  const int bx = tid % kTile, by = tid / kTile * kRows;
  const float* b_sums = sums + by * HP + bx * C;
  const float* b_tap = stage + (by + kHalo) * SP + (bx + kHalo) * C;
  float num[kRows][C], den[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      num[r][c] = 0.f;
      den[r][c] = 0.f;
    }
  }

  const int side = 2 * s + 1, count = side * side;
  for (int i = 0; i < count; ++i) {
    const int dx = i / side - s, dy = i % side - s;
    const int toff = dy * SP + dx * C;
    if (a_on) row_sums<W, B, C>(stage, [&](int j) { return a_ctr[j]; }, toff, sums + a.dst);
    if (a2_on)
      row_sums<W, B, C>(stage, [&](int j) { return a2.row + a2.cols[j] * C; }, toff,
                        sums + a2.dst);
    __syncthreads();
    accumulate<B, C>(b_sums, b_tap + toff, neg_scale, num, den);
    __syncthreads();
  }

  const int ox = ox0 + bx;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int oy = oy0 + by + r;
    if (oy < h && ox < w) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[(static_cast<size_t>(oy) * w + ox) * C + c] =
            fminf(fmaxf(num[r][c] / fmaxf(den[r][c], 1e-8f) / 255.f, 0.f), 1.f);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
fastnlm_kernel(const float* __restrict__ x, const float* __restrict__ params,
               float* __restrict__ out, int h, int w) {
  extern __shared__ float smem[];
  constexpr int SP = stage_pitch<C>();
  float* stage = smem;                                  // [kStaged][SP]: x~
  float* sums = stage + kStaged * SP;                   // [kReach][HP]
  int* srow = reinterpret_cast<int*>(sums + sums_words<C>());  // [kReach]
  int* scol = srow + kReach;                                         // [kReach]

  const int n = blockIdx.z, tid = threadIdx.x;
  // parameters as the JAX and PyTorch forms compute them (no contraction);
  // the weight is exp2(S * neg_scale), neg_scale = -log2(e) / ((2b+1)^2 h^2)
  const int b =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[0], 7.f)), 0.f), 6.f)) + 1;
  const int s =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[3 * n + 1], 7.f)), 0.f), 6.f)) + 1;
  const float hd = __fadd_rn(1.f, __fmul_rn(99.f, params[3 * n + 2]));
  const float inv_h2 = __fdiv_rn(1.f, __fmul_rn(hd, hd));
  const float k = static_cast<float>(2 * b + 1);
  const float neg_scale = -kLog2e * inv_h2 / (k * k);

  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const float* img = x + static_cast<size_t>(n) * h * w * C;
  for (int i = tid; i < kStaged * kStaged; i += kThreads) {
    const int sy = i / kStaged, sx = i % kStaged;
    const float* src =
        img + (static_cast<size_t>(reflect(oy0 - kHalo + sy, h)) * w +
               reflect(ox0 - kHalo + sx, w)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) stage[sy * SP + sx * C + c] = __fmul_rn(src[c], 255.f);
  }
  // staged index of the reflection of each position of the box's reach; the
  // clamp only touches positions that no output pixel of the frame reads
  for (int i = tid; i < 2 * kReach; i += kThreads) {
    if (i < kReach) {
      srow[i] = min(max(reflect(oy0 - kMaxR + i, h) - (oy0 - kHalo), kMaxR),
                    kStaged - 1 - kMaxR);
    } else {
      const int j = i - kReach;
      scol[j] = min(max(reflect(ox0 - kMaxR + j, w) - (ox0 - kHalo), kMaxR),
                    kStaged - 1 - kMaxR);
    }
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(n) * h * w * C;
  switch (b) {
    case 1: nlm_tile<1, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    case 2: nlm_tile<2, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    case 3: nlm_tile<3, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    case 4: nlm_tile<4, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    case 5: nlm_tile<5, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    case 6: nlm_tile<6, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
    default: nlm_tile<7, C>(stage, sums, srow, scol, s, neg_scale, dst, h, w, oy0, ox0); break;
  }
}

template <int C>
int launch(const float* x, const float* params, float* out, int n, int h, int w,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      fastnlm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  fastnlm_kernel<C><<<grid, kThreads, bytes, stream>>>(x, params, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (n, h, w, c) float32 contiguous; params: (n, 3) float32.
// Launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int fastnlm_forward(const float* x, const float* params, float* out,
                               int n, int h, int w, int c, void* stream) {
  if (n < 1 || n > 65535 || h <= kMaxR || w <= kMaxR) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3) return launch<3>(x, params, out, n, h, w, s);
  if (c == 1) return launch<1>(x, params, out, n, h, w, s);
  return cudaErrorInvalidValue;
}

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

#include <algorithm>

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

// ------------------------------------------------------------------ backward
//
// The gradient of the function above for a cotangent g of its output, for
// x and params, in four kernels that never use float atomics.  It replaces
// no TPU kernel: the JAX package differentiates _fastnlm_jnp under jax.vjp,
// and its custom_vjp has no backward kernel.  It replaces the plain form's
// autograd on the card (ops/kernels/_vjp.py), which under a CUDA graph
// capture visited all 225 offsets at MAX_R and boxed their 225 stacked
// difference fields in thousands of small kernels.
//
// With y = num / den the unclipped output, m the clip's mask (1 inside, 1/2
// at an exact bound, as ops/nn.clip's maximum and minimum split a tie) and
// a = g m / (255 den), for each offset o:
//   dw_o = a (tap_o - y)                  the weight's gradient,
//   gS_o = -inv_h2 / (2b+1)^2 w_o dw_o     the box sum's,
//   gD_o = the reflected box's adjoint of gS_o (a position outside the
//          frame adds onto its reflection),
//   T_o  = a w_o + 2 (tap_o - x~) gD_o, which goes to x~ at R(p + o),
//   U_o  = -2 (tap_o - x~) gD_o, which goes to x~ at p,
// gx = 255 (sum_o of T_o gathered from each target's reflection preimages
// + sum_o U_o), and params[:, 2]'s gradient is sum_{p,o} w_o dw_o S_o / k^2
// times 2 * 99 / h^3; the radii come from a floor, so their gradient is 0.
//
//   stats   (a 16x16 tile of one channel plane a block, a thread a pixel)
//           num and den over each image's own offsets in the plain form's
//           order and arithmetic (torch's on the card: box rows then
//           columns, each a sum of its own terms from the first, times the
//           float reciprocal of 2b+1; expf; num += w tap; den += w), so y,
//           and the clip's mask at an exact bound, are the plain form's;
//           -> a and y, and each offset's box mean S_o / k^2 of the group.
//   offsets (the same tiles, each image's offsets of the group in parts,
//           a block a part) per offset: gS over the tile and b around it,
//           the adjoint box along rows then columns, and T and U on the
//           tile; T into a per-offset field, U per part, and the block's
//           partial sum for params[:, 2] (float64, a fixed tree) carried
//           across groups.
//   gather  4 threads a value, each over a quarter of the group's offsets:
//           each offset's T at each reflection preimage of the value's
//           position, in order; the previous groups' sum + ((q0 + q2) +
//           (q1 + q3)), then each part's U; times 255 after the last group.
//   params  a block an image: the blocks' partials in a fixed order.
// The offsets are numbered as the plain form visits them (column offset
// outer); each group is a range of those numbers, chosen by the wrapper
// from the frame size so that the two per-offset fields (box means and T,
// group x N C H W floats each) stay bounded: one group at the search
// step's 4 x 48^2 x 3, where the 81 offsets of s = 4 fill 9 MB of each,
// in the 50 MB L2.  So one application is 3 launches a group + 1, and
// every sum runs in an order fixed by the shapes: two calls, and a
// captured replay, agree bit for bit.
// Like the forward, the kernels read b and each s on the device and switch
// into bodies templated on b, so a capture records them once for any radii.
//
// Bound on the H100: per value and distinct offset the forward's 14
// operations and one exp, and 28 more for the gradient of the pair the
// offset joins (chip_smoke's fastnlm_backward_bound): the exps, under a
// microsecond at the search step's shape.  What bounds this design is
// latency at low occupancy: 4 x 48^2 x 3 values are 27,648 threads, 108
// stats blocks of 8 warps, about one block an SM, each looping over its
// image's offsets with barriers, its sums in dependent chains.  The stats
// pass cannot split an image's offsets (num and den keep the plain form's
// order), so it boxes 4 offsets per pair of barriers; the offsets pass,
// whose offsets are independent, splits them over up to 8 blocks a tile
// (about 512 blocks) and loads the next offset's box means while it uses
// this one's; the gather gives a value 4 threads.  The passes also spend
// redundant work to stay short loops: the stats pass forms boxes over b
// around its tile, the offsets pass gS over b around it (from the stored
// box means, no box of D).  PERF.md gives its times on the card against
// the plain autograd's.

namespace {

constexpr int kBT = 16;                         // backward tile side
constexpr int kBThreads = kBT * kBT;            // a thread per pixel
constexpr int kBStaged = kBT + 2 * kHalo;       // 44 staged rows and columns
constexpr int kBWin = kBT + 2 * kMaxR;          // 30: the tile and b around it
constexpr int kOffsets = (2 * kMaxR + 1) * (2 * kMaxR + 1);  // 225
constexpr int kBatch = 4;                       // stats: offsets boxed per barrier pair
constexpr int kTargetBlocks = 512;              // offsets pass: blocks it aims for
constexpr int kMaxParts = 8;                    // its parts of a group's offsets
constexpr int kQuarters = 4;                    // gather: threads a value
constexpr float kInv255 = 1.f / 255.f;          // torch's CUDA y / 255: y * this

__device__ __forceinline__ int radius_of(float p01) {
  return static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(p01, 7.f)), 0.f), 6.f)) + 1;
}

__device__ __forceinline__ float decay_of(float p01) {
  return __fadd_rn(1.f, __fmul_rn(99.f, p01));
}

// 1 / h^2 as the plain form rounds it: 1 / ((1 + 99 p)^2)
__device__ __forceinline__ float inv_h2_of(float p01) {
  const float hd = decay_of(p01);
  return __fdiv_rn(1.f, __fmul_rn(hd, hd));
}

// [begin, end) of part `part` of `parts` of the image's own offsets in the
// group [first, first + len): contiguous chunks, in order
__device__ __forceinline__ int2 part_range(int count, int first, int len, int part,
                                           int parts) {
  const int n = max(0, min(first + len, count) - first);
  const int chunk = (n + parts - 1) / parts;
  const int begin = first + min(part * chunk, n);
  return make_int2(begin, first + min(part * chunk + chunk, n));
}

// Stage x~ of channel c of image n over the tile and kHalo around it,
// indexed by the unreflected coordinate and filled from the reflected one,
// and the staged index of the reflection of each position of the tile and
// kMaxR around it (clamped, as the forward's, where no pixel of the frame
// reads).
__device__ void stage_plane(const float* __restrict__ x, float* __restrict__ stage,
                            int* __restrict__ srow, int* __restrict__ scol, int n, int c,
                            int h, int w, int C, int y0, int x0) {
  for (int i = threadIdx.x; i < kBStaged * kBStaged; i += kBThreads) {
    const int sy = i / kBStaged, sx = i % kBStaged;
    const size_t at = (static_cast<size_t>(n) * h + reflect(y0 - kHalo + sy, h)) * w +
                      reflect(x0 - kHalo + sx, w);
    stage[i] = __fmul_rn(x[at * C + c], 255.f);
  }
  for (int i = threadIdx.x; i < 2 * kBWin; i += kBThreads) {
    if (i < kBWin) {
      srow[i] = min(max(reflect(y0 - kMaxR + i, h) - (y0 - kHalo), kMaxR),
                    kBStaged - 1 - kMaxR);
    } else {
      const int j = i - kBWin;
      scol[j] = min(max(reflect(x0 - kMaxR + j, w) - (x0 - kHalo), kMaxR),
                    kBStaged - 1 - kMaxR);
    }
  }
}

struct Tile {
  int n, c, part, y0, x0, tile;   // image, channel, part, first row and column, tile
  int py, px;                     // this thread's pixel
  bool valid;                     // whether it lies in the frame
  size_t at;                      // its index in a channel-planar (N, C, H, W) field
};

// blockIdx.x = (tile column * C + channel) * parts + part; y: tile row; z: image
__device__ __forceinline__ Tile tile_of(int h, int w, int C, int parts) {
  const int tiles_x = gridDim.x / (C * parts), cx = blockIdx.x / parts;
  Tile t;
  t.n = blockIdx.z;
  t.c = cx % C;
  t.part = blockIdx.x % parts;
  t.y0 = blockIdx.y * kBT;
  t.x0 = cx / C * kBT;
  t.tile = blockIdx.y * tiles_x + cx / C;
  t.py = t.y0 + threadIdx.x / kBT;
  t.px = t.x0 + threadIdx.x % kBT;
  t.valid = t.py < h && t.px < w;
  t.at = (static_cast<size_t>(t.n) * C + t.c) * h * w + static_cast<size_t>(t.py) * w + t.px;
  return t;
}

// The stats pass for block radius B: offsets [k0, k1) of the image's own,
// kBatch at a time, each box mean as the plain form forms it; num and den
// over them in order where `stats`, and the box means of the group's
// offsets into d2.
template <int B>
__device__ __forceinline__ void stats_tile(const float* __restrict__ stage,
                                           float (*__restrict__ dwin)[kBWin * kBWin],
                                           float (*__restrict__ vwin)[kBT * kBWin],
                                           const int* __restrict__ srow,
                                           const int* __restrict__ scol, int s, float inv_h2,
                                           float rk, bool stats, int first, int len,
                                           float* __restrict__ d2, size_t slot, const Tile& t,
                                           float& num, float& den) {
  constexpr int L = kBT + 2 * B;
  const int tid = threadIdx.x, ty = tid / kBT, tx = tid % kBT;
  const int side = 2 * s + 1, count = side * side;
  const int k0 = stats ? 0 : first, k1 = stats ? count : min(first + len, count);
  const int centre = (ty + kHalo) * kBStaged + tx + kHalo;
  for (int k = k0; k < k1; k += kBatch) {
    const int m = min(kBatch, k1 - k);
    // D over the tile and B around it, at the reflections of those positions
    for (int i = tid; i < m * L * L; i += kBThreads) {
      const int j = i / (L * L), r = i % (L * L);
      const int toff = ((k + j) % side - s) * kBStaged + ((k + j) / side - s);
      const int q = srow[r / L + kMaxR - B] * kBStaged + scol[r % L + kMaxR - B];
      const float d = __fsub_rn(stage[q + toff], stage[q]);
      dwin[j][r / L * kBWin + r % L] = __fmul_rn(d, d);
    }
    __syncthreads();
    // the box's rows: 2B+1 rows of D summed from the first, times 1/(2B+1)
    for (int i = tid; i < m * kBT * L; i += kBThreads) {
      const int j = i / (kBT * L), r = i % (kBT * L);
      const float* col = dwin[j] + r / L * kBWin + r % L;
      float v = col[0];
#pragma unroll
      for (int y = 1; y <= 2 * B; ++y) v = __fadd_rn(v, col[y * kBWin]);
      vwin[j][r / L * kBWin + r % L] = __fmul_rn(v, rk);
    }
    __syncthreads();
    // its columns, at this thread's pixel, and the sums in offset order
    for (int j = 0; j < m; ++j) {
      const float* row = vwin[j] + ty * kBWin + tx;
      float v = row[0];
#pragma unroll
      for (int x = 1; x <= 2 * B; ++x) v = __fadd_rn(v, row[x]);
      const float mean = __fmul_rn(v, rk);
      if (stats) {
        const int toff = ((k + j) % side - s) * kBStaged + ((k + j) / side - s);
        const float wgt = expf(__fmul_rn(-mean, inv_h2));
        num = __fadd_rn(num, __fmul_rn(wgt, stage[centre + toff]));
        den = __fadd_rn(den, wgt);
      }
      if (t.valid && k + j >= first && k + j < first + len)
        d2[(k + j - first) * slot + t.at] = mean;
    }
  }
}

__global__ void __launch_bounds__(kBThreads)
fastnlm_bwd_stats(const float* __restrict__ x, const float* __restrict__ params,
                  const float* __restrict__ g, float* __restrict__ a_out,
                  float* __restrict__ y_out, float* __restrict__ d2, int h, int w, int C,
                  bool stats, int first, int len) {
  __shared__ float stage[kBStaged * kBStaged];
  __shared__ float dwin[kBatch][kBWin * kBWin];
  __shared__ float vwin[kBatch][kBT * kBWin];
  __shared__ int srow[kBWin], scol[kBWin];
  const Tile t = tile_of(h, w, C, 1);
  stage_plane(x, stage, srow, scol, t.n, t.c, h, w, C, t.y0, t.x0);
  __syncthreads();

  const int b = radius_of(params[0]), s = radius_of(params[3 * t.n + 1]);
  const float inv_h2 = inv_h2_of(params[3 * t.n + 2]);
  const float rk = __fdiv_rn(1.f, static_cast<float>(2 * b + 1));
  const size_t slot = static_cast<size_t>(gridDim.z) * C * h * w;
  float num = 0.f, den = 0.f;
  switch (b) {
#define NLM_STATS(B)                                                                     \
  case B:                                                                                \
    stats_tile<B>(stage, dwin, vwin, srow, scol, s, inv_h2, rk, stats, first, len, d2,  \
                  slot, t, num, den);                                                    \
    break;
    NLM_STATS(1) NLM_STATS(2) NLM_STATS(3) NLM_STATS(4) NLM_STATS(5) NLM_STATS(6)
    default: NLM_STATS(7)
#undef NLM_STATS
  }
  if (!stats || !t.valid) return;
  // the centre's weight is 1, so den >= 1 and the plain form's clip of den
  // to 1e-8 never binds
  const float y = __fdiv_rn(num, den);
  const float out = __fmul_rn(y, kInv255);
  const float m = (out > 0.f && out < 1.f) ? 1.f : (out == 0.f || out == 1.f) ? 0.5f : 0.f;
  const float gv = g[((static_cast<size_t>(t.n) * h + t.py) * w + t.px) * C + t.c];
  a_out[t.at] = __fdiv_rn(__fmul_rn(__fmul_rn(gv, m), kInv255), den);
  y_out[t.at] = y;
}

// The offsets pass for block radius B over the offsets [kb, ke) of the
// group [first, first + len); the next offset's box means are loaded while
// this one's are used.
template <int B>
__device__ __forceinline__ void offsets_tile(
    const float* __restrict__ stage, const float* __restrict__ awin,
    const float* __restrict__ ywin, float* __restrict__ gsw, float* __restrict__ gvw,
    float (*__restrict__ awt)[kBThreads], double (*__restrict__ et)[kBThreads], int s,
    float inv_h2, float neg_c, int first, int kb, int ke, const float* __restrict__ d2,
    float* __restrict__ tout, size_t slot, const Tile& t, int h, int w, float& u,
    double& e) {
  constexpr int L = kBT + 2 * B, per = (L * L + kBThreads - 1) / kBThreads;
  const int tid = threadIdx.x, tx = tid % kBT;
  const int side = 2 * s + 1;
  const int centre = (tid / kBT + kHalo) * kBStaged + tx + kHalo;
  const size_t plane = t.at - (static_cast<size_t>(t.py) * w + t.px);
  float cur[per], nxt[per];
  auto fetch = [&](int k, float (&dst)[per]) {
    const float* mean = d2 + (k - first) * slot + plane;
#pragma unroll
    for (int r = 0; r < per; ++r) {
      const int i = tid + r * kBThreads;
      const int yy = t.y0 - B + i / L, xx = t.x0 - B + i % L;
      dst[r] = (i < L * L && yy >= 0 && yy < h && xx >= 0 && xx < w)
                   ? mean[static_cast<size_t>(yy) * w + xx]
                   : 0.f;
    }
  };
  if (kb < ke) fetch(kb, nxt);
  for (int k = kb; k < ke; ++k) {
    const int buf = k & 1;
    const int toff = (k % side - s) * kBStaged + (k / side - s);
#pragma unroll
    for (int r = 0; r < per; ++r) cur[r] = nxt[r];
    if (k + 1 < ke) fetch(k + 1, nxt);
    // gS over the tile and B around it, 0 outside the frame; a w and the
    // partial's term at the tile's pixels
#pragma unroll
    for (int r = 0; r < per; ++r) {
      const int i = tid + r * kBThreads;
      if (i >= L * L) break;
      const int wy = i / L, wx = i % L;
      const int yy = t.y0 - B + wy, xx = t.x0 - B + wx;
      float gs = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float d = cur[r];
        const float wgt = expf(__fmul_rn(-d, inv_h2));
        const float a = awin[wy * kBWin + wx];
        const float tap = stage[(yy - t.y0 + kHalo) * kBStaged + xx - t.x0 + kHalo + toff];
        const float wd = __fmul_rn(wgt, __fmul_rn(a, __fsub_rn(tap, ywin[wy * kBWin + wx])));
        gs = __fmul_rn(neg_c, wd);
        const int iy = wy - B, ix = wx - B;
        if (iy >= 0 && iy < kBT && ix >= 0 && ix < kBT) {
          awt[buf][iy * kBT + ix] = __fmul_rn(a, wgt);
          et[buf][iy * kBT + ix] = static_cast<double>(wd) * static_cast<double>(d);
        }
      }
      gsw[wy * kBWin + wx] = gs;
    }
    __syncthreads();
    // the adjoint of the box's columns, for every row of the window: each
    // column's 2B+1 sources, then those whose window reached past an edge
    for (int i = tid; i < L * kBT; i += kBThreads) {
      const int wy = i / kBT, ix = i % kBT, xc = t.x0 + ix;
      const float* row = gsw + wy * kBWin - t.x0 + B;   // row[x]: gS at column x
      float v = row[xc - B];
#pragma unroll
      for (int j = 1; j <= 2 * B; ++j) v = __fadd_rn(v, row[xc - B + j]);
      if (xc >= 1 && xc <= B)
        for (int xx = 0; xx <= B - xc; ++xx) v = __fadd_rn(v, row[xx]);
      if (xc >= w - 1 - B && xc <= w - 2)
        for (int xx = 2 * w - 2 - xc - B; xx <= w - 1; ++xx) v = __fadd_rn(v, row[xx]);
      gvw[wy * kBT + ix] = v;
    }
    __syncthreads();
    // the adjoint of its rows at this thread's pixel, then T and U
    const float* col = gvw + (B - t.y0) * kBT + tx;     // col[y * kBT]: row y
    float gd = col[(t.py - B) * kBT];
#pragma unroll
    for (int j = 1; j <= 2 * B; ++j) gd = __fadd_rn(gd, col[(t.py - B + j) * kBT]);
    if (t.py >= 1 && t.py <= B)
      for (int yy = 0; yy <= B - t.py; ++yy) gd = __fadd_rn(gd, col[yy * kBT]);
    if (t.py >= h - 1 - B && t.py <= h - 2)
      for (int yy = 2 * h - 2 - t.py - B; yy <= h - 1; ++yy) gd = __fadd_rn(gd, col[yy * kBT]);
    if (t.valid) {
      const float q = __fmul_rn(__fmul_rn(2.f, __fsub_rn(stage[centre + toff], stage[centre])),
                                gd);
      tout[(k - first) * slot + t.at] = __fadd_rn(awt[buf][tid], q);
      u = __fsub_rn(u, q);
      e += et[buf][tid];
    }
  }
}

__global__ void __launch_bounds__(kBThreads)
fastnlm_bwd_offsets(const float* __restrict__ x, const float* __restrict__ params,
                    const float* __restrict__ a_in, const float* __restrict__ y_in,
                    const float* __restrict__ d2, float* __restrict__ tout,
                    float* __restrict__ u_out, double* __restrict__ partial, int h, int w,
                    int C, int first, int len, int parts) {
  __shared__ float stage[kBStaged * kBStaged];
  __shared__ float awin[kBWin * kBWin], ywin[kBWin * kBWin], gsw[kBWin * kBWin];
  __shared__ float gvw[kBWin * kBT];
  __shared__ float awt[2][kBThreads];
  __shared__ double et[2][kBThreads];
  __shared__ int srow[kBWin], scol[kBWin];
  const Tile t = tile_of(h, w, C, parts);
  stage_plane(x, stage, srow, scol, t.n, t.c, h, w, C, t.y0, t.x0);
  const int b = radius_of(params[0]), s = radius_of(params[3 * t.n + 1]);
  // a and y over the tile and b around it, 0 outside the frame
  const int L = kBT + 2 * b;
  const size_t plane = (static_cast<size_t>(t.n) * C + t.c) * h * w;
  for (int i = threadIdx.x; i < L * L; i += kBThreads) {
    const int yy = t.y0 - b + i / L, xx = t.x0 - b + i % L;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const size_t at = plane + static_cast<size_t>(yy) * w + xx;
    awin[i / L * kBWin + i % L] = in ? a_in[at] : 0.f;
    ywin[i / L * kBWin + i % L] = in ? y_in[at] : 0.f;
  }
  __syncthreads();

  const float inv_h2 = inv_h2_of(params[3 * t.n + 2]);
  const float rk = __fdiv_rn(1.f, static_cast<float>(2 * b + 1));
  const float neg_c = -__fmul_rn(__fmul_rn(inv_h2, rk), rk);
  const size_t slot = static_cast<size_t>(gridDim.z) * C * h * w;
  const int2 range = part_range((2 * s + 1) * (2 * s + 1), first, len, t.part, parts);
  float u = 0.f;
  double e = 0.0;
  switch (b) {
#define NLM_OFFSETS(B)                                                                   \
  case B:                                                                                \
    offsets_tile<B>(stage, awin, ywin, gsw, gvw, awt, et, s, inv_h2, neg_c, first,      \
                    range.x, range.y, d2, tout, slot, t, h, w, u, e);                    \
    break;
    NLM_OFFSETS(1) NLM_OFFSETS(2) NLM_OFFSETS(3) NLM_OFFSETS(4) NLM_OFFSETS(5)
    NLM_OFFSETS(6)
    default: NLM_OFFSETS(7)
#undef NLM_OFFSETS
  }
  if (t.valid) u_out[t.part * slot + t.at] = u;
  // the block's partial for params[:, 2], added to the earlier groups': a
  // fixed tree over the threads, in float64
  __shared__ double red[kBThreads];
  const int tid = threadIdx.x;
  red[tid] = e;
  __syncthreads();
  for (int half = kBThreads / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    const size_t tiles = static_cast<size_t>(gridDim.x / (C * parts)) * gridDim.y;
    const size_t at = ((static_cast<size_t>(t.part) * gridDim.z + t.n) * C + t.c) * tiles + t.tile;
    partial[at] = (first == 0 ? 0.0 : partial[at]) + red[0];
  }
}

// kQuarters threads a value, in channel-planar order, each over a quarter
// of the group's offsets of the image: gx~ as the previous groups' sum plus
// ((q0 + q2) + (q1 + q3)) plus each part's U in order.
__global__ void __launch_bounds__(kBThreads)
fastnlm_bwd_gather(const float* __restrict__ params, const float* __restrict__ tin,
                   const float* __restrict__ u_in, float* __restrict__ gx, int n_img, int h,
                   int w, int C, int first, int len, int parts, bool last) {
  const size_t slot = static_cast<size_t>(n_img) * C * h * w;
  const size_t i = (static_cast<size_t>(blockIdx.x) * kBThreads + threadIdx.x) / kQuarters;
  const int quarter = threadIdx.x % kQuarters;
  const bool on = i < slot;   // every lane joins the shuffles below
  const int x = static_cast<int>(i % w), y = static_cast<int>(i / w % h);
  const int c = static_cast<int>(i / (static_cast<size_t>(h) * w) % C);
  const int n = on ? static_cast<int>(i / (static_cast<size_t>(C) * h * w)) : 0;
  const size_t plane = i - (static_cast<size_t>(y) * w + x);
  const int s = radius_of(params[3 * n + 1]), side = 2 * s + 1;
  const int2 range = on ? part_range(side * side, first, len, quarter, kQuarters)
                        : make_int2(0, 0);
  // the rows and columns p with R(p + o) at this value's: p = q - o, and
  // where q is within 7 of an edge, the reflections -q - o and
  // 2 (n - 1) - q - o
  float acc = 0.f;
  for (int k = range.x; k < range.y; ++k) {
    const int ox = k / side - s, oy = k % side - s;
    const float* tk = tin + (k - first) * slot + plane;
    const int rows[3] = {y - oy, y >= 1 ? -y - oy : -1, y <= h - 2 ? 2 * h - 2 - y - oy : -1};
    const int cols[3] = {x - ox, x >= 1 ? -x - ox : -1, x <= w - 2 ? 2 * w - 2 - x - ox : -1};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (rows[r] < 0 || rows[r] >= h) continue;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (cols[q] < 0 || cols[q] >= w) continue;
        acc = __fadd_rn(acc, tk[static_cast<size_t>(rows[r]) * w + cols[q]]);
      }
    }
  }
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 2));
  acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, 1));
  if (!on || quarter != 0) return;
  const size_t out = ((static_cast<size_t>(n) * h + y) * w + x) * C + c;
  float v = first == 0 ? acc : __fadd_rn(gx[out], acc);
  for (int j = 0; j < parts; ++j) v = __fadd_rn(v, u_in[j * slot + i]);
  gx[out] = last ? __fmul_rn(v, 255.f) : v;
}

// A block an image: params[:, 2]'s gradient from the offsets pass's
// partials (parts, channels, tiles), summed in a fixed order; 0 for the
// radii's.
__global__ void __launch_bounds__(kBThreads)
fastnlm_bwd_params(const float* __restrict__ params, const double* __restrict__ partial,
                   float* __restrict__ gp, int parts, int per_part) {
  const int n = blockIdx.x, tid = threadIdx.x;
  double e = 0.0;
  for (int i = tid; i < parts * per_part; i += kBThreads)
    e += partial[(static_cast<size_t>(i / per_part) * gridDim.x + n) * per_part +
                 i % per_part];
  __shared__ double red[kBThreads];
  red[tid] = e;
  __syncthreads();
  for (int half = kBThreads / 2; half > 0; half /= 2) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    const double hd = decay_of(params[3 * n + 2]);
    gp[3 * n] = 0.f;
    gp[3 * n + 1] = 0.f;
    gp[3 * n + 2] = static_cast<float>(red[0] * 2.0 * 99.0 / (hd * hd * hd));
  }
}

// How the offsets pass splits a group's offsets: enough parts that its
// grid reaches kTargetBlocks, at most kMaxParts.
struct Grid {
  int tiles_x, tiles_y, parts;
  size_t values;
};

Grid grid_of(int n, int h, int w, int c) {
  Grid g;
  g.tiles_x = (w + kBT - 1) / kBT;
  g.tiles_y = (h + kBT - 1) / kBT;
  const long long blocks = static_cast<long long>(g.tiles_x) * g.tiles_y * c * n;
  g.parts = static_cast<int>(std::max(1LL, std::min<long long>(kMaxParts, kTargetBlocks / blocks)));
  g.values = static_cast<size_t>(n) * h * w * c;
  return g;
}

// The scratch's parts, each from a 256-byte boundary: the partials
// (float64, parts N C tiles), a and y (N C H W each), U (parts N C H W),
// the box means and T (group N C H W each).
struct Scratch {
  double* partial;
  float *a, *y, *u, *d2, *t;
};

size_t up(size_t bytes) { return (bytes + 255) / 256 * 256; }

size_t scratch_layout(int n, int h, int w, int c, int group, char* base, Scratch* out) {
  const Grid g = grid_of(n, h, w, c);
  const size_t tiles = static_cast<size_t>(g.tiles_x) * g.tiles_y;
  const size_t sizes[6] = {up(sizeof(double) * g.parts * n * c * tiles),
                           up(sizeof(float) * g.values), up(sizeof(float) * g.values),
                           up(sizeof(float) * g.values * g.parts),
                           up(sizeof(float) * g.values * group),
                           up(sizeof(float) * g.values * group)};
  size_t at[6], total = 0;
  for (int i = 0; i < 6; ++i) {
    at[i] = total;
    total += sizes[i];
  }
  if (out != nullptr) {
    *out = {reinterpret_cast<double*>(base + at[0]), reinterpret_cast<float*>(base + at[1]),
            reinterpret_cast<float*>(base + at[2]), reinterpret_cast<float*>(base + at[3]),
            reinterpret_cast<float*>(base + at[4]), reinterpret_cast<float*>(base + at[5])};
  }
  return total;
}

bool backward_operands(int n, int h, int w, int c, int group) {
  return n >= 1 && n <= 65535 && h > kMaxR && w > kMaxR && (c == 1 || c == 3) &&
         group >= 1 && group <= kOffsets;
}

}  // namespace

// Bytes of scratch fastnlm_backward needs at these operands, 0 for operands
// it does not take.
extern "C" long long fastnlm_backward_scratch(int n, int h, int w, int c, int group) {
  if (!backward_operands(n, h, w, c, group)) return 0;
  return static_cast<long long>(scratch_layout(n, h, w, c, group, nullptr, nullptr));
}

// x, g, gx: (n, h, w, c) float32 contiguous; params, gp: (n, 3) float32;
// scratch: fastnlm_backward_scratch(n, h, w, c, group) bytes, 256-byte
// aligned.  The search offsets go in groups of `group` (1 to 225).
// Launches on `stream`, stores the number of launches in *launches and
// returns the CUDA error code (0 on success).
extern "C" int fastnlm_backward(const float* x, const float* params, const float* g,
                                float* gx, float* gp, void* scratch, int n, int h, int w,
                                int c, int group, int* launches, void* stream) {
  *launches = 0;
  if (!backward_operands(n, h, w, c, group)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch sc;
  scratch_layout(n, h, w, c, group, static_cast<char*>(scratch), &sc);
  const Grid gr = grid_of(n, h, w, c);
  const dim3 tiles(gr.tiles_x * c, gr.tiles_y, n);
  const dim3 parted(gr.tiles_x * c * gr.parts, gr.tiles_y, n);
  const unsigned blocks =
      static_cast<unsigned>((gr.values * kQuarters + kBThreads - 1) / kBThreads);
  const int groups = (kOffsets + group - 1) / group;
  for (int i = 0; i < groups; ++i) {
    const int first = i * group;
    fastnlm_bwd_stats<<<tiles, kBThreads, 0, st>>>(x, params, g, sc.a, sc.y, sc.d2, h, w, c,
                                                    i == 0, first, group);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fastnlm_bwd_offsets<<<parted, kBThreads, 0, st>>>(x, params, sc.a, sc.y, sc.d2, sc.t,
                                                       sc.u, sc.partial, h, w, c, first,
                                                       group, gr.parts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    fastnlm_bwd_gather<<<blocks, kBThreads, 0, st>>>(params, sc.t, sc.u, gx, n, h, w, c, first,
                                                      group, gr.parts, i == groups - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *launches += 3;
  }
  fastnlm_bwd_params<<<n, kBThreads, 0, st>>>(params, sc.partial, gp, gr.parts,
                                              c * gr.tiles_x * gr.tiles_y);
  *launches += 1;
  return static_cast<int>(cudaGetLastError());
}

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
//   d2_o   = the separable (2b+1)^2 box mean of D_o, whose reflect padding
//            applies to the field D_o itself (rows summed and divided by
//            2b+1, then columns),
//   w_o    = exp(-d2_o / h^2),
//   out    = clip(sum_o w_o x~(reflect(p + o)) / max(sum_o w_o, 1e-8) / 255, 0, 1).
// The Pallas kernel boxes differences of the reflect-padded image instead,
// so near every frame edge it differs from this form (and from this kernel).
//
// Design.  A 32x16 block computes a 32x16 tile of output pixels, all C
// channels.  It stages x~ over the tile plus a 14-pixel halo (b + s <= 14)
// in dynamic shared memory, indexed by the unreflected frame coordinate and
// filled from the reflected one, with two tables that map every position of
// the box's reach to the staged index of its reflection.  Per offset, in the
// JAX form's order (ox outer, oy inner, each image's own s only):
//   1. D_o over the tile plus a b halo, into shared memory;
//   2. the row sums of the box, into shared memory;
//   3. each thread's column sum, the exp, and num and den in registers.
// So a box costs 2(2b+1) adds per pixel instead of (2b+1)^2, and nothing but
// the input and the output goes through device memory.  Sums run in the
// box's own order, and the products and sums are rounded step by step
// (__fmul_rn, __fadd_rn) as the plain forms round them; `expf` keeps the
// result within 5e-5 of the plain form.
//
// Bound on the H100.  Per pixel and channel and per offset the function
// needs the difference and its square, the separable box and one exp with
// the operations around it; the interior is symmetric (the box of D_o at p
// is the box of D_-o at p + o), so ((2s+1)^2 - 1) / 2 distinct boxes and
// exps.  At b = s = 4 that is about 900 FP32 operations against 8 bytes
// moved, so the operations bound it (chip_smoke.fastnlm_bound_ms).  This
// kernel computes every offset's box, with the D field's halo and the row
// sums going through shared memory, so it is bound by the shared-memory
// port, several times above the function's bound.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 7;                      // largest b and largest s
constexpr int kHalo = 2 * kMaxR;              // reach of b + s
constexpr int kBlockW = 32;
constexpr int kBlockH = 16;
constexpr int kThreads = kBlockW * kBlockH;
constexpr int kSH = kBlockH + 2 * kHalo;      // 44 staged rows
constexpr int kSW = kBlockW + 2 * kHalo;      // 60 staged columns
constexpr int kDH = kBlockH + 2 * kMaxR;      // 30 rows of the D field
constexpr int kDW = kBlockW + 2 * kMaxR;      // 46 columns of the D field

__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return min(max(i, 0), n - 1);
}

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * C * (kSH * kSW + kDH * kDW + kBlockH * kDW) +
         sizeof(int) * (kDH + kDW);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
fastnlm_kernel(const float* __restrict__ x, const float* __restrict__ params,
               float* __restrict__ out, int h, int w) {
  extern __shared__ float smem[];
  float* stage = smem;                          // [kSH][kSW * C]: x~
  float* field = stage + kSH * kSW * C;         // [kDH][kDW * C]: D_o
  float* rows = field + kDH * kDW * C;          // [kBlockH][kDW * C]: row sums
  int* srow = reinterpret_cast<int*>(rows + kBlockH * kDW * C);  // [kDH]
  int* scol = srow + kDH;                                         // [kDW]

  const int n = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBlockW + tx;

  // Parameter arithmetic rounded step by step, as the JAX and PyTorch forms
  // compute it (no FMA contraction).
  const int b =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[0], 7.f)), 0.f), 6.f)) + 1;
  const int s =
      static_cast<int>(fminf(fmaxf(floorf(__fmul_rn(params[3 * n + 1], 7.f)), 0.f), 6.f)) + 1;
  const float hd = __fadd_rn(1.f, __fmul_rn(99.f, params[3 * n + 2]));
  const float inv_h2 = __fdiv_rn(1.f, __fmul_rn(hd, hd));
  const float k = static_cast<float>(2 * b + 1);

  const int oy0 = blockIdx.y * kBlockH, ox0 = blockIdx.x * kBlockW;
  const float* img = x + static_cast<size_t>(n) * h * w * C;
  for (int sy = ty; sy < kSH; sy += kBlockH) {
    const size_t yoff = static_cast<size_t>(reflect(oy0 - kHalo + sy, h)) * w;
    for (int sx = tx; sx < kSW; sx += kBlockW) {
      const float* src = img + (yoff + reflect(ox0 - kHalo + sx, w)) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) stage[sy * kSW * C + sx * C + c] = __fmul_rn(src[c], 255.f);
    }
  }
  // staged index of the reflection of each position of the box's reach; the
  // clamp only touches positions that no output pixel of the frame reads
  for (int i = tid; i < kDH + kDW; i += kThreads) {
    if (i < kDH) {
      srow[i] = min(max(reflect(oy0 - kMaxR + i, h) - (oy0 - kHalo), kMaxR), kSH - 1 - kMaxR);
    } else {
      const int j = i - kDH;
      scol[j] = min(max(reflect(ox0 - kMaxR + j, w) - (ox0 - kHalo), kMaxR), kSW - 1 - kMaxR);
    }
  }
  __syncthreads();

  float num[C], den[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    num[c] = 0.f;
    den[c] = 0.f;
  }
  const int span = (kBlockW + 2 * b) * C;   // D-field row of the box's reach
  const int first = (kMaxR - b) * C;        // its first element in a row
  for (int dx = -s; dx <= s; ++dx) {
    for (int dy = -s; dy <= s; ++dy) {
      // 1. D_o over the tile plus a b halo (rows and columns kMaxR - b ..)
      for (int r = ty; r < kBlockH + 2 * b; r += kBlockH) {
        const int qy = r + kMaxR - b;
        const float* ctr_row = stage + srow[qy] * kSW * C;
        const float* tap_row = ctr_row + dy * kSW * C;
        for (int e = tx; e < span; e += kBlockW) {
          const int qx = e / C + kMaxR - b, c = e % C;
          const int sx = scol[qx] * C + c;
          const float d = __fsub_rn(tap_row[sx + dx * C], ctr_row[sx]);
          field[qy * kDW * C + qx * C + c] = __fmul_rn(d, d);
        }
      }
      __syncthreads();
      // 2. row sums of the box over the tile's rows, divided by 2b+1
      for (int e = tx; e < span; e += kBlockW) {
        const float* col = field + (ty + kMaxR) * kDW * C + first + e;
        float acc = 0.f;
        for (int i = -b; i <= b; ++i) acc = __fadd_rn(acc, col[i * kDW * C]);
        rows[ty * kDW * C + first + e] = __fdiv_rn(acc, k);
      }
      __syncthreads();
      // 3. column sums, weight, and this pixel's num and den; the next
      // offset's step 1 writes only the D field, and its sync orders this
      // step's reads of the row sums before the next step 2 writes them
      const float* row = rows + ty * kDW * C;
      const float* tap = stage + (ty + kHalo + dy) * kSW * C + (tx + kHalo + dx) * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int j = -b; j <= b; ++j) acc = __fadd_rn(acc, row[(tx + kMaxR + j) * C + c]);
        const float d2 = __fdiv_rn(acc, k);
        const float wgt = expf(__fmul_rn(-d2, inv_h2));
        num[c] = __fadd_rn(num[c], __fmul_rn(wgt, tap[c]));
        den[c] = __fadd_rn(den[c], wgt);
      }
    }
  }

  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= h || ox >= w) return;
  float* dst = out + ((static_cast<size_t>(n) * h + oy) * w + ox) * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
    dst[c] = fminf(fmaxf(num[c] / fmaxf(den[c], 1e-8f) / 255.f, 0.f), 1.f);
}

template <int C>
int launch(const float* x, const float* params, float* out, int n, int h, int w,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      fastnlm_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((w + kBlockW - 1) / kBlockW, (h + kBlockH - 1) / kBlockH, n);
  fastnlm_kernel<C><<<grid, block, bytes, stream>>>(x, params, out, h, w);
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

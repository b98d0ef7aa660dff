// rawproc: native raw-Bayer preprocessing for the data path.
//
// A copy of reconfigisp_tpu/native/rawproc.cpp for the PyTorch port.  The
// reference delegates raw decoding to offline rawpy scripts and feeds
// training from lmdb/memcached (reference codes/data/preprocessing/
// generate_rggb2bgr_imgs_SID_Sony.py:32-110, sid...dataset.py:81-117).
// Here the host-side hot loop — uint16 unpack, black-level subtract,
// exposure-ratio scale, RGGB-aligned crop, batch assembly, and feathered
// patch merging for 12MP-class frames — is native C++ with a pthread pool,
// exposed to Python via ctypes (reconfigisp_tpu_torch/native/rawproc.py,
// which builds it with g++ at first use).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Normalize a uint16 raw frame: out = clip((in - black) * ratio / (white - black), 0, 1)
void rawproc_normalize_u16(const uint16_t* in, int64_t n, float black,
                           float white, float ratio, float* out) {
  const float scale = ratio / (white - black);
  for (int64_t i = 0; i < n; ++i) {
    float v = (static_cast<float>(in[i]) - black) * scale;
    out[i] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
  }
}

// Batched RGGB-aligned crop + normalize with a thread pool.
// in:   N pointers are emulated by one contiguous (N, H, W) uint16 buffer
// offs: (N, 2) int32 row/col offsets (will be snapped to even)
// out:  (N, S, S) float32
void rawproc_crop_norm_batch(const uint16_t* in, int n, int h, int w,
                             const int32_t* offs, int s, float black,
                             float white, float ratio, float* out,
                             int n_threads) {
  const float scale = ratio / (white - black);
  std::atomic<int> next(0);
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      int y0 = offs[2 * i] & ~1;    // snap to even: RGGB phase
      int x0 = offs[2 * i + 1] & ~1;
      y0 = std::min(std::max(y0, 0), h - s);
      x0 = std::min(std::max(x0, 0), w - s);
      const uint16_t* src = in + static_cast<int64_t>(i) * h * w;
      float* dst = out + static_cast<int64_t>(i) * s * s;
      for (int r = 0; r < s; ++r) {
        const uint16_t* row = src + static_cast<int64_t>(y0 + r) * w + x0;
        float* orow = dst + static_cast<int64_t>(r) * s;
        for (int c = 0; c < s; ++c) {
          float v = (static_cast<float>(row[c]) - black) * scale;
          orow[c] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        }
      }
    }
  };
  int t = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Mosaic (H, W) -> RGGB planes (4, H/2, W/2).
void rawproc_pack_rggb(const float* in, int h, int w, float* out) {
  const int hh = h / 2, ww = w / 2;
  float* r = out;
  float* g1 = out + static_cast<int64_t>(hh) * ww;
  float* g2 = g1 + static_cast<int64_t>(hh) * ww;
  float* b = g2 + static_cast<int64_t>(hh) * ww;
  for (int y = 0; y < hh; ++y) {
    for (int x = 0; x < ww; ++x) {
      const int64_t i0 = static_cast<int64_t>(2 * y) * w + 2 * x;
      const int64_t o = static_cast<int64_t>(y) * ww + x;
      r[o] = in[i0];
      g1[o] = in[i0 + 1];
      g2[o] = in[i0 + w];
      b[o] = in[i0 + w + 1];
    }
  }
}

// Feathered patch accumulation (the reference's patch2whole hot loop,
// codes/utils/util_path_restore.py:108-134): accumulate patches*mask into
// out and mask into count at the given positions.  Channels-last.
void rawproc_feather_accumulate(const float* patches, const int32_t* pos,
                                int n_patches, int ph, int pw, int c,
                                const float* mask, float* out, float* count,
                                int H, int W, int n_threads) {
  // parallel over rows of the output to avoid write races: each thread owns
  // a horizontal band.
  int t = std::max(1, n_threads);
  std::vector<std::thread> pool;
  int band = (H + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    int y_lo = k * band, y_hi = std::min(H, y_lo + band);
    pool.emplace_back([=]() {
      for (int p = 0; p < n_patches; ++p) {
        const int py = pos[2 * p], px = pos[2 * p + 1];
        const int r_lo = std::max(y_lo, py), r_hi = std::min(y_hi, py + ph);
        for (int y = r_lo; y < r_hi; ++y) {
          const int ly = y - py;
          const float* mrow = mask + static_cast<int64_t>(ly) * pw;
          const float* prow = patches +
              ((static_cast<int64_t>(p) * ph + ly) * pw) * c;
          float* orow = out + (static_cast<int64_t>(y) * W + px) * c;
          float* crow = count + static_cast<int64_t>(y) * W + px;
          for (int x = 0; x < pw; ++x) {
            const float m = mrow[x];
            crow[x] += m;
            for (int ch = 0; ch < c; ++ch)
              orow[x * c + ch] += prow[x * c + ch] * m;
          }
        }
      }
    });
  }
  for (auto& th : pool) th.join();
}

int rawproc_version() { return 1; }

}  // extern "C"

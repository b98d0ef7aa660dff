// pngfilter: undoes the per-row filters of a PNG image's inflated data.
//
// The PNG reader of the port (reconfigisp_tpu_torch/utils/png.py) inflates
// the IDAT stream with Python's zlib and hands it here: every row is one
// filter-type byte and `rowbytes` filtered bytes (PNG specification,
// section 9).  Average and Paeth depend on the unfiltered byte to the left,
// so the loop runs along each row; in numpy a 3000x4000 16-bit frame would
// take minutes.  Built with g++ at first use into build/native/ by
// utils/png.py, as native/rawproc.cpp is.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// in:  rows * (1 + rowbytes) bytes, each row led by its filter type (0-4)
// out: rows * rowbytes unfiltered bytes
// bpp: bytes per complete pixel, at least 1 (the "left" distance)
// Returns 0, or 1 + the index of the first row with an unknown filter type.
int64_t png_unfilter(const uint8_t* in, int64_t rows, int64_t rowbytes,
                     int bpp, uint8_t* out) {
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* src = in + y * (rowbytes + 1) + 1;
    const uint8_t type = src[-1];
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : nullptr;
    switch (type) {
      case 0:  // None
        std::memcpy(cur, src, rowbytes);
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

int pngfilter_version() { return 1; }

}  // extern "C"

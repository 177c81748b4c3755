// PNG row-filter reversal (PNG specification, section 9: filter method 0).
//
// The inflated IDAT stream of one (sub-)image is `height` scanlines, each a
// filter-type byte followed by `row_bytes` filtered bytes. This writes the
// reconstructed scanlines (without their type bytes) to `out`. Sub, Average
// and Paeth depend on the reconstructed byte `bpp` to the left, so the work
// is a sequential pass per row; Python's zlib does the inflate, this does
// the rest of a decode's byte work. Built with g++ by data/native.py.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Returns 0, -1 when `in_len` is short of height * (row_bytes + 1), -2 on a
// filter type above 4 (the failing row is written to *bad_row), -3 on bad
// geometry.
int t2r_png_unfilter(const uint8_t* in, size_t in_len, uint8_t* out, int height,
                     int row_bytes, int bpp, int* bad_row) {
  if (height < 0 || row_bytes < 0 || bpp < 1) return -3;
  const size_t stride = static_cast<size_t>(row_bytes) + 1;
  if (in_len < stride * static_cast<size_t>(height)) return -1;
  const uint8_t* prior = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + stride * y;
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + static_cast<size_t>(row_bytes) * y;
    switch (type) {
      case 0:
        for (int i = 0; i < row_bytes; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        if (bad_row) *bad_row = y;
        return -2;
    }
    prior = dst;
  }
  return 0;
}

}  // extern "C"

// PNG row unfiltering (ISO/IEC 15948, section 9) on the host, for
// groomed_nms_torch/data/png.py.
//
// The Average and Paeth filters predict a byte from the reconstructed byte
// to its left and the one above, so a row cannot be reversed as a vector
// operation; a Python loop over one 375x1242 RGB frame takes over a second.
// This routine reverses all five filter types in one pass over the rows.
// It is built with the host compiler into a shared library with a plain C
// interface and called through ctypes, which releases the interpreter lock,
// so several frames unfilter at once in the decode threads.

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

// in:  height rows of (1 filter byte + row_bytes filtered bytes), as the
//      inflated IDAT stream holds them.
// out: height * row_bytes reconstructed bytes.
// bpp: bytes per complete pixel (>= 1), the left neighbour's distance.
// Returns 0, or 1 + the index of the first row whose filter type is not
// one of 0..4 (the rows before it are reconstructed).
int png_unfilter(const uint8_t* in, uint8_t* out, int height, int row_bytes,
                 int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<int64_t>(y) * (row_bytes + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + static_cast<int64_t>(y) * row_bytes;
    const uint8_t* up = y > 0 ? dst - row_bytes : nullptr;
    switch (type) {
      case 0:  // None
        for (int i = 0; i < row_bytes; ++i) dst[i] = src[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:  // Average
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = src[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = src[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"

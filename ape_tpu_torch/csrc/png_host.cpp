// PNG scanline unfiltering for the host CPU, in plain C++17: the part of
// PNG decoding that is sequential byte by byte (the Sub, Average and Paeth
// filters of the PNG specification, section 9), for `data/image_io.py`,
// which inflates the image data with zlib and unpacks the samples itself.
//
// C interface (ctypes): ape_png_unfilter returns 0, or 1 + the row whose
// filter type is unknown.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// `height` scanlines of a filter byte and `stride` bytes each -> `out`
// (height x stride), with `bpp` bytes a complete pixel (at least 1)
int ape_png_unfilter(const uint8_t* data, int height, int stride, int bpp, uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* raw = data + (size_t)y * (stride + 1) + 1;
    const int kind = raw[-1];
    uint8_t* row = out + (size_t)y * stride;
    const uint8_t* up = y ? row - stride : nullptr;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? row[i - bpp] : 0, b = up ? up[i] : 0,
                c = up && i >= bpp ? up[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = pa <= pb && pa <= pc ? a : pb <= pc ? b : c;
          break;
        }
        default: return y + 1;
      }
      row[i] = (uint8_t)(raw[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"

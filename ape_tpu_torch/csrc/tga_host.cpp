// TGA run-length decoding for the host CPU, in plain C++17: the part of TGA
// reading that is sequential byte by byte, for `data/tga.py`, which parses
// the header and unpacks the pixels itself. It follows PIL 12.1's
// TgaRleDecode.c, its quirks included: a run packet that runs past the end
// of a row is an overrun, and so is a literal packet at one byte a pixel; at
// more bytes a pixel a literal packet goes on into the rows below.
//
// C interface (ctypes): ape_tga_rle returns 0 once `rows` rows of `stride`
// bytes are decoded, 1 when the data ends first (PIL's truncated file), 2
// on an overrun.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// `file` (n bytes) from `offset`: packets of `depth` bytes a pixel -> `out`
// (rows x stride bytes, in the file's row order)
int ape_tga_rle(const uint8_t* file, size_t n, size_t offset, int depth, size_t stride,
                size_t rows, uint8_t* out) {
  const size_t total = stride * rows;
  size_t pos = offset, o = 0;
  while (o < total) {
    if (pos >= n) return 1;
    const int head = file[pos];
    const size_t len = ((size_t)(head & 0x7F) + 1) * (size_t)depth;
    const size_t row_left = stride - o % stride;
    if (head & 0x80) {
      if (n - pos < 1 + (size_t)depth) return 1;
      if (len > row_left) return 2;
      for (size_t i = 0; i < len; ++i) out[o + i] = file[pos + 1 + i % depth];
      pos += 1 + depth;
      o += len;
    } else {
      if (n - pos < 1 + len) return 1;
      if (len > row_left && depth == 1) return 2;
      const size_t here = len < total - o ? len : total - o;
      std::memcpy(out + o, file + pos + 1, here);  // on into the rows below
      pos += 1 + len;
      o += here;
    }
  }
  return 0;
}

}  // extern "C"

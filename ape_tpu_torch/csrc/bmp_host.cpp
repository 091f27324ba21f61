// BMP run-length decoding for the host CPU, in plain C++17: the part of BMP
// reading that is sequential byte by byte, for `data/bmp.py`, which parses
// the headers and unpacks raw rows itself. It follows PIL 12.1's
// BmpRleDecoder (BmpImagePlugin.py) step for step, its quirks included: a
// delta escape reads two bytes and then takes the next two as (right, up);
// an absolute RLE4 run of n pixels reads n // 2 bytes but advances x by n;
// absolute runs are padded to a 16-bit boundary of the file's offset; the
// decoded indices run bottom-up or top-down as the header says (the caller
// flips them).
//
// C interface (ctypes): ape_bmp_rle returns 0 when the indices fill the
// image, 1 when the data ends first (PIL's "not enough image data"), 2 when
// a delta escape lacks its bytes (PIL's unpacking error).

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// `file` (n bytes) from `offset`: RLE8 (rle4 = 0) or RLE4 indices of an
// xsize x ysize image into `out` (xsize * ysize, in the file's row order)
int ape_bmp_rle(const uint8_t* file, size_t n, size_t offset, int rle4, int xsize, int ysize,
                uint8_t* out) {
  const size_t dest = (size_t)xsize * ysize;
  size_t len = 0, pos = offset;
  int64_t x = 0;
  auto put = [&](uint8_t v) {
    if (len < dest) out[len] = v;
    ++len;
  };
  while (len < dest) {
    if (pos + 2 > n) break;  // fd.read(1) twice: a missing byte ends the data
    const int count = file[pos], byte = file[pos + 1];
    pos += 2;
    if (count) {  // encoded mode
      int64_t pixels = count;
      if (x + pixels > xsize) pixels = xsize - x > 0 ? xsize - x : 0;
      for (int64_t i = 0; i < pixels; ++i) put(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
      x += pixels;
    } else if (byte == 0) {  // end of line
      while (len % xsize) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: PIL reads two bytes, then takes the next two
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) return 2;
      const size_t right = file[pos], up = file[pos + 1];
      pos += 2;
      for (size_t i = 0; i < right + up * xsize; ++i) put(0);
      x = (int64_t)(len % xsize);
    } else {  // absolute mode
      const size_t want = rle4 ? byte / 2 : byte;
      const size_t got = pos + want <= n ? want : n - pos;
      for (size_t i = 0; i < got; ++i) {
        const int v = file[pos + i];
        if (rle4) {
          put(v >> 4);
          put(v & 15);
        } else {
          put(v);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) ++pos;  // word alignment of the file offset
    }
  }
  return len >= dest ? 0 : 1;
}

}  // extern "C"

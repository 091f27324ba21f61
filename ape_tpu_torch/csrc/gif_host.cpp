// GIF image data (LZW) decoding for the host CPU, in plain C++17, for
// `data/gif.py`, which parses the blocks and applies PIL 12.1's frame-0 rules
// itself. It follows Pillow's GifDecode.c: codes of 2-12 bits growing when
// the next free entry reaches the code mask, a clear code resetting the
// table, a full table (4096 entries) kept without a clear, the first code
// after a clear taken as a literal, a code one past the table (KwKwK)
// allowed, any larger code refused; the 4-pass interlace; the frame done
// once its last row is written, whatever follows. Data is taken in whole
// sub-blocks, as PIL feeds the decoder blocks of 64 KiB and the decoder
// waits for a sub-block to be complete: an end code before the frame is
// full, or sub-blocks that run past the file, leave it waiting for data the
// file no longer has, which PIL reports as a truncated file.
//
// C interface (ctypes): ape_gif_lzw returns 0 (the frame is full), 1 (broken
// data: a code past the table), 2 (truncated) or 3 (a code size past 12).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTable = 4096;
constexpr size_t kPilBlock = 65536;  // ImageFile.MAXBLOCK

}  // namespace

extern "C" {

// `file` (n bytes), the frame's data from `offset` (the first sub-block's
// length byte) with LZW minimum code size `bits` -> indices of an
// xsize x ysize frame in `out`
int ape_gif_lzw(const uint8_t* file, size_t n, size_t offset, int bits, int interlace, int xsize,
                int ysize, uint8_t* out) {
  if (bits < 0 || bits > 12) return 3;
  if (xsize <= 0 || ysize <= 0) return 0;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> data(kTable), stack(kTable);
  std::vector<int> link(kTable);
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2, lastcode = 0, lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  size_t pos = offset, avail = offset + kPilBlock;
  // rows: interlace passes start at 0, 4, 2, 1 with steps 8, 8, 4, 2
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  auto newline = [&]() -> bool {  // false once the frame is full
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: step = 4; y = 2; pass = 3; break;
        case 3: step = 2; y = 1; pass = 0; break;
        default: return false;
      }
    }
    return true;
  };
  for (;;) {
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= (uint32_t)file[pos++] << bitcount;
        bitcount += 8;
        --blocksize;
      } else {  // the next sub-block, once PIL has fed all of it
        for (;;) {
          if (pos < std::min(avail, n) && pos + 1 + file[pos] <= std::min(avail, n)) break;
          if (avail >= n) return 2;
          avail += kPilBlock;
        }
        blocksize = file[pos++];
      }
    }
    int c = (int)(bitbuffer & (uint32_t)codemask);
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) {  // the decoder returns and waits for more of the file
      if (avail >= n) return 2;
      avail += kPilBlock;
      continue;
    }
    int count = 1;
    const uint8_t* p;
    uint8_t single;
    if (state == 2) {
      if (c > clear) return 1;
      lastdata = lastcode = c;
      state = 3;
      single = (uint8_t)c;
      p = &single;
    } else {
      const int thiscode = c;
      if (c > next) return 1;
      int top = kTable;
      if (c == next) {
        stack[--top] = (uint8_t)lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (top <= 0 || c >= kTable) return 1;
        stack[--top] = data[c];
        c = link[c];
      }
      lastdata = c;
      if (next < kTable) {
        data[next] = (uint8_t)c;
        link[next] = lastcode;
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      // the string is its first symbol, then the stack
      if (top == 0) return 1;
      stack[--top] = (uint8_t)c;
      p = &stack[top];
      count = kTable - top;
    }
    for (int i = 0; i < count; ++i) {
      out[(size_t)y * xsize + x] = p[i];
      if (++x >= xsize && !newline()) return 0;
    }
  }
}

}  // extern "C"

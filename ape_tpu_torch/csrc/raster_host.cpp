// The byte-serial loops of the small raster formats, for the host CPU in
// plain C++17: QOI's op decoder and encoder (`data/qoi.py`), and the run
// lengths of PCX (`data/pcx.py`), SGI (`data/sgi.py`) and Sun raster
// (`data/sun.py`). The Python modules parse the headers and unpack the rows
// themselves. Each loop follows PIL 12.1's own decoder step for step, its
// quirks included:
//
// * QOI (QoiImagePlugin's QoiDecoder and QoiEncoder, in Python in PIL): the
//   colour table starts zeroed, a RUN op leaves it alone, the decoder stops
//   once the pixels are filled (no end marker is looked for) and fails where
//   an op reads past the file;
// * PCX (PcxDecode.c): a run that reaches past the end of the line buffer
//   is an overrun, reported once the image is done;
// * SGI (SgiRleDecode.c): offset and length tables after the 512-byte
//   header; the row buffer is kept from row to row, so a row that ends
//   early keeps the samples of the row before; a one-byte chunk that is not
//   a terminator ends the decode with the rest of the image zero; a copy may
//   not reach the file's last byte;
// * Sun raster (SunRleDecode.c): a run may go on into the rows below.
//
// C interface (ctypes): each decoder returns 0 when the image is done, 1
// when the data ends first (PIL's truncated file), 2 on an overrun (PIL's
// "buffer overrun"); ape_qoi_encode returns the bytes written.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// QOI: `file` (n bytes) from `pos`, `pixels` pixels of `channels` (3 or 4)
// bytes into `out`
int ape_qoi_decode(const uint8_t* file, size_t n, size_t pos, int channels, size_t pixels,
                   uint8_t* out) {
  uint8_t table[64][4];
  std::memset(table, 0, sizeof table);
  uint8_t prev[4] = {0, 0, 0, 255};
  const size_t dest = pixels * (size_t)channels;
  size_t o = 0;
  auto emit = [&](const uint8_t* px) {
    for (int c = 0; c < channels && o < dest; ++c) out[o++] = px[c];
  };
  while (o < dest) {
    if (pos >= n) return 1;
    const uint8_t b = file[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - pos < 3) return 1;
      v[0] = file[pos], v[1] = file[pos + 1], v[2] = file[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (n - pos < 4) return 1;
      std::memcpy(v, file + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {
      std::memcpy(v, table[b & 63], 4);
    } else if ((b >> 6) == 1) {
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {
      if (pos >= n) return 1;
      const int second = file[pos++];
      const int dg = (b & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + (second >> 4) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int k = (b & 63) + 1; k > 0 && o < dest; --k) emit(prev);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(table[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    emit(v);
  }
  return 0;
}

static inline int qoi_delta(int left, int right) {
  int d = (left - right) & 255;
  return d >= 128 ? d - 256 : d;
}

// QOI ops of `pixels` pixels of `channels` bytes (no header, no end
// marker) into `out` (at least 5 bytes a pixel); returns the bytes written
long ape_qoi_encode(const uint8_t* px, size_t pixels, int channels, uint8_t* out) {
  // PIL's encoder starts its table as {0: (0, 0, 0, 0)}: a zeroed table
  // answers the same, since (0, 0, 0, 0) hashes to 0 and no pixel hashing
  // elsewhere is zero
  uint8_t table[64][4];
  std::memset(table, 0, sizeof table);
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t o = 0;
  int run = 0;
  for (size_t i = 0; i < pixels; ++i) {
    uint8_t p[4] = {px[i * channels], px[i * channels + 1], px[i * channels + 2],
                    (uint8_t)(channels == 4 ? px[i * channels + 3] : 255)};
    if (std::memcmp(p, prev, 4) == 0) {
      if (++run == 62) {
        out[o++] = (uint8_t)(0xC0 | (run - 1));
        run = 0;
      }
      continue;
    }
    if (run) {
      out[o++] = (uint8_t)(0xC0 | (run - 1));
      run = 0;
    }
    const int h = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
    if (std::memcmp(table[h], p, 4) == 0) {
      out[o++] = (uint8_t)h;
    } else {
      std::memcpy(table[h], p, 4);
      if (prev[3] == p[3]) {
        const int dr = qoi_delta(p[0], prev[0]), dg = qoi_delta(p[1], prev[1]),
                  db = qoi_delta(p[2], prev[2]);
        if (dr >= -2 && dr < 2 && dg >= -2 && dg < 2 && db >= -2 && db < 2) {
          out[o++] = (uint8_t)(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2));
        } else {
          const int dgr = qoi_delta(dr, dg), dgb = qoi_delta(db, dg);
          if (dgr >= -8 && dgr < 8 && dg >= -32 && dg < 32 && dgb >= -8 && dgb < 8) {
            out[o++] = (uint8_t)(0x80 | (dg + 32));
            out[o++] = (uint8_t)((dgr + 8) << 4 | (dgb + 8));
          } else {
            out[o++] = 0xFE;
            out[o++] = p[0], out[o++] = p[1], out[o++] = p[2];
          }
        }
      } else {
        out[o++] = 0xFF;
        out[o++] = p[0], out[o++] = p[1], out[o++] = p[2], out[o++] = p[3];
      }
    }
    std::memcpy(prev, p, 4);
  }
  if (run) out[o++] = (uint8_t)(0xC0 | (run - 1));
  return (long)o;
}

// PCX: `file` (n bytes) from `offset`, `rows` lines of `line` bytes (the
// planes' padded lines, PIL's state->bytes) into `out`
int ape_pcx_rle(const uint8_t* file, size_t n, size_t offset, size_t line, size_t rows,
                uint8_t* out) {
  size_t pos = offset, x = 0, y = 0;
  bool overrun = false;
  while (y < rows) {
    if (pos >= n) return 1;
    uint8_t* buf = out + y * line;
    if ((file[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return 1;
      for (int k = file[pos] & 0x3F; k > 0; --k) {
        if (x >= line) {
          overrun = true;
          break;
        }
        buf[x++] = file[pos + 1];
      }
      pos += 2;
    } else {
      buf[x++] = file[pos++];
    }
    if (x >= line) {
      x = 0;
      ++y;
    }
  }
  return overrun ? 2 : 0;
}

// PCX writer (PcxEncode.c): `rows` lines of `planes` planes of `line`
// bytes each -> runs of at most 63 within each plane's line, a lone byte
// below 0xC0 written as itself, `padding` zero bytes after each plane's
// line; `out` holds 2 * line + padding bytes a plane line. Returns the
// bytes written.
long ape_pcx_encode(const uint8_t* lines, size_t rows, size_t line, int planes, int padding,
                    uint8_t* out) {
  size_t o = 0;
  const size_t width = line * (size_t)planes;
  for (size_t y = 0; y < rows; ++y) {
    const uint8_t* buf = lines + y * width;
    int count = 1;
    uint8_t last = buf[0];
    size_t x = 1;
    auto flush = [&]() {
      if (count == 1 && last < 0xC0) {
        out[o++] = last;
      } else if (count > 0) {
        out[o++] = (uint8_t)(0xC0 | count);
        out[o++] = last;
      }
    };
    do {
      while (x % line) {
        if (count == 63) {
          out[o++] = 0xFF;
          out[o++] = last;
          count = 0;
        }
        const uint8_t here = buf[x];
        if (here == last) {
          ++x;
          ++count;
        } else {
          flush();
          last = here;
          count = 1;
          ++x;
        }
      }
      flush();
      for (int i = 0; i < padding; ++i) out[o++] = 0;
      if (x < width) {
        count = 1;
        last = buf[x];
        ++x;
      }
    } while (x < width);
  }
  return (long)o;
}

// SGI run lengths: a whole file of n bytes, `bpc` bytes a sample, `bands`
// channels of xsize x ysize -> `out` (ysize rows of xsize * bands * bpc
// bytes, samples interleaved, rows top-down; zeroed by the caller)
int ape_sgi_rle(const uint8_t* file, size_t n, int bpc, int xsize, int ysize, int bands,
                uint8_t* out) {
  const long header = 512;
  const long bufsize = (long)n - header;
  const int tablen = bands * ysize;
  if (bufsize < 8L * tablen) return 2;
  const uint8_t* ptr = file + header;
  const uint8_t* end = ptr + bufsize - 1;  // PIL's end_of_buffer: the last byte
  auto read4 = [&](long at) {
    return (uint32_t)ptr[at] << 24 | (uint32_t)ptr[at + 1] << 16 | (uint32_t)ptr[at + 2] << 8 |
           (uint32_t)ptr[at + 3];
  };
  const size_t row_bytes = (size_t)xsize * bands * bpc;
  std::vector<uint8_t> buffer(row_bytes, 0);
  for (int rowno = 0; rowno < ysize; ++rowno) {
    for (int chan = 0; chan < bands; ++chan) {
      uint32_t off = read4(4L * (rowno + chan * ysize));
      const uint32_t len = read4(4L * tablen + 4L * (rowno + chan * ysize));
      if (off < (uint32_t)header) return 2;
      off -= (uint32_t)header;
      if ((long)(uint32_t)(off + len) > bufsize) return 2;
      const uint8_t* src = ptr + off;
      uint8_t* dest = buffer.data() + (size_t)chan * bpc;
      const size_t step = (size_t)bands * bpc;
      int x = 0, status = 0;
      for (int k = (int)len; k > 0; --k) {
        uint8_t pixel;
        if (bpc == 1) {
          if (src > end) return 2;
          pixel = *src++;
        } else {
          if (src + 1 > end) return 2;
          pixel = src[1];
          src += 2;
        }
        if (k == 1 && pixel != 0) {
          status = 1;
          break;
        }
        int count = pixel & 0x7F;
        if (!count) break;
        if (x + count > xsize) return 2;
        x += count;
        if (pixel & 0x80) {
          if (src + (size_t)bpc * count > end) return 2;
          for (; count > 0; --count, dest += step, src += bpc) std::memcpy(dest, src, bpc);
        } else {
          if (src + (bpc == 1 ? 0 : 2) > end) return 2;
          for (; count > 0; --count, dest += step) std::memcpy(dest, src, bpc);
          src += bpc;
        }
      }
      if (status == 1) return 0;  // PIL ends the decode here, the rest of the image zero
    }
    std::memcpy(out + (size_t)(ysize - 1 - rowno) * row_bytes, buffer.data(), row_bytes);
  }
  return 0;
}

// Sun raster run lengths: `file` (n bytes) from `offset`, `rows` lines of
// `line` bytes into `out`
int ape_sun_rle(const uint8_t* file, size_t n, size_t offset, size_t line, size_t rows,
                uint8_t* out) {
  const size_t total = line * rows;
  size_t pos = offset, o = 0;
  while (o < total) {
    if (pos >= n) return 1;
    if (file[pos] == 0x80) {
      if (n - pos < 2) return 1;
      if (file[pos + 1] == 0) {
        out[o++] = 0x80;
        pos += 2;
        continue;
      }
      if (n - pos < 3) return 1;
      const size_t count = (size_t)file[pos + 1] + 1;
      const size_t here = count < total - o ? count : total - o;
      std::memset(out + o, file[pos + 2], here);
      o += here;
      pos += 3;
    } else {
      out[o++] = file[pos++];
    }
  }
  return 0;
}

}  // extern "C"

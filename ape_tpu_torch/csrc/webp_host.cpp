// WebP decoding for the host CPU, in plain C++17 (no library): the port's
// counterpart of PIL 12.1's WebP plugin over libwebp 1.6, which decodes every
// file through WebPAnimDecoder into RGBA. The rule is the one JAX's reader
// follows through PIL: a file PIL decodes is decoded bit for bit (the first
// frame on its canvas); a file PIL refuses gets the "corrupt" status.
//
//   * the container as WebPDemux takes it (RFC 9649; the image chunk read
//     with its pad byte, as WebPAnimDecoder hands the frame to WebPDecode):
//     a simple file (one
//     'VP8 ' or 'VP8L' chunk) or an extended one (VP8X, then an image with an
//     optional ALPH chunk, or ANIM and ANMF frames); a file shorter than its
//     RIFF size, an unknown VP8X flag, a still image whose size is not the
//     canvas's or a frame outside the canvas are refused, as WebPDemux
//     refuses them;
//   * VP8L (lossless, RFC 9649 section 3): simple and normal prefix codes,
//     the color cache, meta prefix codes, the 120-entry distance map, and the
//     predictor (modes 0-13; 14 and 15 as 0, as libwebp pads them), color,
//     subtract-green and color-indexing (with pixel bundling) transforms;
//     reading past the end of the data is an error, as in vp8l_dec.c;
//   * VP8 key frames (RFC 6386), as libwebp's dec/ decodes them: the
//     boolean decoder, segments, token partitions, coefficient probability
//     updates, 16x16, 4x4 and chroma intra prediction with libwebp's edge
//     samples (127 above, 129 left), the dequantization (y2 AC x 155 / 100,
//     at least 8), the inverse WHT and DCT, and the simple and normal loop
//     filters with sharpness and the delta adjustments, filtered after the
//     whole frame is reconstructed (prediction reads unfiltered samples);
//     partition data running out before the frame is decoded is an error;
//   * ALPH: raw or VP8L-coded alpha, its horizontal, vertical and gradient
//     filters (dsp/filters.c's unfilters); the level-reduction flag is only
//     read (libwebp dequantizes alpha only when asked to dither);
//   * output as libwebp's MODE_RGBA: fancy upsampling of the chroma
//     (dsp/upsampling.c) and the 14-bit YUV -> RGB of dsp/yuv.h, no
//     dithering; alpha 255 where the frame has none;
//   * an animated file's first frame decoded into a zeroed canvas at its
//     offset, as anim_decode.c composes a key frame.
//
// C interface (ctypes): ape_webp_decode returns 0 or 1 (a file PIL refuses)
// and writes a message into `err`; its RGBA output buffer is released with
// ape_webp_free. The alpha is PIL's "RGBA" view: 255 throughout where PIL
// presents the image as RGBX (no alpha flag, no VP8L alpha bit).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "vp8_common.h"

namespace {

struct Failure {
  std::string message;
};

[[noreturn]] void fail(const std::string& m) { throw Failure{m}; }

// RFC 9649 section 5.2.2: the distance codes 1-120 as (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------- VP8L

// Bits LSB first. Past the data it reads zeros; vp8l_dec.c's end of stream
// is more bits consumed than the data holds (than 64 for data under 8 bytes).
struct LBitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  uint64_t pos = 0;  // bits consumed

  void init(const uint8_t* data, size_t len) {
    d = data;
    n = len;
    pos = 0;
  }
  bool eos() const { return pos > std::max<uint64_t>(64, (uint64_t)n * 8); }
  uint64_t window() const {  // the next 56 or more bits
    const size_t byte = (size_t)(pos >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) {
      for (int i = 7; i >= 0; --i) v = (v << 8) | d[byte + i];
    } else {
      for (int i = 7; i >= 0; --i) v = (v << 8) | (byte + i < n ? d[byte + i] : 0);
    }
    return v >> (pos & 7);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = (uint32_t)(window() & ((1ull << k) - 1));
    pos += k;
    return v;
  }
};

// A canonical prefix code as VP8LBuildHuffmanTable accepts it: complete, or
// one symbol (read with no bits)
struct PrefixCode {
  int single = -1;
  int first[16], count[16], index[16];
  std::vector<int> sorted;
  uint16_t lut[256];  // 8 bits read -> (length << 12) | symbol, 0 if longer

  bool build(const int* lengths, int n) {
    int cnt[16] = {0};
    for (int s = 0; s < n; ++s) ++cnt[lengths[s]];
    if (cnt[0] == n) return false;
    for (int len = 1; len < 15; ++len)
      if (cnt[len] > (1 << len)) return false;
    if (n - cnt[0] == 1) {
      for (int s = 0; s < n; ++s)
        if (lengths[s]) single = s;
      return true;
    }
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = open * 2 - cnt[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    sorted.clear();
    int code = 0;
    for (int len = 1; len <= 15; ++len) {
      first[len] = code;
      count[len] = cnt[len];
      index[len] = (int)sorted.size();
      for (int s = 0; s < n; ++s)
        if (lengths[s] == len) sorted.push_back(s);
      code = (code + cnt[len]) << 1;
    }
    std::memset(lut, 0, sizeof(lut));
    for (int bits = 0; bits < 256; ++bits) {
      int c = 0;
      for (int len = 1; len <= 8; ++len) {
        c = (c << 1) | ((bits >> (len - 1)) & 1);
        if (c - first[len] < count[len]) {
          lut[bits] = (uint16_t)((len << 12) | sorted[index[len] + c - first[len]]);
          break;
        }
      }
    }
    return true;
  }

  int decode(LBitReader& br) const {
    if (single >= 0) return single;
    const uint64_t w = br.window();
    const int e = lut[w & 255];
    if (e) {
      br.pos += e >> 12;
      return e & 0xFFF;
    }
    int c = 0;
    for (int len = 1; len <= 15; ++len) {
      c = (c << 1) | (int)((w >> (len - 1)) & 1);
      if (c - first[len] < count[len]) {
        br.pos += len;
        return sorted[index[len] + c - first[len]];
      }
    }
    return 0;  // not reached: the code is complete
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((c0 >> s) & 255) + (int)((c1 >> s) & 255) - (int)((c2 >> s) & 255))
           << s;
  return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 255), b = (int)((c2 >> s) & 255);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ca = (int)((a >> s) & 255), cb = (int)((b >> s) & 255), cc = (int)((c >> s) & 255);
    pa_minus_pb += std::abs(cb - cc) - std::abs(ca - cc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

// VP8LPredictors: L left, T top, TR top-right, TL top-left
inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

class VP8LDecoder {
 public:
  // a level-0 stream of xsize x ysize ARGB pixels (transforms allowed)
  // from bit `start` of `data`; `alpha_rule`: the end-of-stream rule of
  // vp8l_dec.c's 8-bit alpha path (data running out only with pixels left)
  std::vector<uint32_t> decode(const uint8_t* data, size_t len, int start, int xsize, int ysize,
                               bool alpha_rule) {
    br_.init(data, len);
    br_.pos = start;
    int width = xsize;
    while (br_.read(1)) read_transform(&width, ysize);
    const int cache_bits = read_cache_bits();
    Codes codes = read_codes(width, ysize, cache_bits, true);
    bool eight_bit = alpha_rule && transforms_.size() == 1 && transforms_[0].type == 3 &&
                     cache_bits == 0;
    for (const auto& g : codes.groups)
      for (int j = 1; j <= 3; ++j)
        if (g[j].single < 0) eight_bit = false;
    std::vector<uint32_t> pixels((size_t)width * ysize);
    decode_pixels(pixels, width, ysize, codes, cache_bits, eight_bit);
    if (!eight_bit && br_.eos()) fail("VP8L data ends early");
    for (size_t t = transforms_.size(); t-- > 0;) pixels = inverse(transforms_[t], pixels);
    return pixels;
  }

 private:
  using Group = std::vector<PrefixCode>;
  struct Codes {
    int bits = 0, xsize = 0;
    std::vector<uint32_t> meta;  // group index of each tile
    std::vector<Group> groups;
  };
  LBitReader br_;
  std::vector<LTransform> transforms_;
  unsigned seen_ = 0;

  int read_cache_bits() {
    if (!br_.read(1)) return 0;
    const int bits = (int)br_.read(4);
    if (bits < 1 || bits > 11) fail("bad VP8L color cache size");
    return bits;
  }

  // an entropy-coded image without transforms (a transform's data, the
  // meta prefix image, the palette)
  std::vector<uint32_t> sub_image(int xsize, int ysize) {
    const int cache_bits = read_cache_bits();
    Codes codes = read_codes(xsize, ysize, cache_bits, false);
    std::vector<uint32_t> pixels((size_t)xsize * ysize);
    decode_pixels(pixels, xsize, ysize, codes, cache_bits, false);
    if (br_.eos()) fail("VP8L data ends early");
    return pixels;
  }

  void read_transform(int* xsize, int ysize) {
    LTransform t;
    t.type = (int)br_.read(2);
    if (seen_ & (1u << t.type)) fail("a VP8L transform repeated");
    seen_ |= 1u << t.type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (t.type == 0 || t.type == 1) {
      t.bits = (int)br_.read(3) + 2;
      t.data = sub_image(sub_sample(t.xsize, t.bits), sub_sample(ysize, t.bits));
    } else if (t.type == 3) {
      const int num_colors = (int)br_.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = sub_sample(t.xsize, t.bits);
      std::vector<uint32_t> palette = sub_image(num_colors, 1);
      // the palette is coded as differences; entries past it are 0
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      const size_t kept = std::min(palette.size(), t.data.size());
      for (size_t i = 0; i < kept; ++i) t.data[i] = i ? add_pixels(palette[i], t.data[i - 1]) : palette[0];
    }
    transforms_.push_back(std::move(t));
  }

  Codes read_codes(int xsize, int ysize, int cache_bits, bool allow_meta) {
    Codes c;
    int num_groups = 1;
    if (allow_meta && br_.read(1)) {
      c.bits = (int)br_.read(3) + 2;
      c.xsize = sub_sample(xsize, c.bits);
      c.meta = sub_image(c.xsize, sub_sample(ysize, c.bits));
      for (auto& m : c.meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)m + 1);
      }
    }
    const int alphabet[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
    c.groups.resize(num_groups);
    for (auto& g : c.groups) {
      g.resize(5);
      for (int j = 0; j < 5; ++j) read_code(g[j], alphabet[j]);
    }
    return c;
  }

  void read_code(PrefixCode& code, int alphabet) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple: one or two symbols
      const int num = (int)br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br_.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = (int)br_.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) fail("bad VP8L code length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * (int)br_.read(3);
        max_symbol = 2 + (int)br_.read(nbits);
        if (max_symbol > alphabet) fail("bad VP8L code length count");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.decode(br_);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          const int slot = len - 16;
          const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          const int repeat = (int)br_.read(extra[slot]) + offset[slot];
          if (symbol + repeat > alphabet) fail("bad VP8L code lengths");
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = len == 16 ? prev : 0;
        }
      }
    }
    if (br_.eos()) fail("VP8L data ends early");
    if (!code.build(lengths.data(), alphabet)) fail("bad VP8L prefix code");
  }

  int copy_value(int symbol) {  // GetCopyDistance / GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br_.read(extra) + 1;
  }

  void decode_pixels(std::vector<uint32_t>& px, int xsize, int ysize, const Codes& c, int cache_bits,
                     bool eight_bit) {
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    const size_t total = (size_t)xsize * ysize;
    size_t pos = 0;
    while (pos < total) {
      const int col = (int)(pos % xsize), row = (int)(pos / xsize);
      const Group& g = c.groups[c.meta.empty() ? 0
                                               : c.meta[(size_t)(row >> c.bits) * c.xsize +
                                                        (col >> c.bits)]];
      const int code = g[0].decode(br_);
      if (code < 256) {
        const uint32_t red = g[1].decode(br_), blue = g[2].decode(br_), alpha = g[3].decode(br_);
        px[pos] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        insert(px[pos++]);
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dcode = copy_value(g[4].decode(br_));
        int dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int p = kCodeToPlane[dcode - 1];
          dist = (p >> 4) * xsize + (8 - (p & 15));
          if (dist < 1) dist = 1;
        }
        if (pos < (size_t)dist || total - pos < (size_t)length) fail("bad VP8L backward reference");
        for (int i = 0; i < length; ++i, ++pos) {
          px[pos] = px[pos - dist];
          insert(px[pos]);
        }
      } else if (cache_bits && code < 256 + 24 + (1 << cache_bits)) {
        px[pos] = cache[code - 280];
        insert(px[pos++]);
      } else {
        fail("bad VP8L symbol");
      }
      if (eight_bit && pos < total && br_.eos()) fail("VP8L data ends early");
    }
  }

  static std::vector<uint32_t> inverse(const LTransform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out((size_t)w * h);
    if (t.type == 2) {  // subtract green
      for (size_t i = 0; i < out.size(); ++i) {
        const uint32_t a = in[i], g = (a >> 8) & 255;
        out[i] = (a & 0xff00ff00u) | ((((a >> 16) + g) & 255) << 16) | (((a & 255) + g) & 255);
      }
    } else if (t.type == 3) {  // color indexing, with pixels bundled in the green byte
      const int per_byte_bits = 8 >> t.bits, in_w = sub_sample(w, t.bits);
      const uint32_t mask = (1u << per_byte_bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = &in[(size_t)y * in_w];
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (src[x >> t.bits] >> 8) & 255;
          const uint32_t idx = (packed >> ((x & ((1 << t.bits) - 1)) * per_byte_bits)) & mask;
          out[(size_t)y * w + x] = t.data[idx];
        }
      }
    } else if (t.type == 1) {  // cross color
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = (int8_t)(m & 255), g2b = (int8_t)((m >> 8) & 255),
                       r2b = (int8_t)((m >> 16) & 255);
          const uint32_t a = in[(size_t)y * w + x];
          const int8_t green = (int8_t)(a >> 8);
          int red = (int)((a >> 16) & 255), blue = (int)(a & 255);
          red = (red + ((g2r * green) >> 5)) & 255;
          blue += (g2b * green) >> 5;
          blue = (blue + ((r2b * (int8_t)red) >> 5)) & 255;
          out[(size_t)y * w + x] = (a & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
    } else {  // predictor
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* o = &out[(size_t)y * w];
        const uint32_t* r = &in[(size_t)y * w];
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : o[x - 1];
          } else if (x == 0) {
            pred = o[x - (ptrdiff_t)w];
          } else {
            const int mode = (t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15;
            const uint32_t* up = o - w;
            // the top-right of the last column is the row's first pixel
            pred = predict(mode, o[x - 1], up[x], up[x + 1], up[x - 1]);
          }
          o[x] = add_pixels(r[x], pred);
        }
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------- VP8

// The boolean decoder of RFC 6386 section 7 as libwebp's bit_reader reads
// it on x86-64: 56 bits loaded at a time while 8 bytes remain, then a byte
// at a time; past the partition one zero byte, and eof. (How the bits are
// loaded decides what a damaged stream, whose value has left its range,
// decodes to: the value's excess then overflows the 64-bit register.)
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    buf = data;
    end = data + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (end - buf >= 8) {  // VP8LoadNewBytes: BITS = 56
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      value = in | (value << 56);
      bits += 56;
      buf += 7;
    } else if (buf < end) {  // VP8LoadFinalBytes
      bits += 8;
      value = *buf++ | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 7;
    for (uint32_t t = r; t > 1; t >>= 1) --shift;  // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

// --- the loop filters (dsp/dec.c)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `size` edge pixels from p, across the edge by hstride, along it by vstride
void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      do_filter2(p, hstride);
    else if (edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBData {
  int segment = 0, ymode = 0, uvmode = 0;
  bool i4x4 = false, skip = false;
  uint8_t imodes[16];
  int16_t coeffs[384];
  uint8_t code[24];  // libwebp's per-block transform: 3 full, 2 AC3, 1 DC, 0 none
};

class VP8Decoder {
 public:
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  std::vector<uint8_t> Y, U, V;  // mb_w * 16 (8) wide, filtered
  int y_stride = 0, uv_stride = 0;

  void decode(const uint8_t* data, size_t n) {
    if (n < 10) fail("truncated VP8 header");
    const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
    const bool key_frame = !(tag & 1);
    const int profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
    const uint32_t part0 = tag >> 5;
    if (profile > 3) fail("bad VP8 profile");
    if (!show) fail("VP8 frame not displayable");
    if (!key_frame) fail("VP8 frame is not a key frame");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("bad VP8 start code");
    width = ((data[7] << 8) | data[6]) & 0x3fff;
    height = ((data[9] << 8) | data[8]) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t size = n - 10;
    if (part0 > size) fail("bad VP8 partition length");
    br_.init(buf, part0);
    buf += part0;
    size -= part0;
    br_.bit(0x80);  // colorspace
    br_.bit(0x80);  // clamping type
    parse_segment_header();
    parse_filter_header();
    parse_partitions(buf, size);
    parse_quant();
    br_.bit(0x80);  // refresh entropy probabilities (ignored)
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br_.value_bits(8)
                                                                         : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.bit(0x80);
    if (use_skip_proba_) skip_p_ = br_.value_bits(8);
    if (br_.eof) fail("truncated VP8 frame header");
    decode_frame();
  }

 private:
  BoolReader br_, parts_[8];
  int num_parts_ = 1;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm_[4];
  FilterInfo fstrengths_[4][2];

  void parse_segment_header() {
    use_segment_ = br_.bit(0x80);
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {
        absolute_delta_ = br_.bit(0x80);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.bit(0x80) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.bit(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) segment_proba_[s] = br_.bit(0x80) ? (uint8_t)br_.value_bits(8) : 255;
    } else {
      update_map_ = false;
    }
    if (br_.eof) fail("cannot parse VP8 segment header");
  }

  void parse_filter_header() {
    simple_ = br_.bit(0x80);
    level_ = br_.value_bits(6);
    sharpness_ = br_.value_bits(3);
    use_lf_delta_ = br_.bit(0x80);
    if (use_lf_delta_ && br_.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.bit(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) fail("cannot parse VP8 filter header");
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    const uint8_t* sz = buf;
    const uint8_t* buf_end = buf + size;
    num_parts_ = 1 << br_.value_bits(2);
    const size_t last = (size_t)num_parts_ - 1;
    if (size < 3 * last) fail("cannot parse VP8 partitions");
    const uint8_t* start = buf + last * 3;
    size_t left = size - last * 3;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (start >= buf_end) fail("cannot parse VP8 partitions");
  }

  void parse_quant() {
    const int base_q0 = br_.value_bits(7);
    const int dqy1_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.bit(0x80) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.bit(0x80) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x 155 / 100
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  // frame_dec.c PrecomputeFilterStrengths
  void filter_strengths() {
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      b.segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                               : br_.bit(segment_proba_[2]) + 2;
    } else {
      b.segment = 0;
    }
    b.skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
    b.i4x4 = !br_.bit(145);
    if (!b.i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM : B_HE) : (br_.bit(163) ? B_VE : B_DC);
      b.ymode = ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br_.bit(142) ? B_DC : !br_.bit(114) ? B_VE : br_.bit(183) ? B_TM : B_HE;
  }

  int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // tree_dec.c GetCoeffs: returns the position after the last nonzero
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      const int sv = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = (int16_t)(sv * dq[n > 0]);
    }
    return 16;
  }

  // tree_dec.c / vp8_dec.c ParseResiduals; nz contexts as libwebp keeps them
  void parse_residuals(MBData& b, BoolReader& br, uint8_t& top_nz, uint8_t& top_dc,
                       uint8_t& left_nz, uint8_t& left_dc) {
    const Quant& q = dqm_[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    int first, ac_type;
    if (!b.i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_dc + left_dc;
      const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
      top_dc = left_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    bool any = false;
    uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        b.code[y * 4 + x] = (uint8_t)(nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
        any |= b.code[y * 4 + x] != 0;
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      tnz = (uint8_t)(top_nz >> (4 + ch));
      lnz = (uint8_t)(left_nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          b.code[16 + ch * 2 + y * 2 + x] = (uint8_t)(nz > 3 ? 3 : nz > 1 ? 2 : dst[0] != 0);
          any |= b.code[16 + ch * 2 + y * 2 + x] != 0;
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      out_t |= (uint32_t)(tnz << 4) << ch;
      out_l |= (uint32_t)(lnz & 0xf0) << ch;
    }
    top_nz = (uint8_t)out_t;
    left_nz = (uint8_t)out_l;
    b.skip = !any;
  }

  void decode_frame() {
    if (filter_type_ > 0) filter_strengths();
    y_stride = mb_w * 16;
    uv_stride = mb_w * 8;
    Y.assign((size_t)y_stride * mb_h * 16, 0);
    U.assign((size_t)uv_stride * mb_h * 8, 0);
    V.assign((size_t)uv_stride * mb_h * 8, 0);
    std::vector<uint8_t> intra_t((size_t)4 * mb_w, B_DC);
    std::vector<uint8_t> top_nz(mb_w, 0), top_dc(mb_w, 0);
    std::vector<uint8_t> top_y((size_t)16 * mb_w), top_u((size_t)8 * mb_w), top_v((size_t)8 * mb_w);
    std::vector<MBData> row(mb_w);
    std::vector<FilterInfo> finfo((size_t)mb_w * mb_h);
    uint8_t ws[YUV_SIZE];
    std::memset(ws, 0, sizeof(ws));
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        parse_intra_mode(row[mb_x], &intra_t[(size_t)4 * mb_x], intra_l);
      if (br_.eof) fail("premature end of VP8 partition 0");
      BoolReader& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t left_nz = 0, left_dc = 0;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& b = row[mb_x];
        bool skip = b.skip;
        if (!skip) {
          parse_residuals(b, tokens, top_nz[mb_x], top_dc[mb_x], left_nz, left_dc);
          skip = b.skip;
        } else {
          left_nz = top_nz[mb_x] = 0;
          if (!b.i4x4) left_dc = top_dc[mb_x] = 0;
          std::memset(b.code, 0, sizeof(b.code));
          std::memset(b.coeffs, 0, sizeof(b.coeffs));
        }
        if (filter_type_ > 0) {
          FilterInfo f = fstrengths_[b.segment][b.i4x4];
          f.inner = f.inner || !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        if (tokens.eof) fail("premature end of VP8 token partition");
      }
      reconstruct_row(mb_y, row, ws, top_y, top_u, top_v);
    }
    if (filter_type_ > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[(size_t)mb_y * mb_w + mb_x]);
  }

  // frame_dec.c ReconstructRow, through libwebp's work buffer
  void reconstruct_row(int mb_y, std::vector<MBData>& row, uint8_t* ws, std::vector<uint8_t>& top_y,
                       std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
    uint8_t* const y_dst = ws + Y_OFF;
    uint8_t* const u_dst = ws + U_OFF;
    uint8_t* const v_dst = ws + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& b = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, &top_y[(size_t)16 * mb_x], 16);
        std::memcpy(u_dst - BPS, &top_u[(size_t)8 * mb_x], 8);
        std::memcpy(v_dst - BPS, &top_v[(size_t)8 * mb_x], 8);
      }
      const int16_t* coeffs = b.coeffs;
      if (b.i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, top_y[(size_t)16 * mb_x + 15], 4);
          else
            std::memcpy(top_right, &top_y[(size_t)16 * (mb_x + 1)], 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, b.imodes[n]);
          luma_transform(b.code[n], coeffs + n * 16, dst);
        }
      } else {
        int mode = b.ymode;
        if (mode == B_DC) mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                           : (mb_y == 0 ? DC_NOTOP : B_DC);
        predict_block(y_dst, 16, mode);
        for (int n = 0; n < 16; ++n)
          luma_transform(b.code[n], coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      int uvmode = b.uvmode;
      if (uvmode == B_DC) uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                             : (mb_y == 0 ? DC_NOTOP : B_DC);
      predict_block(u_dst, 8, uvmode);
      predict_block(v_dst, 8, uvmode);
      chroma_transform(&b.code[16], coeffs + 256, u_dst);
      chroma_transform(&b.code[20], coeffs + 320, v_dst);
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[(size_t)16 * mb_x], y_dst + 15 * BPS, 16);
        std::memcpy(&top_u[(size_t)8 * mb_x], u_dst + 7 * BPS, 8);
        std::memcpy(&top_v[(size_t)8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&Y[(size_t)(mb_y * 16 + j) * y_stride + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(&U[(size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8], u_dst + j * BPS, 8);
        std::memcpy(&V[(size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  // frame_dec.c DoFilter
  void filter_mb(int mb_x, int mb_y, const FilterInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = &Y[(size_t)mb_y * 16 * y_stride + mb_x * 16];
    const int ys = y_stride;
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, 16, limit);
      if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
      return;
    }
    const int uvs = uv_stride;
    uint8_t* u = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u, 1, uvs, 8, limit + 4, il, hev_t, true);
      filter_loop(v, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u + 4, 1, uvs, 8, limit, il, hev_t, false);
      filter_loop(v + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u, uvs, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
      filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
  }
};

// ---------------------------------------------------------------- alpha

// ALPH (alpha_dec.c): a header byte (method, filter, pre-processing), then
// raw or VP8L-coded values, unfiltered row by row
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t n, int width, int height) {
  if (n <= 1) fail("empty ALPH chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved) fail("bad ALPH header");
  const size_t count = (size_t)width * height;
  std::vector<uint8_t> a(count);
  if (method == 0) {
    if (n - 1 < count) fail("truncated ALPH data");
    std::memcpy(a.data(), data + 1, count);
  } else {
    VP8LDecoder dec;
    std::vector<uint32_t> argb = dec.decode(data + 1, n - 1, 0, width, height, true);
    for (size_t i = 0; i < count; ++i) a[i] = (uint8_t)(argb[i] >> 8);
  }
  for (int y = 0; y < height; ++y) {  // dsp/filters.c unfilters
    uint8_t* row = &a[(size_t)y * width];
    const uint8_t* prev = y ? row - width : nullptr;
    if (filter == 0) continue;
    if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < width; ++x) {
        const int top = prev[x];
        left = (uint8_t)(row[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = (uint8_t)left;
      }
    }
  }
  return a;
}

// ---------------------------------------------------------------- output

// dsp/yuv.h: 14-bit fixed point
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// dsp/upsampling.c's fancy upsampler, one output row: `near` is the chroma
// row nearest it (weight 3), `far` the other (weight 1); u and v packed as
// u | v << 16
void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int len, uint8_t* dst) {
  auto load = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(nu[0], nv[0]), l = load(fu[0], fv[0]);
  uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
  yuv_to_rgba(y[0], uv0 & 0xff, uv0 >> 16, dst);
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t = load(nu[x], nv[x]), uv = load(fu[x], fv[x]);
    const uint32_t avg = tl + t + l + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl + uv)) >> 3;
    const uint32_t a = (diag_12 + tl) >> 1, b = (diag_03 + t) >> 1;
    yuv_to_rgba(y[2 * x - 1], a & 0xff, a >> 16, dst + 4 * (2 * x - 1));
    yuv_to_rgba(y[2 * x], b & 0xff, b >> 16, dst + 4 * (2 * x));
    tl = t;
    l = uv;
  }
  if (!(len & 1)) {
    uv0 = (3 * tl + l + 0x00020002u) >> 2;
    yuv_to_rgba(y[len - 1], uv0 & 0xff, uv0 >> 16, dst + 4 * (len - 1));
  }
}

// ---------------------------------------------------------------- container

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

struct Chunk {
  uint32_t fourcc = 0;
  size_t start = 0, payload = 0, size = 0, next = 0;  // size: the payload's declared size
};

inline uint32_t fourcc(const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); }

struct Frame {
  int x = 0, y = 0, width = 0, height = 0;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  bool alpha_after_image = false, lossless = false, complete = false;
  const uint8_t* image = nullptr;
  size_t image_size = 0;   // the chunk's declared size
  size_t image_data = 0;   // what the decoder reads: the payload with its pad byte
};

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;

class Container {
 public:
  Container(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  bool alpha_flag = false;  // PIL's mode is RGBA (else RGBX: alpha shown as 255)

  // the first frame and the canvas, as WebPAnimDecoderNew validates them:
  // WebPGetFeatures of the whole file, then WebPDemux
  Frame first_frame(int* canvas_w, int* canvas_h) {
    features_check();
    if (n_ < 20 || std::memcmp(d_, "RIFF", 4) || std::memcmp(d_ + 8, "WEBP", 4)) fail("not a WebP file");
    const uint32_t riff_size = le32(d_ + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) fail("bad RIFF size");
    if ((size_t)riff_size + 8 > n_) fail("truncated WebP file");
    end_ = (size_t)riff_size + 8;
    size_t pos = 12;
    if (end_ < pos + 8) fail("truncated WebP file");
    const uint32_t first = le32(d_ + pos);
    if (first == fourcc("VP8X")) return extended(pos, canvas_w, canvas_h);
    if (first != fourcc("VP8 ") && first != fourcc("VP8L")) fail("not a WebP image");
    Frame f;
    store_frame(pos, end_, &f);
    if (!f.complete) fail("bad WebP image");
    f.alpha = nullptr;  // WebPDemux drops the alpha of a file without the VP8X alpha flag
    alpha_flag = f.lossless && ((f.image[4] >> 4) & 1);  // the VP8L header's alpha bit
    *canvas_w = f.width;
    *canvas_h = f.height;
    return f;
  }

 private:
  const uint8_t* d_;
  size_t n_, end_ = 0;

  // dec/webp_dec.c ParseHeadersInternal as WebPGetFeatures runs it (without
  // all the data in hand: running out of it after a VP8X chunk passes): the
  // RIFF header, a VP8X chunk of exactly 10 bytes, for a still image the
  // chunks before its image within the RIFF size, the image chunk's header
  // and VP8GetInfo / VP8LGetInfo, and the image's size equal to the canvas
  void features_check() const {
    if (n_ < 12) fail("truncated WebP file");
    size_t pos = 0, riff = 0;
    if (!std::memcmp(d_, "RIFF", 4)) {
      if (std::memcmp(d_ + 8, "WEBP", 4)) fail("not a WebP file");
      riff = le32(d_ + 4);
      if (riff < 12 || riff > kMaxChunkPayload) fail("bad RIFF size");
      pos = 12;
    }
    if (n_ - pos < 8) fail("truncated WebP file");
    bool vp8x = false;
    int canvas_w = 0, canvas_h = 0;
    if (!std::memcmp(d_ + pos, "VP8X", 4)) {
      if (le32(d_ + pos + 4) != 10) fail("bad VP8X chunk size");
      if (n_ - pos < 18) fail("truncated WebP file");
      const uint32_t flags = le32(d_ + pos + 8);
      canvas_w = (int)le24(d_ + pos + 12) + 1;
      canvas_h = (int)le24(d_ + pos + 15) + 1;
      if ((uint64_t)canvas_w * canvas_h >= (1ull << 32)) fail("WebP canvas too large");
      if (!riff) fail("VP8X without RIFF");
      if (flags & 0x02) return;  // an animation: the features are the VP8X chunk's
      vp8x = true;
      pos += 18;
    }
    auto short_of_data = [&]() {  // NOT_ENOUGH_DATA: passes after a VP8X chunk
      if (!vp8x) fail("truncated WebP file");
    };
    if (n_ - pos < 4) return short_of_data();
    if (vp8x) {  // ParseOptionalChunks
      uint64_t total = 4 + 8 + 10;
      for (;;) {
        if (n_ - pos < 8) return short_of_data();
        const uint32_t size = le32(d_ + pos + 4);
        if (size > kMaxChunkPayload) fail("bad WebP chunk size");
        const uint64_t disk = (8 + (uint64_t)size + 1) & ~1ull;
        total += disk;
        if (riff > 0 && total > riff) fail("WebP chunk past the RIFF size");
        if (!std::memcmp(d_ + pos, "VP8 ", 4) || !std::memcmp(d_ + pos, "VP8L", 4)) break;
        if (n_ - pos < disk) return short_of_data();
        pos += disk;
      }
    }
    if (n_ - pos < 8) return short_of_data();
    const bool is_vp8 = !std::memcmp(d_ + pos, "VP8 ", 4), is_vp8l = !std::memcmp(d_ + pos, "VP8L", 4);
    if (!is_vp8 && !is_vp8l) fail("no VP8 or VP8L chunk");
    const uint32_t size = le32(d_ + pos + 4);
    if (riff >= 12 && size > riff - 12) fail("VP8 chunk past the RIFF size");
    pos += 8;
    int w, h;
    if (is_vp8) {
      if (n_ - pos < 10) return short_of_data();
      const uint8_t* p = d_ + pos;
      const uint32_t bits = le24(p);
      if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a || (bits & 1) || ((bits >> 1) & 7) > 3 ||
          !((bits >> 4) & 1) || (bits >> 5) >= size)
        fail("bad VP8 header");
      w = ((p[7] << 8) | p[6]) & 0x3fff;
      h = ((p[9] << 8) | p[8]) & 0x3fff;
      if (!w || !h) fail("empty VP8 frame");
    } else {
      if (n_ - pos < 5) return short_of_data();
      const uint8_t* p = d_ + pos;
      if (p[0] != 0x2f || (p[4] >> 5) != 0) fail("bad VP8L header");
      const uint32_t bits = le32(p + 1);
      w = (int)(bits & 0x3fff) + 1;
      h = (int)((bits >> 14) & 0x3fff) + 1;
    }
    if (vp8x && (w != canvas_w || h != canvas_h)) fail("image size is not the canvas size");
  }

  Chunk chunk_at(size_t pos, size_t limit) const {
    if (pos + 8 > limit) fail("truncated WebP chunk");
    Chunk c;
    c.fourcc = le32(d_ + pos);
    c.size = le32(d_ + pos + 4);
    if (c.size > kMaxChunkPayload) fail("bad WebP chunk size");
    const size_t padded = c.size + (c.size & 1);
    c.start = pos;
    c.payload = pos + 8;
    c.next = c.payload + padded;
    if (c.next > limit) fail("truncated WebP chunk");
    return c;
  }

  // demux.c StoreFrame: an optional ALPH, then VP8 or VP8L, from pos
  size_t store_frame(size_t pos, size_t limit, Frame* f) {
    int alpha_chunks = 0, image_chunks = 0;
    while (pos + 8 <= limit) {
      const Chunk c = chunk_at(pos, limit);
      if (c.fourcc == fourcc("ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha = d_ + c.payload;
        f->alpha_size = c.size;
        f->alpha_after_image = image_chunks > 0;
      } else if (c.fourcc == fourcc("VP8L") && alpha_chunks) {
        fail("VP8L after ALPH");  // StoreFrame refuses it before looking for a first image
      } else if ((c.fourcc == fourcc("VP8 ") || c.fourcc == fourcc("VP8L")) && image_chunks == 0) {
        ++image_chunks;
        f->lossless = c.fourcc == fourcc("VP8L");
        f->image = d_ + c.payload;
        f->image_size = c.size;
        f->image_data = c.next - c.payload;
        features(*f);
        f->complete = true;
      } else {
        break;
      }
      pos = c.next;
      if (pos != end_ && end_ - pos < 8) fail("truncated WebP chunk");  // WebPDemux waits for more
    }
    return pos;
  }

  // WebPGetFeatures of the image chunk: VP8GetInfo / VP8LGetInfo
  void features(Frame& f) const {
    const uint8_t* p = f.image;
    const size_t n = f.image_data;
    if (f.lossless) {
      if (n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) fail("bad VP8L header");
      const uint32_t bits = le32(p + 1);
      f.width = (int)(bits & 0x3fff) + 1;
      f.height = (int)((bits >> 14) & 0x3fff) + 1;
      return;
    }
    if (n < 10 || p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail("bad VP8 header");
    const uint32_t bits = le24(p);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= f.image_size)
      fail("bad VP8 frame tag");
    f.width = ((p[7] << 8) | p[6]) & 0x3fff;
    f.height = ((p[9] << 8) | p[8]) & 0x3fff;
    if (!f.width || !f.height) fail("empty VP8 frame");
  }

  Frame extended(size_t pos, int* canvas_w, int* canvas_h) {
    const Chunk x = chunk_at(pos, end_);
    if (x.size < 10) fail("bad VP8X chunk");
    const int flags = d_[x.payload];
    if (flags & ~0x3e) fail("unknown VP8X flags");
    alpha_flag = flags & 0x10;
    const bool animation = flags & 0x02;
    *canvas_w = (int)le24(d_ + x.payload + 4) + 1;
    *canvas_h = (int)le24(d_ + x.payload + 7) + 1;
    if ((uint64_t)*canvas_w * *canvas_h >= (1ull << 32)) fail("WebP canvas too large");
    pos = x.next;
    bool have_anim = false;
    Frame first;
    bool found = false;
    while (pos < end_) {
      if (pos + 8 > end_) fail("truncated WebP chunk");  // 1-7 bytes left: WebPDemux waits
      const Chunk c = chunk_at(pos, end_);
      if (c.fourcc == fourcc("VP8X")) fail("a second VP8X chunk");
      if (c.fourcc == fourcc("ALPH") || c.fourcc == fourcc("VP8 ") || c.fourcc == fourcc("VP8L")) {
        if (have_anim || animation || found) fail("a still image where WebPDemux refuses it");
        Frame f;
        pos = store_frame(pos, end_, &f);
        if (!f.complete) fail("incomplete WebP image");
        if (!(flags & 0x10)) f.alpha = nullptr;  // no alpha flag: the ALPH chunk is dropped
        if (f.alpha && f.alpha_after_image) fail("ALPH after the image");
        if (f.width != *canvas_w || f.height != *canvas_h) fail("image size is not the canvas size");
        first = f;
        found = true;
        continue;
      }
      const size_t padded = c.next - c.payload;
      if (c.fourcc == fourcc("ANIM")) {
        if (padded < 6) fail("bad ANIM chunk");
        have_anim = true;
      } else if (c.fourcc == fourcc("ANMF")) {
        if (!have_anim) fail("ANMF before ANIM");
        if (padded < 16) fail("bad ANMF chunk");
        const uint8_t* h = d_ + c.payload;
        Frame f;
        f.x = 2 * (int)le24(h);
        f.y = 2 * (int)le24(h + 3);
        const uint64_t w = le24(h + 6) + 1ull, hh = le24(h + 9) + 1ull;
        if (w * hh >= (1ull << 32)) fail("WebP frame too large");
        // demux.c ParseAnimationFrame: StoreFrame reads on from the frame's
        // header, past the ANMF if need be, and the parser goes on where it
        // stopped; reading past the ANMF's payload is an error
        const size_t after = store_frame(c.payload + 16, end_, &f);
        if (after - c.payload > padded) fail("bad ANMF chunk");
        pos = after;
        if (animation && (f.alpha || f.image)) {
          if (!f.complete) fail("incomplete WebP frame");
          if (f.alpha && f.alpha_after_image) fail("ALPH after the image");
          if (f.x + f.width > *canvas_w || f.y + f.height > *canvas_h) fail("frame outside the canvas");
          if (!found) {
            first = f;
            found = true;
          }
        }
        continue;
      }
      pos = c.next;
    }
    if (!found) fail("no WebP frame");
    return first;
  }
};

void decode_frame(const Frame& f, int canvas_w, uint8_t* canvas) {
  const int w = f.width, h = f.height;
  uint8_t* origin = canvas + ((size_t)f.y * canvas_w + f.x) * 4;
  if (f.lossless) {
    // after the 40-bit header: signature, width - 1, height - 1, alpha, version
    VP8LDecoder dec;
    std::vector<uint32_t> argb = dec.decode(f.image, f.image_data, 40, w, h, false);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t a = argb[(size_t)y * w + x];
        uint8_t* o = origin + ((size_t)y * canvas_w + x) * 4;
        o[0] = (uint8_t)(a >> 16);
        o[1] = (uint8_t)(a >> 8);
        o[2] = (uint8_t)a;
        o[3] = (uint8_t)(a >> 24);
      }
    return;
  }
  VP8Decoder dec;
  dec.decode(f.image, f.image_data);
  if (dec.width != w || dec.height != h) fail("VP8 frame size changed");
  std::vector<uint8_t> alpha;
  if (f.alpha) alpha = decode_alpha(f.alpha, f.alpha_size, w, h);
  std::vector<uint8_t> line((size_t)w * 4);
  const int uv_h = (h + 1) / 2;
  for (int y = 0; y < h; ++y) {
    const int near = y >> 1;
    int far = (y & 1) ? (y + 1) >> 1 : (y - 1) >> 1;
    far = std::min(std::max(far, 0), uv_h - 1);
    const uint8_t* yrow = &dec.Y[(size_t)y * dec.y_stride];
    upsample_row(yrow, &dec.U[(size_t)near * dec.uv_stride], &dec.V[(size_t)near * dec.uv_stride],
                 &dec.U[(size_t)far * dec.uv_stride], &dec.V[(size_t)far * dec.uv_stride], w,
                 line.data());
    uint8_t* o = origin + (size_t)y * canvas_w * 4;
    for (int x = 0; x < w; ++x) {
      std::memcpy(o + 4 * x, &line[4 * x], 3);
      o[4 * x + 3] = alpha.empty() ? 255 : alpha[(size_t)y * w + x];
    }
  }
}

void set_error(char* err, int errlen, const std::string& m) {
  if (errlen <= 0) return;
  const size_t k = std::min(m.size(), (size_t)errlen - 1);
  std::memcpy(err, m.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// WebP bytes -> the first frame on its canvas, RGBA uint8 (H, W, 4),
// allocated here (release with ape_webp_free).
int ape_webp_decode(const uint8_t* data, size_t len, uint8_t** out, int* width, int* height,
                    char* err, int errlen) {
  *out = nullptr;
  try {
    Container container(data, len);
    int cw = 0, ch = 0;
    Frame f = container.first_frame(&cw, &ch);
    if ((uint64_t)cw * ch > 178956970) fail("image size exceeds the decompression-bomb limit");
    std::vector<uint8_t> canvas((size_t)cw * ch * 4, 0);
    decode_frame(f, cw, canvas.data());
    if (!container.alpha_flag)
      for (size_t i = 3; i < canvas.size(); i += 4) canvas[i] = 255;
    *out = static_cast<uint8_t*>(std::malloc(canvas.size()));
    if (!*out) fail("out of memory");
    std::memcpy(*out, canvas.data(), canvas.size());
    *width = cw;
    *height = ch;
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.message);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

void ape_webp_free(void* p) { std::free(p); }

}  // extern "C"

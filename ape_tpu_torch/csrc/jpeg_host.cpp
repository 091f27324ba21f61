// JPEG codec for the host CPU, in plain C++17 (no library): the port's
// counterpart of PIL's JPEG plugin over libjpeg-turbo 3.1. The rule is the
// one JAX's reader follows through PIL: a file PIL decodes is decoded bit for
// bit; a file PIL refuses gets the "refused" status, which the reader turns
// into a dropped record.
//
// Decoder: frames of 8-bit samples with 1, 3 or 4 components, to RGB exactly
// as PIL's `Image.open(f).convert("RGB")` gives it with libjpeg-turbo's
// defaults:
//   * Huffman-coded baseline, extended sequential and progressive frames
//     (SOF0-2), arithmetic-coded sequential and progressive frames (SOF9,
//     SOF10: jdarith.c's QM decoder with T.81 Table D.2, DAC conditioning,
//     restart intervals, zeros past a marker), and lossless frames (SOF3:
//     jdlhuff.c and jdpred.c, predictors 1-7, the point transform, restarts
//     at MCU-row boundaries);
//   * the ISLOW integer IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2) in
//     the 16-bit arithmetic of the SIMD build that PIL ships (`idct_islow`);
//   * progressive files decoded whole before the output pass, as libjpeg
//     does outside buffered-image mode, with jdcoefct.c's block smoothing
//     (decompress_smooth_data: the first nine AC coefficients, and the DC
//     when no AC scan came, estimated from the 5x5 neighbourhood's DC
//     values) wherever smoothing_ok holds;
//   * fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
//     their alternating rounding biases, h1v2, and replication for every
//     other integral ratio and for a component at most 2 samples wide; the
//     context rows above and below a component replicate its first and last
//     real rows (jdmainct.c). Lossless frames replicate (no fancy filter);
//   * YCbCr -> RGB through jdcolor.c's tables (SCALEBITS 16); RGB (Adobe
//     transform 0) copied; gray repeated over the three channels;
//   * 4-component Adobe CMYK, and YCCK through ycck_cmyk_convert, read as
//     PIL reads them ("CMYK;I", then its cmyk2rgb).
// The colour space is libjpeg's guess (jdapimin.c default_decompress_parms):
// a JFIF marker, then the Adobe transform, then the component ids.
//
// Refused (status 3), as libjpeg-turbo or PIL's plugin refuse them: samples
// of another precision than 8 bits, 2 or more than 4 components,
// hierarchical frames (SOF5-7, SOF13-15, DHP, EXP), lossless arithmetic
// coding (SOF11), fractional sampling ratios, a height left to a DNL marker,
// a lossless frame that would need a colour conversion (YCbCr or YCCK), and
// an arithmetic-coded scan whose data runs past the end of the 64 KiB blocks
// PIL feeds libjpeg (whose arithmetic decoder cannot suspend for more input).
//
// Damaged entropy-coded data decodes as libjpeg-turbo 3.1 recovers it with a
// warning, which PIL ignores: a marker met inside a scan's data supplies
// zero bits for the MCU in progress, and the rest of its restart interval is
// skipped (a sequential frame's blocks stay zero, a progressive frame's keep
// the earlier scans' coefficients, block smoothing takes the previous scan's
// coefficient bits past the last good iMCU row, a lossless row restarts its
// predictor at mid-grey); restart markers out of place go through
// jpeg_resync_to_restart's three actions; a Huffman code no table holds
// costs 17 bits and decodes as 0; the arithmetic decoder stops its interval
// at a bad code; progression warnings pass; a sequential Huffman frame
// without Huffman tables takes the standard ones. PIL stops a single-scan image at its last row, so
// nothing after that scan is looked at unless libjpeg refuses it there. The
// entropy decoder keeps libjpeg's bit buffer exactly (filled to 57 bits;
// decode_mcu_fast's six bytes at a time where it has 512 bytes a block in
// hand) and the blocks PIL feeds it, because whether a file cut short fails
// depends on whether that read-ahead reaches the end of the file: there the
// "corrupt" status is PIL's "image file is truncated".
//
// Encoder: the bytes of PIL's `Image.fromarray(x).save(f)` with no options,
// for RGB and gray: JFIF 1.01 (density 1:1, no unit), quality 75 with
// force_baseline, 4:2:0 for RGB (jcsample.c h2v2_downsample), jccolor.c's
// RGB -> YCbCr, the ISLOW forward DCT (jfdctint.c), quantisation by
// jcdctmgr.c's reciprocals (16-bit DCTELEM, as in the SIMD build), the
// standard Huffman tables, libjpeg's marker order.
//
// C interface (ctypes): ape_jpeg_decode / ape_jpeg_encode return 0, 1
// (corrupt), 2 (unsupported: a form PIL encodes and the encoder does not)
// or 3 (refused as PIL refuses it) and write a message into `err`; their
// output buffers are released with ape_jpeg_free.

#include <algorithm>
#include <array>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  int code;  // 1 corrupt, 2 unsupported, 3 refused as PIL refuses it
  std::string message;
  bool truncation = false;  // the file ended where libjpeg waits for more
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{2, m}; }
[[noreturn]] void refused(const std::string& m) { throw Failure{3, m + " (PIL refuses it too)"}; }

// jpeg_natural_order: zigzag index -> natural index, with 16 extra entries
// (63) that absorb a run past the block in damaged data, as libjpeg's do.
constexpr std::array<int, 80> make_natural() {
  std::array<int, 80> order{};
  int idx = 0;
  for (int s = 0; s < 15; ++s) {
    int lo = s > 7 ? s - 7 : 0, hi = s < 7 ? s : 7;
    if (s % 2 == 0) {
      for (int r = hi; r >= lo; --r) order[idx++] = r * 8 + (s - r);
    } else {
      for (int r = lo; r <= hi; ++r) order[idx++] = r * 8 + (s - r);
    }
  }
  for (; idx < 80; ++idx) order[idx] = 63;
  return order;
}
constexpr std::array<int, 80> kNatural = make_natural();

// jstdhuff.c: the standard tables of the JPEG specification, K.3 (the encoder's, and
// the decoder's where a sequential Huffman scan uses table 0 or 1 and no DHT
// defined it)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// libjpeg's fixed-point constants (CONST_BITS 13)
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
constexpr int CONST_BITS = 13, PASS1_BITS = 2;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

// ---------------------------------------------------------------- decoder

struct HuffTable {
  bool defined = false, built = false;
  uint8_t bits[17];       // as the DHT segment gave them
  uint8_t raw_vals[256];
  int max_symbol = 0;  // the largest value, checked when a scan takes it as a DC table
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look8[256];  // 8-bit lookahead: (length << 8) | symbol, 0 for longer codes
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huff(HuffTable& t, const uint8_t bits[17], const uint8_t* vals) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = bits[l];
    if (p + i > 256) corrupt("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) corrupt("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t.valoffset[l] = p - (int32_t)huffcode[p];
      p += bits[l];
      t.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memcpy(t.vals, vals, numsymbols);
  std::memset(t.look8, 0, sizeof(t.look8));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      int lookbits = (int)(huffcode[p] << (8 - l));
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr) t.look8[lookbits++] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  t.max_symbol = 0;
  for (int i = 0; i < numsymbols; ++i) t.max_symbol = std::max(t.max_symbol, (int)vals[i]);
  t.defined = true;
}

// libjpeg's wait for more input: PIL feeds it the file in blocks, and a read
// past the bytes fed so far suspends the decoder, which PIL resumes with the
// next block (the MCU is decoded again from its start)
struct Suspend {};

[[noreturn]] void truncated() { throw Failure{1, "image file is truncated", true}; }

// Entropy-coded data as jdhuff.c reads it (jpeg_fill_bit_buffer, the
// HUFF_DECODE macros and decode_mcu_fast's): a 64-bit buffer whose low
// `bits` bits are unread, filled a byte at a time to at least 57 bits, with
// 0xFF 0x00 read as 0xFF. A marker stops the filling; a bit wanted past it
// reads as zero and sets `hit` (JWRN_HIT_MARKER: the decoder then skips the
// rest of the restart interval). A byte wanted past the bytes PIL has fed
// suspends, and past the end of the file is a truncation: PIL raises
// "image file is truncated" where libjpeg waits for more input.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  size_t* fed = nullptr;  // the end of the bytes PIL has fed libjpeg
  uint64_t buf = 0;       // get_buffer
  int bits = 0;           // bits_left
  int marker = 0;         // unread_marker: the code of the marker the data ran into
  size_t marker_pos = 0;  // its first 0xFF
  bool hit = false;

  void reset(size_t p) {
    pos = p;
    buf = 0;
    bits = 0;
    marker = 0;
    hit = false;
  }

  int next_byte() {
    if (pos >= std::min(*fed, n)) {
      if (*fed >= n) truncated();
      throw Suspend{};
    }
    return d[pos++];
  }

  // jpeg_fill_bit_buffer: load at least 57 bits unless a marker stops it
  void fill(int nbits) {
    if (!marker) {
      while (bits < 57) {
        const size_t at = pos;
        int c = next_byte();
        if (c == 0xFF) {
          do c = next_byte();
          while (c == 0xFF);
          if (c != 0) {
            marker = c;
            marker_pos = at;
            break;
          }
          c = 0xFF;
        }
        buf = (buf << 8) | (uint64_t)c;
        bits += 8;
      }
      if (!marker) return;
    }
    if (nbits > bits) {  // zeros past the marker
      hit = true;
      buf <<= 57 - bits;
      bits = 57;
    }
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    if (bits < k) fill(k);
    bits -= k;
    return (int)((buf >> bits) & ((1u << k) - 1));
  }

  // HUFF_DECODE with jpeg_huff_decode: 8 bits of lookahead, else bit by
  // bit; a code no table holds runs to the sentinel length 17 and decodes
  // as 0 (JWRN_HUFF_BAD_CODE)
  int decode(const HuffTable& t) {
    int nb;
    if (bits < 8) {
      fill(0);
      if (bits < 8) {
        nb = 1;
        return decode_rest(t, nb);
      }
    }
    const int e = t.look8[(buf >> (bits - 8)) & 0xFF];
    if (e) {
      bits -= e >> 8;
      return e & 0xFF;
    }
    return decode_rest(t, 9);
  }

  int decode_rest(const HuffTable& t, int l) {
    if (bits < l) fill(l);
    bits -= l;
    int32_t code = (int32_t)((buf >> bits) & ((1u << l) - 1));
    while (code > t.maxcode[l]) {
      if (bits < 1) fill(1);
      bits -= 1;
      code = (code << 1) | (int32_t)((buf >> bits) & 1);
      ++l;
    }
    if (l > 16) return 0;
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }

  // decode_mcu_fast's FILL_BIT_BUFFER_FAST and HUFF_DECODE_FAST: six bytes
  // once 16 bits or fewer are left; at a marker GET_BYTE sets `marker` and
  // loads a zero byte (the MCU is then decoded again by the slow path).
  void fill_fast() {
    if (bits > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = d[pos], c1 = d[pos + 1];
      ++pos;
      buf = (buf << 8) | (uint64_t)c0;
      bits += 8;
      if (c0 == 0xFF) {
        ++pos;
        if (c1 != 0) {  // a marker: a zero byte instead, and the pointer backed onto it
          marker = c1;
          pos -= 2;
          buf &= ~(uint64_t)0xFF;
        }
      }
    }
  }
  uint64_t shr(int k) const { return buf >> k; }
  int get_bits_fast(int k) {
    fill_fast();
    bits -= k;
    return (int)(shr(bits) & ((1u << k) - 1));
  }
  int decode_fast(const HuffTable& t) {
    fill_fast();
    const int e = t.look8[shr(bits - 8) & 0xFF];
    const int nb = e ? e >> 8 : 9;
    bits -= nb;
    if (nb <= 8) return e & 0xFF;
    int32_t s = (int32_t)(shr(bits) & ((1u << nb) - 1));
    int l = nb;
    while (s > t.maxcode[l]) {
      s <<= 1;
      bits -= 1;
      s |= (int32_t)(shr(bits) & 1);
      ++l;
    }
    return l > 16 ? 0 : t.vals[(s + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)((~0u) << s) + 1 : r; }

// T.81 Table D.2 (jaricom.c): Qe, Next_Index_MPS, Next_Index_LPS with
// Switch_MPS in bit 7; entry 113 is the fixed 0.5 estimate of signs and
// refinement bits
struct QeEntry {
  int32_t qe;
  uint8_t nmps, nlps;
};
constexpr QeEntry kQe[114] = {
    {0x5a1d, 1, 1 | 0x80},  {0x2586, 2, 14},        {0x1114, 3, 16},        {0x080b, 4, 18},
    {0x03d8, 5, 20},        {0x01da, 6, 23},        {0x00e5, 7, 25},        {0x006f, 8, 28},
    {0x0036, 9, 30},        {0x001a, 10, 33},       {0x000d, 11, 35},       {0x0006, 12, 9},
    {0x0003, 13, 10},       {0x0001, 13, 12},       {0x5a7f, 15, 15 | 0x80}, {0x3f25, 16, 36},
    {0x2cf2, 17, 38},       {0x207c, 18, 39},       {0x17b9, 19, 40},       {0x1182, 20, 42},
    {0x0cef, 21, 43},       {0x09a1, 22, 45},       {0x072f, 23, 46},       {0x055c, 24, 48},
    {0x0406, 25, 49},       {0x0303, 26, 51},       {0x0240, 27, 52},       {0x01b1, 28, 54},
    {0x0144, 29, 56},       {0x00f5, 30, 57},       {0x00b7, 31, 59},       {0x008a, 32, 60},
    {0x0068, 33, 62},       {0x004e, 34, 63},       {0x003b, 35, 32},       {0x002c, 9, 33},
    {0x5ae1, 37, 37 | 0x80}, {0x484c, 38, 64},       {0x3a0d, 39, 65},       {0x2ef1, 40, 67},
    {0x261f, 41, 68},       {0x1f33, 42, 69},       {0x19a8, 43, 70},       {0x1518, 44, 72},
    {0x1177, 45, 73},       {0x0e74, 46, 74},       {0x0bfb, 47, 75},       {0x09f8, 48, 77},
    {0x0861, 49, 78},       {0x0706, 50, 79},       {0x05cd, 51, 48},       {0x04de, 52, 50},
    {0x040f, 53, 50},       {0x0363, 54, 51},       {0x02d4, 55, 52},       {0x025c, 56, 53},
    {0x01f8, 57, 54},       {0x01a4, 58, 55},       {0x0160, 59, 56},       {0x0125, 60, 57},
    {0x00f6, 61, 58},       {0x00cb, 62, 59},       {0x00ab, 63, 61},       {0x008f, 32, 61},
    {0x5b12, 65, 65 | 0x80}, {0x4d04, 66, 80},       {0x412c, 67, 81},       {0x37d8, 68, 82},
    {0x2fe8, 69, 83},       {0x293c, 70, 84},       {0x2379, 71, 86},       {0x1edf, 72, 87},
    {0x1aa9, 73, 87},       {0x174e, 74, 72},       {0x1424, 75, 72},       {0x119c, 76, 74},
    {0x0f6b, 77, 74},       {0x0d51, 78, 75},       {0x0bb6, 79, 77},       {0x0a40, 48, 77},
    {0x5832, 81, 80 | 0x80}, {0x4d1c, 82, 88},       {0x438e, 83, 89},       {0x3bdd, 84, 90},
    {0x34ee, 85, 91},       {0x2eae, 86, 92},       {0x299a, 87, 93},       {0x2516, 71, 86},
    {0x5570, 89, 88 | 0x80}, {0x4ca9, 90, 95},       {0x44d9, 91, 96},       {0x3e22, 92, 97},
    {0x3824, 93, 99},       {0x32b4, 94, 99},       {0x2e17, 86, 93},       {0x56a8, 96, 95 | 0x80},
    {0x4f46, 97, 101},      {0x47e5, 98, 102},      {0x41cf, 99, 103},      {0x3c3d, 100, 104},
    {0x375e, 93, 99},       {0x5231, 102, 105},     {0x4c0f, 103, 106},     {0x4639, 104, 107},
    {0x415e, 99, 103},      {0x5627, 106, 105 | 0x80}, {0x50e7, 107, 108},  {0x4b85, 103, 109},
    {0x5597, 109, 110},     {0x504f, 107, 111},     {0x5a10, 111, 110 | 0x80}, {0x5522, 109, 112},
    {0x59eb, 111, 112 | 0x80}, {0x5a1d, 113, 113}};
constexpr uint8_t kFixedBin = 113;

// jdarith.c's arith_decode over the entropy-coded data from `pos`: a marker
// met inside the data is legal and supplies zeros from then on (its code is
// kept); the end of the file is a truncation.
struct ArithReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  int64_t c = 0, a = 0;
  int ct = -16;        // -16 before the first two bytes, -1 after a decoding error
  int marker = 0;      // the code of the marker the data ran into, 0 before one
  size_t marker_pos = 0;  // that marker's first byte

  // from `p`, or against a marker left unread there (`code` at `p`)
  void reset(size_t p, int code = 0) {
    pos = marker_pos = p;
    c = a = 0;
    ct = -16;
    marker = code;
  }

  int get_byte() {
    if (pos >= n) truncated();
    return d[pos++];
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          const size_t at = pos;
          data = get_byte();
          if (data == 0xFF) {
            marker_pos = at;
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    int64_t qe = e.qe;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ e.nmps);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ e.nlps);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ e.nlps);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ e.nmps);
      }
    }
    return sv >> 7;
  }
};

// PIL feeds libjpeg the file in blocks of this many bytes (ImageFile.MAXBLOCK)
constexpr size_t kPilBlock = 65536;

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // jdinput.c initial_setup
  int dw = 0, dh = 0;                             // downsampled width and height
  int bw = 0, bh = 0;                             // stored blocks (MCU-padded)
  std::vector<int16_t> coef;                      // DCT frames: bw * bh blocks of 64
  std::vector<int32_t> diff;                      // lossless frames: bw * bh differences
  std::vector<uint8_t> sample;                    // lossless frames: bw * bh samples
  uint16_t qt[64] = {};  // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];
  int prev_coef_bits[64];  // before the component's last progressive scan (jdphuff.c)
};

// natural positions of the coefficients block smoothing estimates: zigzag 1..9
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len) : d_(data), n_(len) {}
  void set_colour(int colour) { colour_ = colour; }
  int channels() const { return colour_ == kRaw ? ncomp_ : 3; }

  std::vector<uint8_t> decode(int* out_w, int* out_h) {
    if (n_ < 3 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (int t = 0; t < 16; ++t) {  // jdmarker.c get_soi: the default conditioning
      dc_l_[t] = 0;
      dc_u_[t] = 1;
      ac_k_[t] = 5;
    }
    bool done = false;
    while (!done) {
      int m;
      try {
        m = next_marker();
      } catch (const Failure& f) {
        // a single-scan image is complete once its scan is: PIL stops at its
        // last row, and libjpeg's wait for more input past it goes unseen
        if (f.truncation && image_done_) break;
        throw;
      }
      if (image_done_ && m == 0xDA) {  // get_sos reads the header, then consume_markers refuses it
        const int len = word();
        for (int i = 2; i < len; ++i) byte();
        corrupt("a second scan in a single-scan JPEG (EOI expected)");
      }
      try {
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA: read_sof(m); break;
        case 0xCB: refused("lossless arithmetic-coded JPEG (SOF11)");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: case 0xDE: case 0xDF:
          refused("hierarchical JPEG (differential frames, DHP, EXP)");
        case 0xC4: read_dht(); break;
        case 0xCC: read_dac(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD: read_dri(); break;
        case 0xDA: read_sos(); break;
        case 0xD9: done = true; break;
        case 0xE0: case 0xEE: read_app(m); break;
        case 0xDC: skip_segment(); break;  // DNL: libjpeg skips it
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01: break;  // parameterless
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
            skip_segment();
            break;
          }
          corrupt("unknown JPEG marker 0x" + hex(m));
      }
      } catch (const Failure& f) {
        if (f.truncation && image_done_) break;
        throw;
      }
      // the marker reader waits for PIL's next block where a segment crosses one
      while (pos_ > pil_end_) pil_end_ += kPilBlock;
    }
    if (!frame_) corrupt("no frame before EOI");
    if (scans_ == 0) corrupt("no scan before EOI");
    if (progressive_) smoothing_ = smoothing_ok();
    *out_w = width_;
    *out_h = height_;
    return output();
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  uint8_t dc_l_[16], dc_u_[16], ac_k_[16];  // DAC conditioning of each table
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool smoothing_ = false;
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int scans_ = 0;
  // jdhuff.c insufficient_data: the scan's data ran into a marker, so the
  // rest of the restart interval is skipped; and libjpeg-turbo's
  // last_good_iMCU_row, the last iMCU row begun with data in hand
  bool insufficient_ = false;
  int last_good_imcu_ = 0;
  // libjpeg's has_multiple_scans, set by the first scan; a single-scan image
  // is output as its scan is decoded, so nothing after that scan matters
  bool multi_scan_ = false, image_done_ = false;
  Component comp_[4];
  BitReader br_;
  ArithReader ar_;
  size_t pil_end_ = kPilBlock;  // the end of the bytes PIL has fed libjpeg so far

  static std::string hex(int v) {
    const char* digits = "0123456789ABCDEF";
    return std::string(1, digits[(v >> 4) & 15]) + digits[v & 15];
  }

  int byte() {
    if (pos_ >= n_) truncated();
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c next_marker: skip to 0xFF, skip fill bytes, return the code
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();  // garbage before a marker (libjpeg warns)
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // The segments are read as jdmarker.c reads them, a byte at a time: a
  // check fails where libjpeg's does, and a segment cut by the end of the
  // file is a truncation only where libjpeg reaches that end.

  // jdmarker.c skip_variable: a length below 2 skips nothing
  void skip_segment() {
    int len = word() - 2;
    if (len > 0) skip(len);
  }

  void skip(size_t len) {
    if (pos_ + len > n_) truncated();
    pos_ += len;
  }

  // get_interesting_appn: APP0 (JFIF) and APP14 (Adobe) look at their first
  // 14 bytes
  void read_app(int marker) {
    int len = word() - 2;
    const int look = len >= 14 ? 14 : len > 0 ? len : 0;
    uint8_t b[14];
    for (int i = 0; i < look; ++i) b[i] = (uint8_t)byte();
    len -= look;
    if (marker == 0xE0 && look >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif_ = true;
    if (marker == 0xEE && look >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (len > 0) skip(len);
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      --len;
      int pq = byte();
      int prec = pq >> 4, tq = pq & 15;
      if (tq > 3) corrupt("bad DQT table");
      for (int i = 0; i < 64; ++i) {
        int q = prec ? word() : byte();
        qt_[tq][kNatural[i]] = (uint16_t)q;
      }
      qt_defined_[tq] = true;
      len -= prec ? 128 : 64;
    }
    if (len != 0) corrupt("bad DQT length");
  }

  // get_dht: the tables are kept as read and built where a scan uses them
  void read_dht() {
    int len = word() - 2;
    while (len > 16) {
      int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = (uint8_t)byte();
        count += bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) corrupt("bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = (uint8_t)byte();
      len -= count;
      const bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index > 3) corrupt("bad DHT table");
      HuffTable& t = ac ? ac_[index] : dc_[index];
      std::memcpy(t.bits, bits, sizeof(bits));
      std::memcpy(t.raw_vals, vals, sizeof(vals));
      t.defined = true;
      t.built = false;
    }
    if (len != 0) corrupt("bad DHT length");
  }

  // jdmarker.c get_dac: DC tables 0-15 take (L, U), AC tables 16-31 take Kx
  void read_dac() {
    int len = word() - 2;
    while (len > 0) {
      int index = byte(), val = byte();
      len -= 2;
      if (index >= 32) corrupt("bad DAC table index");
      if (index >= 16) {
        ac_k_[index - 16] = (uint8_t)val;
      } else {
        dc_l_[index] = (uint8_t)(val & 15);
        dc_u_[index] = (uint8_t)(val >> 4);
        if (dc_l_[index] > dc_u_[index]) corrupt("bad DAC value");
      }
    }
    if (len != 0) corrupt("bad DAC length");
  }

  void read_dri() {
    if (word() != 4) corrupt("bad DRI length");
    restart_interval_ = word();
  }

  // the end of an SOF or SOS segment, whose bytes are then read one by one
  size_t segment_end() {
    int len = word();
    if (len < 2) corrupt("bad marker length");
    return pos_ + (size_t)len - 2;
  }

  void read_sof(int marker) {
    if (frame_) corrupt("a second frame header");
    size_t end = segment_end();
    int precision = byte();
    height_ = word();
    width_ = word();
    ncomp_ = byte();
    if (precision != 8) refused(std::to_string(precision) + "-bit JPEG samples");
    if (ncomp_ == 2 || ncomp_ > 4 || ncomp_ == 0) refused(std::to_string(ncomp_) + "-component JPEG");
    if (height_ == 0) refused("JPEG without its height (DNL)");
    if (width_ == 0) corrupt("empty JPEG image");
    if ((int64_t)width_ * height_ > 178956970)
      corrupt("image size exceeds the decompression-bomb limit");
    if (end - pos_ != (size_t)(3 * ncomp_)) corrupt("bad SOF length");
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = byte();
      int hv = byte();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte();
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) corrupt("bad sampling factors");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    lossless_ = marker == 0xC3;
    const int unit = lossless_ ? 1 : 8;  // a lossless "block" is one sample
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      if (hmax_ % k.h || vmax_ % k.v) refused("fractional JPEG sampling ratios");
      k.dw = (int)(((int64_t)width_ * k.h + hmax_ - 1) / hmax_);
      k.dh = (int)(((int64_t)height_ * k.v + vmax_ - 1) / vmax_);
      k.width_in_blocks = (int)(((int64_t)width_ * k.h + unit * hmax_ - 1) / (unit * hmax_));
      k.height_in_blocks = (int)(((int64_t)height_ * k.v + unit * vmax_ - 1) / (unit * vmax_));
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      if (lossless_) {
        k.diff.assign((size_t)k.bw * k.bh, 0);
        k.sample.assign((size_t)k.bw * k.bh, 0);
      } else {
        k.coef.assign((size_t)k.bw * k.bh * 64, 0);
      }
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = k.prev_coef_bits[i] = -1;
    }
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    frame_ = true;
  }

  void read_sos() {
    if (!frame_) corrupt("SOS before the frame header");
    size_t end = segment_end();
    int ns = byte();
    if (ns < 1 || ns > 4 || end - pos_ != (size_t)(2 * ns + 3)) corrupt("bad SOS");
    int idx[4], td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      idx[i] = -1;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) idx[i] = c;
      if (idx[i] < 0) corrupt("SOS names an unknown component");
      for (int j = 0; j < i; ++j)
        if (idx[j] == idx[i]) corrupt("SOS names a component twice");
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (scans_ == 0) multi_scan_ = ns < ncomp_ || progressive_;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += comp_[idx[i]].h * comp_[idx[i]].v;
      if (blocks > 10) corrupt("too many blocks in an MCU");
    }
    if (lossless_) {  // jdlossls.c start_pass_lossless
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) corrupt("bad lossless parameters");
      for (int i = 0; i < ns; ++i) {
        if (td[i] > 3) corrupt("bad Huffman table number");
        if (!dc_[td[i]].defined) corrupt("undefined Huffman table");
        table(dc_, td[i], true);
        const HuffTable& t = dc_[td[i]];
        if (t.max_symbol > 16) corrupt("bad Huffman table");
      }
      lossless_scan(ns, idx, td, ss, al);
      ++scans_;
      image_done_ = !multi_scan_;
      return;
    }
    for (int i = 0; i < ns; ++i) {  // jdinput.c latch_quant_tables
      Component& k = comp_[idx[i]];
      if (!k.latched) {
        if (!qt_defined_[k.tq]) corrupt("a component's quantization table is not defined");
        std::memcpy(k.qt, qt_[k.tq], sizeof(k.qt));
        k.latched = true;
      }
    }
    if (progressive_) {
      bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
      // an AC scan before the DC scan, or an Ah the earlier scans did not
      // leave, is only a warning to libjpeg (JWRN_BOGUS_PROGRESSION)
      for (int i = 0; i < ns; ++i) {
        Component& k = comp_[idx[i]];
        for (int c = std::min(ss, 1); c <= std::max(se, 9); ++c)
          k.prev_coef_bits[c] = scans_ > 0 ? k.coef_bits[c] : 0;
        for (int c = ss; c <= se; ++c) k.coef_bits[c] = al;
      }
    }
    if (arith_) {
      arith_scan(ns, idx, td, ta, ss, se, ah, al);
      ++scans_;
      image_done_ = !multi_scan_;
      return;
    }
    for (int i = 0; i < ns; ++i) {  // jdhuff.c / jdphuff.c start_pass: the tables used
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss != 0;
      if (need_dc) table(dc_, td[i], true);
      if (need_dc && dc_[td[i]].max_symbol > 15) corrupt("bad Huffman table");
      if (need_ac) table(ac_, ta[i], false);
    }
    scan(ns, idx, td, ta, ss, se, ah, al);
    ++scans_;
    image_done_ = !multi_scan_;
  }

  // jpeg_make_d_derived_tbl: a table number past 3, or a table no DHT
  // defined, is an error, except that jinit_huff_decoder gives a sequential
  // Huffman frame the standard tables 0 and 1 where none are defined
  // (jstdhuff.c, for Motion-JPEG); progressive and lossless frames get none
  void table(HuffTable* tables, int number, bool dc) {
    if (number > 3) corrupt("bad Huffman table number");
    HuffTable& t = tables[number];
    if (!t.defined) {
      if (number > 1 || progressive_ || lossless_) corrupt("undefined Huffman table");
      std::memcpy(t.bits, dc ? (number ? kDcChromBits : kDcLumBits) : (number ? kAcChromBits : kAcLumBits),
                  17);
      std::memset(t.raw_vals, 0, sizeof(t.raw_vals));
      if (dc)
        std::memcpy(t.raw_vals, kDcVals, sizeof(kDcVals));
      else
        std::memcpy(t.raw_vals, number ? kAcChromVals : kAcLumVals, 162);
      t.defined = true;
    }
    if (!t.built) {
      build_huff(t, t.bits, t.raw_vals);
      t.built = true;
    }
  }

  // the block (by, bx) of component idx[i] that MCU m's (v, h) block is, in
  // a scan of ns components of mx_count MCUs a row
  int16_t* block_at(int ns, const int* idx, int i, int64_t m, int mx_count, int v, int h) {
    Component& k = comp_[idx[i]];
    int my = (int)(m / mx_count), mx = (int)(m % mx_count);
    int by = ns == 1 ? my : my * k.v + v, bx = ns == 1 ? mx : mx * k.h + h;
    return &k.coef[((size_t)by * k.bw + bx) * 64];
  }

  void mcu_counts(int ns, const int* idx, int* mx_count, int* my_count) const {
    if (ns == 1) {
      *mx_count = comp_[idx[0]].width_in_blocks;
      *my_count = comp_[idx[0]].height_in_blocks;
    } else {
      *mx_count = mcux_;
      *my_count = mcuy_;
    }
  }

  void start_reader() {
    br_.d = d_;
    br_.n = n_;
    br_.fed = &pil_end_;
    br_.reset(pos_);
  }

  // where the marker reader goes on after a scan's entropy-coded data
  size_t end_of_data() { return br_.marker ? br_.marker_pos : resume_after(br_.pos); }

  size_t resume_after(size_t p) {
    try {
      return after_entropy(p);
    } catch (const Failure& f) {
      if (f.truncation && !multi_scan_) return n_;  // the image is out; what follows is unseen
      throw;
    }
  }

  void scan(int ns, const int* idx, const int* td, const int* ta, int ss, int se, int ah, int al) {
    start_reader();
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int mx_count, my_count;
    mcu_counts(ns, idx, &mx_count, &my_count);
    int64_t total = (int64_t)mx_count * my_count;
    int restarts_left = restart_interval_, next_rst = 0;
    insufficient_ = false;
    std::vector<int16_t*> blocks;
    std::vector<const HuffTable*> dcs, acs;
    std::vector<int> comp;
    std::vector<int16_t> saved;
    for (int64_t m = 0; m < total; ++m) {
      if (!insufficient_) last_good_imcu_ = imcu_row(ns, idx, m, mx_count);
      if (restart_interval_ && restarts_left == 0) {
        restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        restarts_left = restart_interval_;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      --restarts_left;
      // past the marker: the blocks keep what they hold (zeros in a
      // sequential frame, the earlier scans' coefficients in a progressive one)
      if (insufficient_) continue;
      blocks.clear();
      dcs.clear();
      acs.clear();
      comp.clear();
      for (int i = 0; i < ns; ++i) {
        const Component& k = comp_[idx[i]];
        int nv = ns == 1 ? 1 : k.v, nh = ns == 1 ? 1 : k.h;
        for (int v = 0; v < nv; ++v)
          for (int h = 0; h < nh; ++h) {
            blocks.push_back(block_at(ns, idx, i, m, mx_count, v, h));
            dcs.push_back(&dc_[td[i] & 3]);
            acs.push_back(&ac_[ta[i] & 3]);
            comp.push_back(i);
          }
      }
      // jdhuff.c decode_mcu: decode_mcu_fast where libjpeg has 512 bytes a
      // block in hand, no restart interval and no marker met, falling back
      // to the slow path at a marker; decoded again from the MCU's start
      // after a suspension, with PIL's next block fed
      saved.resize(blocks.size() * 64);
      for (size_t b = 0; b < blocks.size(); ++b) std::memcpy(&saved[b * 64], blocks[b], 128);
      const BitReader at_start = br_;
      const int pred_start[4] = {pred[0], pred[1], pred[2], pred[3]};
      const int eobrun_start = eobrun;
      for (;;) {
        try {
          if (!progressive_ && !restart_interval_ && !br_.marker &&
              std::min(pil_end_, n_) - br_.pos >= 512 * blocks.size()) {
            if (mcu_fast(blocks, dcs, acs, comp, pred)) break;
            br_ = at_start;
          }
          for (size_t b = 0; b < blocks.size(); ++b) {
            int16_t* blk = blocks[b];
            const int i = comp[b];
            if (!progressive_) {
              sequential_block(blk, *dcs[b], *acs[b], pred[i]);
            } else if (ss == 0) {
              if (ah == 0) {
                int s = br_.decode(*dcs[b]);
                if (s) s = extend(br_.get_bits(s), s);
                pred[i] = (int)((unsigned)pred[i] + (unsigned)s);
                blk[0] = (int16_t)(int)((unsigned)pred[i] << al);
              } else if (br_.get_bits(1)) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(blk, *acs[b], ss, se, al, eobrun);
            } else {
              ac_refine(blk, *acs[b], ss, se, al, eobrun);
            }
          }
          break;
        } catch (const Suspend&) {
          br_ = at_start;
          for (int c = 0; c < 4; ++c) pred[c] = pred_start[c];
          eobrun = eobrun_start;
          for (size_t b = 0; b < blocks.size(); ++b) std::memcpy(blocks[b], &saved[b * 64], 128);
          pil_end_ += kPilBlock;
        }
      }
      if (br_.hit) insufficient_ = true;
    }
    pos_ = end_of_data();
  }

  // decode_mcu_fast: false where it met a marker (its writes stay)
  bool mcu_fast(const std::vector<int16_t*>& blocks, const std::vector<const HuffTable*>& dcs,
                const std::vector<const HuffTable*>& acs, const std::vector<int>& comp, int* pred) {
    int p[4] = {pred[0], pred[1], pred[2], pred[3]};
    for (size_t b = 0; b < blocks.size(); ++b) {
      int16_t* blk = blocks[b];
      int s = br_.decode_fast(*dcs[b]);
      if (s) s = extend(br_.get_bits_fast(s), s);
      p[comp[b]] = (int)((unsigned)p[comp[b]] + (unsigned)s);
      blk[0] = (int16_t)p[comp[b]];
      for (int k = 1; k < 64; ++k) {
        s = br_.decode_fast(*acs[b]);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(br_.get_bits_fast(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (br_.marker) return false;
    for (int c = 0; c < 4; ++c) pred[c] = p[c];
    return true;
  }

  // the iMCU row MCU m of a scan lies in
  int imcu_row(int ns, const int* idx, int64_t m, int mx_count) const {
    int my = (int)(m / mx_count);
    return ns == 1 ? my / comp_[idx[0]].v : my;
  }

  void sequential_block(int16_t* blk, const HuffTable& dct, const HuffTable& act, int& pred) {
    int s = br_.decode(dct);
    if (s) s = extend(br_.get_bits(s), s);
    pred = (int)((unsigned)pred + (unsigned)s);
    blk[0] = (int16_t)pred;
    for (int k = 1; k < 64; ++k) {
      s = br_.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br_.get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(int16_t* blk, const HuffTable& t, int ss, int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = br_.decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        int v = extend(br_.get_bits(s), s);
        blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br_.get_bits(r);
        --eobrun;
        break;
      }
    }
  }

  void ac_refine(int16_t* blk, const HuffTable& t, int ss, int se, int al, int& eobrun) {
    int p1 = 1 << al, m1 = (int)((~0u) << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int s = br_.decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {  // a size other than 1 is JWRN_HUFF_BAD_CODE: read as 1
          s = br_.get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br_.get_bits(r);
          break;
        }
        do {
          int16_t* c = &blk[kNatural[k]];
          if (*c != 0) {
            if (br_.get_bits(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = &blk[kNatural[k]];
        if (*c != 0 && br_.get_bits(1) && (*c & p1) == 0)
          *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  // --- arithmetic-coded scans (jdarith.c)

  // F.1.4.4.1.2 / F.23-F.24: the magnitude of a nonzero value after its
  // sign, from bin st; x1: the first magnitude-category bin past the first
  // two (DC: the shared X1 at 20; AC: 189 or 217 by the conditioning).
  // Returns 0 on a magnitude overflow (libjpeg then stops the scan).
  int arith_magnitude(uint8_t* stats, uint8_t* st, int x1, bool dc, int* category) {
    int m = ar_.decode(st);
    if (m) {
      if (dc || ar_.decode(st)) {
        if (!dc) m <<= 1;
        st = stats + x1;
        while (ar_.decode(st)) {
          if ((m <<= 1) == 0x8000) return 0;
          st += 1;
        }
      }
    }
    *category = m;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar_.decode(st)) v |= m;
    return v + 1;
  }

  void arith_reset_stats(int ns, const int* td, const int* ta, int ss, int ah,
                         int* last_dc, int* dc_ctx) {
    for (int i = 0; i < ns; ++i) {
      if (!progressive_ || (ss == 0 && ah == 0)) {
        std::memset(dc_stats_[td[i]], 0, sizeof(dc_stats_[0]));
        last_dc[i] = 0;
        dc_ctx[i] = 0;
      }
      if (!progressive_ || ss) std::memset(ac_stats_[ta[i]], 0, sizeof(ac_stats_[0]));
    }
  }

  void arith_scan(int ns, const int* idx, const int* td, const int* ta, int ss, int se, int ah,
                  int al) {
    while (pos_ > pil_end_) pil_end_ += kPilBlock;  // the SOS segment is read whole first
    ar_.d = d_;
    ar_.n = n_;
    ar_.reset(pos_);
    int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    arith_reset_stats(ns, td, ta, ss, ah, last_dc, dc_ctx);
    uint8_t fixed = kFixedBin;
    int mx_count, my_count;
    mcu_counts(ns, idx, &mx_count, &my_count);
    int64_t total = (int64_t)mx_count * my_count;
    int restarts_left = restart_interval_, next_rst = 0;
    size_t extent = pos_;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_) {
        if (restarts_left == 0) {  // jdarith.c process_restart
          int unread;
          size_t p = resync(ar_.marker ? ar_.marker_pos : ar_.pos, next_rst, &unread);
          next_rst = (next_rst + 1) & 7;
          arith_reset_stats(ns, td, ta, ss, ah, last_dc, dc_ctx);
          ar_.reset(p, unread);  // a marker left in place supplies zeros
          extent = std::max(extent, p);
          restarts_left = restart_interval_;
        }
        --restarts_left;
      }
      last_good_imcu_ = imcu_row(ns, idx, m, mx_count);
      if (ar_.ct == -1) continue;  // a decoding error: the rest of the interval stays as is
      for (int i = 0; i < ns && ar_.ct != -1; ++i) {
        const Component& k = comp_[idx[i]];
        int nv = ns == 1 ? 1 : k.v, nh = ns == 1 ? 1 : k.h;
        for (int v = 0; v < nv && ar_.ct != -1; ++v)
          for (int h = 0; h < nh && ar_.ct != -1; ++h)
            arith_block(block_at(ns, idx, i, m, mx_count, v, h), td[i], ta[i], ss, se, ah, al,
                        last_dc[i], dc_ctx[i], &fixed);
      }
    }
    extent = std::max(extent, ar_.pos);
    if (extent > pil_end_)
      refused("arithmetic-coded JPEG whose scan data runs past PIL's 64 KiB read block "
              "(libjpeg's arithmetic decoder cannot wait for more input)");
    if (ar_.marker) {  // the marker the data ran into is the next one read
      pos_ = ar_.marker_pos;
    } else {
      pos_ = resume_after(ar_.pos);
    }
  }

  void arith_block(int16_t* blk, int dct, int act, int ss, int se, int ah, int al, int& last_dc,
                   int& dc_ctx, uint8_t* fixed) {
    if (!progressive_ || (ss == 0 && ah == 0)) {  // F.19: the DC difference
      uint8_t* stats = dc_stats_[dct];
      uint8_t* st = stats + dc_ctx;
      if (ar_.decode(st) == 0) {
        dc_ctx = 0;
      } else {
        int sign = ar_.decode(st + 1);
        int m;
        int v = arith_magnitude(stats, st + 2 + sign, 20, true, &m);
        if (!v) {
          ar_.ct = -1;
          return;
        }
        if (m < (int)((1L << dc_l_[dct]) >> 1))
          dc_ctx = 0;
        else if (m > (int)((1L << dc_u_[dct]) >> 1))
          dc_ctx = 12 + sign * 4;
        else
          dc_ctx = 4 + sign * 4;
        if (sign) v = -v;
        last_dc = (last_dc + v) & 0xFFFF;
      }
      blk[0] = (int16_t)(uint16_t)((uint32_t)last_dc << al);
      if (progressive_) return;
      ss = 1;
      se = 63;
    } else if (ss == 0) {  // DC refinement: the next bit of the two's complement
      if (ar_.decode(fixed)) blk[0] = (int16_t)(blk[0] | (1 << al));
      return;
    }
    uint8_t* stats = ac_stats_[act];
    if (ah == 0 || !progressive_) {  // F.20: the AC coefficients
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = stats + 3 * (k - 1);
        if (ar_.decode(st)) break;  // EOB
        while (ar_.decode(st + 1) == 0) {
          st += 3;
          if (++k > se) {
            ar_.ct = -1;  // spectral overflow
            return;
          }
        }
        int sign = ar_.decode(fixed);
        int m;
        int v = arith_magnitude(stats, st + 2, k <= ac_k_[act] ? 189 : 217, false, &m);
        if (!v) {
          ar_.ct = -1;
          return;
        }
        if (sign) v = -v;
        blk[kNatural[k]] = (int16_t)(int)((unsigned)v << al);
      }
      return;
    }
    // G.1.3.3: AC refinement
    int p1 = 1 << al, m1 = (int)((~0u) << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar_.decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = &blk[kNatural[k]];
        if (*c) {
          if (ar_.decode(st + 2)) *c = (int16_t)(*c < 0 ? *c + m1 : *c + p1);
          break;
        }
        if (ar_.decode(st + 1)) {
          *c = (int16_t)(ar_.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar_.ct = -1;
          return;
        }
      }
    }
  }

  // --- lossless scans (jdlhuff.c, jddiffct.c, jdpred.c)

  void lossless_scan(int ns, const int* idx, const int* td, int psv, int pt) {
    start_reader();
    size_t everything = n_;  // jdlhuff.c has no fast path: a suspension changes nothing
    br_.fed = &everything;
    int mx_count, my_count;
    mcu_counts(ns, idx, &mx_count, &my_count);
    const int per_restart = restart_interval_ ? restart_interval_ / mx_count : 0;
    int rows_left = per_restart, next_rst = 0;
    bool first_row[4] = {true, true, true, true};  // start_pass: the first-row undifferencer
    insufficient_ = false;
    for (int imcu = 0; imcu < mcuy_; ++imcu) {
      const bool last = imcu == mcuy_ - 1;
      int mcu_rows = 1;
      if (ns == 1) {
        const Component& k = comp_[idx[0]];
        mcu_rows = last ? (k.height_in_blocks % k.v ? k.height_in_blocks % k.v : k.v) : k.v;
      }
      for (int r = 0; r < mcu_rows; ++r) {
        if (restart_interval_) {
          if (rows_left == 0) {
            restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            rows_left = per_restart;
            for (int i = 0; i < 4; ++i) first_row[i] = true;
          }
        }
        // jdlhuff.c decode_mcus: past the marker an MCU row's differences are
        // zero and the undifferencer starts over (samples at mid-grey)
        const bool skip = insufficient_;
        if (skip)
          for (int i = 0; i < 4; ++i) first_row[i] = true;
        for (int mx = 0; mx < mx_count; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component& k = comp_[idx[i]];
            int nv = ns == 1 ? 1 : k.v, nh = ns == 1 ? 1 : k.h;
            for (int v = 0; v < nv; ++v)
              for (int h = 0; h < nh; ++h) {
                int y = ns == 1 ? imcu * k.v + r : imcu * k.v + v, x = ns == 1 ? mx : mx * k.h + h;
                int s = skip ? 0 : br_.decode(dc_[td[i]]);
                if (s == 16) {
                  s = 32768;
                } else if (s) {
                  s = extend(br_.get_bits(s), s);
                }
                k.diff[(size_t)y * k.bw + x] = s;
              }
          }
        }
        if (br_.hit) insufficient_ = true;
        if (restart_interval_) --rows_left;
      }
      // undifference and scale the component rows of this iMCU row
      for (int i = 0; i < ns; ++i) {
        Component& k = comp_[idx[i]];
        int rows = last ? (k.height_in_blocks % k.v ? k.height_in_blocks % k.v : k.v) : k.v;
        for (int r = 0; r < rows; ++r) {
          int y = imcu * k.v + r;
          undifference(k, y, psv, pt, first_row[idx[i]]);
          first_row[idx[i]] = false;
        }
      }
    }
    pos_ = end_of_data();
    br_.fed = &pil_end_;
  }

  static void undifference(Component& k, int y, int psv, int pt, bool first) {
    const int32_t* diff = &k.diff[(size_t)y * k.bw];
    int32_t* out = &k.diff[(size_t)y * k.bw];  // undifferenced in place
    const int32_t* prev = y > 0 ? &k.diff[(size_t)(y - 1) * k.bw] : nullptr;
    const int w = k.width_in_blocks;
    int ra;
    if (first) {
      ra = (diff[0] + (1 << (8 - pt - 1))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
    } else {
      int rb = prev[0], rc;
      out[0] = ra = (diff[0] + rb) & 0xFFFF;
      for (int x = 1; x < w; ++x) {
        rc = rb;
        rb = prev[x];
        int64_t p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = (int64_t)ra + rb - rc; break;
          case 5: p = ra + (((int64_t)rb - rc) >> 1); break;
          case 6: p = rb + (((int64_t)ra - rc) >> 1); break;
          default: p = ((int64_t)ra + rb) >> 1; break;
        }
        out[x] = ra = (int)((diff[x] + p) & 0xFFFF);
      }
    }
    uint8_t* s = &k.sample[(size_t)y * k.bw];
    for (int x = 0; x < w; ++x) s[x] = (uint8_t)(out[x] << pt);
  }

  // the marker that ends entropy-coded data: its position and code
  size_t marker_at(size_t p, int* code) {
    for (;;) {
      if (p >= n_) truncated();
      if (d_[p] != 0xFF) {
        ++p;  // extraneous bytes before the marker (libjpeg warns and skips)
        continue;
      }
      size_t q = p + 1;
      while (q < n_ && d_[q] == 0xFF) ++q;
      if (q >= n_) truncated();
      if (d_[q] != 0) {
        *code = d_[q];
        return p;
      }
      p = q + 1;
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart: the marker
  // that ends a restart interval, found from `p` (the data's next byte or a
  // marker the data ran into). The expected RSTn is swallowed; otherwise
  // libjpeg's recovery: a marker below SOF0, or one of the two restarts
  // before the one expected, is skipped and the next marker decides again
  // (action 2); any other non-RST marker, or one of the next two restarts,
  // is left in place (action 3: the interval reads as empty); any other RST
  // is discarded (action 1). Returns where the data resumes, with *unread
  // the marker left in place, else 0.
  size_t resync(size_t p, int expected, int* unread) {
    int code;
    size_t start = marker_at(p, &code);
    auto past = [this](size_t at) {
      while (d_[at] == 0xFF) ++at;
      return at + 1;
    };
    *unread = 0;
    if (code == 0xD0 + expected) return past(start);
    for (;;) {
      int action = 1;
      if (code < 0xC0) {
        action = 2;
      } else if (code < 0xD0 || code > 0xD7) {
        action = 3;
      } else {
        const int r = code - 0xD0;
        if (r == ((expected + 1) & 7) || r == ((expected + 2) & 7))
          action = 3;
        else if (r == ((expected - 1) & 7) || r == ((expected - 2) & 7))
          action = 2;
      }
      if (action == 1) return past(start);
      if (action == 3) {
        *unread = code;
        return start;
      }
      start = marker_at(past(start), &code);
    }
  }

  // jdhuff.c process_restart: the bit buffer is dropped; insufficient_data
  // is cleared unless a marker was left in place
  void restart(int expected) {
    int unread;
    const size_t p = resync(br_.marker ? br_.marker_pos : br_.pos, expected, &unread);
    while (p > pil_end_) pil_end_ += kPilBlock;  // next_marker waits for PIL's blocks
    br_.reset(p);
    if (!unread) insufficient_ = false;
  }

  size_t after_entropy(size_t p) {
    int code;
    return marker_at(p, &code);  // next_marker reads it from here
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths when every component's DC is
  // known and any of a component's first ten coefficients is left unrefined
  bool smoothing_ok() {
    bool useful = false;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      if (!k.latched) return false;
      for (int pos : kSmoothPos)
        if (k.qt[pos] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  // --- output pass

  // jidctint.c's ISLOW IDCT as libjpeg-turbo's SIMD build computes it
  // (jsimd_idct_islow_sse2/avx2, the one PIL ships and runs): the same
  // constants and rounding, but in 16-bit lanes. The dequantised
  // coefficients are the low 16 bits of coefficient x quantizer; in0 + in4,
  // in0 - in4, in7 + in3 and in5 + in1 are 16-bit sums; each pass's outputs
  // saturate to int16 and the samples to -128..127 (no RANGE_MASK wrap);
  // the DC-only shortcut applies to the whole block (every AC row zero) and
  // shifts in 16 bits. On a file an encoder writes every intermediate fits
  // and this equals the C code; large coefficients or 16-bit tables tell
  // them apart.
  static inline int16_t sat16(int64_t v) {
    return (int16_t)(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
  }

  // one 8-point pass over 16-bit inputs: in[k * step], k = 0..7
  static void idct_pass(const int16_t* in, int step, int shift, int32_t out[8]) {
    int32_t in0 = in[0], in1 = in[step], in2 = in[2 * step], in3 = in[3 * step],
            in4 = in[4 * step], in5 = in[5 * step], in6 = in[6 * step], in7 = in[7 * step];
    int64_t tmp3 = (int64_t)in2 * (FIX_0_541196100 + FIX_0_765366865) + (int64_t)in6 * FIX_0_541196100;
    int64_t tmp2 = (int64_t)in2 * FIX_0_541196100 + (int64_t)in6 * (FIX_0_541196100 - FIX_1_847759065);
    int64_t tmp0 = (int64_t)(int16_t)(in0 + in4) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t)(int16_t)(in0 - in4) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    int64_t z3 = (int16_t)(in7 + in3), z4 = (int16_t)(in5 + in1);
    int64_t z3r = z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602;
    int64_t z4r = z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644);
    tmp0 = (int64_t)in7 * (FIX_0_298631336 - FIX_0_899976223) + (int64_t)in1 * -FIX_0_899976223 + z3r;
    tmp1 = (int64_t)in5 * (FIX_2_053119869 - FIX_2_562915447) + (int64_t)in3 * -FIX_2_562915447 + z4r;
    tmp2 = (int64_t)in5 * -FIX_2_562915447 + (int64_t)in3 * (FIX_3_072711026 - FIX_2_562915447) + z3r;
    tmp3 = (int64_t)in7 * -FIX_0_899976223 + (int64_t)in1 * (FIX_1_501321110 - FIX_0_899976223) + z4r;
    out[0] = sat16(descale(tmp10 + tmp3, shift));
    out[7] = sat16(descale(tmp10 - tmp3, shift));
    out[1] = sat16(descale(tmp11 + tmp2, shift));
    out[6] = sat16(descale(tmp11 - tmp2, shift));
    out[2] = sat16(descale(tmp12 + tmp1, shift));
    out[5] = sat16(descale(tmp12 - tmp1, shift));
    out[3] = sat16(descale(tmp13 + tmp0, shift));
    out[4] = sat16(descale(tmp13 - tmp0, shift));
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int16_t deq[64], ws[64];
    bool ac_zero = true;
    for (int i = 0; i < 64; ++i) {
      deq[i] = (int16_t)(uint16_t)((uint32_t)(int32_t)in[i] * q[i]);
      if (i >= 8 && in[i] != 0) ac_zero = false;
    }
    int32_t col[8];
    for (int c = 0; c < 8; ++c) {
      if (ac_zero) {
        int16_t dc = (int16_t)(uint16_t)((uint32_t)(uint16_t)deq[c] << PASS1_BITS);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
        continue;
      }
      idct_pass(deq + c, 8, CONST_BITS - PASS1_BITS, col);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = (int16_t)col[r];
    }
    for (int r = 0; r < 8; ++r) {
      idct_pass(ws + r * 8, 1, CONST_BITS + PASS1_BITS + 3, col);
      uint8_t* op = out + (size_t)r * stride;
      for (int c = 0; c < 8; ++c) op[c] = (uint8_t)(std::min(std::max(col[c], -128), 127) + 128);
    }
  }

  // jdcoefct.c decompress_smooth_data's estimate of one coefficient from
  // num = Q00 x (a weighted sum of DC values), clamped below 2^Al
  static void estimate(int16_t* ws, int pos, int al, int64_t q, int64_t num) {
    if (al == 0 || ws[pos] != 0) return;
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = (int16_t)pred;
  }

  // A component's samples: (height_in_blocks * 8, width_in_blocks * 8),
  // or a lossless component's (bh, bw)
  std::vector<uint8_t> samples(const Component& k, int* stride) const {
    if (lossless_) {
      *stride = k.bw;
      return k.sample;
    }
    int sw = k.width_in_blocks * 8, sh = k.height_in_blocks * 8;
    std::vector<uint8_t> plane((size_t)sw * sh);
    *stride = sw;
    if (!smoothing_) {
      for (int by = 0; by < k.height_in_blocks; ++by)
        for (int bx = 0; bx < k.width_in_blocks; ++bx)
          idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.qt,
                     &plane[(size_t)by * 8 * sw + (size_t)bx * 8], sw);
      return plane;
    }
    // decompress_smooth_data, over the iMCU rows as libjpeg walks them (its
    // image_block_row of the last iMCU row counts that row's own height)
    // the coefficient bits latched at the output pass; the iMCU rows past
    // last_good_iMCU_row (the last scan ran out of data there) take those
    // from before each component's last scan
    int prev_bits[64];
    for (int i = 0; i < 64; ++i) prev_bits[i] = i == 0 ? k.coef_bits[0] : scans_ > 1 ? k.prev_coef_bits[i] : -1;
    const int64_t q00 = k.qt[0];
    const int total = mcuy_, last_col = k.width_in_blocks - 1;
    auto dc = [&](int row, int col) { return (int64_t)k.coef[((size_t)row * k.bw + col) * 64]; };
    int16_t ws[64];
    for (int imcu = 0; imcu < total; ++imcu) {
      const int* bits = imcu > last_good_imcu_ ? prev_bits : k.coef_bits;
      bool change_dc = true;  // DC interpolation only where no AC scan came
      for (int i = 1; i < 10; ++i)
        if (bits[i] != -1) change_dc = false;
      int block_rows = imcu < total - 1 ? k.v
                                        : (k.height_in_blocks % k.v ? k.height_in_blocks % k.v : k.v);
      int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        int ibr = imcu * block_rows + br, row = imcu * k.v + br;
        int prev = ibr > 0 ? row - 1 : row;
        int rows[5] = {ibr > 1 ? row - 2 : prev, prev, row, 0, 0};
        rows[3] = ibr < image_block_rows - 1 ? row + 1 : row;
        rows[4] = ibr < image_block_rows - 2 ? row + 2 : rows[3];
        for (int col = 0; col <= last_col; ++col) {
          // D[r][j] is DC(5r + j + 1): rows above to below, columns left to
          // right, both clamped to the component's blocks
          int64_t D[5][5];
          for (int r = 0; r < 5; ++r)
            for (int j = 0; j < 5; ++j)
              D[r][j] = dc(rows[r], std::min(std::max(col + j - 2, 0), last_col));
          std::memcpy(ws, &k.coef[((size_t)row * k.bw + col) * 64], sizeof(ws));
          const int64_t DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3],
                        DC05 = D[0][4], DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2],
                        DC09 = D[1][3], DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
                        DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4], DC16 = D[3][0],
                        DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
                        DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                        DC25 = D[4][4];
          estimate(ws, 1, bits[1], k.qt[1], q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 +
               3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
          estimate(ws, 8, bits[2], k.qt[8], q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
               13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
               3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
          estimate(ws, 16, bits[3], k.qt[16], q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
          estimate(ws, 9, bits[4], k.qt[9], q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
               10 * DC07 - 10 * DC09)));
          estimate(ws, 2, bits[5], k.qt[2], q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
               2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
          if (change_dc) {
            estimate(ws, 3, bits[6], k.qt[3],
                     q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
            estimate(ws, 10, bits[7], k.qt[10],
                     q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
            estimate(ws, 17, bits[8], k.qt[17],
                     q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
            estimate(ws, 24, bits[9], k.qt[24],
                     q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
            int64_t num = q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            int pred = num >= 0 ? (int)(((q00 << 7) + num) / (q00 << 8))
                                : -(int)(((q00 << 7) - num) / (q00 << 8));
            ws[0] = (int16_t)pred;
          }
          idct_islow(ws, k.qt, &plane[(size_t)row * 8 * sw + (size_t)col * 8], sw);
        }
      }
    }
    return plane;
  }

  // jdsample.c: the component upsampled to (height_, width_)
  std::vector<uint8_t> upsampled(const Component& k) const {
    int sw;
    std::vector<uint8_t> in = samples(k, &sw);
    int he = hmax_ / k.h, ve = vmax_ / k.v;
    const int W = width_, H = height_, dw = k.dw, dh = k.dh;
    const bool fancy = !lossless_;  // do_fancy needs a DCT scaled size above 1
    std::vector<uint8_t> out((size_t)W * H);
    auto row = [&](int y) { return &in[(size_t)std::min(std::max(y, 0), dh - 1) * sw]; };
    if (he == 1 && ve == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[(size_t)y * W], row(y), W);
    } else if (fancy && he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> line((size_t)2 * dw);
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = row(y);
        uint8_t* op = line.data();
        int v = ip[0];
        op[0] = (uint8_t)v;
        op[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = ip[x] * 3;
          op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
          op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        op[2 * dw - 2] = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
        op[2 * dw - 1] = (uint8_t)v;
        std::memcpy(&out[(size_t)y * W], op, W);
      }
    } else if (fancy && he == 1 && ve == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int i = y >> 1;
        const uint8_t* p0 = row(i);
        const uint8_t* p1 = (y & 1) ? row(i + 1) : row(i - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* op = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) op[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
      }
    } else if (fancy && he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<uint8_t> line((size_t)2 * dw);
      for (int y = 0; y < H; ++y) {
        int i = y >> 1;
        const uint8_t* p0 = row(i);
        const uint8_t* p1 = (y & 1) ? row(i + 1) : row(i - 1);
        uint8_t* op = line.data();
        int thiscol = p0[0] * 3 + p1[0], nextcol = p0[1] * 3 + p1[1], lastcol;
        op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 2; x < dw; ++x) {
          nextcol = p0[x] * 3 + p1[x];
          op[2 * x - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * x - 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
        std::memcpy(&out[(size_t)y * W], op, W);
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < H; ++y) {
        const uint8_t* ip = row(y / ve);
        uint8_t* op = &out[(size_t)y * W];
        for (int x = 0; x < W; ++x) op[x] = ip[x / he];
      }
    }
    return out;
  }

  // the colour setting: kGuess as PIL's JPEG plugin leaves libjpeg to guess
  // (RGB out); as libtiff's JPEG codec sets it, kYcc (JPEGCOLORMODE_RGB:
  // YCbCr in, RGB out, whatever the markers say) or kRaw (JCS_UNKNOWN: the
  // components as stored, one channel each)
  static constexpr int kGuess = -1, kRaw = 0, kYcc = 1;
  int colour_ = kGuess;

  std::vector<uint8_t> output() const {
    const size_t npix = (size_t)width_ * height_;
    if (colour_ == kRaw) {
      std::vector<uint8_t> raw(npix * ncomp_);
      for (int c = 0; c < ncomp_; ++c) {
        const std::vector<uint8_t> plane = upsampled(comp_[c]);
        for (size_t i = 0; i < npix; ++i) raw[i * ncomp_ + c] = plane[i];
      }
      return raw;
    }
    if (colour_ == kYcc && ncomp_ != 3)
      corrupt("JPEGCOLORMODE_RGB on a " + std::to_string(ncomp_) + "-component frame");
    // libjpeg's colour-space guess: 3 components are YCbCr under JFIF, then
    // as the Adobe transform says, then unless the ids are 'R' 'G' 'B' (RGB
    // for any ids in a lossless frame); 4 are YCCK under a nonzero Adobe
    // transform, else CMYK
    bool ycc = false;
    if (colour_ == kYcc) {
      ycc = true;
    } else if (ncomp_ == 3) {
      if (jfif_) {
        ycc = true;
      } else if (adobe_) {
        ycc = adobe_transform_ != 0;
      } else {
        ycc = !lossless_ && !(comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66);
      }
    } else if (ncomp_ == 4) {
      ycc = adobe_ && adobe_transform_ != 0;
    }
    if (lossless_ && ycc)
      refused(std::string("lossless JPEG in ") + (ncomp_ == 3 ? "YCbCr" : "YCCK") +
              " (libjpeg-turbo converts no colour in lossless mode)");
    std::vector<uint8_t> rgb(npix * 3);
    std::vector<uint8_t> planes[4];
    for (int c = 0; c < ncomp_; ++c) planes[c] = upsampled(comp_[c]);
    if (ncomp_ == 1) {
      for (size_t i = 0; i < npix; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = planes[0][i];
      return rgb;
    }
    if (ncomp_ == 3 && !ycc) {
      for (size_t i = 0; i < npix; ++i)
        for (int c = 0; c < 3; ++c) rgb[3 * i + c] = planes[c][i];
      return rgb;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert (ycck_cmyk_convert:
    // the same, subtracted from 255)
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    if (ycc) {
      for (size_t i = 0; i < npix; ++i) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        int c[3] = {y + cr_r[cr], y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS), y + cb_b[cb]};
        for (int j = 0; j < 3; ++j) {
          if (ncomp_ == 4)
            planes[j][i] = clamp(255 - c[j]);  // YCCK: the CMY samples, K passes
          else
            rgb[3 * i + j] = clamp(c[j]);
        }
      }
      if (ncomp_ == 3) return rgb;
    }
    for (size_t i = 0; i < npix; ++i) {
      // PIL's "CMYK;I" unpack inverts, then its cmyk2rgb
      int c = 255 - planes[0][i], m = 255 - planes[1][i], yy = 255 - planes[2][i];
      int nk = 255 - (255 - planes[3][i]);
      auto muldiv255 = [](int a, int b) {
        int tmp = a * b + 128;
        return ((tmp >> 8) + tmp) >> 8;
      };
      auto clip8 = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
      rgb[3 * i] = clip8(nk - muldiv255(c, nk));
      rgb[3 * i + 1] = clip8(nk - muldiv255(m, nk));
      rgb[3 * i + 2] = clip8(nk - muldiv255(yy, nk));
    }
    return rgb;
  }
};

// ---------------------------------------------------------------- encoder

// jcparam.c: the standard quantization tables (natural order)
const uint16_t kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint16_t kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffEncode {
  uint32_t code[256];
  uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl
HuffEncode encode_table(const uint8_t bits[17], const uint8_t* vals) {
  HuffEncode t{};
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int last = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  for (p = 0; p < last; ++p) {
    t.code[vals[p]] = huffcode[p];
    t.size[vals[p]] = (uint8_t)huffsize[p];
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // the partial byte filled with 1 bits (jchuff.c flush_bits)
    put(0x7F, 7);
    nbits = 0;
    acc = 0;
  }
};

// jfdctint.c jpeg_fdct_islow, in place
void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = data + r * 8;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32],
            tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: (recip, corr, shift)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return Divisor{fq, c, r};
}

struct EncComponent {
  int id, h, v, tq, tbl;
  int width_in_blocks, height_in_blocks;
  int pw, ph;  // the padded, downsampled plane
  std::vector<uint8_t> plane;
};

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int channels) {
  if (W < 1 || H < 1 || W > 65500 || H > 65500) unsupported("image size outside 1..65500");
  if (channels != 1 && channels != 3) unsupported("only gray and RGB images are encoded");
  const int ncomp = channels;
  const int hmax = ncomp == 3 ? 2 : 1, vmax = hmax;
  // quality 75: scale factor 50, force_baseline (jcparam.c jpeg_add_quant_table)
  uint16_t q[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long v = ((long)(t ? kChromQuant : kLumQuant)[i] * 50 + 50) / 100;
      q[t][i] = (uint16_t)std::min(255L, std::max(1L, v));
    }
  // jccolor.c rgb_ycc_convert (or the gray copy) into full planes
  const size_t npix = (size_t)W * H;
  std::vector<uint8_t> full[3];
  if (ncomp == 1) {
    full[0].assign(px, px + npix);
  } else {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    constexpr int64_t CBCR_OFFSET = (int64_t)128 << SCALEBITS;
    auto fix = [](double x) { return (int64_t)(x * (1 << SCALEBITS) + 0.5); };
    std::vector<int64_t> tab(8 * 256);
    for (int i = 0; i < 256; ++i) {
      tab[i] = fix(0.29900) * i;
      tab[256 + i] = fix(0.58700) * i;
      tab[512 + i] = fix(0.11400) * i + ONE_HALF;
      tab[768 + i] = -fix(0.16874) * i;
      tab[1024 + i] = -fix(0.33126) * i;
      tab[1280 + i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
      tab[1536 + i] = -fix(0.41869) * i;
      tab[1792 + i] = -fix(0.08131) * i;
    }
    for (int c = 0; c < 3; ++c) full[c].resize(npix);
    for (size_t i = 0; i < npix; ++i) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = (uint8_t)((tab[r] + tab[256 + g] + tab[512 + b]) >> SCALEBITS);
      full[1][i] = (uint8_t)((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> SCALEBITS);
      full[2][i] = (uint8_t)((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> SCALEBITS);
    }
  }
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
  std::vector<EncComponent> comps;
  for (int c = 0; c < ncomp; ++c) {
    EncComponent k;
    k.id = c + 1;
    k.h = k.v = c == 0 ? hmax : 1;
    k.tq = k.tbl = c == 0 ? 0 : 1;
    k.width_in_blocks = (W * k.h + 8 * hmax - 1) / (8 * hmax);
    k.height_in_blocks = (H * k.v + 8 * vmax - 1) / (8 * vmax);
    k.pw = k.width_in_blocks * 8;
    k.ph = mcuy * k.v * 8;  // a full iMCU row at the bottom (jcprepct.c)
    k.plane.resize((size_t)k.pw * k.ph);
    // the image rows, padded to a multiple of vmax by repeating the last
    const int rows_in = (H + vmax - 1) / vmax * vmax;
    auto src = [&](int y, int x) { return full[c][(size_t)std::min(y, H - 1) * W + std::min(x, W - 1)]; };
    int produced;
    if (k.h == hmax) {  // fullsize_downsample: columns padded to pw by repetition
      produced = rows_in;
      for (int y = 0; y < produced; ++y)
        for (int x = 0; x < k.pw; ++x) k.plane[(size_t)y * k.pw + x] = src(y, x);
    } else {  // h2v2_downsample: input padded to 2 * pw columns, biases 1, 2, 1, 2, ...
      produced = rows_in / 2;
      for (int y = 0; y < produced; ++y) {
        int bias = 1;
        for (int x = 0; x < k.pw; ++x) {
          int s = src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) + src(2 * y + 1, 2 * x) +
                  src(2 * y + 1, 2 * x + 1);
          k.plane[(size_t)y * k.pw + x] = (uint8_t)((s + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int y = produced; y < k.ph; ++y)  // expand_bottom_edge to the iMCU row
      std::memcpy(&k.plane[(size_t)y * k.pw], &k.plane[(size_t)(produced - 1) * k.pw], k.pw);
    comps.push_back(std::move(k));
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)q[t][i] << 3);
  HuffEncode dc[2] = {encode_table(kDcLumBits, kDcVals), encode_table(kDcChromBits, kDcVals)};
  HuffEncode ac[2] = {encode_table(kAcLumBits, kAcLumVals),
                      encode_table(kAcChromBits, kAcChromVals)};

  std::vector<uint8_t> out;
  auto marker = [&](int m) {
    out.push_back(0xFF);
    out.push_back((uint8_t)m);
  };
  auto word = [&](int v) {
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)v);
  };
  marker(0xD8);
  marker(0xE0);  // JFIF 1.01, density 1:1, no unit, no thumbnail
  word(16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {
    marker(0xDB);
    word(67);
    out.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) out.push_back((uint8_t)q[t][kNatural[i]]);
  }
  marker(0xC0);
  word(8 + 3 * ncomp);
  out.push_back(8);
  word(H);
  word(W);
  out.push_back((uint8_t)ncomp);
  for (auto& k : comps) {
    out.push_back((uint8_t)k.id);
    out.push_back((uint8_t)((k.h << 4) | k.v));
    out.push_back((uint8_t)k.tq);
  }
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    marker(0xC4);
    word(count + 2 + 1 + 16);
    out.push_back((uint8_t)cls_id);
    out.insert(out.end(), bits + 1, bits + 17);
    out.insert(out.end(), vals, vals + count);
  };
  dht(0x00, kDcLumBits, kDcVals);
  dht(0x10, kAcLumBits, kAcLumVals);
  if (ncomp == 3) {
    dht(0x01, kDcChromBits, kDcVals);
    dht(0x11, kAcChromBits, kAcChromVals);
  }
  marker(0xDA);
  word(6 + 2 * ncomp);
  out.push_back((uint8_t)ncomp);
  for (auto& k : comps) {
    out.push_back((uint8_t)k.id);
    out.push_back((uint8_t)((k.tbl << 4) | k.tbl));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int32_t work[64];
  auto encode_block = [&](const int16_t* blk, int c, int t) {
    int temp = blk[0] - last_dc[c];
    last_dc[c] = blk[0];
    int temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dc[t].code[nbits], dc[t].size[nbits]);
    if (nbits) bw.put((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = blk[kNatural[k]];
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int sym = (r << 4) + nbits;
      bw.put(ac[t].code[sym], ac[t].size[sym]);
      bw.put((uint32_t)temp2, nbits);
      r = 0;
    }
    if (r > 0) bw.put(ac[t].code[0], ac[t].size[0]);
  };
  auto forward = [&](const EncComponent& k, int by, int bx, int16_t* outblk) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        work[y * 8 + x] = (int32_t)k.plane[(size_t)(by * 8 + y) * k.pw + bx * 8 + x] - 128;
    fdct_islow(work);
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c quantize
      const Divisor& dv = div[k.tq][i];
      int32_t t = work[i];
      uint32_t a = (uint32_t)(t < 0 ? -t : t);
      uint32_t v = (uint32_t)(((uint64_t)(a + dv.corr) * dv.recip) >> dv.shift);
      outblk[i] = (int16_t)(t < 0 ? -(int32_t)v : (int32_t)v);
    }
  };
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int c = 0; c < ncomp; ++c) {
        const EncComponent& k = comps[c];
        // jccoefct.c compress_data: a dummy block past the component's
        // blocks carries no AC and the DC of the block before it (in a row
        // of dummies, of the block before the row)
        int16_t mcu[16][64];
        int n = 0;
        for (int v = 0; v < k.v; ++v) {
          int by = my * k.v + v, row_start = n;
          for (int h = 0; h < k.h; ++h, ++n) {
            int bx = mx * k.h + h;
            if (by < k.height_in_blocks && bx < k.width_in_blocks) {
              forward(k, by, bx, mcu[n]);
            } else {
              std::memset(mcu[n], 0, sizeof(mcu[n]));
              mcu[n][0] = by < k.height_in_blocks ? mcu[n - 1][0] : mcu[row_start - 1][0];
            }
          }
        }
        for (int i = 0; i < n; ++i) encode_block(mcu[i], c, k.tbl);
      }
    }
  }
  bw.flush();
  marker(0xD9);
  return out;
}

void set_error(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) {
    std::strncpy(err, m.c_str(), (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// JPEG bytes -> uint8 (H, W, channels), allocated here (release with
// ape_jpeg_free): RGB under colour -1 (PIL's JPEG plugin) and 1 (libtiff's
// YCbCr to RGB), the stored components under 0 (libtiff's raw samples)
int ape_jpeg_decode(const uint8_t* data, size_t len, int colour, uint8_t** out, int* width,
                    int* height, int* channels, char* err, int errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, len);
    dec.set_colour(colour);
    std::vector<uint8_t> rgb = dec.decode(width, height);
    *channels = dec.channels();
    *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
    if (!*out) {
      set_error(err, errlen, "out of memory");
      return 1;
    }
    std::memcpy(*out, rgb.data(), rgb.size());
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.message);
    return f.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

// uint8 (H, W) or (H, W, 3) pixels -> JPEG bytes, allocated here.
int ape_jpeg_encode(const uint8_t* pixels, int width, int height, int channels, uint8_t** out,
                    size_t* out_len, char* err, int errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> bytes = encode(pixels, width, height, channels);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) {
      set_error(err, errlen, "out of memory");
      return 1;
    }
    std::memcpy(*out, bytes.data(), bytes.size());
    *out_len = bytes.size();
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.message);
    return f.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

void ape_jpeg_free(void* p) { std::free(p); }

}  // extern "C"

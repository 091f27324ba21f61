// Lossy WebP encoding for the host CPU, in plain C++17 (no library): the
// port's counterpart of PIL 12.1's `Image.save(f, "WEBP")`, which calls
// libwebp 1.6's WebPEncode at quality 80, method 4, no alpha. The encoder
// follows libwebp's choices at those settings (sns_strength 50,
// filter_strength 60, filter_sharpness 0, the normal loop filter, 4
// segments, one pass, one token partition, no trellis):
//
//   * RGB to YUV 4:2:0 as WebPPictureImportRGB converts (dsp/yuv.h's
//     VP8RGBToY/U/V, 16-bit fixed point; the chroma of each 2x2 block the
//     gamma-corrected average of picture_csp_enc.c, gamma 0.8 through its
//     12-bit tables); edge macroblocks padded by repeating the last
//     column and row (ImportBlock);
//   * analysis (analysis_enc.c): per macroblock the susceptibility alpha of
//     the DC and TM predictions of the source (the histogram of the forward
//     DCT's magnitudes / 8: last nonzero bin over the peak), luma and chroma
//     mixed 3:1 and inverted; a k-means of the alphas into 4 segments
//     (AssignSegments), each segment's alpha and beta rescaled
//     (SetSegmentAlphas);
//   * quantizers (quant_enc.c): QualityToCompression, each segment's
//     quantizer modulated by its alpha (SetSegmentParams), the chroma AC
//     delta from the mean chroma alpha, the chroma DC delta -2; segments of
//     equal quantizer and filter merged (SimplifySegments); the dequantizer
//     steps of the decoder's tables (`vp8_common.h`); the quantizer's
//     rounding bias, zero threshold and sharpening (ExpandMatrix,
//     QuantizeBlock) and the RD lambdas (SetupMatrices);
//   * the filter (filter_enc.c): each segment's level from the AC step and
//     its beta (SetupFilterStrength), raised for flat macroblocks' DC steps
//     (VP8AdjustFilterStrength), sharpness 0;
//   * mode choice (quant_enc.c's VP8Decimate at RD_OPT_BASIC): every
//     16x16 mode, then every 4x4 mode of each subblock (kept only while the
//     sum beats the 16x16 score), then every chroma mode, each scored as
//     rate x lambda + 256 x (SSE + the spectral distortion of TDisto for
//     luma), with libwebp's flatness penalties; the rates from level cost
//     tables of the current probabilities, refreshed eight times a frame
//     from the token statistics gathered so far (VP8EncTokenLoop);
//   * tokens: the coefficients coded with the probabilities that pay for
//     their update (FinalizeTokenProbas), no skip flag (the token loop
//     writes none);
//   * output: the boolean encoder of RFC 6386 section 7, partition 0 (the
//     frame header, segment map, modes) then the token partition, in a
//     RIFF/WEBP/'VP8 ' container with no VP8X chunk.
//
// The reconstruction that drives prediction is the decoder's own
// (`vp8_common.h`: the same predictors over the same work buffer, the same
// inverse transforms), so the decoder's output is what the encoder scored.
// Where libwebp's arithmetic is not reproduced (its bit costs are rounded
// from log2 here; the partition-0 writer is the RFC's), the bytes can
// differ from libwebp's while the stream stays a valid key frame.
//
// C interface (ctypes): ape_webp_encode(rgb, width, height, out, size)
// returns 0 or 1 (bad size) and hands back a buffer freed with
// ape_webp_enc_free; ape_webp_yuv420 gives the YUV planes alone.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_common.h"

namespace {

// ------------------------------------------------------------ RGB -> YUV

constexpr int YUV_FIX = 16, YUV_HALF = 1 << (YUV_FIX - 1);
constexpr int kGammaFix = 12, kGammaTabFix = 7, kGammaTabScale = 1 << kGammaTabFix;
constexpr int kGammaTabRounder = kGammaTabScale >> 1;
constexpr int kGammaTabSize = 1 << (kGammaFix - kGammaTabFix);
constexpr int kGammaScale = (1 << kGammaFix) - 1;
constexpr double kGamma = 0.80;

struct GammaTables {
  uint16_t to_linear[256], to_gamma[kGammaTabSize + 1];
  GammaTables() {
    const double scale = (double)(1 << kGammaTabFix) / kGammaScale, norm = 1. / 255.;
    for (int v = 0; v <= 255; ++v)
      to_linear[v] = (uint16_t)(std::pow(norm * v, kGamma) * kGammaScale + .5);
    for (int v = 0; v <= kGammaTabSize; ++v)
      to_gamma[v] = (uint16_t)(255. * std::pow(scale * v, 1. / kGamma) + .5);
  }
};

const GammaTables& gamma_tables() {
  static const GammaTables t;
  return t;
}

inline int linear_to_gamma(uint32_t base, int shift) {
  const int v = (int)(base << shift);
  const int pos = v >> (kGammaTabFix + 2), x = v & ((kGammaTabScale << 2) - 1);
  const GammaTables& g = gamma_tables();
  const int y = g.to_gamma[pos + 1] * x + g.to_gamma[pos] * ((kGammaTabScale << 2) - x);
  return (y + kGammaTabRounder) >> kGammaTabFix;
}

inline int rgb_to_y(int r, int g, int b) {
  return (16839 * r + 33059 * g + 6420 * b + YUV_HALF + (16 << YUV_FIX)) >> YUV_FIX;
}

inline int clip_uv(int uv, int rounding) {
  uv = (uv + rounding + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2);
  return (uv & ~0xff) == 0 ? uv : uv < 0 ? 0 : 255;
}

// `rgb` (h x w x 3) -> Y (h x w), U and V ((h + 1) / 2 x (w + 1) / 2)
void rgb_to_yuv420(const uint8_t* rgb, int w, int h, uint8_t* Y, uint8_t* U, uint8_t* V) {
  const GammaTables& g = gamma_tables();
  const int uv_w = (w + 1) >> 1;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = rgb + ((size_t)y * w + x) * 3;
      Y[(size_t)y * w + x] = (uint8_t)rgb_to_y(p[0], p[1], p[2]);
    }
  for (int y = 0; y < h; y += 2) {
    const uint8_t* row0 = rgb + (size_t)y * w * 3;
    const uint8_t* row1 = y + 1 < h ? row0 + (size_t)w * 3 : row0;  // the last odd row twice
    for (int i = 0; i < uv_w; ++i) {
      int c[3];
      for (int k = 0; k < 3; ++k) {
        const int x = 2 * i;
        if (x + 1 < w) {
          const uint32_t sum = g.to_linear[row0[3 * x + k]] + g.to_linear[row0[3 * x + 3 + k]] +
                               g.to_linear[row1[3 * x + k]] + g.to_linear[row1[3 * x + 3 + k]];
          c[k] = linear_to_gamma(sum, 0);
        } else {
          c[k] = linear_to_gamma(g.to_linear[row0[3 * x + k]] + g.to_linear[row1[3 * x + k]], 1);
        }
      }
      const size_t o = (size_t)(y >> 1) * uv_w + i;
      U[o] = (uint8_t)clip_uv(-9719 * c[0] - 19081 * c[1] + 28800 * c[2], YUV_HALF << 2);
      V[o] = (uint8_t)clip_uv(28800 * c[0] - 24116 * c[1] - 4684 * c[2], YUV_HALF << 2);
    }
  }
}

// ------------------------------------------------------------ constants

constexpr int kNumSegments = 4;
constexpr int kMaxAlpha = 255, kAlphaScale = 2 * kMaxAlpha;  // analysis_enc.c
constexpr int kMaxItersKMeans = 6;
constexpr double kSnsToDq = 0.9;  // quant_enc.c
constexpr int kMidAlpha = 64, kMinAlpha = 30, kMaxAlphaUV = 100, kMaxDqUV = 6, kMinDqUV = -4;
constexpr int kSns = 50, kFilterStrength = 60, kQuality = 80;  // PIL's WebPConfig
constexpr int QFIX = 17, MAX_LEVEL = 2047, kSharpenBits = 11;
constexpr int kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};  // y1, y2, uv
constexpr uint8_t kFreqSharpening[16] = {0, 30, 60, 90, 30, 60, 90, 90,
                                         60, 90, 90, 90, 90, 90, 90, 90};
constexpr uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4, 2};
constexpr int kFlatnessLimitI16 = 0, kFlatnessLimitI4 = 3, kFlatnessLimitUV = 2;
constexpr int kFlatnessPenalty = 140, kRdDistoMult = 256;
constexpr int kFStrengthCutoff = 2;
constexpr int kMaxVariableLevel = 67;
constexpr int kMinCount = 96;  // frame_enc.c's MIN_COUNT

// the cost of a bit in 1/256 bit: -log2 of its probability (libwebp keeps
// the same quantity in VP8EntropyCost)
struct Costs {
  uint16_t of[256];
  Costs() {
    for (int p = 0; p < 256; ++p) of[p] = (uint16_t)std::lround(-std::log2((p + 1) / 256.0) * 256);
  }
};

inline int bit_cost(int bit, int p) {
  static const Costs c;
  return bit ? c.of[255 - p] : c.of[p];
}

// ------------------------------------------------------------ the bit writer

struct BoolWriter {  // RFC 6386 section 7.3
  std::vector<uint8_t> out;
  uint32_t range = 255, bottom = 0;
  int bit_count = 24;
  void carry() {
    size_t i = out.size();
    while (i > 0 && out[i - 1] == 255) out[--i] = 0;
    if (i > 0) ++out[i - 1];
  }
  int put(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & (1u << 31)) carry();
      bottom <<= 1;
      if (!--bit_count) {
        out.push_back((uint8_t)(bottom >> 24));
        bottom &= (1 << 24) - 1;
        bit_count = 8;
      }
    }
    return bit;
  }
  int put_uniform(int bit) { return put(bit, 128); }
  void put_value(int v, int bits) {
    for (int m = 1 << (bits - 1); m; m >>= 1) put_uniform((v & m) != 0);
  }
  void put_signed(int v, int bits) {
    if (!put_uniform(v != 0)) return;
    put_value(v < 0 ? -v : v, bits);
    put_uniform(v < 0);
  }
  void finish() {
    int c = bit_count;
    uint32_t v = bottom;
    if (v & (1u << (32 - c))) carry();
    v <<= c & 7;
    c >>= 3;
    while (--c >= 0) v <<= 8;
    for (c = 0; c < 4; ++c) {
      out.push_back((uint8_t)(v >> 24));
      v <<= 8;
    }
  }
};

// ------------------------------------------------------------ transforms

// dsp/enc.c FTransform: src - ref of a 4x4 block (stride BPS) -> out
void ftransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1], d2 = src[2] - ref[2],
              d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

// FTransformWHT: the 16 DC coefficients (block n's at in[16 n]) -> out
void ftransform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16], a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16], a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a3 - a2) >> 1);
    out[12 + i] = (int16_t)((a0 - a1) >> 1);
  }
}

// the Walsh-Hadamard spectrum of a 4x4 block, weighted (TTransform)
int ttransform(const uint8_t* in, const uint16_t* w) {
  int tmp[16], sum = 0;
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2], a1 = in[1] + in[3], a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    sum += w[0] * std::abs(a0 + a1) + w[4] * std::abs(a3 + a2) + w[8] * std::abs(a3 - a2) +
           w[12] * std::abs(a0 - a1);
  }
  return sum;
}

int tdisto(const uint8_t* a, const uint8_t* b, int blocks_w, int blocks_h) {
  int d = 0;
  for (int y = 0; y < blocks_h; ++y)
    for (int x = 0; x < blocks_w; ++x) {
      const int o = x * 4 + y * 4 * BPS;
      d += std::abs(ttransform(b + o, kWeightY) - ttransform(a + o, kWeightY)) >> 5;
    }
  return d;
}

int sse(const uint8_t* a, const uint8_t* b, int w, int h) {
  int s = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int d = a[x + y * BPS] - b[x + y * BPS];
      s += d * d;
    }
  return s;
}

inline int mult_8b(int a, int b) { return (a * b + 128) >> 8; }

// ------------------------------------------------------------ quantization

struct Matrix {
  int q[16], iq[16], bias[16], zthresh[16], sharpen[16];
};

// ExpandMatrix: returns the mean step
int expand_matrix(Matrix& m, int dc, int ac, int type) {
  m.q[0] = dc;
  m.q[1] = ac;
  for (int i = 0; i < 2; ++i) {
    m.iq[i] = (1 << QFIX) / m.q[i];
    m.bias[i] = kBiasMatrices[type][i > 0] << (QFIX - 8);
    m.zthresh[i] = ((1 << QFIX) - 1 - m.bias[i]) / m.iq[i];
  }
  int sum = 0;
  for (int i = 0; i < 16; ++i) {
    if (i >= 2) {
      m.q[i] = m.q[1];
      m.iq[i] = m.iq[1];
      m.bias[i] = m.bias[1];
      m.zthresh[i] = m.zthresh[1];
    }
    m.sharpen[i] = type == 0 ? (kFreqSharpening[i] * m.q[i]) >> kSharpenBits : 0;
    sum += m.q[i];
  }
  return (sum + 8) >> 4;
}

// QuantizeBlock: in (natural order) -> levels (zigzag order); in holds the
// dequantized coefficients afterwards; returns whether any level is nonzero
int quantize_block(int16_t in[16], int16_t out[16], const Matrix& m) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    const bool sign = in[j] < 0;
    const uint32_t coeff = (uint32_t)((sign ? -in[j] : in[j]) + m.sharpen[j]);
    if (coeff > (uint32_t)m.zthresh[j]) {
      int level = (int)((coeff * (uint32_t)m.iq[j] + (uint32_t)m.bias[j]) >> QFIX);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = (int16_t)(level * m.q[j]);
      out[n] = (int16_t)level;
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}

struct Segment {
  int quant = 0, fstrength = 0, alpha = 0, beta = 0;
  Matrix y1, y2, uv;
  int lambda_i4 = 0, lambda_i16 = 0, lambda_uv = 0, lambda_mode = 0, tlambda = 0;
  int min_disto = 0, max_edge = 0;
};

// ------------------------------------------------------------ probabilities

using Proba = uint8_t[4][8][3][11];

struct TokenStats {
  uint32_t s[4][8][3][11];
  void record(int bit, uint32_t& p) {
    if (p >= 0xfffe0000u) p = ((p + 1u) >> 1) & 0x7fff7fffu;
    p += 0x00010000u + (uint32_t)bit;
  }
};

// level cost tables (VP8CalculateLevelCosts), by position rather than band
struct LevelCosts {
  uint16_t t[4][16][3][kMaxVariableLevel + 1];
};

int variable_level_cost(int v, const uint8_t* p) {  // the tree after p[1]
  if (v == 1) return bit_cost(0, p[2]);
  int c = bit_cost(1, p[2]);
  if (v <= 4) {
    c += bit_cost(0, p[3]);
    return v == 2 ? c + bit_cost(0, p[4]) : c + bit_cost(1, p[4]) + bit_cost(v == 4, p[5]);
  }
  c += bit_cost(1, p[3]);
  if (v <= 10) return c + bit_cost(0, p[6]) + bit_cost(v > 6, p[7]);
  c += bit_cost(1, p[6]);
  if (v < 19) return c + bit_cost(0, p[8]) + bit_cost(0, p[9]);
  if (v < 35) return c + bit_cost(0, p[8]) + bit_cost(1, p[9]);
  if (v < 67) return c + bit_cost(1, p[8]) + bit_cost(0, p[10]);
  return c + bit_cost(1, p[8]) + bit_cost(1, p[10]);
}

// the sign and the extra bits of a level (VP8LevelFixedCosts)
int level_fixed_cost(int v) {
  if (v == 0) return 0;
  int c = 256;
  if (v == 5 || v == 6) return c + bit_cost(v == 6, 159);
  if (v >= 7 && v <= 10) return c + bit_cost(v >= 9, 165) + bit_cost(!(v & 1), 145);
  if (v >= 11) {
    int cat, base;
    if (v < 19) cat = 0, base = 11;
    else if (v < 35) cat = 1, base = 19;
    else if (v < 67) cat = 2, base = 35;
    else cat = 3, base = 67;
    const uint8_t* tab = kCat3456[cat];
    int bits = 0;
    while (tab[bits]) ++bits;
    const int r = std::min(v - base, (1 << bits) - 1);
    for (int i = 0; i < bits; ++i) c += bit_cost((r >> (bits - 1 - i)) & 1, tab[i]);
  }
  return c;
}

struct FixedLevelCosts {
  int of[MAX_LEVEL + 1];
  FixedLevelCosts() {
    for (int v = 0; v <= MAX_LEVEL; ++v) of[v] = level_fixed_cost(v);
  }
};

inline int fixed_level_cost(int v) {
  static const FixedLevelCosts f;
  return f.of[v];
}

void compute_level_costs(const Proba& proba, LevelCosts& lc) {
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int ctx = 0; ctx < 3; ++ctx) {
        const uint8_t* p = proba[t][b][ctx];
        const int cost0 = ctx > 0 ? bit_cost(1, p[0]) : 0;
        const int base = bit_cost(1, p[1]) + cost0;
        uint16_t table[kMaxVariableLevel + 1];
        table[0] = (uint16_t)(bit_cost(0, p[1]) + cost0);
        for (int v = 1; v <= kMaxVariableLevel; ++v)
          table[v] = (uint16_t)(base + variable_level_cost(v, p));
        for (int n = 0; n < 16; ++n)
          if (kBands[n] == b) std::memcpy(lc.t[t][n][ctx], table, sizeof(table));
      }
}

// GetResidualCost: levels (zigzag) from `first` of type `t` under context ctx0
int residual_cost(const int16_t* levels, int first, int t, int ctx0, const Proba& proba,
                  const LevelCosts& lc) {
  int last = -1;
  for (int n = 15; n >= first; --n)
    if (levels[n]) {
      last = n;
      break;
    }
  const int p0 = proba[t][kBands[first]][ctx0][0];
  if (last < 0) return bit_cost(0, p0);
  int cost = ctx0 == 0 ? bit_cost(1, p0) : 0;
  int n = first, ctx = ctx0;
  for (; n < last; ++n) {
    const int v = std::abs(levels[n]);
    cost += fixed_level_cost(v) + lc.t[t][n][ctx][std::min(v, kMaxVariableLevel)];
    ctx = v >= 2 ? 2 : v;
  }
  const int v = std::abs(levels[n]);
  cost += fixed_level_cost(v) + lc.t[t][n][ctx][std::min(v, kMaxVariableLevel)];
  if (n < 15) cost += bit_cost(0, proba[t][kBands[n + 1]][v == 1 ? 1 : 2][0]);
  return cost;
}

// the bits PutCoeffs writes for one block, with their probability slots;
// `emit(bit, prob, slot)` gets slot -1 for a fixed probability
template <class Emit>
int code_block(const int16_t* levels, int first, int t, int ctx, Emit emit) {
  int last = -1;
  for (int n = 15; n >= first; --n)
    if (levels[n]) {
      last = n;
      break;
    }
  int n = first;
  int band = kBands[n], c = ctx;
  if (!emit(last >= 0, t, band, c, 0)) return 0;
  while (n < 16) {
    const int lv = levels[n++];
    const int sign = lv < 0;
    int v = sign ? -lv : lv;
    if (!emit(v != 0, t, band, c, 1)) {
      band = kBands[n];
      c = 0;
      continue;
    }
    if (!emit(v > 1, t, band, c, 2)) {
      band = kBands[n];
      c = 1;
    } else {
      if (!emit(v > 4, t, band, c, 3)) {
        if (emit(v != 2, t, band, c, 4)) emit(v == 4, t, band, c, 5);
      } else if (!emit(v > 10, t, band, c, 6)) {
        if (!emit(v > 6, t, band, c, 7)) {
          emit(v == 6, 159, -1, -1, -1);
        } else {
          emit(v >= 9, 165, -1, -1, -1);
          emit(!(v & 1), 145, -1, -1, -1);
        }
      } else {
        int cat;
        if (v < 3 + (8 << 1)) {
          emit(0, t, band, c, 8);
          emit(0, t, band, c, 9);
          v -= 3 + (8 << 0);
          cat = 0;
        } else if (v < 3 + (8 << 2)) {
          emit(0, t, band, c, 8);
          emit(1, t, band, c, 9);
          v -= 3 + (8 << 1);
          cat = 1;
        } else if (v < 3 + (8 << 3)) {
          emit(1, t, band, c, 8);
          emit(0, t, band, c, 10);
          v -= 3 + (8 << 2);
          cat = 2;
        } else {
          emit(1, t, band, c, 8);
          emit(1, t, band, c, 10);
          v -= 3 + (8 << 3);
          cat = 3;
        }
        const uint8_t* tab = kCat3456[cat];
        int bits = 0;
        while (tab[bits]) ++bits;
        for (int i = bits - 1; i >= 0; --i) emit((v >> i) & 1, *tab++, -1, -1, -1);
      }
      band = kBands[n];
      c = 2;
    }
    emit(sign, 128, -1, -1, -1);
    if (n == 16 || !emit(n <= last, t, band, c, 0)) return 1;
  }
  return 1;
}

// ------------------------------------------------------------ the encoder

struct MBInfo {
  int segment = 0, alpha = 0;
  bool i16 = true;
  int ymode = B_DC, uvmode = B_DC;
  uint8_t imodes[16];
  int16_t y_dc[16], y_ac[16][16], uv[8][16];  // levels, zigzag order
};

// the nonzero contexts of one macroblock's blocks: Y 0-3, U 4-5, V 6-7, Y2 8
struct NzContext {
  int top[9], left[9];
};

struct ModeScore {
  int64_t D = 0, SD = 0, H = 0, R = 0, score = 0;
  int nz = 0;
};

inline void set_score(int64_t lambda, ModeScore& s) {
  s.score = (s.R + s.H) * lambda + kRdDistoMult * (s.D + s.SD);
}

bool is_flat(const int16_t* levels, int num_blocks, int thresh) {
  int score = 0;
  for (; num_blocks > 0; --num_blocks, levels += 16)
    for (int i = 1; i < 16; ++i) {
      score += levels[i] != 0;
      if (score > thresh) return false;
    }
  return true;
}

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

class Encoder {
 public:
  Encoder(const uint8_t* rgb, int w, int h) : width_(w), height_(h) {
    mb_w_ = (w + 15) >> 4;
    mb_h_ = (h + 15) >> 4;
    const int uv_w = (w + 1) >> 1, uv_h = (h + 1) >> 1;
    std::vector<uint8_t> Y((size_t)w * h), U((size_t)uv_w * uv_h), V((size_t)uv_w * uv_h);
    rgb_to_yuv420(rgb, w, h, Y.data(), U.data(), V.data());
    ys_ = mb_w_ * 16;
    uvs_ = mb_w_ * 8;
    Ysrc_.resize((size_t)ys_ * mb_h_ * 16);
    Usrc_.resize((size_t)uvs_ * mb_h_ * 8);
    Vsrc_.resize(Usrc_.size());
    pad(Y.data(), w, h, Ysrc_.data(), ys_, mb_h_ * 16);
    pad(U.data(), uv_w, uv_h, Usrc_.data(), uvs_, mb_h_ * 8);
    pad(V.data(), uv_w, uv_h, Vsrc_.data(), uvs_, mb_h_ * 8);
    Yr_.assign(Ysrc_.size(), 0);
    Ur_.assign(Usrc_.size(), 0);
    Vr_.assign(Vsrc_.size(), 0);
    mbs_.resize((size_t)mb_w_ * mb_h_);
  }

  std::vector<uint8_t> encode() {
    analyze();
    set_segment_params();
    set_segment_probas();
    token_loop();
    adjust_filter_strength();
    return write();
  }

 private:
  int width_, height_, mb_w_, mb_h_, ys_, uvs_;
  std::vector<uint8_t> Ysrc_, Usrc_, Vsrc_, Yr_, Ur_, Vr_;
  std::vector<MBInfo> mbs_;
  Segment dqm_[kNumSegments];
  int num_segments_ = kNumSegments, uv_alpha_ = 0, base_quant_ = 0;
  int dq_uv_ac_ = 0, dq_uv_dc_ = 0, filter_level_ = 0;
  bool update_map_ = false;
  uint8_t segment_proba_[3] = {255, 255, 255};
  Proba proba_;
  TokenStats stats_;
  LevelCosts costs_;

  static void pad(const uint8_t* src, int w, int h, uint8_t* dst, int ds, int dh) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* s = src + (size_t)std::min(y, h - 1) * w;
      uint8_t* d = dst + (size_t)y * ds;
      std::memcpy(d, s, w);
      std::memset(d + w, s[w - 1], ds - w);
    }
  }

  // the work buffer of macroblock (x, y) as libwebp's decoder sets it up:
  // the source in `src`, the edges from `Yp/Up/Vp` (the source for the
  // analysis, the reconstruction otherwise)
  void load(int mbx, int mby, const uint8_t* Yp, const uint8_t* Up, const uint8_t* Vp,
            uint8_t* ws, uint8_t* src) const {
    std::memset(ws, 0, YUV_SIZE);
    const int x0 = mbx * 16, y0 = mby * 16;
    uint8_t* y = ws + Y_OFF;
    uint8_t* u = ws + U_OFF;
    uint8_t* v = ws + V_OFF;
    for (int j = 0; j < 16; ++j) y[j * BPS - 1] = mbx ? Yp[(size_t)(y0 + j) * ys_ + x0 - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      u[j * BPS - 1] = mbx ? Up[(size_t)(mby * 8 + j) * uvs_ + mbx * 8 - 1] : 129;
      v[j * BPS - 1] = mbx ? Vp[(size_t)(mby * 8 + j) * uvs_ + mbx * 8 - 1] : 129;
    }
    if (mby == 0) {
      std::memset(y - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u - BPS - 1, 127, 8 + 1);
      std::memset(v - BPS - 1, 127, 8 + 1);
    } else {
      const uint8_t* ty = Yp + (size_t)(y0 - 1) * ys_ + x0;
      const uint8_t* tu = Up + (size_t)(mby * 8 - 1) * uvs_ + mbx * 8;
      const uint8_t* tv = Vp + (size_t)(mby * 8 - 1) * uvs_ + mbx * 8;
      y[-BPS - 1] = mbx ? ty[-1] : 129;
      u[-BPS - 1] = mbx ? tu[-1] : 129;
      v[-BPS - 1] = mbx ? tv[-1] : 129;
      std::memcpy(y - BPS, ty, 16);
      std::memcpy(u - BPS, tu, 8);
      std::memcpy(v - BPS, tv, 8);
      if (mbx < mb_w_ - 1)
        std::memcpy(y - BPS + 16, ty + 16, 4);
      else
        std::memset(y - BPS + 16, ty[15], 4);
    }
    for (int r = 1; r <= 3; ++r) std::memcpy(y - BPS + 16 + r * 4 * BPS, y - BPS + 16, 4);
    if (src) {
      std::memset(src, 0, YUV_SIZE);
      for (int j = 0; j < 16; ++j)
        std::memcpy(src + Y_OFF + j * BPS, &Ysrc_[(size_t)(y0 + j) * ys_ + x0], 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(src + U_OFF + j * BPS, &Usrc_[(size_t)(mby * 8 + j) * uvs_ + mbx * 8], 8);
        std::memcpy(src + V_OFF + j * BPS, &Vsrc_[(size_t)(mby * 8 + j) * uvs_ + mbx * 8], 8);
      }
    }
  }

  static int dc_mode(int mode, int mbx, int mby) {
    if (mode != B_DC) return mode;
    return mbx == 0 ? (mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT) : (mby == 0 ? DC_NOTOP : B_DC);
  }

  // ---- analysis (analysis_enc.c)

  static int histogram_alpha(const uint8_t* src, const uint8_t* pred, const int* offsets, int n) {
    int distribution[32] = {0};
    for (int j = 0; j < n; ++j) {
      int16_t out[16];
      ftransform(src + offsets[j], pred + offsets[j], out);
      for (int k = 0; k < 16; ++k) ++distribution[std::min(std::abs(out[k]) >> 3, 31)];
    }
    int max_value = 0, last_non_zero = 1;
    for (int k = 0; k <= 31; ++k)
      if (distribution[k] > 0) {
        max_value = std::max(max_value, distribution[k]);
        last_non_zero = k;
      }
    return max_value > 1 ? kAlphaScale * last_non_zero / max_value : 0;
  }

  void analyze() {
    int alphas[kMaxAlpha + 1] = {0};
    int uv_sum = 0;
    uint8_t ws[YUV_SIZE], pred[YUV_SIZE], src[YUV_SIZE];
    int yoff[16], uvoff[8];
    for (int n = 0; n < 16; ++n) yoff[n] = Y_OFF + (n & 3) * 4 + (n >> 2) * 4 * BPS;
    for (int n = 0; n < 8; ++n)
      uvoff[n] = (n < 4 ? U_OFF : V_OFF) + (n & 1) * 4 + ((n >> 1) & 1) * 4 * BPS;
    for (int mby = 0; mby < mb_h_; ++mby)
      for (int mbx = 0; mbx < mb_w_; ++mbx) {
        load(mbx, mby, Ysrc_.data(), Usrc_.data(), Vsrc_.data(), ws, src);
        int best_alpha = -1;
        for (int mode : {B_DC, B_TM}) {
          std::memcpy(pred, ws, YUV_SIZE);
          predict_block(pred + Y_OFF, 16, dc_mode(mode, mbx, mby));
          const int a = histogram_alpha(src, pred, yoff, 16);
          if (a > best_alpha) best_alpha = a;
        }
        int best_uv = -1;
        for (int mode : {B_DC, B_TM}) {
          std::memcpy(pred, ws, YUV_SIZE);
          predict_block(pred + U_OFF, 8, dc_mode(mode, mbx, mby));
          predict_block(pred + V_OFF, 8, dc_mode(mode, mbx, mby));
          const int a = histogram_alpha(src, pred, uvoff, 8);
          if (a > best_uv) best_uv = a;
        }
        int alpha = (3 * best_alpha + best_uv + 2) >> 2;
        alpha = clip(kMaxAlpha - alpha, 0, kMaxAlpha);
        ++alphas[alpha];
        MBInfo& mb = mbs_[(size_t)mby * mb_w_ + mbx];
        mb.alpha = alpha;
        uv_sum += best_uv;
      }
    uv_alpha_ = uv_sum / (mb_w_ * mb_h_);
    assign_segments(alphas);
  }

  void assign_segments(const int alphas[kMaxAlpha + 1]) {
    const int nb = kNumSegments;
    int centers[kNumSegments], map[kMaxAlpha + 1], accum[kNumSegments], dist_accum[kNumSegments];
    int n, a, min_a, max_a, weighted_average = 0;
    for (n = 0; n <= kMaxAlpha && alphas[n] == 0; ++n) {}
    min_a = n;
    for (n = kMaxAlpha; n > min_a && alphas[n] == 0; --n) {}
    max_a = n;
    const int range_a = max_a - min_a;
    for (int k = 0, m = 1; k < nb; ++k, m += 2) centers[k] = min_a + (m * range_a) / (2 * nb);
    for (int k = 0; k < kMaxItersKMeans; ++k) {
      for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
      n = 0;
      for (a = min_a; a <= max_a; ++a) {
        if (!alphas[a]) continue;
        while (n + 1 < nb && std::abs(a - centers[n + 1]) < std::abs(a - centers[n])) ++n;
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
      int displaced = 0, total_weight = 0;
      weighted_average = 0;
      for (n = 0; n < nb; ++n) {
        if (!accum[n]) continue;
        const int c = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += std::abs(centers[n] - c);
        centers[n] = c;
        weighted_average += c * accum[n];
        total_weight += accum[n];
      }
      weighted_average = (weighted_average + total_weight / 2) / total_weight;
      if (displaced < 5) break;
    }
    for (MBInfo& mb : mbs_) {
      mb.segment = map[mb.alpha];
      mb.alpha = centers[mb.segment];
    }
    // SetSegmentAlphas
    int lo = centers[0], hi = centers[0];
    for (n = 0; n < nb; ++n) {
      lo = std::min(lo, centers[n]);
      hi = std::max(hi, centers[n]);
    }
    if (hi == lo) hi = lo + 1;
    for (n = 0; n < nb; ++n) {
      dqm_[n].alpha = clip(255 * (centers[n] - weighted_average) / (hi - lo), -127, 127);
      dqm_[n].beta = clip(255 * (centers[n] - lo) / (hi - lo), 0, 255);
    }
  }

  // ---- quantizers and filter (quant_enc.c, filter_enc.c)

  void set_segment_params() {
    const double amp = kSnsToDq * kSns / 100. / 128.;
    const double q = kQuality / 100.;
    const double linear_c = q < 0.75 ? q * (2. / 3.) : 2. * q - 1.;
    const double c_base = std::pow(linear_c, 1 / 3.);
    for (int i = 0; i < kNumSegments; ++i) {
      const double expn = 1. - amp * dqm_[i].alpha;
      const double c = std::pow(c_base, expn);
      dqm_[i].quant = clip((int)(127. * (1. - c)), 0, 127);
    }
    base_quant_ = dqm_[0].quant;
    int dq_uv_ac = (uv_alpha_ - kMidAlpha) * (kMaxDqUV - kMinDqUV) / (kMaxAlphaUV - kMinAlpha);
    dq_uv_ac = dq_uv_ac * kSns / 100;
    dq_uv_ac_ = clip(dq_uv_ac, kMinDqUV, kMaxDqUV);
    dq_uv_dc_ = clip(-4 * kSns / 100, -15, 15);
    // SetupFilterStrength
    const int level0 = 5 * kFilterStrength;
    for (int i = 0; i < kNumSegments; ++i) {
      const int qstep = kAcTable[clip(dqm_[i].quant, 0, 127)] >> 2;
      const int base = std::min(qstep, 63);  // kLevelsFromDelta[sharpness 0]
      const int f = base * level0 / (256 + dqm_[i].beta);
      dqm_[i].fstrength = f < kFStrengthCutoff ? 0 : f > 63 ? 63 : f;
    }
    filter_level_ = dqm_[0].fstrength;
    simplify_segments();
    for (int i = 0; i < num_segments_; ++i) setup_matrices(dqm_[i]);
  }

  void simplify_segments() {
    int map[kNumSegments] = {0, 1, 2, 3};
    int final_n = 1;
    for (int s1 = 1; s1 < kNumSegments; ++s1) {
      int s2;
      bool found = false;
      for (s2 = 0; s2 < final_n; ++s2)
        if (dqm_[s1].quant == dqm_[s2].quant && dqm_[s1].fstrength == dqm_[s2].fstrength) {
          found = true;
          break;
        }
      map[s1] = s2;
      if (!found) {
        if (final_n != s1) dqm_[final_n] = dqm_[s1];
        ++final_n;
      }
    }
    if (final_n < kNumSegments) {
      for (MBInfo& mb : mbs_) mb.segment = map[mb.segment];
      num_segments_ = final_n;
      for (int i = final_n; i < kNumSegments; ++i) dqm_[i] = dqm_[final_n - 1];
    }
  }

  void setup_matrices(Segment& m) {
    const int q = m.quant;
    const int y2_ac = std::max((kAcTable[clip(q, 0, 127)] * 101581) >> 16, 8);
    const int q_i4 = expand_matrix(m.y1, kDcTable[clip(q, 0, 127)], kAcTable[clip(q, 0, 127)], 0);
    const int q_i16 = expand_matrix(m.y2, kDcTable[clip(q, 0, 127)] * 2, y2_ac, 1);
    const int q_uv = expand_matrix(m.uv, kDcTable[clip(q + dq_uv_dc_, 0, 117)],
                                   kAcTable[clip(q + dq_uv_ac_, 0, 127)], 2);
    m.lambda_i4 = std::max((3 * q_i4 * q_i4) >> 7, 1);
    m.lambda_i16 = std::max(3 * q_i16 * q_i16, 1);
    m.lambda_uv = std::max((3 * q_uv * q_uv) >> 6, 1);
    m.lambda_mode = std::max((1 * q_i4 * q_i4) >> 7, 1);
    m.tlambda = (kSns * q_i4) >> 5;
    m.min_disto = 20 * m.y1.q[0];
    m.max_edge = 0;
  }

  static int get_proba(int a, int b) {
    const int total = a + b;
    return total == 0 ? 255 : (255 * a + total / 2) / total;
  }

  void set_segment_probas() {
    int p[kNumSegments] = {0};
    for (const MBInfo& mb : mbs_) ++p[mb.segment];
    if (num_segments_ > 1) {
      segment_proba_[0] = (uint8_t)get_proba(p[0] + p[1], p[2] + p[3]);
      segment_proba_[1] = (uint8_t)get_proba(p[0], p[1]);
      segment_proba_[2] = (uint8_t)get_proba(p[2], p[3]);
      update_map_ = segment_proba_[0] != 255 || segment_proba_[1] != 255 ||
                    segment_proba_[2] != 255;
      if (!update_map_)
        for (MBInfo& mb : mbs_) mb.segment = 0;
    } else {
      update_map_ = false;
    }
  }

  void adjust_filter_strength() {
    int max_level = 0;
    for (int s = 0; s < kNumSegments; ++s) {
      Segment& d = dqm_[s];
      const int delta = (d.max_edge * d.y2.q[1]) >> 3;
      const int level = std::min(delta, 63);
      if (level > d.fstrength) d.fstrength = level;
      max_level = std::max(max_level, d.fstrength);
    }
    filter_level_ = max_level;
  }

  // ---- token statistics and probabilities (frame_enc.c)

  void record_block(const int16_t* levels, int first, int t, int ctx) {
    code_block(levels, first, t, ctx, [&](int bit, int tt, int band, int c, int slot) {
      if (slot >= 0) stats_.record(bit, stats_.s[tt][band][c][slot]);
      return bit;
    });
  }

  void finalize_token_probas() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const uint32_t s = stats_.s[t][b][c][p];
            const int nb = s & 0xffff, total = (s >> 16) & 0xffff;
            const int update = kCoeffsUpdateProba[t][b][c][p];
            const int old_p = kCoeffsProba0[t][b][c][p];
            const int new_p = nb ? 255 - nb * 255 / total : 255;
            const int old_cost = nb * bit_cost(1, old_p) + (total - nb) * bit_cost(0, old_p) +
                                 bit_cost(0, update);
            const int new_cost = nb * bit_cost(1, new_p) + (total - nb) * bit_cost(0, new_p) +
                                 bit_cost(1, update) + 8 * 256;
            proba_[t][b][c][p] = (uint8_t)(old_cost > new_cost ? new_p : old_p);
          }
  }

  // ---- mode decision (quant_enc.c)

  struct Luma16 {
    ModeScore s;
    int mode;
    int16_t dc[16], ac[16][16];
    uint8_t recon[YUV_SIZE];
  };

  // ReconstructIntra16 over the prediction in `ws` (already predicted):
  // the levels, and the reconstruction written over the prediction
  int reconstruct16(const uint8_t* src, uint8_t* ws, const Segment& d, int16_t dc_levels[16],
                    int16_t ac_levels[16][16]) {
    int16_t tmp[16][16], dc_tmp[16];
    uint8_t* y = ws + Y_OFF;
    for (int n = 0; n < 16; ++n) {
      const int o = (n & 3) * 4 + (n >> 2) * 4 * BPS;
      ftransform(src + Y_OFF + o, y + o, tmp[n]);
    }
    ftransform_wht(tmp[0], dc_tmp);
    int nz = quantize_block(dc_tmp, dc_levels, d.y2) << 24;
    for (int n = 0; n < 16; ++n) {
      tmp[n][0] = 0;
      nz |= quantize_block(tmp[n], ac_levels[n], d.y1) << n;
    }
    // the decoder's reconstruction: the DC levels through the inverse WHT
    int16_t coeffs[256] = {0};
    int16_t dq[16] = {0};
    int dc_last = -1;
    for (int n = 0; n < 16; ++n) {
      dq[kZigzag[n]] = (int16_t)(dc_levels[n] * d.y2.q[n > 0]);
      if (dc_levels[n]) dc_last = n;
    }
    if (dc_last > 0) {
      transform_wht(dq, coeffs);
    } else {
      const int dc0 = (dq[0] + 3) >> 3;
      for (int i = 0; i < 256; i += 16) coeffs[i] = (int16_t)dc0;
    }
    for (int n = 0; n < 16; ++n) {
      int last = 0;
      for (int k = 1; k < 16; ++k)
        if (ac_levels[n][k]) {
          coeffs[n * 16 + kZigzag[k]] = (int16_t)(ac_levels[n][k] * d.y1.q[1]);
          last = k;
        }
      const int nzpos = last ? last + 1 : 1;
      const int code = nzpos > 3 ? 3 : nzpos > 1 ? 2 : coeffs[n * 16] != 0;
      luma_transform(code, coeffs + n * 16, y + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    return nz;
  }

  // one 4x4 block: prediction at `dst` -> levels and reconstruction in place
  static int reconstruct4(const uint8_t* src, uint8_t* dst, const Segment& d, int16_t levels[16]) {
    int16_t tmp[16];
    ftransform(src, dst, tmp);
    const int nz = quantize_block(tmp, levels, d.y1);
    int16_t coeffs[16] = {0};
    int last = -1;
    for (int k = 0; k < 16; ++k)
      if (levels[k]) {
        coeffs[kZigzag[k]] = (int16_t)(levels[k] * d.y1.q[k > 0]);
        last = k;
      }
    const int nzpos = last + 1;
    luma_transform(nzpos > 3 ? 3 : nzpos > 1 ? 2 : coeffs[0] != 0, coeffs, dst);
    return nz;
  }

  // chroma: 8 blocks (U then V) -> levels and reconstruction in place
  static int reconstruct_uv(const uint8_t* src, uint8_t* ws, const Segment& d,
                            int16_t levels[8][16]) {
    int nz = 0;
    int16_t coeffs[8][16];
    uint8_t code[8];
    for (int n = 0; n < 8; ++n) {
      const int o = (n < 4 ? U_OFF : V_OFF) + (n & 1) * 4 + ((n >> 1) & 1) * 4 * BPS;
      int16_t tmp[16];
      ftransform(src + o, ws + o, tmp);
      nz |= quantize_block(tmp, levels[n], d.uv) << n;
      std::memset(coeffs[n], 0, sizeof(coeffs[n]));
      int last = -1;
      for (int k = 0; k < 16; ++k)
        if (levels[n][k]) {
          coeffs[n][kZigzag[k]] = (int16_t)(levels[n][k] * d.uv.q[k > 0]);
          last = k;
        }
      const int nzpos = last + 1;
      code[n] = (uint8_t)(nzpos > 3 ? 3 : nzpos > 1 ? 2 : coeffs[n][0] != 0);
    }
    int16_t plane[64];
    for (int ch = 0; ch < 2; ++ch) {
      for (int k = 0; k < 4; ++k) std::memcpy(plane + 16 * k, coeffs[ch * 4 + k], 32);
      chroma_transform(code + ch * 4, plane, ws + (ch ? V_OFF : U_OFF));
    }
    return nz;
  }

  int cost_luma16(const int16_t dc[16], const int16_t ac[16][16], const NzContext& nzc) {
    NzContext c = nzc;
    int R = residual_cost(dc, 0, 1, c.top[8] + c.left[8], proba_, costs_);
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        const int16_t* lv = ac[x + y * 4];
        R += residual_cost(lv, 1, 0, c.top[x] + c.left[y], proba_, costs_);
        bool any = false;
        for (int k = 1; k < 16; ++k) any |= lv[k] != 0;
        c.top[x] = c.left[y] = any;
      }
    return R;
  }

  int cost_uv(const int16_t lv[8][16], const NzContext& nzc) {
    NzContext c = nzc;
    int R = 0;
    for (int ch = 0; ch <= 2; ch += 2)
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x) {
          const int16_t* l = lv[ch * 2 + x + y * 2];
          R += residual_cost(l, 0, 2, c.top[4 + ch + x] + c.left[4 + ch + y], proba_, costs_);
          bool any = false;
          for (int k = 0; k < 16; ++k) any |= l[k] != 0;
          c.top[4 + ch + x] = c.left[4 + ch + y] = any;
        }
    return R;
  }

  static int i16_mode_cost(int mode) {  // the i16 flag and the mode's bits
    int c = bit_cost(1, 145);
    if (mode == B_TM || mode == B_HE)
      return c + bit_cost(1, 156) + bit_cost(mode == B_TM, 128);
    return c + bit_cost(0, 156) + bit_cost(mode == B_VE, 163);
  }

  static int i4_mode_cost(int mode, const uint8_t* prob) {
    int c = bit_cost(mode != B_DC, prob[0]);
    if (mode == B_DC) return c;
    c += bit_cost(mode != B_TM, prob[1]);
    if (mode == B_TM) return c;
    c += bit_cost(mode != B_VE, prob[2]);
    if (mode == B_VE) return c;
    c += bit_cost(mode >= B_LD, prob[3]);
    if (mode < B_LD) {
      c += bit_cost(mode != B_HE, prob[4]);
      if (mode != B_HE) c += bit_cost(mode != B_RD, prob[5]);
      return c;
    }
    c += bit_cost(mode != B_LD, prob[6]);
    if (mode == B_LD) return c;
    c += bit_cost(mode != B_VL, prob[7]);
    if (mode != B_VL) c += bit_cost(mode != B_HD, prob[8]);
    return c;
  }

  static int uv_mode_cost(int mode) {
    int c = bit_cost(mode != B_DC, 142);
    if (mode == B_DC) return c;
    c += bit_cost(mode != B_VE, 114);
    if (mode == B_VE) return c;
    return c + bit_cost(mode != B_HE, 183);
  }

  void decide(int mbx, int mby, MBInfo& mb, NzContext& nzc, std::vector<uint8_t>& top_modes,
              uint8_t left_modes[4]) {
    const Segment& d = dqm_[mb.segment];
    uint8_t ws[YUV_SIZE], src[YUV_SIZE], best[YUV_SIZE], trial[YUV_SIZE];
    load(mbx, mby, Yr_.data(), Ur_.data(), Vr_.data(), ws, src);
    const uint8_t* s = src + Y_OFF;
    bool flat = true;
    for (int y = 0; y < 16 && flat; ++y)
      for (int x = 0; x < 16; ++x)
        if (s[x + y * BPS] != s[0]) {
          flat = false;
          break;
        }
    // PickBestIntra16
    ModeScore best16;
    int16_t dc16[16], ac16[16][16];
    for (int mode : {B_DC, B_TM, B_VE, B_HE}) {
      std::memcpy(trial, ws, YUV_SIZE);
      predict_block(trial + Y_OFF, 16, dc_mode(mode, mbx, mby));
      int16_t dc[16], ac[16][16];
      ModeScore sc;
      sc.nz = reconstruct16(src, trial, d, dc, ac);
      sc.D = sse(s, trial + Y_OFF, 16, 16);
      sc.SD = d.tlambda ? mult_8b(d.tlambda, tdisto(s, trial + Y_OFF, 4, 4)) : 0;
      sc.H = i16_mode_cost(mode);
      sc.R = cost_luma16(dc, ac, nzc);
      if (flat) {
        flat = is_flat(ac[0], 16, kFlatnessLimitI16);
        if (flat) {
          sc.D *= 2;
          sc.SD *= 2;
        }
      }
      set_score(d.lambda_i16, sc);
      if (mode == B_DC || sc.score < best16.score) {
        best16 = sc;
        mb.ymode = mode;
        std::memcpy(dc16, dc, sizeof(dc));
        std::memcpy(ac16, ac, sizeof(ac));
        std::memcpy(best, trial, YUV_SIZE);
      }
    }
    ModeScore rd = best16;
    set_score(d.lambda_mode, rd);
    if ((rd.nz & 0x100ffff) == 0x1000000 && rd.D > d.min_disto) {
      const int v = std::max({std::abs(dc16[1]), std::abs(dc16[2]), std::abs(dc16[3])});
      Segment& dm = dqm_[mb.segment];
      if (v > dm.max_edge) dm.max_edge = v;
    }
    mb.i16 = true;
    std::memcpy(mb.y_dc, dc16, sizeof(dc16));
    std::memcpy(mb.y_ac, ac16, sizeof(ac16));
    // PickBestIntra4
    {
      std::memcpy(trial, ws, YUV_SIZE);
      ModeScore total;
      total.H = 211;
      set_score(d.lambda_mode, total);
      NzContext c = nzc;
      uint8_t modes[16];
      int16_t levels4[16][16];
      bool ok = true;
      int header_bits = 0;
      for (int n = 0; n < 16 && ok; ++n) {
        const int bx = n & 3, by = n >> 2;
        const int o = Y_OFF + bx * 4 + by * 4 * BPS;
        const int top = by ? modes[n - 4] : top_modes[(size_t)mbx * 4 + bx];
        const int left = bx ? modes[n - 1] : left_modes[by];
        const uint8_t* prob = kBModesProba[top][left];
        ModeScore best4;
        int best_mode = -1;
        uint8_t keep[4 * BPS];
        int16_t keep_levels[16];
        for (int mode = 0; mode < 10; ++mode) {
          uint8_t block[YUV_SIZE];
          std::memcpy(block, trial, YUV_SIZE);
          predict4(block + o, mode);
          int16_t lv[16];
          ModeScore sc;
          sc.nz = reconstruct4(src + o, block + o, d, lv);
          sc.D = sse(src + o, block + o, 4, 4);
          sc.SD = d.tlambda ? mult_8b(d.tlambda, tdisto(src + o, block + o, 1, 1)) : 0;
          sc.H = i4_mode_cost(mode, prob);
          sc.R = mode > 0 && is_flat(lv, 1, kFlatnessLimitI4) ? kFlatnessPenalty : 0;
          set_score(d.lambda_i4, sc);
          if (best_mode >= 0 && sc.score >= best4.score) continue;
          sc.R += residual_cost(lv, 0, 3, c.top[bx] + c.left[by], proba_, costs_);
          set_score(d.lambda_i4, sc);
          if (best_mode < 0 || sc.score < best4.score) {
            best4 = sc;
            best_mode = mode;
            for (int r = 0; r < 4; ++r) std::memcpy(keep + r * BPS, block + o + r * BPS, 4);
            std::memcpy(keep_levels, lv, sizeof(lv));
          }
        }
        set_score(d.lambda_mode, best4);
        total.D += best4.D;
        total.SD += best4.SD;
        total.H += best4.H;
        total.R += best4.R;
        total.nz |= best4.nz << n;
        set_score(d.lambda_mode, total);
        if (total.score >= rd.score) {
          ok = false;
          break;
        }
        header_bits += (int)best4.H;
        if (header_bits > 256 * 16 * 16) {
          ok = false;
          break;
        }
        for (int r = 0; r < 4; ++r) std::memcpy(trial + o + r * BPS, keep + r * BPS, 4);
        modes[n] = (uint8_t)best_mode;
        std::memcpy(levels4[n], keep_levels, sizeof(keep_levels));
        c.top[bx] = c.left[by] = best4.nz ? 1 : 0;
      }
      if (ok) {
        rd = total;
        mb.i16 = false;
        std::memcpy(mb.imodes, modes, 16);
        std::memcpy(mb.y_ac, levels4, sizeof(levels4));
        std::memcpy(best, trial, YUV_SIZE);
      }
    }
    // PickBestUV, on the chosen luma
    std::memcpy(trial, best, YUV_SIZE);
    ModeScore best_uv;
    int16_t uv_levels[8][16];
    uint8_t uv_best[YUV_SIZE];
    for (int mode : {B_DC, B_TM, B_VE, B_HE}) {
      uint8_t t2[YUV_SIZE];
      std::memcpy(t2, trial, YUV_SIZE);
      predict_block(t2 + U_OFF, 8, dc_mode(mode, mbx, mby));
      predict_block(t2 + V_OFF, 8, dc_mode(mode, mbx, mby));
      int16_t lv[8][16];
      ModeScore sc;
      sc.nz = reconstruct_uv(src, t2, d, lv);
      sc.D = sse(src + U_OFF, t2 + U_OFF, 8, 8) + sse(src + V_OFF, t2 + V_OFF, 8, 8);
      sc.H = uv_mode_cost(mode);
      sc.R = cost_uv(lv, nzc);
      if (mode > 0 && is_flat(lv[0], 8, kFlatnessLimitUV)) sc.R += kFlatnessPenalty * 8;
      set_score(d.lambda_uv, sc);
      if (mode == B_DC || sc.score < best_uv.score) {
        best_uv = sc;
        mb.uvmode = mode;
        std::memcpy(uv_levels, lv, sizeof(lv));
        std::memcpy(uv_best, t2, YUV_SIZE);
      }
    }
    std::memcpy(mb.uv, uv_levels, sizeof(uv_levels));
    // the reconstruction, into the frame
    const int x0 = mbx * 16, y0 = mby * 16;
    for (int j = 0; j < 16; ++j)
      std::memcpy(&Yr_[(size_t)(y0 + j) * ys_ + x0], uv_best + Y_OFF + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&Ur_[(size_t)(mby * 8 + j) * uvs_ + mbx * 8], uv_best + U_OFF + j * BPS, 8);
      std::memcpy(&Vr_[(size_t)(mby * 8 + j) * uvs_ + mbx * 8], uv_best + V_OFF + j * BPS, 8);
    }
    // the i4 mode contexts of the next macroblocks
    for (int k = 0; k < 4; ++k) {
      top_modes[(size_t)mbx * 4 + k] = mb.i16 ? (uint8_t)mb.ymode : mb.imodes[12 + k];
      left_modes[k] = mb.i16 ? (uint8_t)mb.ymode : mb.imodes[4 * k + 3];
    }
  }

  // record the macroblock's tokens, updating the nonzero contexts
  void record(const MBInfo& mb, NzContext& c) {
    int first = 0, type = 3;
    if (mb.i16) {
      record_block(mb.y_dc, 0, 1, c.top[8] + c.left[8]);
      bool any = false;
      for (int k = 0; k < 16; ++k) any |= mb.y_dc[k] != 0;
      c.top[8] = c.left[8] = any;
      first = 1;
      type = 0;
    }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        const int16_t* lv = mb.y_ac[x + y * 4];
        record_block(lv, first, type, c.top[x] + c.left[y]);
        bool any = false;
        for (int k = first; k < 16; ++k) any |= lv[k] != 0;
        c.top[x] = c.left[y] = any;
      }
    for (int ch = 0; ch <= 2; ch += 2)
      for (int y = 0; y < 2; ++y)
        for (int x = 0; x < 2; ++x) {
          const int16_t* lv = mb.uv[ch * 2 + x + y * 2];
          record_block(lv, 0, 2, c.top[4 + ch + x] + c.left[4 + ch + y]);
          bool any = false;
          for (int k = 0; k < 16; ++k) any |= lv[k] != 0;
          c.top[4 + ch + x] = c.left[4 + ch + y] = any;
        }
  }

  void token_loop() {
    std::memcpy(proba_, kCoeffsProba0, sizeof(proba_));
    std::memset(&stats_, 0, sizeof(stats_));
    compute_level_costs(proba_, costs_);
    int max_count = std::max((mb_w_ * mb_h_) >> 3, kMinCount), cnt = max_count;
    std::vector<NzContext> top((size_t)mb_w_);
    std::memset(top.data(), 0, top.size() * sizeof(NzContext));
    std::vector<uint8_t> top_modes((size_t)mb_w_ * 4, B_DC);
    for (int mby = 0; mby < mb_h_; ++mby) {
      int left[9] = {0};
      uint8_t left_modes[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mbx = 0; mbx < mb_w_; ++mbx) {
        if (--cnt < 0) {
          finalize_token_probas();
          compute_level_costs(proba_, costs_);
          cnt = max_count;
        }
        NzContext c;
        std::memcpy(c.top, top[mbx].top, sizeof(c.top));
        std::memcpy(c.left, left, sizeof(left));
        MBInfo& mb = mbs_[(size_t)mby * mb_w_ + mbx];
        decide(mbx, mby, mb, c, top_modes, left_modes);
        record(mb, c);
        std::memcpy(top[mbx].top, c.top, sizeof(c.top));
        std::memcpy(left, c.left, sizeof(left));
      }
    }
    finalize_token_probas();
  }

  // ---- the bitstream (syntax_enc.c)

  void put_tokens(BoolWriter& bw, const int16_t* levels, int first, int t, int ctx) {
    code_block(levels, first, t, ctx, [&](int bit, int tt, int band, int c, int slot) {
      return bw.put(bit, slot >= 0 ? proba_[tt][band][c][slot] : tt);
    });
  }

  std::vector<uint8_t> write() {
    BoolWriter p0, tokens;
    p0.put_uniform(0);  // color space
    p0.put_uniform(0);  // clamping type
    if (p0.put_uniform(num_segments_ > 1)) {
      p0.put_uniform(update_map_);
      p0.put_uniform(1);  // update the segment data
      p0.put_uniform(1);  // absolute values
      for (int s = 0; s < kNumSegments; ++s) p0.put_signed(dqm_[s].quant, 7);
      for (int s = 0; s < kNumSegments; ++s) p0.put_signed(dqm_[s].fstrength, 6);
      if (update_map_)
        for (int s = 0; s < 3; ++s)
          if (p0.put_uniform(segment_proba_[s] != 255)) p0.put_value(segment_proba_[s], 8);
    }
    p0.put_uniform(0);  // the normal filter
    p0.put_value(filter_level_, 6);
    p0.put_value(0, 3);  // sharpness
    p0.put_uniform(0);   // no loop-filter deltas
    p0.put_value(0, 2);  // one token partition
    p0.put_value(base_quant_, 7);
    p0.put_signed(0, 4);
    p0.put_signed(0, 4);
    p0.put_signed(0, 4);
    p0.put_signed(dq_uv_dc_, 4);
    p0.put_signed(dq_uv_ac_, 4);
    p0.put_uniform(0);  // no refresh of the entropy probabilities
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int v = proba_[t][b][c][p];
            if (p0.put(v != kCoeffsProba0[t][b][c][p], kCoeffsUpdateProba[t][b][c][p]))
              p0.put_value(v, 8);
          }
    p0.put_uniform(0);  // no skip probability
    std::vector<uint8_t> top_modes((size_t)mb_w_ * 4, B_DC);
    std::vector<NzContext> top((size_t)mb_w_);
    std::memset(top.data(), 0, top.size() * sizeof(NzContext));
    for (int mby = 0; mby < mb_h_; ++mby) {
      uint8_t left_modes[4] = {B_DC, B_DC, B_DC, B_DC};
      int left[9] = {0};
      for (int mbx = 0; mbx < mb_w_; ++mbx) {
        const MBInfo& mb = mbs_[(size_t)mby * mb_w_ + mbx];
        if (update_map_) {
          if (p0.put(mb.segment >= 2, segment_proba_[0]))
            p0.put(mb.segment & 1, segment_proba_[2]);
          else
            p0.put(mb.segment & 1, segment_proba_[1]);
        }
        uint8_t* tm = &top_modes[(size_t)mbx * 4];
        if (p0.put(mb.i16, 145)) {
          if (p0.put(mb.ymode == B_TM || mb.ymode == B_HE, 156))
            p0.put(mb.ymode == B_TM, 128);
          else
            p0.put(mb.ymode == B_VE, 163);
          std::memset(tm, mb.ymode, 4);
          std::memset(left_modes, mb.ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int l = left_modes[y];
            for (int x = 0; x < 4; ++x) {
              const int mode = mb.imodes[y * 4 + x];
              const uint8_t* prob = kBModesProba[tm[x]][l];
              if (p0.put(mode != B_DC, prob[0]) && p0.put(mode != B_TM, prob[1]) &&
                  p0.put(mode != B_VE, prob[2])) {
                if (!p0.put(mode >= B_LD, prob[3])) {
                  if (p0.put(mode != B_HE, prob[4])) p0.put(mode != B_RD, prob[5]);
                } else if (p0.put(mode != B_LD, prob[6]) && p0.put(mode != B_VL, prob[7])) {
                  p0.put(mode != B_HD, prob[8]);
                }
              }
              tm[x] = (uint8_t)mode;
              l = mode;
            }
            left_modes[y] = (uint8_t)l;
          }
        }
        if (p0.put(mb.uvmode != B_DC, 142) && p0.put(mb.uvmode != B_VE, 114))
          p0.put(mb.uvmode != B_HE, 183);
        // the tokens
        NzContext c;
        std::memcpy(c.top, top[mbx].top, sizeof(c.top));
        std::memcpy(c.left, left, sizeof(left));
        int first = 0, type = 3;
        if (mb.i16) {
          put_tokens(tokens, mb.y_dc, 0, 1, c.top[8] + c.left[8]);
          bool any = false;
          for (int k = 0; k < 16; ++k) any |= mb.y_dc[k] != 0;
          c.top[8] = c.left[8] = any;
          first = 1;
          type = 0;
        }
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) {
            const int16_t* lv = mb.y_ac[x + y * 4];
            put_tokens(tokens, lv, first, type, c.top[x] + c.left[y]);
            bool any = false;
            for (int k = first; k < 16; ++k) any |= lv[k] != 0;
            c.top[x] = c.left[y] = any;
          }
        for (int ch = 0; ch <= 2; ch += 2)
          for (int y = 0; y < 2; ++y)
            for (int x = 0; x < 2; ++x) {
              const int16_t* lv = mb.uv[ch * 2 + x + y * 2];
              put_tokens(tokens, lv, 0, 2, c.top[4 + ch + x] + c.left[4 + ch + y]);
              bool any = false;
              for (int k = 0; k < 16; ++k) any |= lv[k] != 0;
              c.top[4 + ch + x] = c.left[4 + ch + y] = any;
            }
        std::memcpy(top[mbx].top, c.top, sizeof(c.top));
        std::memcpy(left, c.left, sizeof(left));
      }
    }
    p0.finish();
    tokens.finish();
    // the frame: tag (key frame, profile 0, shown, partition 0 size), start
    // code, size; then the RIFF container
    std::vector<uint8_t> vp8;
    const uint32_t tag = (1u << 4) | ((uint32_t)p0.out.size() << 5);
    const uint8_t head[10] = {(uint8_t)tag, (uint8_t)(tag >> 8), (uint8_t)(tag >> 16), 0x9d, 0x01,
                              0x2a, (uint8_t)width_, (uint8_t)(width_ >> 8), (uint8_t)height_,
                              (uint8_t)(height_ >> 8)};
    vp8.insert(vp8.end(), head, head + 10);
    vp8.insert(vp8.end(), p0.out.begin(), p0.out.end());
    vp8.insert(vp8.end(), tokens.out.begin(), tokens.out.end());
    const uint32_t chunk = (uint32_t)vp8.size(), padded = chunk + (chunk & 1);
    std::vector<uint8_t> file;
    auto u32 = [&](uint32_t v) {
      for (int i = 0; i < 4; ++i) file.push_back((uint8_t)(v >> (8 * i)));
    };
    file.insert(file.end(), {'R', 'I', 'F', 'F'});
    u32(4 + 8 + padded);
    file.insert(file.end(), {'W', 'E', 'B', 'P', 'V', 'P', '8', ' '});
    u32(chunk);
    file.insert(file.end(), vp8.begin(), vp8.end());
    if (chunk & 1) file.push_back(0);
    return file;
  }
};

}  // namespace

extern "C" {

// RGB (height x width x 3) -> the WebP file in *out (*size bytes)
int ape_webp_encode(const uint8_t* rgb, int width, int height, uint8_t** out, size_t* size) {
  if (width <= 0 || height <= 0 || width > 16383 || height > 16383) return 1;
  Encoder enc(rgb, width, height);
  const std::vector<uint8_t> file = enc.encode();
  *out = (uint8_t*)std::malloc(file.size());
  if (!*out) return 1;
  std::memcpy(*out, file.data(), file.size());
  *size = file.size();
  return 0;
}

void ape_webp_enc_free(void* p) { std::free(p); }

// the encoder's YUV 4:2:0 planes of an RGB image
void ape_webp_yuv420(const uint8_t* rgb, int width, int height, uint8_t* y, uint8_t* u,
                     uint8_t* v) {
  rgb_to_yuv420(rgb, width, height, y, u, v);
}

}  // extern "C"

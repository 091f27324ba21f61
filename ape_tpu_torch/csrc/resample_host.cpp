// 8-bit image resampling for the host CPU, in plain C++17: the two passes of
// Pillow's Resample.c (ImagingResampleHorizontal_8bpc, then Vertical) for
// `data/transforms.py`, which computes the filter's taps and their 22-bit
// fixed-point weights itself (precompute_coeffs, normalize_coeffs_8bpc).
// Each output sample is the sum of its taps' samples times their weights
// from half a unit, shifted down by 22 bits and clipped to 0..255; the
// intermediate image is uint8, as Pillow's is.
//
// C interface (ctypes): ape_resample_u8 returns 0.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int v) {
  v >>= kPrecisionBits;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

}  // namespace

extern "C" {

// `in` (in_h x in_w x channels) -> `out` (out_h x out_w x channels); a pass
// whose `*_k` is 0 is skipped (that side keeps its size). The taps of output
// column x start at hstart[x], hk weights each (hw, out_w x hk); likewise
// rows.
int ape_resample_u8(const uint8_t* in, int in_w, int in_h, int channels, const int64_t* hstart,
                    const int32_t* hw, int hk, int out_w, const int64_t* vstart,
                    const int32_t* vw, int vk, int out_h, uint8_t* out) {
  const int mid_w = hk ? out_w : in_w;
  std::vector<uint8_t> mid;
  const uint8_t* src = in;
  if (hk) {
    mid.resize((size_t)in_h * mid_w * channels);
    for (int y = 0; y < in_h; ++y) {
      const uint8_t* row = in + (size_t)y * in_w * channels;
      uint8_t* dst = mid.data() + (size_t)y * mid_w * channels;
      for (int x = 0; x < out_w; ++x) {
        const int32_t* w = hw + (size_t)x * hk;
        const int64_t x0 = hstart[x];
        const int taps = (int)std::min<int64_t>(hk, in_w - x0);
        for (int c = 0; c < channels; ++c) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int k = 0; k < taps; ++k) ss += row[(x0 + k) * channels + c] * w[k];
          dst[x * channels + c] = clip8(ss);
        }
      }
    }
    src = mid.data();
  }
  if (!vk) {
    std::copy(src, src + (size_t)in_h * mid_w * channels, out);
    return 0;
  }
  const size_t stride = (size_t)mid_w * channels;
  for (int y = 0; y < out_h; ++y) {
    const int32_t* w = vw + (size_t)y * vk;
    const int64_t y0 = vstart[y];
    const int taps = (int)std::min<int64_t>(vk, in_h - y0);
    uint8_t* dst = out + (size_t)y * stride;
    for (size_t i = 0; i < stride; ++i) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int k = 0; k < taps; ++k) ss += src[(y0 + k) * stride + i] * w[k];
      dst[i] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"

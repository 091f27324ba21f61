// The pair probe (K10): one (query level, value level) pair of K1's gather in
// eight variants, each a template instance that changes or skips one stage.
//
// Replaces the TPU kernel experiments/pair_probe.py (run_pair_variant ->
// pallas_call, body make_kernel): the v2 window-MSDA pair kernel in about
// fifteen variants, each skipping one stage (the slab DMA alone, the tap
// weights, the FMA into the accumulator) or computing the same function in
// another layout, timed per pair to split the pair kernel's time by stage.
// On Hopper the pair kernel is K1's gather (msda_fwd.cu) restricted to one
// value level, so its stages are the sample's location and weight loads, the
// bilinear and attention weight math, the four corner loads and the store:
//
//   base          K1's body on the pair: its f32 accumulator bit for bit
//                 (the same explicitly rounded blend as both of K1's bodies)
//   vec2          lanes over channel pairs (float2 / bf16x2 corner loads),
//                 two (b, q, h) items a warp: base's arithmetic per channel
//   bf16fma       vec2 with the four-corner blend in bf16 (__hfma2), folded
//                 into the f32 accumulator once a sample
//   branchless    all four corners read at clamped addresses, corners and
//                 samples outside the level weighted 0: no branches
//   const_w       the corners read at the sampled addresses, each weighted
//                 0.01: no bilinear or attention math, no attention weights
//   corners_only  the corners read and summed, no weights
//   no_corners    every weight computed, no corner read (each counts 1)
//   store_only    the attention weights read, their sum over points stored
//
// Every variant stores a value that depends on every load it keeps, so the
// compiler drops none of them (the SASS's LDG counts are in PERF.md). The
// output is f32, as the TPU kernel's: base rounded to the value's dtype is
// K1's output on the pair. Every variant rounds a location to its pixel and
// tests the sample's liveness with msda_sample.cuh's pixel() and live(), as
// the backward kernels do. live() also keeps a sample at pixel -1 exactly,
// which K1 drops: every weight it gives a corner there is 0, so the weighted
// variants add nothing for it, and const_w and corners_only read the one
// corner it touches.
//
// What bounds it on an H100: as K1, the latency of four scattered 64-byte
// corner rows a sample, read from L2; about 8 flops for each byte read. One
// pair at 256^2 <- 256^2 in bf16 must move 126 MB (value, locations,
// weights, the f32 output), 38 us at 3.35 TB/s. The variants exist to split
// the time above that between the corner loads, the weight math and the
// launch and store floor.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "msda_sample.cuh"

namespace {

using ape_msda::kWarpsPerBlock;
using ape_msda::live;
using ape_msda::pixel;
using ape_msda::to_f32;

enum Variant : int {
  kBase = 0,
  kVec2,
  kBf16Fma,
  kBranchless,
  kConstW,
  kCornersOnly,
  kNoCorners,
  kStoreOnly,
};

constexpr int kD = 32;  // the head width the probe takes (APE-Ti's)

// Two neighbouring channels, as f32 and as bf16x2.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ __nv_bfloat162 load2_bf16(const float* p) {
  return __float22bfloat162_rn(load2(p));
}
__device__ __forceinline__ __nv_bfloat162 load2_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// The four corners' blend of one live sample for one channel pair, in f32
// (vec2: base's expressions) or in bf16 (bf16fma).
template <int V, typename VT>
__device__ __forceinline__ float2 blend2(const VT* vl, int64_t row_stride, int wl, int hl,
                                         int x0, int y0, float fx, float fy) {
  const VT* r0 = vl + (static_cast<int64_t>(y0) * wl + x0) * row_stride;
  const VT* r1 = r0 + static_cast<int64_t>(wl) * row_stride;
  if constexpr (V == kVec2) {
    float2 v = make_float2(0.f, 0.f);
    if (y0 >= 0) {
      if (x0 >= 0) {
        const float w = (1.f - fx) * (1.f - fy);
        const float2 c = load2(r0);
        v.x += w * c.x;
        v.y += w * c.y;
      }
      if (x0 + 1 < wl) {
        const float w = fx * (1.f - fy);
        const float2 c = load2(r0 + row_stride);
        v.x += w * c.x;
        v.y += w * c.y;
      }
    }
    if (y0 + 1 < hl) {
      if (x0 >= 0) {
        const float w = (1.f - fx) * fy;
        const float2 c = load2(r1);
        v.x += w * c.x;
        v.y += w * c.y;
      }
      if (x0 + 1 < wl) {
        const float w = fx * fy;
        const float2 c = load2(r1 + row_stride);
        v.x += w * c.x;
        v.y += w * c.y;
      }
    }
    return v;
  } else {
    __nv_bfloat162 v = __float2bfloat162_rn(0.f);
    if (y0 >= 0) {
      if (x0 >= 0) v = __hfma2(__float2bfloat162_rn((1.f - fx) * (1.f - fy)), load2_bf16(r0), v);
      if (x0 + 1 < wl)
        v = __hfma2(__float2bfloat162_rn(fx * (1.f - fy)), load2_bf16(r0 + row_stride), v);
    }
    if (y0 + 1 < hl) {
      if (x0 >= 0) v = __hfma2(__float2bfloat162_rn((1.f - fx) * fy), load2_bf16(r1), v);
      if (x0 + 1 < wl)
        v = __hfma2(__float2bfloat162_rn(fx * fy), load2_bf16(r1 + row_stride), v);
    }
    return __bfloat1622float2(v);
  }
}

template <int V, typename VT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_pair_probe_kernel(const VT* __restrict__ value,   // (B, hl * wl, H, kD)
                       const float* __restrict__ loc,  // (B, Q, H, P, 2), normalized
                       const float* __restrict__ att,  // (B, Q, H, P)
                       float* __restrict__ out,        // (B, Q, H * kD)
                       int B, int Q, int H, int P, int hl, int wl) {
  // vec2 and bf16fma: half a warp a (b, q, h), a lane per channel pair
  constexpr bool kPairs = V == kVec2 || V == kBf16Fma;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t item = kPairs ? 2 * warp + (lane >> 4) : warp;
  if (item >= static_cast<int64_t>(B) * Q * H) return;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);
  const int d = kPairs ? 2 * (lane & 15) : lane;
  const int64_t row_stride = static_cast<int64_t>(H) * kD;
  const VT* vl = value + static_cast<int64_t>(b) * hl * wl * row_stride +
                 static_cast<int64_t>(h) * kD + d;
  const int64_t samp0 = item * P;

  if constexpr (V == kStoreOnly) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += att[samp0 + p];
    out[item * kD + d] = acc;
    return;
  } else if constexpr (kPairs) {
    float2 acc = make_float2(0.f, 0.f);
    for (int p = 0; p < P; ++p) {
      const int64_t s = samp0 + p;
      const float a = att[s];
      const float x = pixel(loc[2 * s], wl);
      const float y = pixel(loc[2 * s + 1], hl);
      if (!live(x, y, hl, wl)) continue;
      const float xf = floorf(x);
      const float yf = floorf(y);
      const float2 v = blend2<V, VT>(vl, row_stride, wl, hl, static_cast<int>(xf),
                                     static_cast<int>(yf), x - xf, y - yf);
      acc.x += a * v.x;
      acc.y += a * v.y;
    }
    *reinterpret_cast<float2*>(out + item * kD + d) = acc;
  } else {
    constexpr bool kWeighted = V == kBase || V == kBranchless || V == kNoCorners;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      const int64_t s = samp0 + p;
      const float a = kWeighted ? att[s] : 0.f;  // read before the test, as K1 reads it
      const float x = pixel(loc[2 * s], wl);
      const float y = pixel(loc[2 * s + 1], hl);
      const bool in = live(x, y, hl, wl);
      if constexpr (V == kBranchless) {
        // x, y kept in [-2, size]: the same pixel for a live sample, a legal
        // int conversion for a dead one (whose weight is 0)
        const float xc = fminf(fmaxf(x, -2.f), static_cast<float>(wl));
        const float yc = fminf(fmaxf(y, -2.f), static_cast<float>(hl));
        const float xf = floorf(xc);
        const float yf = floorf(yc);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float fx = xc - xf;
        const float fy = yc - yf;
        const float wx0 = x0 >= 0 ? 1.f - fx : 0.f;
        const float wx1 = x0 + 1 < wl ? fx : 0.f;
        const float wy0 = y0 >= 0 ? 1.f - fy : 0.f;
        const float wy1 = y0 + 1 < hl ? fy : 0.f;
        const int64_t c0 = clampi(x0, wl - 1), c1 = clampi(x0 + 1, wl - 1);
        const int64_t r0 = static_cast<int64_t>(clampi(y0, hl - 1)) * wl;
        const int64_t r1 = static_cast<int64_t>(clampi(y0 + 1, hl - 1)) * wl;
        float v = 0.f;
        v += wx0 * wy0 * to_f32(vl[(r0 + c0) * row_stride]);
        v += wx1 * wy0 * to_f32(vl[(r0 + c1) * row_stride]);
        v += wx0 * wy1 * to_f32(vl[(r1 + c0) * row_stride]);
        v += wx1 * wy1 * to_f32(vl[(r1 + c1) * row_stride]);
        acc += (in ? a : 0.f) * v;
        continue;
      }
      if (!in) continue;
      const float xf = floorf(x);
      const float yf = floorf(y);
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      const float fx = x - xf;
      const float fy = y - yf;
      const VT* r0 = vl + (static_cast<int64_t>(y0) * wl + x0) * row_stride;
      const VT* r1 = r0 + static_cast<int64_t>(wl) * row_stride;
      if constexpr (V == kBase) {  // msda_fwd.cu's sample, one level, rounded as it rounds
        float v = 0.f;
        if (y0 >= 0) {
          if (x0 >= 0) v = __fmaf_rn(__fmul_rn(1.f - fx, 1.f - fy), to_f32(r0[0]), v);
          if (x0 + 1 < wl) v = __fmaf_rn(__fmul_rn(fx, 1.f - fy), to_f32(r0[row_stride]), v);
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0) v = __fmaf_rn(__fmul_rn(1.f - fx, fy), to_f32(r1[0]), v);
          if (x0 + 1 < wl) v = __fmaf_rn(__fmul_rn(fx, fy), to_f32(r1[row_stride]), v);
        }
        acc = __fmaf_rn(a, v, acc);
      } else if constexpr (V == kNoCorners) {
        float v = 0.f;
        if (y0 >= 0) {
          if (x0 >= 0) v += (1.f - fx) * (1.f - fy);
          if (x0 + 1 < wl) v += fx * (1.f - fy);
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0) v += (1.f - fx) * fy;
          if (x0 + 1 < wl) v += fx * fy;
        }
        acc += a * v;
      } else {  // kConstW, kCornersOnly: the corners, unweighted or at 0.01
        const float w = V == kConstW ? 0.01f : 1.f;
        if (y0 >= 0) {
          if (x0 >= 0) acc = fmaf(w, to_f32(r0[0]), acc);
          if (x0 + 1 < wl) acc = fmaf(w, to_f32(r0[row_stride]), acc);
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0) acc = fmaf(w, to_f32(r1[0]), acc);
          if (x0 + 1 < wl) acc = fmaf(w, to_f32(r1[row_stride]), acc);
        }
      }
    }
    out[item * kD + d] = acc;
  }
}

template <int V, typename VT>
int launch(const void* value, const float* loc, const float* att, float* out, int B, int Q,
           int H, int P, int hl, int wl, cudaStream_t stream) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * ((V == kVec2 || V == kBf16Fma) ? 2 : 1);
  const int64_t blocks = (static_cast<int64_t>(B) * Q * H + kItemsPerBlock - 1) / kItemsPerBlock;
  msda_pair_probe_kernel<V, VT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const VT*>(value), loc, att, out, B, Q, H, P, hl, wl);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int dispatch(int variant, const void* value, const float* loc, const float* att, float* out,
             int B, int Q, int H, int P, int hl, int wl, cudaStream_t st) {
  switch (variant) {
    case kBase: return launch<kBase, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kVec2: return launch<kVec2, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kBf16Fma: return launch<kBf16Fma, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kBranchless: return launch<kBranchless, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kConstW: return launch<kConstW, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kCornersOnly: return launch<kCornersOnly, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kNoCorners: return launch<kNoCorners, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    case kStoreOnly: return launch<kStoreOnly, VT>(value, loc, att, out, B, Q, H, P, hl, wl, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// value (B, hl * wl, H, D) bf16 (value_bf16) or f32; loc (B, Q, H, P, 2) and
// att (B, Q, H, P) f32; out (B, Q, H * D) f32; D must be 32. variant: the
// index in ops/msda_pair_probe.py's VARIANTS. Returns the launch's cudaError_t.
extern "C" int ape_msda_pair_probe(const void* value, const float* loc, const float* att,
                                   float* out, int B, int Q, int H, int P, int hl, int wl, int D,
                                   int variant, int value_bf16, void* stream) {
  if (D != kD || P < 1 || hl < 1 || wl < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bf16)
    return dispatch<__nv_bfloat16>(variant, value, loc, att, out, B, Q, H, P, hl, wl, st);
  return dispatch<float>(variant, value, loc, att, out, B, Q, H, P, hl, wl, st);
}

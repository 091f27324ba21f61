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
// bilinear and attention weight math, the four corner loads and the store.
//
// Two bodies. Every variant but vec2 runs msda_pair_probe_kernel_d32, K1's
// D = 32 body (msda_fwd_kernel_d32) on one level, on msda_sample.cuh's D = 32
// layout: 8 lanes an item (b, q, h) and 4 channels a lane, the 4 heads of
// one query a warp; one 8-byte (bf16) or 16-byte (f32) load a corner row, one
// 16-byte f32 store a lane; the item's lanes load its samples' float2
// locations and weights 8 samples at a time, coalesced, and every lane reads
// them by shuffles. Only whole warps run: a lane of an item past the end
// takes part in the shuffles with NaN locations and stores nothing. vec2
// runs msda_pair_probe_kernel_vec2: 16 lanes an item, a channel pair a lane.
// With K1's general body (32 lanes an item, a channel a lane) the three make
// a ladder of item widths over the same function.
//
//   base          K1's D = 32 body on the pair: cell and blend4 in K1's
//                 order, its f32 accumulator bit for bit
//   vec2          16 lanes an item, a float2 / bf16x2 corner load a lane,
//                 two items a warp: base's arithmetic per channel
//   bf16fma       base with the four-corner blend in bf16 (two __hfma2 a
//                 corner, the 4 channels as two bf16x2), folded into the f32
//                 accumulator once a sample
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
// corner rows a sample, read from L2, and the instructions a sample; about 8
// flops for each byte read. One pair at 256^2 <- 256^2 in bf16 must move
// 126 MB (value, locations, weights, the f32 output), 38 us at 3.35 TB/s.
// The variants split the time above that between the corner loads, the
// weight math and the launch and store floor. At the probe's P = 4 only
// lanes 0-3 of an item load a sample's location and weight, as on K1 at one
// level; K1 on APE's pyramid takes L * P = 16 samples an item in two rounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "msda_sample.cuh"

namespace {

using namespace ape_msda;

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

constexpr float kConstWeight = 0.01f;  // const_w's weight of every corner

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// 4 channels of a corner row as two bf16x2: one 8-byte load of bf16, one
// 16-byte load of f32 rounded to bf16
__device__ __forceinline__ void load4_bf16(const __nv_bfloat16* p, __nv_bfloat162 (&v)[2]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  v[1] = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
}
__device__ __forceinline__ void load4_bf16(const float* p, __nv_bfloat162 (&v)[2]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = __floats2bfloat162_rn(t.x, t.y);
  v[1] = __floats2bfloat162_rn(t.z, t.w);
}

// The 8-lane body of every variant but vec2. At most 64 registers a thread
// (4 blocks an SM), as K1's D = 32 body.
template <int V, typename VT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
msda_pair_probe_kernel_d32(const VT* __restrict__ value,   // (B, hl * wl, H, kD32)
                           const float* __restrict__ loc,  // (B, Q, H, P, 2), normalized
                           const float* __restrict__ att,  // (B, Q, H, P)
                           float* __restrict__ out,        // (B, Q, H * kD32)
                           int B, int Q, int H, int P, int hl, int wl) {
  constexpr bool kReadsAtt = V == kBase || V == kBf16Fma || V == kBranchless ||
                             V == kNoCorners || V == kStoreOnly;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item within the warp
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  const int64_t first = warp * kItemsPerWarp;
  if (first >= n_items) return;  // whole warps only: every item of this one is past the end
  const bool valid = first + slot < n_items;
  const int64_t item = valid ? first + slot : 0;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);
  const int c0 = sub * 4;
  const int64_t row_stride = static_cast<int64_t>(H) * kD32;
  const VT* vl = value + static_cast<int64_t>(b) * hl * wl * row_stride +
                 static_cast<int64_t>(h) * kD32 + c0;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int64_t samp0 = item * P;
  for (int s0 = 0; s0 < P; s0 += kItemLanes) {
    // the item's next 8 samples: lane sub loads sample s0 + sub (coalesced
    // over the 8 lanes), and every lane of the item reads them by shuffles
    const int mine = s0 + sub;
    float2 my_loc = make_float2(NAN, NAN);
    float my_a = 0.f;
    if (valid && mine < P) {
      if (V != kStoreOnly) my_loc = *reinterpret_cast<const float2*>(loc + 2 * (samp0 + mine));
      if (kReadsAtt) my_a = att[samp0 + mine];
    }
    const int n = min(kItemLanes, P - s0);  // uniform over the warp
    for (int j = 0; j < n; ++j) {
      const int src = slot * kItemLanes + j;
      const float a = kReadsAtt ? __shfl_sync(0xffffffffu, my_a, src) : 0.f;
      if constexpr (V == kStoreOnly) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += a;
        continue;
      }
      const float x = pixel(__shfl_sync(0xffffffffu, my_loc.x, src), wl);
      const float y = pixel(__shfl_sync(0xffffffffu, my_loc.y, src), hl);
      float v00[4] = {0.f, 0.f, 0.f, 0.f}, v01[4] = {0.f, 0.f, 0.f, 0.f};
      float v10[4] = {0.f, 0.f, 0.f, 0.f}, v11[4] = {0.f, 0.f, 0.f, 0.f};
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
        const int64_t cx0 = clampi(x0, wl - 1), cx1 = clampi(x0 + 1, wl - 1);
        const int64_t ry0 = static_cast<int64_t>(clampi(y0, hl - 1)) * wl;
        const int64_t ry1 = static_cast<int64_t>(clampi(y0 + 1, hl - 1)) * wl;
        load4(vl + (ry0 + cx0) * row_stride, v00);
        load4(vl + (ry0 + cx1) * row_stride, v01);
        load4(vl + (ry1 + cx0) * row_stride, v10);
        load4(vl + (ry1 + cx1) * row_stride, v11);
        const float w00 = wx0 * wy0, w01 = wx1 * wy0, w10 = wx0 * wy1, w11 = wx1 * wy1;
        const float as = live(x, y, hl, wl) ? a : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] += as * (w00 * v00[k] + w01 * v01[k] + w10 * v10[k] + w11 * v11[k]);
        continue;
      }
      if (!live(x, y, hl, wl)) continue;
      const Cell c = cell(x, y, hl, wl);
      const int64_t r00 = (static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride;
      const int64_t r01 = r00 + row_stride;
      const int64_t r10 = r00 + static_cast<int64_t>(wl) * row_stride;
      const int64_t r11 = r10 + row_stride;
      if constexpr (V == kNoCorners) {
        float v = 0.f;
        if (c.c00) v += (1.f - c.fx) * (1.f - c.fy);
        if (c.c01) v += c.fx * (1.f - c.fy);
        if (c.c10) v += (1.f - c.fx) * c.fy;
        if (c.c11) v += c.fx * c.fy;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += a * v;
      } else if constexpr (V == kBf16Fma) {
        const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
        __nv_bfloat162 b00[2] = {zero, zero}, b01[2] = {zero, zero};
        __nv_bfloat162 b10[2] = {zero, zero}, b11[2] = {zero, zero};
        if (c.c00) load4_bf16(vl + r00, b00);
        if (c.c01) load4_bf16(vl + r01, b01);
        if (c.c10) load4_bf16(vl + r10, b10);
        if (c.c11) load4_bf16(vl + r11, b11);
        __nv_bfloat162 v[2] = {zero, zero};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (c.c00) v[k] = __hfma2(__float2bfloat162_rn((1.f - c.fx) * (1.f - c.fy)), b00[k], v[k]);
          if (c.c01) v[k] = __hfma2(__float2bfloat162_rn(c.fx * (1.f - c.fy)), b01[k], v[k]);
          if (c.c10) v[k] = __hfma2(__float2bfloat162_rn((1.f - c.fx) * c.fy), b10[k], v[k]);
          if (c.c11) v[k] = __hfma2(__float2bfloat162_rn(c.fx * c.fy), b11[k], v[k]);
        }
        const float2 lo = __bfloat1622float2(v[0]);
        const float2 hi = __bfloat1622float2(v[1]);
        acc[0] += a * lo.x;
        acc[1] += a * lo.y;
        acc[2] += a * hi.x;
        acc[3] += a * hi.y;
      } else {
        if (c.c00) load4(vl + r00, v00);
        if (c.c01) load4(vl + r01, v01);
        if (c.c10) load4(vl + r10, v10);
        if (c.c11) load4(vl + r11, v11);
        if constexpr (V == kBase) {  // K1's sample on one level, rounded as it rounds
          blend4(acc, a, c, v00, v01, v10, v11);
        } else {  // kConstW, kCornersOnly: the corners, at 0.01 or unweighted
          const float w = V == kConstW ? kConstWeight : 1.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k] = fmaf(w, v00[k], acc[k]);
            acc[k] = fmaf(w, v01[k], acc[k]);
            acc[k] = fmaf(w, v10[k], acc[k]);
            acc[k] = fmaf(w, v11[k], acc[k]);
          }
        }
      }
    }
  }
  if (valid) store4(out + item * kD32 + c0, acc);
}

// vec2's channel pair of one corner row, as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The four corners' blend of one live sample for one channel pair, base's
// expressions per channel.
template <typename VT>
__device__ __forceinline__ float2 blend2(const VT* vl, int64_t row_stride, int wl, int hl,
                                         int x0, int y0, float fx, float fy) {
  const VT* r0 = vl + (static_cast<int64_t>(y0) * wl + x0) * row_stride;
  const VT* r1 = r0 + static_cast<int64_t>(wl) * row_stride;
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
}

// vec2's body: half a warp a (b, q, h), a lane per channel pair.
template <typename VT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_pair_probe_kernel_vec2(const VT* __restrict__ value, const float* __restrict__ loc,
                            const float* __restrict__ att, float* __restrict__ out,
                            int B, int Q, int H, int P, int hl, int wl) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t item = 2 * warp + (lane >> 4);
  if (item >= static_cast<int64_t>(B) * Q * H) return;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);
  const int d = 2 * (lane & 15);
  const int64_t row_stride = static_cast<int64_t>(H) * kD32;
  const VT* vl = value + static_cast<int64_t>(b) * hl * wl * row_stride +
                 static_cast<int64_t>(h) * kD32 + d;
  const int64_t samp0 = item * P;
  float2 acc = make_float2(0.f, 0.f);
  for (int p = 0; p < P; ++p) {
    const int64_t s = samp0 + p;
    const float a = att[s];
    const float x = pixel(loc[2 * s], wl);
    const float y = pixel(loc[2 * s + 1], hl);
    if (!live(x, y, hl, wl)) continue;
    const float xf = floorf(x);
    const float yf = floorf(y);
    const float2 v = blend2<VT>(vl, row_stride, wl, hl, static_cast<int>(xf),
                                static_cast<int>(yf), x - xf, y - yf);
    acc.x += a * v.x;
    acc.y += a * v.y;
  }
  *reinterpret_cast<float2*>(out + item * kD32 + d) = acc;
}

template <int V, typename VT>
int launch(const void* value, const float* loc, const float* att, float* out, int B, int Q,
           int H, int P, int hl, int wl, cudaStream_t stream) {
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if constexpr (V == kVec2) {
    constexpr int kItemsPerBlock = kWarpsPerBlock * 2;
    const int64_t blocks = (n_items + kItemsPerBlock - 1) / kItemsPerBlock;
    msda_pair_probe_kernel_vec2<VT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                                      stream>>>(static_cast<const VT*>(value), loc, att, out, B,
                                                Q, H, P, hl, wl);
  } else {
    const int64_t warps = (n_items + kItemsPerWarp - 1) / kItemsPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    msda_pair_probe_kernel_d32<V, VT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                                        stream>>>(static_cast<const VT*>(value), loc, att, out, B,
                                                  Q, H, P, hl, wl);
  }
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
// att (B, Q, H, P) f32; out (B, Q, H * D) f32; D must be 32; value, loc and
// out 16-byte aligned. variant: the index in ops/msda_pair_probe.py's
// VARIANTS. Returns the launch's cudaError_t.
extern "C" int ape_msda_pair_probe(const void* value, const float* loc, const float* att,
                                   float* out, int B, int Q, int H, int P, int hl, int wl, int D,
                                   int variant, int value_bf16, void* stream) {
  if (D != kD32 || P < 1 || hl < 1 || wl < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bf16)
    return dispatch<__nv_bfloat16>(variant, value, loc, att, out, B, Q, H, P, hl, wl, st);
  return dispatch<float>(variant, value, loc, att, out, B, Q, H, P, hl, wl, st);
}

// Per-sample arithmetic of the MSDA kernels. The rounding (pixel) and the
// backward's boundary test (live) are shared by the merged backward
// (msda_bwd.cu) and the split one (msda_bwd_split.cu), so that the two forms
// pick the same corners and boundary cases, and by the pair probe
// (msda_pair_probe.cu), whose base variant K1 checks them against; the
// rounding also by K1 (msda_fwd.cu). The D = 32 bodies share more: K1's,
// K8's and K10's the forward's cell and blend (cell, blend4), K2's and K3's the
// backward's dot products (sample_dots4), K2's and K4's the d_value
// reduction (red_add4). The split kernels' general bodies
// take the rest (corners, weights, dot products, scatter) from Sample and
// its helpers.
//
// A sample at normalized location (lx, ly) on a level of size (H_l, W_l)
// reads pixel (x, y) = loc * size - 0.5 (align_corners=False) and its four
// corners v00 (y0, x0), v01 (y0, x0 + 1), v10 (y0 + 1, x0), v11 (y0 + 1,
// x0 + 1), each zero outside the level.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ape_msda {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLevels = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The level tables of a launch, staged in shared memory by every block.
struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ void load_levels(Levels& lv, const int64_t* shapes,
                                            const int64_t* starts, int L) {
  if (threadIdx.x < L) {
    lv.h[threadIdx.x] = static_cast<int>(shapes[2 * threadIdx.x]);
    lv.w[threadIdx.x] = static_cast<int>(shapes[2 * threadIdx.x + 1]);
    lv.start[threadIdx.x] = static_cast<int>(starts[threadIdx.x]);
  }
  __syncthreads();
}

// Pixel coordinate of a normalized location on a level of `size` pixels,
// rounded as torch rounds loc * size - 0.5 (no FMA contraction): floor() then
// picks the same corners at integer pixels, where d_loc is one-sided.
__device__ __forceinline__ float pixel(float l, int size) {
  return __fsub_rn(__fmul_rn(l, static_cast<float>(size)), 0.5f);
}

// Whether a sample at pixel (x, y) touches a level of size (hl, wl); false for
// NaN, so such a sample contributes nothing. At x = -1 (or y = -1) exactly,
// which the window clip produces, the forward adds 0 but d_loc keeps its
// one-sided slope toward the first column, as the plain version's autograd
// and JAX's VJP have it.
__device__ __forceinline__ bool live(float x, float y, int hl, int wl) {
  return x >= -1.f && y >= -1.f && x < wl && y < hl;
}

// The D = 32 layout of the MSDA bodies for APE's head width (K1-K4, K8, K10):
// 8 lanes an item (b, q, h) and 4 channels a lane, so a warp holds
// kItemsPerWarp = 4 items, and each corner row is read as one vector load a
// lane.
constexpr int kD32 = 32;
constexpr int kItemLanes = 8;
constexpr int kItemsPerWarp = 32 / kItemLanes;

// Sum over the 8 lanes of an item, in 3 shuffle steps.
__device__ __forceinline__ float item_sum(float v) {
#pragma unroll
  for (int off = 1; off < kItemLanes; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 4 channels as f32: one 16-byte load of f32, one 8-byte load of bf16
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// 4 channels from f32: one 16-byte store of f32, one 8-byte store of bf16
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// ---- the forward's blend (K1 msda_fwd.cu, K8 msda_fwd_qlevel.cu) ----

// K1's liveness: a sample touches the level. Strict at -1, unlike live()
// (the backward's): at x = -1 or y = -1 exactly, which the window clip
// produces at the grid's edge, every corner inside the level has weight 0,
// so the forward skips the sample. False for NaN.
__device__ __forceinline__ bool touches(float x, float y, int hl, int wl) {
  return x > -1.f && y > -1.f && x < wl && y < hl;
}

// One corner's term of the blend, v += w * c, as one rounding (an FMA)
__device__ __forceinline__ float blend(float v, float w, float c) { return __fmaf_rn(w, c, v); }

// The cell of a sample at pixel (x, y) that touches a level of (hl, wl):
// its corner 00 at (y0, x0), its fractional position, and which of its
// corners lie inside the level.
struct Cell {
  int x0, y0;
  float fx, fy;
  bool c00, c01, c10, c11;
};

__device__ __forceinline__ Cell cell(float x, float y, int hl, int wl) {
  Cell c;
  const float xf = floorf(x);
  const float yf = floorf(y);
  c.x0 = static_cast<int>(xf);
  c.y0 = static_cast<int>(yf);
  c.fx = x - xf;
  c.fy = y - yf;
  const bool in_y0 = c.y0 >= 0, in_y1 = c.y0 + 1 < hl;
  const bool in_x0 = c.x0 >= 0, in_x1 = c.x0 + 1 < wl;
  c.c00 = in_y0 && in_x0;
  c.c01 = in_y0 && in_x1;
  c.c10 = in_y1 && in_x0;
  c.c11 = in_y1 && in_x1;
  return c;
}

// acc[k] += a * bilinear(k) for a lane's 4 channels k of one sample in cell
// c, from its 4 corners' channels v00 .. v11; a corner outside the level
// reads as 0, and its term w * 0 leaves the sum as the general body's
// skipped term does. Every product and sum is explicitly rounded, so K1's
// D = 32 body, K8's and K10's base, which call this, and K1's general body,
// which writes the same expressions per channel, agree bit for bit. The callers
// load the corners themselves: K1 was 30 % slower (0.245 against 0.187 ms,
// protocol shape, bf16, H100 80GB HBM3, 700 W) with the addresses made by
// one callback a corner instead of one 64-bit offset and three additions.
__device__ __forceinline__ void blend4(float (&acc)[4], float a, const Cell& c,
                                       const float (&v00)[4], const float (&v01)[4],
                                       const float (&v10)[4], const float (&v11)[4]) {
  const float w00 = __fmul_rn(1.f - c.fx, 1.f - c.fy), w01 = __fmul_rn(c.fx, 1.f - c.fy);
  const float w10 = __fmul_rn(1.f - c.fx, c.fy), w11 = __fmul_rn(c.fx, c.fy);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = 0.f;
    v = blend(v, w00, v00[k]);
    v = blend(v, w01, v01[k]);
    v = blend(v, w10, v10[k]);
    v = blend(v, w11, v11[k]);
    acc[k] = __fmaf_rn(a, v, acc[k]);
  }
}

// ---- the backward's dot products (K2 msda_bwd.cu, K3 msda_bwd_split.cu) ----

// A lane's share of a live sample's three dot products over its 4 channels
// g (D = 32 layout): pa += <g, sum_c w_c v_c>, px += <g, dv/dx>, py += <g,
// dv/dy> (pixel units), with the corner weights w00 .. w11 of the fractional
// position (fx, fy). Every product and sum is explicitly rounded, so K2's
// D = 32 body and K3's, which both call this, agree bit for bit.
__device__ __forceinline__ void sample_dots4(const float (&g)[4], float fx, float fy, float w00,
                                             float w01, float w10, float w11,
                                             const float (&v00)[4], const float (&v01)[4],
                                             const float (&v10)[4], const float (&v11)[4],
                                             float& pa, float& px, float& py) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float v = __fmaf_rn(w11, v11[c], __fmaf_rn(w10, v10[c], __fmaf_rn(w01, v01[c],
                                                                           __fmul_rn(w00, v00[c]))));
    const float dx = __fmaf_rn(fy, __fsub_rn(v11[c], v10[c]),
                               __fmul_rn(1.f - fy, __fsub_rn(v01[c], v00[c])));
    const float dy = __fmaf_rn(fx, __fsub_rn(v11[c], v01[c]),
                               __fmul_rn(1.f - fx, __fsub_rn(v10[c], v00[c])));
    pa = __fmaf_rn(g[c], v, pa);
    px = __fmaf_rn(g[c], dx, px);
    py = __fmaf_rn(g[c], dy, py);
  }
}

// ---- the backward's d_value scatter (K2 msda_bwd.cu, K4 msda_bwd_split.cu) ----

// d_value[p .. p + 3] += w * ag[0 .. 3]: one 16-byte vector reduction
// (atomicAdd on float4, global memory, compute capability 9.x). K2's D = 32
// body and K4's call it with the same w and ag, so each addend is the same
// in both; only the order of the atomics differs from run to run.
__device__ __forceinline__ void red_add4(float* p, float w, const float (&ag)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * ag[0], w * ag[1], w * ag[2], w * ag[3]));
}

struct Sample {
  bool live;                       // the sample touches the level at all
  float fx, fy;                    // fractional position inside the cell
  float w00, w01, w10, w11;        // bilinear corner weights
  bool c00, c01, c10, c11;         // corner inside the level
  int64_t r00, r01, r10, r11;      // corner element offsets (row * H * D)
};

// lvl_off: the level's first element offset; row_stride: H * D.
__device__ __forceinline__ Sample make_sample(float lx, float ly, int hl, int wl,
                                              int64_t lvl_off, int64_t row_stride) {
  Sample s;
  const float x = pixel(lx, wl);
  const float y = pixel(ly, hl);
  s.live = live(x, y, hl, wl);
  if (!s.live) return s;
  const float xf = floorf(x);
  const float yf = floorf(y);
  const int x0 = static_cast<int>(xf);
  const int y0 = static_cast<int>(yf);
  s.fx = x - xf;
  s.fy = y - yf;
  const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
  s.c00 = in_y0 && in_x0;
  s.c01 = in_y0 && in_x1;
  s.c10 = in_y1 && in_x0;
  s.c11 = in_y1 && in_x1;
  s.r00 = lvl_off + (static_cast<int64_t>(y0) * wl + x0) * row_stride;
  s.r01 = s.r00 + row_stride;
  s.r10 = s.r00 + static_cast<int64_t>(wl) * row_stride;
  s.r11 = s.r10 + row_stride;
  s.w00 = (1.f - s.fx) * (1.f - s.fy);
  s.w01 = s.fx * (1.f - s.fy);
  s.w10 = (1.f - s.fx) * s.fy;
  s.w11 = s.fx * s.fy;
  return s;
}

// One lane's share of the three dot products of a sample for channel d:
// pa += <g, sum_c w_c v_c>, px += <g, dv/dx>, py += <g, dv/dy> (pixel units).
template <typename VT>
__device__ __forceinline__ void accumulate_dots(const Sample& s, const VT* vb, int d, float g,
                                                float& pa, float& px, float& py) {
  const float v00 = s.c00 ? to_f32(vb[s.r00 + d]) : 0.f;
  const float v01 = s.c01 ? to_f32(vb[s.r01 + d]) : 0.f;
  const float v10 = s.c10 ? to_f32(vb[s.r10 + d]) : 0.f;
  const float v11 = s.c11 ? to_f32(vb[s.r11 + d]) : 0.f;
  pa += g * (s.w00 * v00 + s.w01 * v01 + s.w10 * v10 + s.w11 * v11);
  px += g * ((1.f - s.fy) * (v01 - v00) + s.fy * (v11 - v10));
  py += g * ((1.f - s.fx) * (v10 - v00) + s.fx * (v11 - v01));
}

// One lane's d_value scatter of a sample for channel d: d_value[c] += w_c * ag.
__device__ __forceinline__ void scatter_value(const Sample& s, float* dvb, int d, float ag) {
  if (s.c00) atomicAdd(dvb + s.r00 + d, s.w00 * ag);
  if (s.c01) atomicAdd(dvb + s.r01 + d, s.w01 * ag);
  if (s.c10) atomicAdd(dvb + s.r10 + d, s.w10 * ag);
  if (s.c11) atomicAdd(dvb + s.r11 + d, s.w11 * ag);
}

}  // namespace ape_msda

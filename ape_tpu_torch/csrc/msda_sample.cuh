// Per-sample arithmetic of the MSDA backward kernels. The rounding (pixel)
// and the boundary test (live) are shared by the merged backward
// (msda_bwd.cu) and the split one (msda_bwd_split.cu), so that the two forms
// pick the same corners and boundary cases, and by the pair probe
// (msda_pair_probe.cu), whose base variant K1 checks them against. The split kernels take the rest
// (corners, weights, dot products, scatter) from Sample and its helpers; the
// merged kernel writes the same expressions out, as its registers need.
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

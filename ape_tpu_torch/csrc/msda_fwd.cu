// Multi-scale deformable attention forward: exact bilinear gather.
//
// Replaces the TPU kernel ape_tpu/ops/msda_window_pallas_v2.py
// (ms_deform_attn_window_pallas_v2 -> _run_pair_v2 -> _pair_kernel_v2), the
// encoder's window-clamped MSDA, and serves the decoder's exact MSDA
// (ape_tpu/ops/msda_decoder.py, an XLA gather in JAX) as well. The TPU kernel
// exists because the TPU has no gather unit: it pre-shifts value planes and
// turns the clamped window into dense shift-and-FMA work. Hopper gathers
// natively, so this is a plain gather in the style of the reference CUDA op.
//
//   out[b, q, h*D + d] = sum_{l, p} att[b,q,h,l,p] *
//                        bilinear0(value[b, start_l + ., h, d], loc[b,q,h,l,p])
//
// with pixel = loc * size - 0.5 (align_corners=False) and zero padding.
//
// Two entries. ape_msda_fwd takes the f32 sampling locations (the decoder's,
// and the encoder's under autograd, where torch carries the clip's chain
// rule). ape_msda_fwd_window takes the encoder's f32 pixel offsets and the
// radius, as the TPU kernel does, and forms each location itself:
//
//   loc = center[first_query + q] + clip(off, -R, R) / size_l
//
// from the cached grid-center and level-size tables, rounded as torch rounds
// ops/msda_dispatch.window_locations (a division, then an addition, no
// contraction). The clip is by comparisons: a NaN offset stays NaN, as
// torch.clamp keeps it, and such a sample contributes nothing; +-inf clip to
// +-R. So the window entry equals ape_msda_fwd on window_locations bit for
// bit, and the encoder runs one launch a layer where it ran the clamp, the
// divide and the add before it.
//
// What bounds it on an H100: each sample reads four scattered corner rows of
// D values (64 bytes at D = 32 in bf16), so the kernel is bound by memory
// latency and L2 traffic, not by arithmetic (about 8 flops per byte read);
// the value tensor of APE (11 MB in bf16 at the protocol pyramid) stays
// resident in the 50 MB L2 across the queries of a launch.
//
// Two bodies, chosen by the caller (ops/msda_dispatch.fwd_body):
//   * D = 32, every MSDA layer of APE (8 heads of 32 channels),
//     msda_fwd_kernel_d32: K2's layout (msda_bwd.cu). 8 lanes an item
//     (b, q, h) and 4 channels a lane, so a warp holds 4 items (4 heads of
//     one query). Each corner read is one 8-byte load of 4 bf16 (16 bytes in
//     f32), the output one 8- or 16-byte store a lane. The item's 8 lanes
//     load its locations (one float2 each) and weights 8 samples at a time,
//     coalesced, and every lane reads them by shuffles, where the general
//     body loads each sample's as a dependent warp-wide broadcast. The pair
//     probe K10 measured lanes over channel pairs 37-42 % faster on the
//     corner loads (vec2), and the same layout cut K2 by 42 %.
//   * any D (and D = 32 when asked, so that the card can compare the two):
//     msda_fwd_kernel, one warp per (b, q, h), the lanes over D, each corner
//     read one coalesced row of the (B, S, H, D) value tensor.
//
// Both bodies accumulate in f32 per channel in the same (l, p) order with the
// same explicitly rounded expressions (msda_sample.cuh's blend and blend4),
// and K10's base variant (msda_pair_probe.cu) and K8's D = 32
// body (msda_fwd_qlevel.cu) write the same ones: they agree bit for bit.

#include <math.h>

#include "msda_sample.cuh"

namespace {

using namespace ape_msda;

// The window entry's inputs; unused (all zero) by the location entry.
struct Window {
  const float* centers;  // (S, 2) normalized (x, y) centers of the pyramid grid's cells
  const float* sizes;    // (L, 2) level sizes (W, H) as f32
  float radius;
  int first_query;       // grid index of query 0
};

// The window entry's level sizes (W, H) as f32, staged in shared memory
// beside the level tables (synchronised by load_levels).
template <bool kWindow>
__device__ __forceinline__ void load_sizes(float (&size)[kMaxLevels][2], const Window& win,
                                           int L) {
  if (kWindow && threadIdx.x < L) {
    size[threadIdx.x][0] = win.sizes[2 * threadIdx.x];
    size[threadIdx.x][1] = win.sizes[2 * threadIdx.x + 1];
  }
}

// clip(o, -r, r) by comparisons: NaN stays NaN (torch.clamp), +-inf -> +-r
__device__ __forceinline__ float clip(float o, float r) {
  return o < -r ? -r : (o > r ? r : o);
}

// A sample's normalized location: the location entry's as given, the window
// entry's center + clip(off, -R, R) / size, rounded as torch rounds it.
template <bool kWindow>
__device__ __forceinline__ float2 sample_loc(float2 in, float2 center,
                                             const float (&size)[kMaxLevels][2], int l,
                                             float radius) {
  if (!kWindow) return in;
  return make_float2(__fadd_rn(center.x, __fdiv_rn(clip(in.x, radius), size[l][0])),
                     __fadd_rn(center.y, __fdiv_rn(clip(in.y, radius), size[l][1])));
}

// Registers: the location entry's instances at most 32 a thread (8 blocks an
// SM), the window entry's, which hold the center and radius besides, at most
// 64 (4 blocks an SM): held to 32, they spilled.
template <typename VT, typename AT, bool kWindow>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kWindow ? 4 : 8)
msda_fwd_kernel(const VT* __restrict__ value,        // (B, S, H, D)
                const float* __restrict__ loc,       // (B, Q, H, L, P, 2): locations or offsets
                const AT* __restrict__ att,          // (B, Q, H, L, P)
                const int64_t* __restrict__ shapes,  // (L, 2) as (H_l, W_l)
                const int64_t* __restrict__ starts,  // (L,)
                const Window win,
                VT* __restrict__ out,                // (B, Q, H * D)
                int B, int S, int Q, int H, int D, int L, int P) {
  __shared__ Levels lv;
  __shared__ float size[kMaxLevels][2];
  load_sizes<kWindow>(size, win, L);
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (item >= n_items) return;
  const int h = static_cast<int>(item % H);
  const int64_t bq = item / H;               // b * Q + q
  const int b = static_cast<int>(bq / Q);
  float2 center = make_float2(0.f, 0.f);
  if (kWindow) {
    const int64_t g = win.first_query + bq % Q;
    center = make_float2(win.centers[2 * g], win.centers[2 * g + 1]);
  }

  const int64_t samp0 = item * L * P;         // first (l, p) sample of this (b, q, h)
  const VT* vb = value + static_cast<int64_t>(b) * S * H * D + static_cast<int64_t>(h) * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const VT* vl = vb + static_cast<int64_t>(lv.start[l]) * row_stride;
      for (int p = 0; p < P; ++p) {
        const int64_t s = samp0 + l * P + p;
        const float a = to_f32(att[s]);
        const float2 xy = sample_loc<kWindow>(make_float2(loc[2 * s], loc[2 * s + 1]), center,
                                              size, l, win.radius);
        const float x = pixel(xy.x, wl);
        const float y = pixel(xy.y, hl);
        if (!touches(x, y, hl, wl)) continue;
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float fx = x - xf;
        const float fy = y - yf;
        if (!active) continue;
        float v = 0.f;
        if (y0 >= 0) {
          if (x0 >= 0)
            v = blend(v, __fmul_rn(1.f - fx, 1.f - fy),
                      to_f32(vl[(static_cast<int64_t>(y0) * wl + x0) * row_stride + d]));
          if (x0 + 1 < wl)
            v = blend(v, __fmul_rn(fx, 1.f - fy),
                      to_f32(vl[(static_cast<int64_t>(y0) * wl + x0 + 1) * row_stride + d]));
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0)
            v = blend(v, __fmul_rn(1.f - fx, fy),
                      to_f32(vl[(static_cast<int64_t>(y0 + 1) * wl + x0) * row_stride + d]));
          if (x0 + 1 < wl)
            v = blend(v, __fmul_rn(fx, fy),
                      to_f32(vl[(static_cast<int64_t>(y0 + 1) * wl + x0 + 1) * row_stride + d]));
        }
        acc = __fmaf_rn(a, v, acc);
      }
    }
    if (active) out[item * D + d] = from_f32<VT>(acc);
  }
}

// The D = 32 body, on msda_sample.cuh's D = 32 layout: 8 lanes an item and 4
// channels a lane, kItemsPerWarp = 4 items a warp, 4 heads of one query
// (item = bq * H + h, 4 at a time), the order K2 measured fastest. At most
// 64 registers a thread (4 blocks an SM).
template <typename VT, typename AT, bool kWindow>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
msda_fwd_kernel_d32(const VT* __restrict__ value, const float* __restrict__ loc,
                    const AT* __restrict__ att, const int64_t* __restrict__ shapes,
                    const int64_t* __restrict__ starts, const Window win,
                    VT* __restrict__ out, int B, int S, int Q, int H, int L, int P) {
  __shared__ Levels lv;
  __shared__ float size[kMaxLevels][2];
  load_sizes<kWindow>(size, win, L);
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item within the warp
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  const int64_t first = warp * kItemsPerWarp;
  if (first >= n_items) return;  // whole warps only: every item of this one is past the end
  // a lane of an item past the end (the last warp's) loads nothing and
  // stores nothing, but takes part in the shuffles with NaN locations
  const bool valid = first + slot < n_items;
  const int64_t item = valid ? first + slot : 0;
  const int h = static_cast<int>(item % H);
  const int64_t bq = item / H;
  const int b = static_cast<int>(bq / Q);
  const int c0 = sub * 4;
  const VT* vb = value + static_cast<int64_t>(b) * S * H * kD32 + static_cast<int64_t>(h) * kD32 + c0;
  const int64_t row_stride = static_cast<int64_t>(H) * kD32;
  float2 center = make_float2(0.f, 0.f);
  if (kWindow && valid)
    center = *reinterpret_cast<const float2*>(win.centers + 2 * (win.first_query + bq % Q));

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int LP = L * P;
  const int64_t samp0 = item * LP;
  for (int s0 = 0; s0 < LP; s0 += kItemLanes) {
    // the item's next 8 samples: lane sub loads sample s0 + sub (coalesced
    // over the 8 lanes), and every lane of the item reads them by shuffles
    const int mine = s0 + sub;
    float2 my_loc = make_float2(NAN, NAN);
    float my_a = 0.f;
    if (valid && mine < LP) {
      my_loc = sample_loc<kWindow>(*reinterpret_cast<const float2*>(loc + 2 * (samp0 + mine)),
                                   center, size, mine / P, win.radius);
      my_a = to_f32(att[samp0 + mine]);
    }
    const int n = min(kItemLanes, LP - s0);  // uniform over the warp
    for (int j = 0; j < n; ++j) {
      const int src = slot * kItemLanes + j;
      const float lx = __shfl_sync(0xffffffffu, my_loc.x, src);
      const float ly = __shfl_sync(0xffffffffu, my_loc.y, src);
      const float a = __shfl_sync(0xffffffffu, my_a, src);
      const int l = (s0 + j) / P;
      const int hl = lv.h[l];
      const int wl = lv.w[l];
      const float x = pixel(lx, wl);
      const float y = pixel(ly, hl);
      if (!touches(x, y, hl, wl)) continue;
      const Cell c = cell(x, y, hl, wl);
      const int64_t r00 = static_cast<int64_t>(lv.start[l]) * row_stride +
                          (static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride;
      const int64_t r01 = r00 + row_stride;
      const int64_t r10 = r00 + static_cast<int64_t>(wl) * row_stride;
      const int64_t r11 = r10 + row_stride;
      float v00[4] = {0.f, 0.f, 0.f, 0.f}, v01[4] = {0.f, 0.f, 0.f, 0.f};
      float v10[4] = {0.f, 0.f, 0.f, 0.f}, v11[4] = {0.f, 0.f, 0.f, 0.f};
      if (c.c00) load4(vb + r00, v00);
      if (c.c01) load4(vb + r01, v01);
      if (c.c10) load4(vb + r10, v10);
      if (c.c11) load4(vb + r11, v11);
      blend4(acc, a, c, v00, v01, v10, v11);
    }
  }
  if (valid) store4(out + item * kD32 + c0, acc);
}

template <typename VT, typename AT, bool kWindow>
int launch(const void* value, const float* loc, const void* att, const int64_t* shapes,
           const int64_t* starts, const Window& win, void* out, int B, int S, int Q, int H, int D,
           int L, int P, bool d32, cudaStream_t stream) {
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (d32) {
    const int64_t warps = (n_items + kItemsPerWarp - 1) / kItemsPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    msda_fwd_kernel_d32<VT, AT, kWindow>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts, win,
            static_cast<VT*>(out), B, S, Q, H, L, P);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_fwd_kernel<VT, AT, kWindow><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts, win,
      static_cast<VT*>(out), B, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWindow>
int dispatch(const void* value, const float* loc, const void* att, const int64_t* shapes,
             const int64_t* starts, const Window& win, void* out, int B, int S, int Q, int H,
             int D, int L, int P, int value_bf16, int att_f32, int body, void* stream) {
  if (L > kMaxLevels || L < 1 || P < 1 || D < 1 || body < 0 || body > 1 ||
      (body == 1 && D != kD32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d32 = body == 1;
  if (value_bf16) {
    if (att_f32)
      return launch<__nv_bfloat16, float, kWindow>(value, loc, att, shapes, starts, win, out, B, S,
                                                   Q, H, D, L, P, d32, st);
    return launch<__nv_bfloat16, __nv_bfloat16, kWindow>(value, loc, att, shapes, starts, win, out,
                                                         B, S, Q, H, D, L, P, d32, st);
  }
  return launch<float, float, kWindow>(value, loc, att, shapes, starts, win, out, B, S, Q, H, D, L,
                                       P, d32, st);
}

}  // namespace

// value_bf16: value and out are bf16 (else f32). att_f32: attention weights
// are f32 (else the value dtype). body: 0 the general body, 1 the D = 32 body
// (D must be 32; value, loc and out 16-byte aligned). Returns the launch's
// cudaError_t.
extern "C" int ape_msda_fwd(const void* value, const float* loc, const void* att,
                            const int64_t* shapes, const int64_t* starts, void* out,
                            int B, int S, int Q, int H, int D, int L, int P,
                            int value_bf16, int att_f32, int body, void* stream) {
  return dispatch<false>(value, loc, att, shapes, starts, Window{nullptr, nullptr, 0.f, 0}, out,
                         B, S, Q, H, D, L, P, value_bf16, att_f32, body, stream);
}

// The window entry: pixel_offsets (B, Q, H, L, P, 2) f32 in value-level
// pixels, clipped to [-radius, radius], around the centers (S, 2) of the
// grid cells first_query .. first_query + Q - 1; sizes (L, 2) f32 as (W, H).
// Otherwise as ape_msda_fwd.
extern "C" int ape_msda_fwd_window(const void* value, const float* pixel_offsets, const void* att,
                                   const int64_t* shapes, const int64_t* starts,
                                   const float* centers, const float* sizes, float radius,
                                   int first_query, void* out, int B, int S, int Q, int H, int D,
                                   int L, int P, int value_bf16, int att_f32, int body,
                                   void* stream) {
  return dispatch<true>(value, pixel_offsets, att, shapes, starts,
                        Window{centers, sizes, radius, first_query}, out, B, S, Q, H, D, L, P,
                        value_bf16, att_f32, body, stream);
}

// Multi-scale deformable attention backward: gradients of the exact bilinear
// gather of msda_fwd.cu with respect to value, locations and weights.
//
// Replaces the TPU kernel ape_tpu/ops/msda_window_pallas_bwd.py
// (ms_deform_attn_window_pallas_bwd -> _run_pair_grad_merged, the merged
// d_value / d_offsets / d_att pass, K2), the encoder's window-MSDA backward,
// and serves the decoder's exact-MSDA backward as well (ape_tpu/ops/
// msda_decoder.py _dec_bwd, an XLA gather VJP plus a dense matmul in JAX).
// The TPU kernel works on pre-shifted value planes because the TPU has no
// scatter unit; Hopper has native atomics, so this is the scatter-add
// backward of the reference CUDA op. The window clip and the division by the
// level size stay in the caller (torch autograd carries their chain rule):
// the kernel takes the f32 locations the forward sampled at.
//
// For each (b, q, h) and sample s = (l, p), with g = dL/dout[b, q, h, :],
// a = att[s], pixel (x, y) = loc * (W_l, H_l) - 0.5 and corner weights
// w_c of the four corners v_c (zero outside the level):
//
//   d_att[s]    = <g, sum_c w_c v_c>
//   d_loc[s].x  = a * <g, (1-fy)(v01 - v00) + fy (v11 - v10)> * W_l
//   d_loc[s].y  = a * <g, (1-fx)(v10 - v00) + fx (v11 - v01)> * H_l
//   d_value[c] += a * w_c * g            (f32 atomicAdd)
//
// A NaN or out-of-range sample contributes nothing, as in the forward (which
// also skips x = -1 or y = -1 exactly, where it would add 0).
//
// What bounds it on an H100: the scatter. Every sample adds four rows of D
// floats into d_value with atomics, against the same four corner reads as the
// forward. d_value is an f32 buffer the caller zeroes and casts back to the
// value dtype; atomics make its sums run-order dependent at the last bits.
//
// Two bodies, one branch on D in the launch:
//   * D = 32, every MSDA layer of APE (8 heads of 32 channels): 8 lanes an
//     item (b, q, h) and 4 channels a lane, so a warp holds 4 items (4 heads
//     of one query). Each corner read is one 8-byte load of 4
//     bf16 (16 bytes in f32), each corner's d_value update one 16-byte
//     vector reduction (atomicAdd on float4, compute capability 9.x): 4x
//     fewer reduction instructions than lanes over D, and loads on channel
//     groups, which the pair probe K10 measured 37-42 % faster on the
//     forward's gather (vec2). The 8 lanes load the item's locations and
//     weights 8 samples at a time, coalesced, and share them by shuffles; the
//     three dot products take 3 shuffle steps over the 8 lanes, and lane j
//     stores the results of its sample j. At most 64 registers a thread
//     (__launch_bounds__ with 4 blocks an SM).
//   * any other D: one warp per (b, q, h), lanes over D, each corner read
//     and each atomic row one coalesced 128-byte transaction, the dot
//     products by warp shuffles.
//
// The rounding of loc * size - 0.5 and the boundary test come from
// msda_sample.cuh, shared with the split form (msda_bwd_split.cu), so the
// two forms pick the same corners and boundary cases; the D = 32 body's dot
// products too (sample_dots4, which K3's D = 32 body calls), so K3's d_loc
// and d_att there equal this body's bit for bit. The rest of the per-sample
// arithmetic is the same expressions as that header's Sample helpers,
// written out here: through the Sample struct the bf16 instantiations took
// 80 registers a thread instead of 64 and ran ~11 % slower on an H100.

#include <math.h>

#include "msda_sample.cuh"

namespace {

using namespace ape_msda;

template <typename VT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const VT* __restrict__ value,        // (B, S, H, D)
                const float* __restrict__ loc,       // (B, Q, H, L, P, 2)
                const AT* __restrict__ att,          // (B, Q, H, L, P)
                const int64_t* __restrict__ shapes,  // (L, 2) as (H_l, W_l)
                const int64_t* __restrict__ starts,  // (L,)
                const VT* __restrict__ grad_out,     // (B, Q, H * D)
                float* __restrict__ d_value,         // (B, S, H, D), zeroed by the caller
                float* __restrict__ d_loc,           // (B, Q, H, L, P, 2)
                float* __restrict__ d_att,           // (B, Q, H, L, P)
                int B, int S, int Q, int H, int D, int L, int P) {
  __shared__ Levels lv;
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (item >= n_items) return;  // whole warps only: item is uniform in a warp
  const int h = static_cast<int>(item % H);
  const int64_t bq = item / H;
  const int b = static_cast<int>(bq / Q);

  const int64_t samp0 = item * L * P;
  const int64_t base = static_cast<int64_t>(b) * S * H * D + static_cast<int64_t>(h) * D;
  const VT* vb = value + base;
  float* dvb = d_value + base;
  const VT* gq = grad_out + item * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int64_t lvl_off = static_cast<int64_t>(lv.start[l]) * row_stride;
    for (int p = 0; p < P; ++p) {
      const int64_t s = samp0 + l * P + p;
      const float a = to_f32(att[s]);
      const float x = pixel(loc[2 * s], wl);
      const float y = pixel(loc[2 * s + 1], hl);
      if (!live(x, y, hl, wl)) {
        if (lane == 0) {
          d_att[s] = 0.f;
          d_loc[2 * s] = 0.f;
          d_loc[2 * s + 1] = 0.f;
        }
        continue;
      }
      const float xf = floorf(x);
      const float yf = floorf(y);
      const int x0 = static_cast<int>(xf);
      const int y0 = static_cast<int>(yf);
      const float fx = x - xf;
      const float fy = y - yf;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
      const int64_t r00 = lvl_off + (static_cast<int64_t>(y0) * wl + x0) * row_stride;
      const int64_t r01 = r00 + row_stride;
      const int64_t r10 = r00 + static_cast<int64_t>(wl) * row_stride;
      const int64_t r11 = r10 + row_stride;
      const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
      const float w10 = (1.f - fx) * fy, w11 = fx * fy;

      float pa = 0.f, px = 0.f, py = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float g = to_f32(gq[d]);
        const float v00 = (in_y0 && in_x0) ? to_f32(vb[r00 + d]) : 0.f;
        const float v01 = (in_y0 && in_x1) ? to_f32(vb[r01 + d]) : 0.f;
        const float v10 = (in_y1 && in_x0) ? to_f32(vb[r10 + d]) : 0.f;
        const float v11 = (in_y1 && in_x1) ? to_f32(vb[r11 + d]) : 0.f;
        pa += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
        px += g * ((1.f - fy) * (v01 - v00) + fy * (v11 - v10));
        py += g * ((1.f - fx) * (v10 - v00) + fx * (v11 - v01));
        const float ag = a * g;
        if (in_y0 && in_x0) atomicAdd(dvb + r00 + d, w00 * ag);
        if (in_y0 && in_x1) atomicAdd(dvb + r01 + d, w01 * ag);
        if (in_y1 && in_x0) atomicAdd(dvb + r10 + d, w10 * ag);
        if (in_y1 && in_x1) atomicAdd(dvb + r11 + d, w11 * ag);
      }
      pa = warp_sum(pa);
      px = warp_sum(px);
      py = warp_sum(py);
      if (lane == 0) {
        d_att[s] = pa;
        d_loc[2 * s] = a * px * wl;
        d_loc[2 * s + 1] = a * py * hl;
      }
    }
  }
}

// The D = 32 body (APE's every MSDA layer: 8 heads of 32 channels), on
// msda_sample.cuh's D = 32 layout: 8 lanes an item and 4 channels a lane, so
// a warp holds kItemsPerWarp = 4 items. A warp's 4 items are 4 heads of one
// query (item = bq * H + h, 4 at a time): on an H100 80GB HBM3 at 700 W that
// order ran 0.2-0.4 % faster than one head of 4 neighbouring queries at the
// encoder's training shape (4.90-4.91 against 4.92 ms), and tied at the
// decoder's.

// d_value[p .. p + 3] += w * ag[0 .. 3]: one 16-byte vector reduction
// (atomicAdd on float4, global memory, compute capability 9.x)
__device__ __forceinline__ void red_add4(float* p, float w, const float (&ag)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(w * ag[0], w * ag[1], w * ag[2], w * ag[3]));
}

template <typename VT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
msda_bwd_kernel_d32(const VT* __restrict__ value, const float* __restrict__ loc,
                    const AT* __restrict__ att, const int64_t* __restrict__ shapes,
                    const int64_t* __restrict__ starts, const VT* __restrict__ grad_out,
                    float* __restrict__ d_value, float* __restrict__ d_loc,
                    float* __restrict__ d_att, int B, int S, int Q, int H, int L, int P) {
  __shared__ Levels lv;
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item within the warp
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  const int64_t first = warp * kItemsPerWarp;
  if (first >= n_items) return;  // whole warps only: every item of this one is past the end
  // a lane of an item past the end (the last warp's) loads nothing and
  // stores nothing, but takes part in the shuffles
  const bool valid = first + slot < n_items;
  const int64_t item = valid ? first + slot : 0;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);
  const int c0 = sub * 4;
  const int64_t base = static_cast<int64_t>(b) * S * H * kD32 + static_cast<int64_t>(h) * kD32 + c0;
  const VT* vb = value + base;
  float* dvb = d_value + base;
  const int64_t row_stride = static_cast<int64_t>(H) * kD32;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) load4(grad_out + item * kD32 + c0, g);

  const int LP = L * P;
  const int64_t samp0 = item * LP;
  for (int s0 = 0; s0 < LP; s0 += kItemLanes) {
    // the item's next 8 samples: lane sub loads sample s0 + sub (coalesced
    // over the 8 lanes), and every lane of the item reads them by shuffles
    const int mine = s0 + sub;
    const bool mine_ok = valid && mine < LP;
    float2 my_loc = make_float2(NAN, NAN);
    float my_a = 0.f;
    if (mine_ok) {
      my_loc = *reinterpret_cast<const float2*>(loc + 2 * (samp0 + mine));
      my_a = to_f32(att[samp0 + mine]);
    }
    float out_att = 0.f, out_x = 0.f, out_y = 0.f;  // lane sub's own sample
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
      float pa = 0.f, px = 0.f, py = 0.f;
      if (live(x, y, hl, wl)) {
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float fx = x - xf;
        const float fy = y - yf;
        const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < hl;
        const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < wl;
        const int64_t r00 = static_cast<int64_t>(lv.start[l]) * row_stride +
                            (static_cast<int64_t>(y0) * wl + x0) * row_stride;
        const int64_t r01 = r00 + row_stride;
        const int64_t r10 = r00 + static_cast<int64_t>(wl) * row_stride;
        const int64_t r11 = r10 + row_stride;
        const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
        const float w10 = (1.f - fx) * fy, w11 = fx * fy;
        float v00[4] = {0.f, 0.f, 0.f, 0.f}, v01[4] = {0.f, 0.f, 0.f, 0.f};
        float v10[4] = {0.f, 0.f, 0.f, 0.f}, v11[4] = {0.f, 0.f, 0.f, 0.f};
        if (in_y0 && in_x0) load4(vb + r00, v00);
        if (in_y0 && in_x1) load4(vb + r01, v01);
        if (in_y1 && in_x0) load4(vb + r10, v10);
        if (in_y1 && in_x1) load4(vb + r11, v11);
        sample_dots4(g, fx, fy, w00, w01, w10, w11, v00, v01, v10, v11, pa, px, py);
        float ag[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) ag[c] = a * g[c];
        if (in_y0 && in_x0) red_add4(dvb + r00, w00, ag);
        if (in_y0 && in_x1) red_add4(dvb + r01, w01, ag);
        if (in_y1 && in_x0) red_add4(dvb + r10, w10, ag);
        if (in_y1 && in_x1) red_add4(dvb + r11, w11, ag);
      }
      pa = item_sum(pa);
      px = item_sum(px);
      py = item_sum(py);
      if (sub == j) {
        out_att = pa;
        out_x = a * px * wl;
        out_y = a * py * hl;
      }
    }
    if (mine_ok) {
      d_att[samp0 + mine] = out_att;
      *reinterpret_cast<float2*>(d_loc + 2 * (samp0 + mine)) = make_float2(out_x, out_y);
    }
  }
}

template <typename VT, typename AT>
int launch(const void* value, const float* loc, const void* att, const int64_t* shapes,
           const int64_t* starts, const void* grad_out, float* d_value, float* d_loc,
           float* d_att, int B, int S, int Q, int H, int D, int L, int P, cudaStream_t stream) {
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (D == kD32) {
    const int64_t warps = (n_items + kItemsPerWarp - 1) / kItemsPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    msda_bwd_kernel_d32<VT, AT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts,
        static_cast<const VT*>(grad_out), d_value, d_loc, d_att, B, S, Q, H, L, P);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_bwd_kernel<VT, AT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts,
      static_cast<const VT*>(grad_out), d_value, d_loc, d_att, B, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value_bf16: value and grad_out are bf16 (else f32). att_f32: attention
// weights are f32 (else the value dtype). d_value (zeroed), d_loc and d_att
// are f32. Returns the launch's cudaError_t.
extern "C" int ape_msda_bwd(const void* value, const float* loc, const void* att,
                            const int64_t* shapes, const int64_t* starts, const void* grad_out,
                            float* d_value, float* d_loc, float* d_att,
                            int B, int S, int Q, int H, int D, int L, int P,
                            int value_bf16, int att_f32, void* stream) {
  if (L > kMaxLevels || L < 1 || P < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bf16) {
    if (att_f32)
      return launch<__nv_bfloat16, float>(value, loc, att, shapes, starts, grad_out, d_value,
                                          d_loc, d_att, B, S, Q, H, D, L, P, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(value, loc, att, shapes, starts, grad_out,
                                                 d_value, d_loc, d_att, B, S, Q, H, D, L, P, st);
  }
  return launch<float, float>(value, loc, att, shapes, starts, grad_out, d_value, d_loc, d_att,
                              B, S, Q, H, D, L, P, st);
}

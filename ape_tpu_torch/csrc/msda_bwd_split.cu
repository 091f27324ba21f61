// Multi-scale deformable attention backward, split form: one kernel for the
// gradients of the sampling locations and the attention weights, one for the
// gradient of the value. Together they compute what msda_bwd.cu (the merged
// form) computes in one pass, with the same rounding and boundary test and
// the same per-sample expressions (msda_sample.cuh).
//
// Replaces the TPU kernels of ape_tpu/ops/msda_window_pallas_bwd.py that the
// encoder's window-MSDA backward runs under APE_MSDA_BWD_MERGED=0:
//   _run_pair_grad_offatt (K3): d_offsets and d_att of one (query level,
//     value level) pair, reading the value planes;
//   _run_pair_grad_value (K4): the d_value contribution of one pair, reading
//     no value at all.
// The TPU kernels work on pre-shifted value planes per level pair because the
// TPU cannot gather or scatter. Hopper can, so each kernel here takes the f32
// sampling locations the forward used, over all levels in one launch; the
// window clip and the division by the level size stay in the caller (torch
// autograd carries their chain rule).
//
// For each (b, q, h) and sample s = (l, p), with g = dL/dout[b, q, h, :],
// a = att[s] and the corner weights w_c of the four corners v_c:
//
//   msda_bwd_offatt:  d_att[s]   = <g, sum_c w_c v_c>
//                     d_loc[s].x = a * <g, (1-fy)(v01 - v00) + fy (v11 - v10)> * W_l
//                     d_loc[s].y = a * <g, (1-fx)(v10 - v00) + fx (v11 - v01)> * H_l
//   msda_bwd_value:   d_value[c] += a * w_c * g        (f32 atomicAdd)
//
// What bounds them on an H100. msda_bwd_offatt: the four scattered corner
// reads per sample, as the forward (memory latency and L2 traffic); it writes
// each output once and uses no atomics, so it is deterministic. msda_bwd_value:
// the scatter, four coalesced 128-byte atomic rows per sample into a d_value
// buffer the caller zeroes (f32) and casts back.
//
// msda_bwd_offatt has two bodies, chosen by the caller (ops/msda_dispatch.
// fwd_body, as for K1):
//   * D = 32, every MSDA layer of APE: msda_bwd_offatt_kernel_d32, K2's D = 32
//     body (msda_bwd.cu) without the scatter. 8 lanes an item and 4 channels
//     a lane, 4 items a warp; the grad row is loaded once, 4 channels a lane,
//     each corner read is one 8-byte load of 4 bf16 (16 bytes in f32); the
//     item's 8 lanes load its locations and weights 8 samples at a time,
//     coalesced, and share them by shuffles; the three dot products
//     (msda_sample.cuh's sample_dots4, which K2 calls too) reduce over the
//     item's 8 lanes in 3 shuffle steps, and lane j stores sample j's d_att
//     and its d_loc as one float2. Its d_loc and d_att equal K2's bit for bit
//     (with bf16 weights d_att is K2's f32 d_att rounded once).
//   * any D (and D = 32 when asked, so that the card can compare the two):
//     msda_bwd_offatt_kernel, one warp per (b, q, h), lanes over D, dot
//     products by warp shuffles.
// msda_bwd_value has two bodies too, chosen the same way:
//   * D = 32: msda_bwd_value_kernel_d32, K2's D = 32 body without the gather
//     and the dot products. 8 lanes an item and 4 channels a lane, 4 items a
//     warp (4 heads of one query); the grad row loaded once, 4 channels a
//     lane; the item's 8 lanes load its locations (float2) and weights 8
//     samples at a time, coalesced, and share them by shuffles; for each
//     live sample the lanes form ag = a * g and add each corner inside the
//     level by msda_sample.cuh's red_add4, one 16-byte vector reduction a
//     lane and corner (REDG.E.ADD.F32x4), which K2's D = 32 body calls with
//     the same addends: a quarter of the reduction instructions of lanes
//     over D, and no load of the sample in every lane. It reads no value.
//     Its d_value differs from K2's only by the run-dependent order of the
//     f32 atomics. What bounds it is the L2's reduction throughput, as K2's
//     scatter: 4 corners x 32 f32 channels a sample.
//   * any D (and D = 32 when asked): msda_bwd_value_kernel, one warp per
//     (b, q, h), lanes over D, one scalar reduction a lane and corner.

#include "msda_sample.cuh"

namespace {

using namespace ape_msda;

template <typename VT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_offatt_kernel(const VT* __restrict__ value,        // (B, S, H, D)
                       const float* __restrict__ loc,       // (B, Q, H, L, P, 2)
                       const AT* __restrict__ att,          // (B, Q, H, L, P)
                       const int64_t* __restrict__ shapes,  // (L, 2) as (H_l, W_l)
                       const int64_t* __restrict__ starts,  // (L,)
                       const VT* __restrict__ grad_out,     // (B, Q, H * D)
                       float* __restrict__ d_loc,           // (B, Q, H, L, P, 2)
                       AT* __restrict__ d_att,              // (B, Q, H, L, P)
                       int B, int S, int Q, int H, int D, int L, int P) {
  __shared__ Levels lv;
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (item >= n_items) return;  // whole warps only: item is uniform in a warp
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);

  const int64_t samp0 = item * L * P;
  const VT* vb = value + static_cast<int64_t>(b) * S * H * D + static_cast<int64_t>(h) * D;
  const VT* gq = grad_out + item * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int64_t lvl_off = static_cast<int64_t>(lv.start[l]) * row_stride;
    for (int p = 0; p < P; ++p) {
      const int64_t s = samp0 + l * P + p;
      const Sample smp = make_sample(loc[2 * s], loc[2 * s + 1], hl, wl, lvl_off, row_stride);
      float pa = 0.f, px = 0.f, py = 0.f;
      if (smp.live) {
        for (int d = lane; d < D; d += 32) accumulate_dots(smp, vb, d, to_f32(gq[d]), pa, px, py);
        pa = warp_sum(pa);
        px = warp_sum(px);
        py = warp_sum(py);
      }
      if (lane == 0) {
        const float a = to_f32(att[s]);
        d_att[s] = from_f32<AT>(pa);
        d_loc[2 * s] = a * px * wl;
        d_loc[2 * s + 1] = a * py * hl;
      }
    }
  }
}

// The D = 32 body: K2's D = 32 body without the scatter (msda_bwd.cu). A
// warp's 4 items are 4 heads of one query (item = bq * H + h, 4 at a time).
// At most 64 registers a thread (4 blocks an SM).
template <typename VT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
msda_bwd_offatt_kernel_d32(const VT* __restrict__ value, const float* __restrict__ loc,
                           const AT* __restrict__ att, const int64_t* __restrict__ shapes,
                           const int64_t* __restrict__ starts, const VT* __restrict__ grad_out,
                           float* __restrict__ d_loc, AT* __restrict__ d_att, int B, int S, int Q,
                           int H, int L, int P) {
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
  const VT* vb = value + static_cast<int64_t>(b) * S * H * kD32 + static_cast<int64_t>(h) * kD32 + c0;
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
      d_att[samp0 + mine] = from_f32<AT>(out_att);
      *reinterpret_cast<float2*>(d_loc + 2 * (samp0 + mine)) = make_float2(out_x, out_y);
    }
  }
}

template <typename GT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_value_kernel(const float* __restrict__ loc,       // (B, Q, H, L, P, 2)
                      const AT* __restrict__ att,          // (B, Q, H, L, P)
                      const int64_t* __restrict__ shapes,  // (L, 2) as (H_l, W_l)
                      const int64_t* __restrict__ starts,  // (L,)
                      const GT* __restrict__ grad_out,     // (B, Q, H * D)
                      float* __restrict__ d_value,         // (B, S, H, D), zeroed by the caller
                      int B, int S, int Q, int H, int D, int L, int P) {
  __shared__ Levels lv;
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (item >= n_items) return;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);

  const int64_t samp0 = item * L * P;
  float* dvb = d_value + static_cast<int64_t>(b) * S * H * D + static_cast<int64_t>(h) * D;
  const GT* gq = grad_out + item * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;

  for (int l = 0; l < L; ++l) {
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int64_t lvl_off = static_cast<int64_t>(lv.start[l]) * row_stride;
    for (int p = 0; p < P; ++p) {
      const int64_t s = samp0 + l * P + p;
      const Sample smp = make_sample(loc[2 * s], loc[2 * s + 1], hl, wl, lvl_off, row_stride);
      if (!smp.live) continue;
      const float a = to_f32(att[s]);
      for (int d = lane; d < D; d += 32) scatter_value(smp, dvb, d, a * to_f32(gq[d]));
    }
  }
}

// The D = 32 body (see the note at the top). A warp's 4 items are 4 heads
// of one query (item = bq * H + h, 4 at a time). At most 64 registers a
// thread (4 blocks an SM).
template <typename GT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
msda_bwd_value_kernel_d32(const float* __restrict__ loc, const AT* __restrict__ att,
                          const int64_t* __restrict__ shapes, const int64_t* __restrict__ starts,
                          const GT* __restrict__ grad_out, float* __restrict__ d_value, int B,
                          int S, int Q, int H, int L, int P) {
  __shared__ Levels lv;
  load_levels(lv, shapes, starts, L);

  const int lane = threadIdx.x & 31;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item within the warp
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  const int64_t first = warp * kItemsPerWarp;
  if (first >= n_items) return;  // whole warps only: every item of this one is past the end
  // a lane of an item past the end (the last warp's) loads nothing and adds
  // nothing, but takes part in the shuffles
  const bool valid = first + slot < n_items;
  const int64_t item = valid ? first + slot : 0;
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Q);
  const int c0 = sub * 4;
  float* dvb = d_value + static_cast<int64_t>(b) * S * H * kD32 + static_cast<int64_t>(h) * kD32 + c0;
  const int64_t row_stride = static_cast<int64_t>(H) * kD32;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  if (valid) load4(grad_out + item * kD32 + c0, g);

  const int LP = L * P;
  const int64_t samp0 = item * LP;
  for (int s0 = 0; s0 < LP; s0 += kItemLanes) {
    // the item's next 8 samples: lane sub loads sample s0 + sub (coalesced
    // over the 8 lanes), and every lane of the item reads them by shuffles
    const int mine = s0 + sub;
    float2 my_loc = make_float2(NAN, NAN);
    float my_a = 0.f;
    if (valid && mine < LP) {
      my_loc = *reinterpret_cast<const float2*>(loc + 2 * (samp0 + mine));
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
        float ag[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) ag[c] = a * g[c];
        if (in_y0 && in_x0) red_add4(dvb + r00, w00, ag);
        if (in_y0 && in_x1) red_add4(dvb + r01, w01, ag);
        if (in_y1 && in_x0) red_add4(dvb + r10, w10, ag);
        if (in_y1 && in_x1) red_add4(dvb + r11, w11, ag);
      }
    }
  }
}

inline unsigned n_blocks(int B, int Q, int H) {
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  return static_cast<unsigned>((n_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename VT, typename AT>
int launch_offatt(const void* value, const float* loc, const void* att, const int64_t* shapes,
                  const int64_t* starts, const void* grad_out, float* d_loc, void* d_att,
                  int B, int S, int Q, int H, int D, int L, int P, bool d32,
                  cudaStream_t stream) {
  if (d32) {
    const int64_t warps = (static_cast<int64_t>(B) * Q * H + kItemsPerWarp - 1) / kItemsPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    msda_bwd_offatt_kernel_d32<VT, AT>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts,
            static_cast<const VT*>(grad_out), d_loc, static_cast<AT*>(d_att), B, S, Q, H, L, P);
    return static_cast<int>(cudaGetLastError());
  }
  msda_bwd_offatt_kernel<VT, AT><<<n_blocks(B, Q, H), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts,
      static_cast<const VT*>(grad_out), d_loc, static_cast<AT*>(d_att), B, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename GT, typename AT>
int launch_value(const float* loc, const void* att, const int64_t* shapes, const int64_t* starts,
                 const void* grad_out, float* d_value, int B, int S, int Q, int H, int D, int L,
                 int P, bool d32, cudaStream_t stream) {
  if (d32) {
    const int64_t warps = (static_cast<int64_t>(B) * Q * H + kItemsPerWarp - 1) / kItemsPerWarp;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    msda_bwd_value_kernel_d32<GT, AT>
        <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
            loc, static_cast<const AT*>(att), shapes, starts, static_cast<const GT*>(grad_out),
            d_value, B, S, Q, H, L, P);
    return static_cast<int>(cudaGetLastError());
  }
  msda_bwd_value_kernel<GT, AT><<<n_blocks(B, Q, H), kWarpsPerBlock * 32, 0, stream>>>(
      loc, static_cast<const AT*>(att), shapes, starts, static_cast<const GT*>(grad_out), d_value,
      B, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

int check_sizes(int D, int L, int P) {
  if (L > kMaxLevels || L < 1 || P < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// value_bf16: value and grad_out are bf16 (else f32). att_f32: attention
// weights, and so d_att, are f32 (else the value dtype). d_loc is f32. body:
// 0 the general body, 1 the D = 32 body (D must be 32; value, loc, grad_out
// and d_loc 16-byte aligned). Returns the launch's cudaError_t.
extern "C" int ape_msda_bwd_offatt(const void* value, const float* loc, const void* att,
                                   const int64_t* shapes, const int64_t* starts,
                                   const void* grad_out, float* d_loc, void* d_att,
                                   int B, int S, int Q, int H, int D, int L, int P,
                                   int value_bf16, int att_f32, int body, void* stream) {
  if (const int err = check_sizes(D, L, P)) return err;
  if (body < 0 || body > 1 || (body == 1 && D != kD32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d32 = body == 1;
  if (value_bf16) {
    if (att_f32)
      return launch_offatt<__nv_bfloat16, float>(value, loc, att, shapes, starts, grad_out, d_loc,
                                                 d_att, B, S, Q, H, D, L, P, d32, st);
    return launch_offatt<__nv_bfloat16, __nv_bfloat16>(value, loc, att, shapes, starts, grad_out,
                                                        d_loc, d_att, B, S, Q, H, D, L, P, d32,
                                                        st);
  }
  return launch_offatt<float, float>(value, loc, att, shapes, starts, grad_out, d_loc, d_att,
                                     B, S, Q, H, D, L, P, d32, st);
}

// grad_bf16: grad_out is bf16 (else f32). att_f32: attention weights are f32
// (else grad_out's dtype). d_value is f32, zeroed by the caller. body: 0 the
// general body, 1 the D = 32 body (D must be 32; loc, grad_out and d_value
// 16-byte aligned). Returns the launch's cudaError_t.
extern "C" int ape_msda_bwd_value(const float* loc, const void* att, const int64_t* shapes,
                                  const int64_t* starts, const void* grad_out, float* d_value,
                                  int B, int S, int Q, int H, int D, int L, int P,
                                  int grad_bf16, int att_f32, int body, void* stream) {
  if (const int err = check_sizes(D, L, P)) return err;
  if (body < 0 || body > 1 || (body == 1 && D != kD32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d32 = body == 1;
  if (grad_bf16) {
    if (att_f32)
      return launch_value<__nv_bfloat16, float>(loc, att, shapes, starts, grad_out, d_value,
                                                B, S, Q, H, D, L, P, d32, st);
    return launch_value<__nv_bfloat16, __nv_bfloat16>(loc, att, shapes, starts, grad_out, d_value,
                                                       B, S, Q, H, D, L, P, d32, st);
  }
  return launch_value<float, float>(loc, att, shapes, starts, grad_out, d_value,
                                    B, S, Q, H, D, L, P, d32, st);
}

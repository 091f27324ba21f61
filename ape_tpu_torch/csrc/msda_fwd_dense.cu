// Window-MSDA forward with dense tap weights, per wide query level (K9).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v6.py
// (ms_deform_attn_window_pallas_v6 -> _run_pair_v6): for query levels whose
// width is a multiple of 128, value tiles held channels-major so that the
// P points' bilinear hats, summed into one weight per window tap, scale all
// channels at once, with no MXU weight expansion; the narrower query levels
// stay on the v2 chain. Here they go to K1 (msda_fwd.cu), one launch over
// their contiguous query rows, made by ops/msda_window_forms.py.
//
// What bounds it on an H100: the function's bytes, as K1's (value,
// offsets, weights and output once, about 57 MB at the protocol pyramid in
// bf16, 17 us at 3.35 TB/s); but this form chooses more arithmetic: one FMA
// per (tap, channel), win^2 = (2 ceil(R) + 3)^2 = 121 taps a level at R = 4,
// against 4 P = 16 corner FMAs of the gather, about 6.8 GFLOP of f32 FMAs
// at the protocol pyramid (0.10 ms at 67 TFLOP/s).
//
// The design: one block per (query tile, head, batch) walks every value
// level of its query level in order, re-using one shared-memory buffer: the
// tile's footprint staged by cp.async for a level as fine as the query
// level or coarser, or each query's own window, staged by its warp, for a
// finer level (msda_window.cuh). For each (query, level) a warp's lanes
// first turn the P samples into (x, y, weight) triples in shared memory
// (lane = point, with K1's boundary test), then build the dense win x win
// tap map, lane = tap, w(u, v) = sum_p a_p hat(u - x_p) hat(v - y_p); then
// the lanes, over the head's channels, contract the map against the staged
// window, one FMA per tap and channel, no per-point corner loads and no
// data-dependent skipping. The window covers every bilinear corner of the
// query's samples, and the box is zero outside the level, so the map gives
// K1's sum up to rounding (the hats round (x0 + 1) - x where K1 rounds fx).

#include "msda_window.cuh"

namespace {

using namespace ape_msda_win;

__device__ __forceinline__ float hat(float t) { return fmaxf(0.f, 1.f - fabsf(t)); }

template <typename VT, typename AT>
__device__ __forceinline__ void dense_level(float (&acc)[kQueriesPerWarp], const Plan& p,
                                            const Tile& t, int j, const VT* value,
                                            const float* off, const AT* att, const VT* smem,
                                            float* taps, int warp, int lane) {
  const int l = p.lv[j];
  const Level<VT> lv = level(p, value, t, l);
  const bool fine = finer(p, l);
  const int win = p.win;
  const int n_taps = win * win;
  float* samples = taps + n_taps;  // (x, y, weight) of each point, window-relative
  Box<VT> bx;
  if (!fine) bx = tile_box(p, t, j, smem);
  VT* wbuf = const_cast<VT*>(smem) + p.win_off + warp * win * win * p.D;
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) {
    const QueryRef r = query_ref(p, t, warp, k);
    if (!r.valid) break;
    const int wy = window_base(r.qy, p.hq, lv.h, win);
    const int wx = window_base(r.qx, p.wq, lv.w, win);
    if (fine) {
      bx.s = wbuf;
      bx.y0 = wy;
      bx.x0 = wx;
      bx.h = bx.w = win;
      stage_window(wbuf, lv, wy, wx, win, p.D, lane);
    }
    if (lane < p.P) {
      const int64_t s = (r.item * p.L + l) * p.P + lane;
      const float x = sample_pixel(center(r.qx, p.wq), off[2 * s], p.radius, lv.w);
      const float y = sample_pixel(center(r.qy, p.hq), off[2 * s + 1], p.radius, lv.h);
      const bool live = x > -1.f && y > -1.f && x < lv.w && y < lv.h;
      samples[3 * lane] = live ? x - wx : 0.f;
      samples[3 * lane + 1] = live ? y - wy : 0.f;
      samples[3 * lane + 2] = live ? to_f32(att[s]) : 0.f;
    }
    __syncwarp();
    for (int tp = lane; tp < n_taps; tp += 32) {
      const int v = tp / win;
      const float u = static_cast<float>(tp - v * win);
      float w = 0.f;
      for (int pp = 0; pp < p.P; ++pp)
        w += samples[3 * pp + 2] * hat(u - samples[3 * pp]) *
             hat(static_cast<float>(v) - samples[3 * pp + 1]);
      taps[tp] = w;
    }
    __syncwarp();
    if (lane < p.D) {
      float sum = 0.f;
      for (int v = 0; v < win; ++v) {
        const int yy = wy + v;
        if (yy < 0 || yy >= lv.h) continue;  // zero padding
        for (int u = 0; u < win; ++u) {
          const int xx = wx + u;
          if (xx < 0 || xx >= lv.w) continue;
          sum += taps[v * win + u] * corner(bx, lv, yy, xx, lane, p.D);
        }
      }
      acc[k] += sum;
    }
    __syncwarp();  // every lane is done with the taps and the window
  }
}

template <typename VT, typename AT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_dense_kernel(const void* value_, const float* off, const void* att_, void* out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VT* value = static_cast<const VT*>(value_);
  const AT* att = static_cast<const AT*>(att_);
  VT* smem = reinterpret_cast<VT*>(smem_raw);
  const Tile t = make_tile(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* taps = reinterpret_cast<float*>(smem_raw + p.tap_off) +
                warp * (p.win * p.win + 3 * kMaxPoints);
  float acc[kQueriesPerWarp];
  init_tile(acc, p, t, out, warp, lane);
  for (int j = 0; j < p.n_lv; ++j) {
    const bool fine = finer(p, p.lv[j]);
    if (!fine) {
      stage_box(tile_box(p, t, j, smem), level(p, value, t, p.lv[j]), p.D);
      cp_async_wait(0);
      __syncthreads();
    }
    dense_level<VT, AT>(acc, p, t, j, value, off, att, smem, taps, warp, lane);
    if (!fine) __syncthreads();  // every warp is done with the box before the next level
  }
  write_tile<VT>(acc, p, t, out, warp, lane);
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_dense, msda_fwd_dense_kernel)

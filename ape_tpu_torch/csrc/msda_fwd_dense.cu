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
// bf16, 17 us at 3.35 TB/s); but this form chooses more arithmetic, a dense
// weight for every tap a query's window holds.
//
// Two bodies, chosen by ops/msda_window_forms.py (dense_body) by the head
// width and the value's dtype:
//
//  * D = 32 and a bf16 value, every MSDA layer of APE in bf16:
//    msda_fwd_dense_kernel_d32, the taps as a matrix product on the tensor
//    cores. One block of 4 warps per (query tile of at most 32 queries, head,
//    batch). The tile's rows are two m16 blocks of mma.sync m16n8k16
//    (bf16_mma.cuh). For each value level as fine as the query level or
//    coarser, in order, re-using one set of buffers:
//      1. the box that covers the tile's query windows (the plan's bound,
//         box_extent) is staged in bf16 by one TMA load through a tensor
//         map over the level (msda_window.cuh, shared with K8), zeros
//         outside the level, one 64-byte row a pixel in the TMA's 64-byte
//         swizzle, so that the 8 rows an ldmatrix reads below fall in 8
//         bank groups; the block zeros the pixels past the box up to a
//         multiple of 16 (TMA, not every thread's cp.async into the
//         same layout, which ran slower on an H100 80GB HBM3 at 700 W:
//         PERF.md);
//      2. the tile's weight matrix W (tile rows x box pixels, f32, rows
//         padded to a stride of 8 mod 32 floats, so that the A fragment
//         loads are free of bank conflicts; zeroed once a block): the 4
//         threads of each query row add a_p * w_c for each live corner of
//         the query's P samples into their row, one point at a time (the 4
//         corners of a point are 4 pixels, a thread each), and after the
//         products set the entries they wrote back to 0. The placement is
//         K1's window entry's (msda_window.cuh sample_pixel, msda_sample.cuh
//         touches and cell) and the corner weights blend4's, so W carries
//         K1's corner weights, not the hats' rounding; a NaN sample adds
//         nothing and +-inf offsets clip to +-R;
//      3. out_tile += W V_box on the tensor cores, k over the box pixels
//         that the m16 block's windows span: each A fragment is read from W
//         as f32 pairs and split into hi = bf16(w) and lo = bf16(w - hi),
//         two products a k-step, so the weights keep about 2^-16 of
//         themselves while V is bf16 and exact; B fragments come from the
//         box by ldmatrix.trans, as K5 reads V; the sums stay in f32. The
//         4 warps are (m16 block, half of the k-steps), each over all 32
//         channels, so W is read once; the two halves meet in the f32 out
//         tile in shared memory.
//    A finer value level (only the 4-scale pyramid's 128^2 query level reads
//    one, the 256^2 level) is read from device memory with K1's 8-lane
//    sampling (4 queries a warp, one 8-byte load a corner, cell and blend4)
//    into the same out tile before the box levels, as K8's D = 32 body reads
//    it: its box would grow with the ratio of the sizes (26 x 26 pixels for
//    a 4 x 8 tile), and W with it past the 2 blocks an SM that shared memory
//    allows; the value sits in L2. Every live corner of a staged level
//    falls in its m16 block's staged rows and the box's columns (band(),
//    below, says why), so W holds all of them.
//    Out tile, W and one box: 61,456 bytes at a 4 x 8 tile, 3 blocks an SM.
//    The next level's box is staged while its W is built, and each thread's
//    first sample of the next level loaded while this level runs. A second
//    box buffer, to stage a level's box while the level before runs, cost a
//    block an SM and ran slower (H100 80GB HBM3, 700 W). A variant argument
//    skips parts of the op to time them (ops/msda_window_forms.py
//    DENSE_D32_VARIANTS).
//  * any D <= 32, and f32, whose 1e-5 bound bf16 products cannot meet:
//    msda_fwd_dense_kernel, one block per (query tile, head, batch) walks
//    every value level of its query level in order, re-using one
//    shared-memory buffer: the tile's footprint staged by cp.async for a
//    level as fine as the query level or coarser, or each query's own
//    window, staged by its warp, for a finer level (msda_window.cuh). For
//    each (query, level) a warp's lanes first turn the P samples into (x,
//    y, weight) triples in shared memory (lane = point, with K1's boundary
//    test), then build the dense win x win tap map, lane = tap, w(u, v) =
//    sum_p a_p hat(u - x_p) hat(v - y_p); then the lanes, over the head's
//    channels, contract the map against the staged window, one FMA per tap
//    and channel (win^2 = 121 taps a level at R = 4 against the gather's 16
//    corner FMAs), no per-point corner loads and no data-dependent
//    skipping. The window covers every bilinear corner of the query's
//    samples, and the box is zero outside the level, so the map gives K1's
//    sum up to rounding (the hats round (x0 + 1) - x where K1 rounds fx).

#include "bf16_mma.cuh"
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
      ape_msda_win::cp_async_wait(0);
      __syncthreads();
    }
    dense_level<VT, AT>(acc, p, t, j, value, off, att, smem, taps, warp, lane);
    if (!fine) __syncthreads();  // every warp is done with the box before the next level
  }
  write_tile<VT>(acc, p, t, out, warp, lane);
}

// ---- the D = 32 body on the tensor cores ----------------------------------

using ape_msda::blend4;
using ape_msda::cell;
using ape_msda::Cell;
using ape_msda::kD32;
using ape_msda::kItemLanes;
using ape_msda::kItemsPerWarp;
using ape_msda::load4;
using ape_msda::store4;
using ape_msda::touches;

constexpr int kDenseWarps = 4;
constexpr int kDenseThreads = kDenseWarps * 32;
constexpr int kDenseRows = 32;          // a tile's rows, padded: two m16 blocks
constexpr int kQueryLanes = 4;          // threads a query row has for W: one corner each
constexpr int kBoxRow = kD32;           // bf16 a staged pixel: 64 bytes, swizzled
constexpr int kBoxAlign = 1024;         // bytes: the box's address, for the swizzle
constexpr int kOutRow = kD32 + 8;       // f32 an out-tile row: 160 bytes
constexpr int kOutBytes = kDenseRows * kOutRow * 4;
static_assert(kDenseRows * kQueryLanes == kDenseThreads, "a query row's threads");

// What a launch of the D = 32 body does (the variant argument): the whole
// op; or, to time its parts, the box levels alone (no finer level), the
// finer levels alone, the box levels without the products, or only their
// staging. Only kWhole's output is the op's (ops/msda_window_forms.py:
// DENSE_D32_VARIANTS).
enum DenseVariant { kWhole = 0, kBoxesOnly = 1, kFinerOnly = 2, kNoMma = 3, kStagingOnly = 4 };

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The D = 32 body's shared memory: the f32 out tile, W (kDenseRows rows of
// w_stride floats), one box of k_max staged pixels at a kBoxAlign-byte
// aligned offset, the box's mbarrier. The same sums as
// ops/msda_window_forms.py's _dense_d32_layout.
struct DenseLayout {
  int k_max, w_stride, w_off, box_off, bar_off, bytes;
};

__host__ __device__ __forceinline__ DenseLayout dense_layout(const Plan& p) {
  DenseLayout d;
  d.k_max = 16;
  for (int j = 0; j < p.n_lv; ++j) {
    if (finer(p, p.lv[j])) continue;
    const int k = round_up(p.box_h[j] * p.box_w[j], 16);
    d.k_max = k > d.k_max ? k : d.k_max;
  }
  d.w_stride = round_up(d.k_max, 32) + 8;
  d.w_off = kOutBytes;
  d.box_off = round_up(d.w_off + kDenseRows * d.w_stride * 4, kBoxAlign);
  d.bar_off = d.box_off + d.k_max * kBoxRow * 2;
  d.bytes = d.bar_off + 16;
  return d;
}

// Query i of the tile: its item (b * Q + q) * H + h and its place on the
// query level.
struct TileQuery {
  int64_t item;
  int qy, qx;
};

__device__ __forceinline__ TileQuery tile_query(const Plan& p, const Tile& t, int i) {
  TileQuery r;
  const int iy = i / t.nx;
  r.qy = t.qy0 + iy;
  r.qx = t.qx0 + i - iy * t.nx;
  const int64_t q = p.q_start + static_cast<int64_t>(r.qy) * p.wq + r.qx;
  r.item = (static_cast<int64_t>(t.b) * p.Q + q) * p.H + t.h;
  return r;
}

// The staged rows of one m16 block of the tile on a box level: box rows
// [lo, hi) (relative to the box's first row y0), which the windows of the
// block's queries span, and the k-steps [k_lo, k_hi) of 16 box pixels that
// hold them; empty for a block past the tile's n queries.
//
// Every live corner of a query of the block lies in these rows, and in the
// box's columns, so W holds all of them. Per axis, with c = pixel(center),
// the window starts at base = floor(c + 1/2) - ceil(R) - 1, and a sample's
// pixel is c + clip(o) within rounding (a few 1e-5 pixels at 256 pixels a
// side), so its corners floor(c + o) and floor(c + o) + 1 lie in
// [floor(c + 1/2) - ceil(R) - 1, floor(c + 1/2) + ceil(R) + 1], half a pixel
// inside [base, base + win) on each side. window_base grows with the
// query's row, so the block's windows span rows [lo, hi); box_extent bounds
// the spread of the tile's bases plus a window, so the box holds every
// column. tests/test_torch_dense_d32.py sweeps +-R, +-inf and offsets a
// rounding step either side of +-R over every query of the planned tiles.
struct Band {
  int lo, hi, k_lo, k_hi;
};

__device__ __forceinline__ Band band(const Plan& p, const Tile& t, int n, int m, int hl, int y0,
                                     int bh, int bw) {
  Band r{0, 0, 0, 0};
  if (16 * m >= n) return r;
  const int i0 = 16 * m, i1 = min(16 * m + 15, n - 1);
  r.lo = max(window_base(t.qy0 + i0 / t.nx, p.hq, hl, p.win) - y0, 0);
  r.hi = min(window_base(t.qy0 + i1 / t.nx, p.hq, hl, p.win) - y0 + p.win, bh);
  if (r.hi <= r.lo) {
    r.hi = r.lo;
    return r;
  }
  r.k_lo = r.lo * bw / 16;
  r.k_hi = (r.hi * bw + 15) / 16;
  return r;
}

// Adds the finer levels' samples to the out tile by K1's 8-lane sampling
// from device memory: 4 queries a warp, 4 channels a lane.
template <typename AT>
__device__ __forceinline__ void dense_finer(const Plan& p, const Tile& t, int n,
                                            const __nv_bfloat16* vb, const float* off,
                                            const AT* att, float* otile, int warp, int lane) {
  const int sub = lane & (kItemLanes - 1);
  const int slot = lane / kItemLanes;
  const int c0 = sub * 4;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD32;
  for (int i0 = warp * kItemsPerWarp; i0 < n; i0 += kDenseWarps * kItemsPerWarp) {
    const int i = i0 + slot;
    const bool valid = i < n;
    const TileQuery r = tile_query(p, t, valid ? i : 0);
    const float cx = center(r.qx, p.wq), cy = center(r.qy, p.hq);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < p.n_lv; ++j) {
      const int l = p.lv[j];
      if (!finer(p, l)) continue;  // uniform
      const int hl = p.lvl_h[l], wl = p.lvl_w[l];
      const int64_t s_base = (r.item * p.L + l) * p.P;
      for (int s0 = 0; s0 < p.P; s0 += kItemLanes) {
        const int mine = s0 + sub;
        float my_x = NAN, my_y = NAN, my_a = 0.f;
        if (valid && mine < p.P) {
          const float2 o = *reinterpret_cast<const float2*>(off + 2 * (s_base + mine));
          my_x = sample_pixel(cx, o.x, p.radius, wl);
          my_y = sample_pixel(cy, o.y, p.radius, hl);
          my_a = to_f32(att[s_base + mine]);
        }
        const int nn = min(kItemLanes, p.P - s0);  // uniform over the warp
        for (int jj = 0; jj < nn; ++jj) {
          const int src = slot * kItemLanes + jj;
          const float x = __shfl_sync(0xffffffffu, my_x, src);
          const float y = __shfl_sync(0xffffffffu, my_y, src);
          const float a = __shfl_sync(0xffffffffu, my_a, src);
          if (!touches(x, y, hl, wl)) continue;
          const Cell c = cell(x, y, hl, wl);
          const __nv_bfloat16* v00 = vb + (static_cast<int64_t>(p.lvl_start[l]) +
                                           static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride + c0;
          float c00[4] = {0.f, 0.f, 0.f, 0.f}, c01[4] = {0.f, 0.f, 0.f, 0.f};
          float c10[4] = {0.f, 0.f, 0.f, 0.f}, c11[4] = {0.f, 0.f, 0.f, 0.f};
          if (c.c00) load4(v00, c00);
          if (c.c01) load4(v00 + row_stride, c01);
          if (c.c10) load4(v00 + wl * row_stride, c10);
          if (c.c11) load4(v00 + (wl + 1) * row_stride, c11);
          blend4(acc, a, c, c00, c01, c10, c11);
        }
      }
    }
    if (valid) {
      float4* o = reinterpret_cast<float4*>(otile + i * kOutRow + c0);
      const float4 v = *o;
      *o = make_float4(v.x + acc[0], v.y + acc[1], v.z + acc[2], v.w + acc[3]);
    }
  }
}

// The next launch level after j whose box is staged; n_lv if none.
__device__ __forceinline__ int next_box_level(const Plan& p, int j) {
  do {
    ++j;
  } while (j < p.n_lv && finer(p, p.lv[j]));
  return j;
}

// Element offset of 16-byte piece c (of 4) of staged pixel px: 64-byte rows
// swizzled as TMA's 64-byte mode lays them out (the piece index XOR bits 1-2
// of the pixel), so that the 8 rows an ldmatrix reads fall in 8 different
// 16-byte bank groups.
__device__ __forceinline__ int box_at(int px, int c) {
  return px * kBoxRow + 8 * (c ^ ((px >> 1) & 3));
}

// Stages launch level j's box of the tile into buf by TMA: thread 0 arms the
// barrier for the box's bytes and issues one load through the level's
// tensor map (zeros outside the level); every thread zeros the pixels past
// the box up to a multiple of 16. The block must have synchronised since
// its last reads of buf.
__device__ __forceinline__ void tma_dense_box(const Plan& p, const Tile& t, int j,
                                              const TileMaps& maps, __nv_bfloat16* buf,
                                              uint64_t* bar) {
  const int l = p.lv[j];
  const int bh = p.box_h[j], bw = p.box_w[j];
  if (threadIdx.x == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, bh * bw * kD32 * 2);
    tma_load_box(buf, &maps.map[j], bar, 0, t.h, window_base(t.qx0, p.wq, p.lvl_w[l], p.win),
                 window_base(t.qy0, p.hq, p.lvl_h[l], p.win), t.b);
  }
  const int tail = round_up(bh * bw, 16) - bh * bw;
  for (int e = threadIdx.x; e < tail * 4; e += kDenseThreads)
    *reinterpret_cast<uint4*>(buf + (bh * bw + (e >> 2)) * kBoxRow + 8 * (e & 3)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// A sample's pixel offsets and weight, as loaded; NaN offsets and weight 0
// for a sample past the query's P or a query past the tile.
struct Point {
  float2 o;
  float a;
};

template <typename AT>
__device__ __forceinline__ Point load_point(const Plan& p, int64_t item, int l, int pt, bool valid,
                                            const float* off, const AT* att) {
  Point r{make_float2(NAN, NAN), 0.f};
  if (valid && pt < p.P) {
    const int64_t s = (item * p.L + l) * p.P + pt;
    r.o = *reinterpret_cast<const float2*>(off + 2 * s);
    r.a = to_f32(att[s]);
  }
  return r;
}

template <typename AT>
__global__ void __launch_bounds__(kDenseThreads)
msda_fwd_dense_kernel_d32(const __nv_bfloat16* __restrict__ value, const float* __restrict__ off,
                          const AT* __restrict__ att, void* __restrict__ out, const Plan p,
                          __grid_constant__ const TileMaps maps, const int variant) {
  extern __shared__ __align__(kBoxAlign) unsigned char smem_raw[];
  const DenseLayout ly = dense_layout(p);
  float* otile = reinterpret_cast<float*>(smem_raw);
  float* W = reinterpret_cast<float*>(smem_raw + ly.w_off);
  __nv_bfloat16* box = reinterpret_cast<__nv_bfloat16*>(smem_raw + ly.box_off);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + ly.bar_off);
  const bool products = variant != kNoMma && variant != kStagingOnly;
  const bool finer_part = variant == kWhole || variant == kFinerOnly;
  uint32_t phase = 0;  // the box barrier's phase: one a staged level
  const Tile t = make_tile(p);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = t.ny * t.nx;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD32;
  const __nv_bfloat16* vb = value + static_cast<int64_t>(t.b) * p.S * row_stride + t.h * kD32;

  // the first box level's box on its way; the out tile 0, or the f32
  // partial of an earlier launch (out mode 2); W 0 (its entries go back to
  // 0 after each level's products)
  int j = variant == kFinerOnly ? p.n_lv : next_box_level(p, -1);
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  if (j < p.n_lv) tma_dense_box(p, t, j, maps, box, bar);
  for (int e = tid; e < kDenseRows * 8; e += kDenseThreads) {
    const int i = e >> 3, c0 = (e & 7) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (p.out_mode == 2 && i < n)
      load4(static_cast<const float*>(out) + tile_query(p, t, i).item * kD32 + c0, v);
    *reinterpret_cast<float4*>(otile + i * kOutRow + c0) = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int e = tid; e < kDenseRows * ly.w_stride / 4; e += kDenseThreads)
    reinterpret_cast<float4*>(W)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  bool any_finer = false;
  for (int jj = 0; jj < p.n_lv; ++jj) any_finer |= finer(p, p.lv[jj]);
  __syncthreads();
  if (any_finer && finer_part) {
    dense_finer<AT>(p, t, n, vb, off, att, otile, warp, lane);
    __syncthreads();  // every warp's rows are in before the products add to them
  }

  // W's rows: thread tid adds corner `corner` of each sample of query `qi`
  const int qi = tid / kQueryLanes, corner = tid % kQueryLanes;
  const bool q_valid = qi < n;
  const TileQuery me = tile_query(p, t, q_valid ? qi : 0);
  const float cx = center(me.qx, p.wq), cy = center(me.qy, p.hq);
  const int mb_me = qi / 16;  // the m16 block of the query's row
  float* w_row = W + qi * ly.w_stride;
  // the products: warp (mb, kh) takes m16 block mb and every other k-step
  // from kh, over all 32 channels (4 n8 tiles); W's hi and lo halves sum
  // into accumulators of their own, two chains of dependent products
  const int mb = warp & 1, kh = warp >> 1;
  const int g = lane >> 2, tq = lane & 3;
  const LaneOffsets at(lane);
  float acc[4][4] = {}, acc_lo[4][4] = {};

  // the box levels in order; the next level's box is staged after this
  // level's products, while the next level's W is built, and each thread's
  // first point of the next level is loaded while this level runs
  Point next = load_point(p, me.item, j < p.n_lv ? p.lv[j] : 0, corner, q_valid && j < p.n_lv,
                          off, att);
  while (j < p.n_lv) {
    const int jn = next_box_level(p, j);
    const Point first = next;
    if (jn < p.n_lv) next = load_point(p, me.item, p.lv[jn], corner, q_valid, off, att);
    const int l = p.lv[j];
    const int hl = p.lvl_h[l], wl = p.lvl_w[l];
    const int by0 = window_base(t.qy0, p.hq, hl, p.win);
    const int bx0 = window_base(t.qx0, p.wq, wl, p.win);
    const int bh = p.box_h[j], bw = p.box_w[j];
    // the staged rows of the query's m16 block and of the warp's
    const Band mine = band(p, t, n, mb_me, hl, by0, bh, bw);
    const Band ours = band(p, t, n, mb, hl, by0, bh, bw);
    // W: the query's 4 threads add its samples' corner weights into its
    // row, one point at a time; with P <= 4 each thread keeps the entries
    // it wrote, to set them back to 0 after the products
    int wrote[kQueryLanes] = {-1, -1, -1, -1};
    if (variant != kStagingOnly) {
      for (int p0 = 0; p0 < p.P; p0 += kQueryLanes) {
        // thread `corner` places point p0 + corner; the 4 share by shuffles
        const Point pt =
            p0 == 0 ? first : load_point(p, me.item, l, p0 + corner, q_valid, off, att);
        float my_x = NAN, my_y = NAN;
        if (q_valid && p0 + corner < p.P) {
          my_x = sample_pixel(cx, pt.o.x, p.radius, wl);
          my_y = sample_pixel(cy, pt.o.y, p.radius, hl);
        }
        const int np = min(kQueryLanes, p.P - p0);  // uniform
#pragma unroll
        for (int jj = 0; jj < kQueryLanes; ++jj) {
          if (jj >= np) break;
          const float x = __shfl_sync(0xffffffffu, my_x, jj, kQueryLanes);
          const float y = __shfl_sync(0xffffffffu, my_y, jj, kQueryLanes);
          const float a = __shfl_sync(0xffffffffu, pt.a, jj, kQueryLanes);
          if (touches(x, y, hl, wl)) {
            const Cell c = cell(x, y, hl, wl);
            const int dy = corner >> 1, dx = corner & 1;
            const bool inside = corner == 0 ? c.c00 : corner == 1 ? c.c01 : corner == 2 ? c.c10
                                                                                       : c.c11;
            const float wx = dx ? c.fx : 1.f - c.fx;
            const float wy = dy ? c.fy : 1.f - c.fy;
            const float w = __fmul_rn(wx, wy);  // blend4's corner weight
            const int ry = c.y0 + dy - by0, rx = c.x0 + dx - bx0;
            // always in the block's rows and the box's columns (band()); the
            // check keeps W's writes inside the row whatever the inputs
            if (inside && ry >= mine.lo && ry < mine.hi &&
                static_cast<unsigned>(rx) < static_cast<unsigned>(bw)) {
              const int k = ry * bw + rx;
              w_row[k] = __fmaf_rn(a, w, w_row[k]);
              if (p0 == 0) wrote[jj] = k;
            }
          }
          __syncwarp();  // the next point may add to the same pixel
        }
      }
    }
    mbar_wait(bar, phase++ & 1);
    __syncthreads();  // W and the box are complete
    // out_tile += W V_box: hi and lo halves of W, f32 sums
    if (products) {
      const float* wa = W + (16 * mb + g) * ly.w_stride + 2 * tq;
      for (int ks = ours.k_lo + kh; ks < ours.k_hi; ks += 2) {
        const float2 f[4] = {*reinterpret_cast<const float2*>(wa + 16 * ks),
                             *reinterpret_cast<const float2*>(wa + 8 * ly.w_stride + 16 * ks),
                             *reinterpret_cast<const float2*>(wa + 16 * ks + 8),
                             *reinterpret_cast<const float2*>(wa + 8 * ly.w_stride + 16 * ks + 8)};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(f[r].x, f[r].y);
          hi[r] = *reinterpret_cast<const uint32_t*>(&h);
          lo[r] = pack_bf16(f[r].x - __low2float(h), f[r].y - __high2float(h));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // channels 16 half .. 16 half + 15
          uint32_t b[4];
          ldmatrix_x4_trans(b, box + box_at(16 * ks + at.t_row, 2 * half + at.t_col / 8));
          mma_bf16(acc[2 * half], hi, b[0], b[1]);
          mma_bf16(acc_lo[2 * half], lo, b[0], b[1]);
          mma_bf16(acc[2 * half + 1], hi, b[2], b[3]);
          mma_bf16(acc_lo[2 * half + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with W and the box
    if (jn < p.n_lv) tma_dense_box(p, t, jn, maps, box, bar);
    // W back to 0: the entries this query's threads wrote (each by its
    // writer, so the query's 4 threads cover them all), or with P > 4 the
    // query's row over its block's k-steps
    if (p.P <= kQueryLanes) {
#pragma unroll
      for (int jj = 0; jj < kQueryLanes; ++jj)
        if (wrote[jj] >= 0) w_row[wrote[jj]] = 0.f;
    } else {
      for (int c = 16 * mine.k_lo + 4 * corner; c < 16 * mine.k_hi; c += 16)
        *reinterpret_cast<float4*>(w_row + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();  // before the query's threads add to the row again
    j = jn;
  }

  // the two halves of the k-steps meet in the out tile, one after the other
  for (int turn = 1; turn >= 0; --turn) {
    if (kh == turn) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* o = otile + (16 * mb + g) * kOutRow + 8 * nt + 2 * tq;
        float2 v = *reinterpret_cast<float2*>(o);
        *reinterpret_cast<float2*>(o) = make_float2(v.x + (acc[nt][0] + acc_lo[nt][0]),
                                                    v.y + (acc[nt][1] + acc_lo[nt][1]));
        o += 8 * kOutRow;
        v = *reinterpret_cast<float2*>(o);
        *reinterpret_cast<float2*>(o) = make_float2(v.x + (acc[nt][2] + acc_lo[nt][2]),
                                                    v.y + (acc[nt][3] + acc_lo[nt][3]));
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < n * 8; e += kDenseThreads) {
    const int i = e >> 3, c0 = (e & 7) * 4;
    float v[4];
    load4(otile + i * kOutRow + c0, v);
    const int64_t at_out = tile_query(p, t, i).item * kD32 + c0;
    if (p.out_mode == 0)
      store4(static_cast<__nv_bfloat16*>(out) + at_out, v);
    else
      store4(static_cast<float*>(out) + at_out, v);
  }
}

// Whether a plan is one the D = 32 body takes: head width 32, a tile of at
// most kDenseRows queries, every staged level's box non-empty, and the
// plan's shared memory what the body lays out.
bool dense_d32_plan(const Plan& p) {
  if (p.D != kD32 || p.tq_y * p.tq_x > kDenseRows) return false;
  for (int j = 0; j < p.n_lv; ++j)
    if (!finer(p, p.lv[j]) && (p.box_h[j] < 1 || p.box_w[j] < 1)) return false;
  return p.smem_bytes == dense_layout(p).bytes;
}

template <typename AT>
int launch_dense_d32(const Plan& p, const TileMaps& maps, int variant, cudaStream_t stream,
                     const void* value, const float* off, const void* att, void* out) {
  const auto kernel = msda_fwd_dense_kernel_d32<AT>;
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((p.hq + p.tq_y - 1) / p.tq_y) * ((p.wq + p.tq_x - 1) / p.tq_x);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  kernel<<<grid, kDenseThreads, p.smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(value), off, static_cast<const AT*>(att), out, p, maps,
      variant);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_dense, msda_fwd_dense_kernel)

// K9's D = 32 body: a bf16 value, the plan as the general entry's
// (ops/msda_window_forms.py, body "d32"), and the DenseVariant (kWhole for
// the op). att_f32: the weights are f32, else bf16. Returns the launch's
// cudaError_t, or kNoTensorMapEncoder / kTensorMapRefused (negative) when
// the tensor maps could not be made, in which case nothing is launched.
extern "C" int ape_msda_fwd_dense_d32(const void* value, const float* off, const void* att,
                                      void* out, const int* plan, float radius, int att_f32,
                                      int variant, void* stream) {
  using namespace ape_msda_win;
  Plan p;
  if (!parse_plan(plan, radius, 2, p) || !dense_d32_plan(p) || variant < kWhole ||
      variant > kStagingOnly)
    return static_cast<int>(cudaErrorInvalidValue);
  TileMaps maps;
  if (const int err = encode_maps(p, value, true, CU_TENSOR_MAP_SWIZZLE_64B, maps)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (att_f32) return launch_dense_d32<float>(p, maps, variant, st, value, off, att, out);
  return launch_dense_d32<__nv_bfloat16>(p, maps, variant, st, value, off, att, out);
}

// The machinery the four window-MSDA forward forms share (msda_fwd_pair.cu,
// msda_fwd_rows.cu, msda_fwd_qlevel.cu, msda_fwd_dense.cu). Each computes K1's
// function (msda_fwd.cu) for the encoder's window mode, where the queries are
// the pyramid grid itself, from pixel offsets, with the window clip inside
// the kernel:
//
//   out[b, q, h*D + d] = sum_{l, p} att[b,q,h,l,p] *
//       bilinear0(value[b, start_l + ., h, d],
//                 center(q) + clip(off[b,q,h,l,p], -R, R) / size_l)
//
// A sample's location is rounded as torch rounds ops/msda_dispatch.py's
// window_locations (center = (q + 0.5) / n, then + clip(off) / size), and its
// pixel by msda_sample.cuh's pixel(), so it falls where K1's does.
//
// The idea they share, from the TPU kernels they replace: a tile of queries
// of one query level reads a bounded window of each value level, so the
// kernel can stage that footprint in fast memory and read every corner
// there. On Hopper the fast memory is a block's shared memory:
//
//  * A block holds one (batch, head, query tile) and 8 warps; a warp takes
//    every 8th query of the tile, its lanes over the head's D channels.
//  * For a value level as fine as the query level or coarser, the block
//    stages with cp.async the box that covers every query's window: the
//    tile's footprint, zero-filled outside the level.
//  * For a finer value level the tile's bounding box grows with the ratio
//    of the sizes, so each warp stages the window of the one query it is
//    at, win x win pixels, in a buffer of its own.
//  * A corner outside the staged box (only where float rounding would move
//    a window by a pixel) is read from device memory, so the result never
//    depends on the box's size.
//
// Per axis a query's samples lie within win = 2 ceil(R) + 3 pixels starting
// at window_base(): the clip bounds the offset by R, and its center pixel
// c rounds to base + R + 1.
//
// That is the design of the general bodies (every head width up to 32). At
// head width 32, every MSDA layer of APE, K6, K7 and K8 run D = 32 bodies of
// another design, whose shared parts are the last section here: one thread
// stages each box of a same-or-coarser level by one TMA load (the tensor
// maps of encode_maps, an mbarrier each), a finer level is read from device
// memory, not staged, and the sampling is K1's D = 32 layout
// (msda_sample.cuh: 8 lanes an item, 4 channels a lane, one vector load a
// corner), so each equals K1's window entry bit for bit. The section holds
// the header at the start of their shared memory (the barriers and the
// boxes' corners), the corner fetch from a box or from device memory, the
// plan's checks and the launch; K8 calls only some of them (the section says
// which and why). K9's D = 32 body (msda_fwd_dense.cu) shares only the TMA
// parts.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "msda_sample.cuh"

namespace ape_msda_win {

using ape_msda::from_f32;
using ape_msda::kMaxLevels;
using ape_msda::pixel;
using ape_msda::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueriesPerWarp = 16;      // a tile holds at most kWarps * 16 queries
constexpr int kMaxPoints = 32;           // the dense kernel keeps one point per lane
constexpr int kHeaderInts = 18;

// One launch's plan, made by ops/msda_window_forms.py and passed as ints:
// the header (kHeaderInts), then (H_l, W_l, start_l) for every level, then
// (level, box rows, box cols, box offset) for each value level of the launch.
struct Plan {
  int B, S, Q, H, D, L, P;
  int hq, wq, q_start;   // the query level: its size and first query row
  int tq_y, tq_x;        // the query tile
  int out_mode;          // 0: store in the value's dtype, 1: store f32, 2: continue from
                         // the f32 partial in out (start the sums there) and store f32
  int n_lv;              // value levels of this launch
  int smem_bytes;
  int win;               // window taps per axis, 2 ceil(R) + 3
  int win_off;           // element offset of the warps' query windows
  int tap_off;           // byte offset of the warps' tap maps (dense kernel)
  float radius;
  int lvl_h[kMaxLevels], lvl_w[kMaxLevels], lvl_start[kMaxLevels];
  int lv[kMaxLevels];      // the launch's value levels, in order
  int box_h[kMaxLevels];   // staged box bounds per launch level; 0: a finer
  int box_w[kMaxLevels];   // level, staged one query window at a time
  int box_off[kMaxLevels]; // element offset of the level's box
};

// Parses and checks a plan; false if it is not one the kernels take.
inline bool parse_plan(const int* a, float radius, int elem_bytes, Plan& p) {
  p.B = a[0]; p.S = a[1]; p.Q = a[2]; p.H = a[3]; p.D = a[4]; p.L = a[5]; p.P = a[6];
  p.hq = a[7]; p.wq = a[8]; p.q_start = a[9]; p.tq_y = a[10]; p.tq_x = a[11];
  p.out_mode = a[12]; p.n_lv = a[13]; p.smem_bytes = a[14]; p.win = a[15];
  p.win_off = a[16]; p.tap_off = a[17];
  p.radius = radius;
  if (p.L < 1 || p.L > kMaxLevels || p.n_lv < 1 || p.n_lv > p.L) return false;
  if (p.D < 1 || p.D > 32 || (p.D * elem_bytes) % 16 != 0) return false;
  if (p.P < 1 || p.P > kMaxPoints || p.H < 1 || p.B < 1 || p.hq < 1 || p.wq < 1) return false;
  if (p.tq_y < 1 || p.tq_x < 1 || p.tq_y * p.tq_x > kWarps * kQueriesPerWarp) return false;
  if (p.out_mode < 0 || p.out_mode > 2 || p.win < 3 || p.smem_bytes < 0) return false;
  const int* lv = a + kHeaderInts;
  for (int l = 0; l < p.L; ++l) {
    p.lvl_h[l] = lv[3 * l];
    p.lvl_w[l] = lv[3 * l + 1];
    p.lvl_start[l] = lv[3 * l + 2];
  }
  const int* ln = lv + 3 * p.L;
  for (int j = 0; j < p.n_lv; ++j) {
    p.lv[j] = ln[4 * j];
    p.box_h[j] = ln[4 * j + 1];
    p.box_w[j] = ln[4 * j + 2];
    p.box_off[j] = ln[4 * j + 3];
    if (p.lv[j] < 0 || p.lv[j] >= p.L) return false;
  }
  return p.q_start >= 0 && p.q_start + p.hq * p.wq <= p.Q;
}

// ---- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Waits until at most n of this thread's committed groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// ---- geometry ---------------------------------------------------------------

// The block's query tile: (batch, head) and the tile's rows and columns on
// the query level, cut at its edge.
struct Tile {
  int b, h, qy0, qx0, ny, nx;
};

__device__ __forceinline__ Tile make_tile(const Plan& p) {
  const int ntx = (p.wq + p.tq_x - 1) / p.tq_x;
  const int ty = blockIdx.x / ntx;
  const int tx = blockIdx.x - ty * ntx;
  Tile t;
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  t.qy0 = ty * p.tq_y;
  t.qx0 = tx * p.tq_x;
  t.ny = min(p.tq_y, p.hq - t.qy0);
  t.nx = min(p.tq_x, p.wq - t.qx0);
  return t;
}

// Normalized center of query q of n along an axis, as grid_centers() rounds it.
__device__ __forceinline__ float center(int q, int n) {
  return __fdiv_rn(static_cast<float>(q) + 0.5f, static_cast<float>(n));
}

// First pixel of the win-pixel window of query q (of nq) on a level of nv.
__device__ __forceinline__ int window_base(int q, int nq, int nv, int win) {
  const float c = pixel(center(q, nq), nv);
  return static_cast<int>(floorf(c + 0.5f)) - (win - 3) / 2 - 1;
}

// clip(o, -r, r) with NaN kept, as torch.clamp keeps it.
__device__ __forceinline__ float clip(float o, float r) {
  return o != o ? o : fminf(fmaxf(o, -r), r);
}

// Pixel of a sample at offset o (value-level pixels) from center c (normalized).
__device__ __forceinline__ float sample_pixel(float c, float o, float r, int size) {
  return pixel(__fadd_rn(c, __fdiv_rn(clip(o, r), static_cast<float>(size))), size);
}

// A staged rectangle of one value level for one head: rows [y0, y0 + h),
// columns [x0, x0 + w), D values per pixel.
template <typename VT>
struct Box {
  const VT* s;
  int y0, x0, h, w;
};

// One value level of one (batch, head), as the kernels read it.
template <typename VT>
struct Level {
  const VT* v;          // the level's pixel 0, channel h * D
  int64_t row_stride;   // H * D
  int h, w;
};

template <typename VT>
__device__ __forceinline__ Level<VT> level(const Plan& p, const VT* value, const Tile& t, int l) {
  Level<VT> lv;
  lv.row_stride = static_cast<int64_t>(p.H) * p.D;
  lv.v = value + (static_cast<int64_t>(t.b) * p.S + p.lvl_start[l]) * lv.row_stride +
         static_cast<int64_t>(t.h) * p.D;
  lv.h = p.lvl_h[l];
  lv.w = p.lvl_w[l];
  return lv;
}

// Whether value level l is finer than the query level along either axis.
__host__ __device__ __forceinline__ bool finer(const Plan& p, int l) {
  return p.lvl_h[l] > p.hq || p.lvl_w[l] > p.wq;
}

// The box the block stages for its tile on launch level j (not finer): the
// union of the tile's query windows, cut to the plan's bound.
template <typename VT>
__device__ __forceinline__ Box<VT> tile_box(const Plan& p, const Tile& t, int j, const VT* smem) {
  const int l = p.lv[j];
  Box<VT> bx;
  bx.s = smem + p.box_off[j];
  bx.y0 = window_base(t.qy0, p.hq, p.lvl_h[l], p.win);
  bx.x0 = window_base(t.qx0, p.wq, p.lvl_w[l], p.win);
  bx.h = min(window_base(t.qy0 + t.ny - 1, p.hq, p.lvl_h[l], p.win) - bx.y0 + p.win, p.box_h[j]);
  bx.w = min(window_base(t.qx0 + t.nx - 1, p.wq, p.lvl_w[l], p.win) - bx.x0 + p.win, p.box_w[j]);
  return bx;
}

// ---- staging ----------------------------------------------------------------

// The whole block copies a box into shared memory by cp.async, 16 bytes a
// thread, zero-filling the pixels outside the level; commits one group.
template <typename VT>
__device__ __forceinline__ void stage_box(const Box<VT>& bx, const Level<VT>& lv, int D) {
  const int chunks = D * static_cast<int>(sizeof(VT)) / 16;  // per pixel
  const int n = bx.h * bx.w * chunks;
  char* dst = reinterpret_cast<char*>(const_cast<VT*>(bx.s));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int px = i / chunks;
    const int c = i - px * chunks;
    const int ry = px / bx.w;
    const int yy = bx.y0 + ry;
    const int xx = bx.x0 + px - ry * bx.w;
    const bool in = yy >= 0 && yy < lv.h && xx >= 0 && xx < lv.w;
    const VT* src = in ? lv.v + (static_cast<int64_t>(yy) * lv.w + xx) * lv.row_stride : lv.v;
    cp_async16(dst + (static_cast<int64_t>(px) * D) * sizeof(VT) + 16 * c,
               reinterpret_cast<const char*>(src) + 16 * c, in);
  }
  cp_async_commit();
}

// One warp copies a query's win x win window into its own buffer with
// 16-byte loads, zero outside the level; the lanes then share it.
template <typename VT>
__device__ __forceinline__ void stage_window(VT* buf, const Level<VT>& lv, int y0, int x0,
                                             int win, int D, int lane) {
  const int chunks = D * static_cast<int>(sizeof(VT)) / 16;
  const int n = win * win * chunks;
  char* dst = reinterpret_cast<char*>(buf);
  for (int i = lane; i < n; i += 32) {
    const int px = i / chunks;
    const int c = i - px * chunks;
    const int ry = px / win;
    const int yy = y0 + ry;
    const int xx = x0 + px - ry * win;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (yy >= 0 && yy < lv.h && xx >= 0 && xx < lv.w)
      v = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const char*>(lv.v + (static_cast<int64_t>(yy) * lv.w + xx) * lv.row_stride) +
          16 * c);
    *reinterpret_cast<uint4*>(dst + (static_cast<int64_t>(px) * D) * sizeof(VT) + 16 * c) = v;
  }
  __syncwarp();
}

// ---- reading ----------------------------------------------------------------

// Channel d of pixel (yy, xx), which lies inside the level: from the box, or
// from device memory where the box does not reach.
template <typename VT>
__device__ __forceinline__ float corner(const Box<VT>& bx, const Level<VT>& lv, int yy, int xx,
                                        int d, int D) {
  const int ry = yy - bx.y0;
  const int rx = xx - bx.x0;
  if (static_cast<unsigned>(ry) < static_cast<unsigned>(bx.h) &&
      static_cast<unsigned>(rx) < static_cast<unsigned>(bx.w))
    return to_f32(bx.s[(ry * bx.w + rx) * D + d]);
  return to_f32(lv.v[(static_cast<int64_t>(yy) * lv.w + xx) * lv.row_stride + d]);
}

// Adds one query's P samples of one level for channel d into acc, with K1's
// arithmetic (msda_fwd.cu): the same boundary test, corners and order.
template <typename VT, typename AT>
__device__ __forceinline__ void add_samples(float& acc, const Box<VT>& bx, const Level<VT>& lv,
                                            float cx, float cy, const float* off, const AT* att,
                                            int P, float radius, int d, int D) {
  const int wl = lv.w, hl = lv.h;
  for (int p = 0; p < P; ++p) {
    const float a = to_f32(att[p]);
    const float x = sample_pixel(cx, off[2 * p], radius, wl);
    const float y = sample_pixel(cy, off[2 * p + 1], radius, hl);
    if (!(x > -1.f && y > -1.f && x < wl && y < hl)) continue;
    const float xf = floorf(x);
    const float yf = floorf(y);
    const int x0 = static_cast<int>(xf);
    const int y0 = static_cast<int>(yf);
    const float fx = x - xf;
    const float fy = y - yf;
    float v = 0.f;
    if (y0 >= 0) {
      if (x0 >= 0) v += (1.f - fx) * (1.f - fy) * corner(bx, lv, y0, x0, d, D);
      if (x0 + 1 < wl) v += fx * (1.f - fy) * corner(bx, lv, y0, x0 + 1, d, D);
    }
    if (y0 + 1 < hl) {
      if (x0 >= 0) v += (1.f - fx) * fy * corner(bx, lv, y0 + 1, x0, d, D);
      if (x0 + 1 < wl) v += fx * fy * corner(bx, lv, y0 + 1, x0 + 1, d, D);
    }
    acc += a * v;
  }
}

// Offsets, weights and out element of the k-th query of a warp.
struct QueryRef {
  bool valid;
  int qy, qx;           // on the query level
  int64_t item;         // (b * Q + q) * H + h
};

__device__ __forceinline__ QueryRef query_ref(const Plan& p, const Tile& t, int warp, int k) {
  QueryRef r;
  const int i = warp + k * kWarps;
  r.valid = i < t.ny * t.nx;
  const int iy = r.valid ? i / t.nx : 0;
  r.qy = t.qy0 + iy;
  r.qx = t.qx0 + (r.valid ? i - iy * t.nx : 0);
  const int64_t q = p.q_start + static_cast<int64_t>(r.qy) * p.wq + r.qx;
  r.item = (static_cast<int64_t>(t.b) * p.Q + q) * p.H + t.h;
  return r;
}

// Adds launch level j's samples into the warp's accumulators: from the
// block's box, or for a finer level from each query's own staged window.
// The box, if any, must be staged and visible to the block.
template <typename VT, typename AT>
__device__ __forceinline__ void sample_level(float (&acc)[kQueriesPerWarp], const Plan& p,
                                             const Tile& t, int j, const VT* value,
                                             const float* off, const AT* att, const VT* smem,
                                             int warp, int lane) {
  const int l = p.lv[j];
  const Level<VT> lv = level(p, value, t, l);
  const bool fine = finer(p, l);
  Box<VT> bx;
  if (!fine) bx = tile_box(p, t, j, smem);
  VT* wbuf = const_cast<VT*>(smem) + p.win_off + warp * p.win * p.win * p.D;
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) {
    const QueryRef r = query_ref(p, t, warp, k);
    if (!r.valid) break;
    if (fine) {
      bx.s = wbuf;
      bx.y0 = window_base(r.qy, p.hq, lv.h, p.win);
      bx.x0 = window_base(r.qx, p.wq, lv.w, p.win);
      bx.h = bx.w = p.win;
      stage_window(wbuf, lv, bx.y0, bx.x0, p.win, p.D, lane);
    }
    if (lane < p.D)
      add_samples(acc[k], bx, lv, center(r.qx, p.wq), center(r.qy, p.hq),
                  off + (r.item * p.L + l) * p.P * 2, att + (r.item * p.L + l) * p.P, p.P,
                  p.radius, lane, p.D);
    if (fine) __syncwarp();  // every lane is done with the window before the next
  }
}

// The warp's accumulators at the start of a launch: 0, or under out_mode 2
// the f32 partial that an earlier launch of the query level stored, so that
// the launch continues its sums.
__device__ __forceinline__ void init_tile(float (&acc)[kQueriesPerWarp], const Plan& p,
                                          const Tile& t, const void* out, int warp, int lane) {
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) {
    const QueryRef r = query_ref(p, t, warp, k);
    acc[k] = p.out_mode == 2 && r.valid && lane < p.D
                 ? static_cast<const float*>(out)[r.item * p.D + lane]
                 : 0.f;
  }
}

// Writes the warp's accumulators: in the value's dtype, or in f32 (out_mode).
template <typename VT>
__device__ __forceinline__ void write_tile(const float (&acc)[kQueriesPerWarp], const Plan& p,
                                           const Tile& t, void* out, int warp, int lane) {
  if (lane >= p.D) return;
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) {
    const QueryRef r = query_ref(p, t, warp, k);
    if (!r.valid) break;
    const int64_t i = r.item * p.D + lane;
    if (p.out_mode == 0)
      static_cast<VT*>(out)[i] = from_f32<VT>(acc[k]);
    else
      static_cast<float*>(out)[i] = acc[k];
  }
}

// ---- TMA (the D = 32 bodies of K6-K9) -------------------------------------------

// One tensor map per launch level whose box is staged.
struct TileMaps {
  CUtensorMap map[kMaxLevels];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Makes the barriers' initialisation visible to the TMA unit.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arming thread's arrival, expecting `bytes` from the TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on the barrier (not a TMA's).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 5-d tensor map, at coordinates (c0 .. c4) innermost first,
// into shared memory; its bytes complete on the barrier.
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Error codes of the entries that stage by TMA, besides cudaError_t's:
// libcuda has no cuTensorMapEncodeTiled, or it refused a level's tensor map.
constexpr int kNoTensorMapEncoder = -1;
constexpr int kTensorMapRefused = -2;

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// libcuda's cuTensorMapEncodeTiled, through the runtime; null if missing.
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The tensor map of each staged launch level of a D = 32 plan: the level of
// the (B, S, H, 32) value as (32, H, W_l, H_l, B), innermost first, based at
// its first pixel; a box of (32, 1, box_w, box_h, 1); zeros outside the
// level; the box's pixel rows swizzled as asked.
inline int encode_maps(const Plan& p, const void* value, bool bf16, CUtensorMapSwizzle swizzle,
                       TileMaps& maps) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return kNoTensorMapEncoder;
  memset(&maps, 0, sizeof(maps));
  const cuuint64_t es = bf16 ? 2 : 4;
  for (int j = 0; j < p.n_lv; ++j) {
    const int l = p.lv[j];
    if (finer(p, l)) continue;
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(ape_msda::kD32), static_cast<cuuint64_t>(p.H),
                                static_cast<cuuint64_t>(p.lvl_w[l]),
                                static_cast<cuuint64_t>(p.lvl_h[l]),
                                static_cast<cuuint64_t>(p.B)};
    const cuuint64_t pixel_bytes = static_cast<cuuint64_t>(p.H) * ape_msda::kD32 * es;
    const cuuint64_t strides[4] = {ape_msda::kD32 * es, pixel_bytes, p.lvl_w[l] * pixel_bytes,
                                   static_cast<cuuint64_t>(p.S) * pixel_bytes};
    const cuuint32_t box[5] = {static_cast<cuuint32_t>(ape_msda::kD32), 1,
                               static_cast<cuuint32_t>(p.box_w[j]),
                               static_cast<cuuint32_t>(p.box_h[j]), 1};
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
    void* base = static_cast<char*>(const_cast<void*>(value)) + p.lvl_start[l] * pixel_bytes;
    const CUresult r = encode(&maps.map[j],
                              bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              5, base, dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kTensorMapRefused;
  }
  return 0;
}

// The signature of the four kernels; each casts value and att to its VT, AT.
using Kernel = void (*)(const void* value, const float* off, const void* att, void* out, Plan p);

// Launches a kernel over the plan's tiles x heads x batch on a stream,
// raising its shared memory where the plan asks for more than 48 KB.
inline int launch_plan(Kernel kernel, const Plan& p, cudaStream_t stream, const void* value,
                       const float* off, const void* att, void* out) {
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((p.hq + p.tq_y - 1) / p.tq_y) * ((p.wq + p.tq_x - 1) / p.tq_x);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  kernel<<<grid, kThreads, p.smem_bytes, stream>>>(value, off, att, out, p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the D = 32 bodies of K6, K7 and K8 ------------------------------------------
//
// K8's body (msda_fwd_qlevel.cu) takes the header's layout, d32_plan,
// launch_d32 and by_dtypes from here. It keeps its own inline copies of
// d32_header's pointers, the corner fetch (box_corners, device_corners),
// the query lookup and the sums' start and store, as it had them before K6
// and K7 shared them: calling the shared corner fetch and header moved its
// code (62 to 64 registers, 2-3 % more device time on an H100 80GB HBM3 at
// 700 W), so only K6 and K7 call those.

using ape_msda::Cell;
using ape_msda::kD32;
using ape_msda::kItemsPerWarp;

// The first bytes of a D = 32 body's shared memory: kMaxLevels mbarriers,
// then the box's first row and first column for each launch level. The
// boxes follow, at 128-byte aligned offsets (ops/msda_window_forms.py:
// D32_HEADER_BYTES).
constexpr int kD32HeaderBytes = 256;
static_assert(kMaxLevels * (8 + 2 * 4) <= kD32HeaderBytes, "header");

struct D32Header {
  uint64_t* bar;
  int* box_y0;
  int* box_x0;
};

__device__ __forceinline__ D32Header d32_header(unsigned char* smem) {
  D32Header h;
  h.bar = reinterpret_cast<uint64_t*>(smem);
  h.box_y0 = reinterpret_cast<int*>(smem + kMaxLevels * sizeof(uint64_t));
  h.box_x0 = h.box_y0 + kMaxLevels;
  return h;
}

// K7's and K8's D = 32 block: 16 warps of 4 queries, so a tile of at most
// 64 queries takes one pass (ops/msda_window_forms.py: D32_TILES).
constexpr int kD32Warps = 16;
constexpr int kD32Threads = kD32Warps * 32;
constexpr int kD32TileQueries = kD32Warps * kItemsPerWarp;

// Query i of the tile: q (of the value's Q rows) and its item (b * Q + q) *
// H + h.
struct D32Query {
  int64_t q, item;
};

__device__ __forceinline__ D32Query d32_query(const Plan& p, const Tile& t, int i) {
  const int iy = i / t.nx;
  D32Query r;
  r.q = p.q_start + static_cast<int64_t>(t.qy0 + iy) * p.wq + t.qx0 + (i - iy * t.nx);
  r.item = (static_cast<int64_t>(t.b) * p.Q + r.q) * p.H + t.h;
  return r;
}

// A lane's 4 sums of a query (channels c0 .. c0 + 3) at the start of a
// launch: 0, or under out mode 2 the f32 partial an earlier launch of the
// query level stored, so that the launch continues them.
__device__ __forceinline__ void d32_start_sums(float (&acc)[4], const Plan& p, const void* out,
                                               bool valid, int64_t item, int c0) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  if (valid && p.out_mode == 2)
    ape_msda::load4(static_cast<const float*>(out) + item * kD32 + c0, acc);
}

// Stores them: in the value's dtype (out mode 0), else in f32.
template <typename VT>
__device__ __forceinline__ void d32_store_sums(const float (&acc)[4], const Plan& p, void* out,
                                               bool valid, int64_t item, int c0) {
  if (!valid) return;
  if (p.out_mode == 0)
    ape_msda::store4(static_cast<VT*>(out) + item * kD32 + c0, acc);
  else
    ape_msda::store4(static_cast<float*>(out) + item * kD32 + c0, acc);
}

// A lane's 4 channels of the corners of cell c inside the level, as K1
// reads them: from device memory, v00 at the cell's corner 00 and the
// lane's channels, row_stride H * D, wl the level's width. A corner outside
// the level is left as the caller set it (0).
template <typename VT>
__device__ __forceinline__ void device_corners(const Cell& c, const VT* v00, int64_t row_stride,
                                               int wl, float (&c00)[4], float (&c01)[4],
                                               float (&c10)[4], float (&c11)[4]) {
  using ape_msda::load4;
  if (c.c00) load4(v00, c00);
  if (c.c01) load4(v00 + row_stride, c01);
  if (c.c10) load4(v00 + wl * row_stride, c10);
  if (c.c11) load4(v00 + (wl + 1) * row_stride, c11);
}

// The same corners from a staged box: box at its pixel (0, 0) and the
// lane's channels, (by0, bx0) its first row and column on the level, bh x
// bw pixels. A corner outside the box (where float rounding moved a window
// by a pixel) is read from device memory, so the result never depends on
// the box's size.
template <typename VT>
__device__ __forceinline__ void box_corners(const Cell& c, const VT* box, int by0, int bx0, int bh,
                                            int bw, const VT* v00, int64_t row_stride, int wl,
                                            float (&c00)[4], float (&c01)[4], float (&c10)[4],
                                            float (&c11)[4]) {
  using ape_msda::load4;
  const int ry = c.y0 - by0, rx = c.x0 - bx0;
  const VT* b00 = box + (ry * bw + rx) * kD32;
  const bool y0_in = static_cast<unsigned>(ry) < static_cast<unsigned>(bh);
  const bool y1_in = static_cast<unsigned>(ry + 1) < static_cast<unsigned>(bh);
  const bool x0_in = static_cast<unsigned>(rx) < static_cast<unsigned>(bw);
  const bool x1_in = static_cast<unsigned>(rx + 1) < static_cast<unsigned>(bw);
  if (c.c00) {
    if (y0_in && x0_in) load4(b00, c00);
    else load4(v00, c00);
  }
  if (c.c01) {
    if (y0_in && x1_in) load4(b00 + kD32, c01);
    else load4(v00 + row_stride, c01);
  }
  if (c.c10) {
    if (y1_in && x0_in) load4(b00 + bw * kD32, c10);
    else load4(v00 + wl * row_stride, c10);
  }
  if (c.c11) {
    if (y1_in && x1_in) load4(b00 + (bw + 1) * kD32, c11);
    else load4(v00 + (wl + 1) * row_stride, c11);
  }
}

// Whether a plan is one a D = 32 body takes: head width 32, a tile of at
// most tile_queries (one pass), the launch's levels consecutive, every
// staged box at a 128-byte aligned offset past the header and inside the
// plan's shared memory.
inline bool d32_plan(const Plan& p, int es, int tile_queries) {
  if (p.D != kD32 || p.tq_y * p.tq_x > tile_queries) return false;
  for (int j = 0; j < p.n_lv; ++j) {
    if (p.lv[j] != p.lv[0] + j) return false;
    if (finer(p, p.lv[j])) continue;
    const int64_t at = static_cast<int64_t>(p.box_off[j]) * es;
    const int64_t bytes = static_cast<int64_t>(p.box_h[j]) * p.box_w[j] * kD32 * es;
    if (p.box_h[j] < 1 || p.box_w[j] < 1 || at % 128 || at < kD32HeaderBytes ||
        at + bytes > p.smem_bytes)
      return false;
  }
  return true;
}

// Launches a D = 32 body over the plan's tiles x heads x batch on a
// stream, `threads` a block, raising its shared memory where the plan asks
// for more than 48 KB; args are the kernel's.
template <typename... Params, typename... Args>
inline int launch_d32(void (*kernel)(Params...), const Plan& p, int threads, cudaStream_t stream,
                      Args... args) {
  if (p.smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ((p.hq + p.tq_y - 1) / p.tq_y) * ((p.wq + p.tq_x - 1) / p.tq_x);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  kernel<<<grid, threads, p.smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Calls launch(VT{}, AT{}) for the value's and the weights' dtypes, as the
// entries take them (value_bf16, att_f32): bf16 with bf16 or f32 weights,
// or f32 with f32.
template <typename F>
inline int by_dtypes(int value_bf16, int att_f32, F&& launch) {
  if (value_bf16) {
    if (att_f32) return launch(__nv_bfloat16{}, float{});
    return launch(__nv_bfloat16{}, __nv_bfloat16{});
  }
  return launch(float{}, float{});
}

}  // namespace ape_msda_win

// The C entry of one form: parses the plan and launches the kernel for the
// value's and the weights' dtypes. value_bf16: value (and out in mode 0) are
// bf16, else f32; att_f32: the weights are f32, else the value's dtype.
#define APE_MSDA_WINDOW_ENTRY(NAME, KERNEL)                                                       \
  extern "C" int NAME(const void* value, const float* off, const void* att, void* out,           \
                      const int* plan, float radius, int value_bf16, int att_f32, void* stream) { \
    using namespace ape_msda_win;                                                                 \
    Plan p;                                                                                       \
    if (!parse_plan(plan, radius, value_bf16 ? 2 : 4, p))                                         \
      return static_cast<int>(cudaErrorInvalidValue);                                             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                                          \
    if (value_bf16) {                                                                             \
      if (att_f32)                                                                                \
        return launch_plan(KERNEL<__nv_bfloat16, float>, p, st, value, off, att, out);            \
      return launch_plan(KERNEL<__nv_bfloat16, __nv_bfloat16>, p, st, value, off, att, out);      \
    }                                                                                             \
    return launch_plan(KERNEL<float, float>, p, st, value, off, att, out);                        \
  }

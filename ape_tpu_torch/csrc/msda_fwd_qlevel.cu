// Window-MSDA forward, per query level: every value level in one launch,
// each level's footprint prefetched at tile entry (K8).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v5.py
// (ms_deform_attn_window_pallas_v5 -> _run_qlevel_fused): all value levels
// of a query level inside one kernel, the f32 accumulator in VMEM across
// levels, every level's slab DMA started at tile entry so that levels
// 1 .. L-1 stream while level 0 computes, and the levels packed greedily
// into groups whose slabs fit the VMEM budget. v5 keeps the partials
// between groups in bf16 for a bf16 value; this kernel keeps them in f32,
// and a later group continues the sums from the partial (out mode 2).
//
// What bounds it on an H100: as K1 (msda_fwd.cu), the samples' corner
// reads; the bytes it must move are value, offsets, weights and the output
// once, about 57 MB at the protocol pyramid in bf16.
//
// Two bodies, chosen by ops/msda_window_forms.py by the head width:
//
//  * D = 32, every MSDA layer of APE: msda_fwd_qlevel_kernel_d32. One block
//    per (query tile, head, batch). At entry one thread arms one mbarrier per
//    value level as fine as the query level or coarser and issues that
//    level's box, the union of the tile's query windows, as one TMA load
//    (cp.async.bulk.tensor) through a tensor map over the level, (D, H, W_l,
//    H_l, B) based at its first pixel, which fills zeros outside the level;
//    no other thread copies. A finer value level, whose box would grow with
//    the ratio of the sizes, is read from device memory (the value sits in
//    L2), as K1 reads it. The sampling is K1's D = 32 layout (msda_sample.cuh:
//    8 lanes an item, 4 channels a lane, 4 queries of the tile a warp, one
//    8-byte bf16 or 16-byte f32 load a corner, offsets and weights 8 samples
//    at a time), the locations K1's window entry's (its grid-center table,
//    the clip, a division and an addition), and the blend K1's (cell,
//    blend4): the levels in increasing order, a warp waiting on a
//    box level's barrier before its first read there, a corner outside the
//    box from device memory, so the result never depends on the box's
//    size. Where a query level's boxes do not fit one block's shared memory,
//    the plan packs the levels greedily into groups, one launch each; the
//    first stores the f32 sums, a later one loads them into its accumulators
//    and goes on. So this body equals K1's window entry bit for bit, at any
//    grouping. The box rows are not swizzled: a half-warp's LDS.64 reads two
//    queries' pixels, 64 bytes each, and only those of the same parity share
//    banks.
//  * any D <= 32: msda_fwd_qlevel_kernel, the design of the other window forms
//    (msda_window.cuh). At entry it issues the cp.async copies of every
//    staged level's box, one commit group per level; it samples the finer
//    levels first, whose windows each warp stages per query with plain
//    loads, while the boxes stream in; then each box level in order, waiting
//    only for that level's group. 16 queries a warp, lanes over D.
//
// The tensor maps are encoded on the host for each launch by libcuda's
// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (cudaGetDriverEntryPoint) so that the library links no libcuda, and
// passed as a __grid_constant__ parameter (msda_window.cuh, shared with the
// D = 32 bodies of K6, K7 and K9). The layout of the header of the block's
// shared memory, the plan's checks and the launch are msda_window.cuh's
// too, shared with K6's and K7's D = 32 bodies; this body keeps its own
// inline copy of the header's pointers and of the corner fetch
// (msda_window.cuh says why).

#include "msda_window.cuh"

namespace {

using namespace ape_msda_win;

template <typename VT, typename AT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_qlevel_kernel(const void* value_, const float* off, const void* att_, void* out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VT* value = static_cast<const VT*>(value_);
  const AT* att = static_cast<const AT*>(att_);
  VT* smem = reinterpret_cast<VT*>(smem_raw);
  const Tile t = make_tile(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int boxes = 0;
  for (int j = 0; j < p.n_lv; ++j) {
    if (finer(p, p.lv[j])) continue;
    stage_box(tile_box(p, t, j, smem), level(p, value, t, p.lv[j]), p.D);
    ++boxes;
  }
  float acc[kQueriesPerWarp];
  init_tile(acc, p, t, out, warp, lane);
  for (int j = 0; j < p.n_lv; ++j)
    if (finer(p, p.lv[j])) sample_level<VT, AT>(acc, p, t, j, value, off, att, smem, warp, lane);
  for (int j = 0, done = 0; j < p.n_lv; ++j) {
    if (finer(p, p.lv[j])) continue;
    cp_async_wait(boxes - 1 - done++);  // this level's group has landed
    __syncthreads();
    sample_level<VT, AT>(acc, p, t, j, value, off, att, smem, warp, lane);
  }
  write_tile<VT>(acc, p, t, out, warp, lane);
}

// ---- the D = 32 body ----------------------------------------------------------

using ape_msda::blend4;
using ape_msda::cell;
using ape_msda::Cell;
using ape_msda::kD32;
using ape_msda::kItemLanes;
using ape_msda::kItemsPerWarp;
using ape_msda::load4;
using ape_msda::store4;
using ape_msda::touches;

// What a launch of the D = 32 body does (the variant argument): the whole
// op; or, to time its parts, only the samples of the staged levels, only
// those of the finer levels, or the whole op with the boxes staged by every
// thread's cp.async (msda_window.cuh's stage_box) instead of TMA. Only
// kWhole's output is the op's (ops/msda_window_forms.py: D32_VARIANTS).
enum Variant { kWhole = 0, kBoxesOnly = 1, kFinerOnly = 2, kCpAsync = 3 };

// At most 64 registers a thread (2 blocks an SM where shared memory allows).
template <typename VT, typename AT>
__global__ void __launch_bounds__(kD32Threads, 2)
msda_fwd_qlevel_kernel_d32(const VT* __restrict__ value, const float* __restrict__ off,
                           const AT* __restrict__ att, const float* __restrict__ centers,
                           void* __restrict__ out, const Plan p,
                           __grid_constant__ const TileMaps maps, const int variant) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* box_y0 = reinterpret_cast<int*>(smem_raw + kMaxLevels * sizeof(uint64_t));
  int* box_x0 = box_y0 + kMaxLevels;
  const Tile t = make_tile(p);
  const bool by_tma = variant != kCpAsync;
  const int first = p.lv[0];  // the launch's levels are first .. first + n_lv - 1
  unsigned fine = 0;          // bit j: launch level j is finer, read from device memory
  for (int j = 0; j < p.n_lv; ++j) fine |= static_cast<unsigned>(finer(p, first + j)) << j;
  if (threadIdx.x < p.n_lv) {
    const int j = threadIdx.x;
    box_y0[j] = window_base(t.qy0, p.hq, p.lvl_h[first + j], p.win);
    box_x0[j] = window_base(t.qx0, p.wq, p.lvl_w[first + j], p.win);
    if (by_tma && !(fine >> j & 1u)) mbar_init(bar + j, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (by_tma) {
    if (threadIdx.x == 0) {
      for (int j = 0; j < p.n_lv; ++j) {
        if (fine >> j & 1u) continue;
        mbar_expect_tx(bar + j, p.box_h[j] * p.box_w[j] * kD32 * sizeof(VT));
        tma_load_box(smem_raw + p.box_off[j] * sizeof(VT), &maps.map[j], bar + j, 0, t.h,
                     box_x0[j], box_y0[j], t.b);
      }
    }
  } else {
    for (int j = 0; j < p.n_lv; ++j) {
      if (fine >> j & 1u) continue;
      const Box<VT> bx{reinterpret_cast<const VT*>(smem_raw) + p.box_off[j], box_y0[j],
                       box_x0[j], p.box_h[j], p.box_w[j]};
      stage_box(bx, level(p, value, t, first + j), kD32);
    }
    cp_async_wait(0);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item (query) within the warp
  const int c0 = sub * 4;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD32;
  const VT* vb = value + static_cast<int64_t>(t.b) * p.S * row_stride + t.h * kD32 + c0;
  const int s_end = (first + p.n_lv) * p.P;
  const int n = t.ny * t.nx;
  unsigned landed = by_tma ? 0u : ~0u;  // launch levels whose box this thread has seen land
  for (int i0 = warp * kItemsPerWarp; i0 < n; i0 += kD32Warps * kItemsPerWarp) {
    // a lane of a query past the tile's end loads nothing and stores
    // nothing, but takes part in the shuffles with NaN pixels
    const int i = i0 + slot;
    const bool valid = i < n;
    const int iy = valid ? i / t.nx : 0;
    const int64_t q = p.q_start + static_cast<int64_t>(t.qy0 + iy) * p.wq + t.qx0 +
                      (valid ? i - iy * t.nx : 0);
    const int64_t item = (static_cast<int64_t>(t.b) * p.Q + q) * p.H + t.h;
    const int64_t samp0 = item * p.L * p.P;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (valid && p.out_mode == 2) load4(static_cast<const float*>(out) + item * kD32 + c0, acc);
    float2 center = make_float2(0.f, 0.f);
    if (valid) center = *reinterpret_cast<const float2*>(centers + 2 * q);
    for (int s0 = first * p.P; s0 < s_end; s0 += kItemLanes) {
      // the query's next 8 samples: lane sub loads sample s0 + sub
      // (coalesced over the 8 lanes), places it as K1's window entry does,
      // and every lane of the item reads them by shuffles
      const int mine = s0 + sub;
      float my_x = NAN, my_y = NAN, my_a = 0.f;
      if (valid && mine < s_end) {
        const int l = mine / p.P;
        const float2 o = *reinterpret_cast<const float2*>(off + 2 * (samp0 + mine));
        my_x = sample_pixel(center.x, o.x, p.radius, p.lvl_w[l]);
        my_y = sample_pixel(center.y, o.y, p.radius, p.lvl_h[l]);
        my_a = to_f32(att[samp0 + mine]);
      }
      const int nn = min(kItemLanes, s_end - s0);  // uniform over the warp
      int l_next = s0 / p.P, point = s0 - l_next * p.P;  // sample s0 + j is (l, point)
      for (int j = 0; j < nn; ++j) {
        const int src = slot * kItemLanes + j;
        const float x = __shfl_sync(0xffffffffu, my_x, src);
        const float y = __shfl_sync(0xffffffffu, my_y, src);
        const float a = __shfl_sync(0xffffffffu, my_a, src);
        const int l = l_next;
        if (++point == p.P) {
          point = 0;
          ++l_next;
        }
        const int jl = l - first;
        const bool from_box = !(fine >> jl & 1u);
        if (variant == (from_box ? kFinerOnly : kBoxesOnly)) continue;
        const int hl = p.lvl_h[l];
        const int wl = p.lvl_w[l];
        if (!touches(x, y, hl, wl)) continue;
        const Cell c = cell(x, y, hl, wl);
        const VT* v00 = vb + (static_cast<int64_t>(p.lvl_start[l]) +
                              static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride;
        float c00[4] = {0.f, 0.f, 0.f, 0.f}, c01[4] = {0.f, 0.f, 0.f, 0.f};
        float c10[4] = {0.f, 0.f, 0.f, 0.f}, c11[4] = {0.f, 0.f, 0.f, 0.f};
        if (!from_box) {  // as K1 reads them
          if (c.c00) load4(v00, c00);
          if (c.c01) load4(v00 + row_stride, c01);
          if (c.c10) load4(v00 + wl * row_stride, c10);
          if (c.c11) load4(v00 + (wl + 1) * row_stride, c11);
          blend4(acc, a, c, c00, c01, c10, c11);
          continue;
        }
        if (!(landed >> jl & 1u)) {
          mbar_wait(bar + jl, 0);
          landed |= 1u << jl;
        }
        // the corners from the box; one outside it (where float rounding
        // moved a window by a pixel) from device memory
        const int ry = c.y0 - box_y0[jl], rx = c.x0 - box_x0[jl];
        const int bh = p.box_h[jl], bw = p.box_w[jl];
        const VT* b00 = reinterpret_cast<const VT*>(smem_raw) + p.box_off[jl] + c0 +
                        (ry * bw + rx) * kD32;
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
        blend4(acc, a, c, c00, c01, c10, c11);
      }
    }
    if (valid) {
      if (p.out_mode == 0)
        store4(static_cast<VT*>(out) + item * kD32 + c0, acc);
      else
        store4(static_cast<float*>(out) + item * kD32 + c0, acc);
    }
  }
  // the block's shared memory stays its own until every box has landed
  if (by_tma && threadIdx.x == 0)
    for (int j = 0; j < p.n_lv; ++j)
      if (!(fine >> j & 1u)) mbar_wait(bar + j, 0);
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_qlevel, msda_fwd_qlevel_kernel)

// K8's D = 32 body: the plan as the general entry's (ops/msda_window_forms.py,
// body "d32"), the (S, 2) f32 grid-center table of K1's window entry, and
// the Variant (kWhole for the op). Returns the launch's cudaError_t, or
// kNoTensorMapEncoder / kTensorMapRefused (negative) when the tensor maps
// could not be made, in which case nothing is launched.
extern "C" int ape_msda_fwd_qlevel_d32(const void* value, const float* off, const void* att,
                                       const float* centers, void* out, const int* plan,
                                       float radius, int value_bf16, int att_f32, int variant,
                                       void* stream) {
  using namespace ape_msda_win;
  Plan p;
  const int es = value_bf16 ? 2 : 4;
  if (!parse_plan(plan, radius, es, p) || !d32_plan(p, es, kD32TileQueries) ||
      variant < kWhole || variant > kCpAsync)
    return static_cast<int>(cudaErrorInvalidValue);
  TileMaps maps;
  if (const int err = encode_maps(p, value, value_bf16 != 0, CU_TENSOR_MAP_SWIZZLE_NONE, maps))
    return err;
  return by_dtypes(value_bf16, att_f32, [&](auto v, auto a) {
    using VT = decltype(v);
    using AT = decltype(a);
    return launch_d32(msda_fwd_qlevel_kernel_d32<VT, AT>, p, kD32Threads,
                      static_cast<cudaStream_t>(stream), static_cast<const VT*>(value), off,
                      static_cast<const AT*>(att), centers, out, p, maps, variant);
  });
}

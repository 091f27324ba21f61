// Window-MSDA forward, per query level: its same-or-coarser value levels in
// one launch (K7).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v3.py
// (ms_deform_attn_window_pallas_v3 -> _run_row_v3): per query level, every
// value level whose grid is as fine as the query level's or coarser runs as
// the innermost, sequential grid axis of one kernel (grid (b, hq / tq, wq /
// tw, lf)), the f32 accumulator kept in VMEM scratch across those levels
// and the output written once; the finer pairs stay on a pair kernel. Here
// they go to K6 (msda_fwd_pair.cu), and run first: the plan
// (ops/msda_window_forms.py) launches a query level's finer pairs, then this
// kernel, which continues from the f32 partial they stored, so that each
// query's samples are added in K1's level order.
//
// What bounds it on an H100: as K1 (msda_fwd.cu), the samples' corner
// reads; the bytes it must move are value, offsets, weights and the output
// once, about 57 MB at the protocol pyramid in bf16, 17 us at 3.35 TB/s.
//
// Two bodies, chosen by ops/msda_window_forms.py by the head width:
//
//  * D = 32, every MSDA layer of APE: msda_fwd_rows_kernel_d32. The TPU's
//    sequential level axis becomes a loop inside the block. One block per
//    (query tile of at most 64 queries, head, batch), 16 warps of 4
//    queries, K1's D = 32 layout (msda_sample.cuh: 8 lanes an item, 4
//    channels a lane, one 8-byte bf16 or 16-byte f32 load a corner; offsets
//    and weights loaded and placed 8 samples at a time, two levels' points).
//    Each lane keeps its item's 4 sums in registers across the levels, which
//    go in ascending order, and stores them once. The boxes (the union of
//    the tile's windows on each level) go through a ring of two
//    shared-memory slots, each sized for the launch's largest box: thread 0
//    issues levels 0 and 1 by TMA at entry (msda_window.cuh: tma_load_box),
//    and level j + 2 into slot j mod 2 once every warp has released it. Each
//    slot has a "full" mbarrier (one arrival and the box's bytes) and an
//    "empty" one (one arrival a warp with queries); a level's use of its
//    slot is the slot's (j / 2)-th, so the wait parity flips with each
//    reuse. A warp waits on a level's full barrier before its first sample
//    there and releases the slot after its last, so it samples level j + 1
//    while level j + 2 streams into the slot it left. Shared memory is the
//    header and two slots, whatever the number of levels: a rows launch
//    never splits into groups as K8's can (msda_fwd_qlevel.cu), which holds
//    every box at once. A corner outside the box is read from device
//    memory, as K8's D = 32 body reads it, so the result never depends on
//    the box's size and equals K1's window entry bit for bit.
//  * any D <= 32: msda_fwd_rows_kernel, the design of msda_window.cuh's
//    general bodies: one shared-memory buffer re-used level after level,
//    each box staged by cp.async and sampled after a __syncthreads, with no
//    overlap of staging and sampling. 16 queries a warp, lanes over D.

#include "msda_window.cuh"

namespace {

using namespace ape_msda_win;

template <typename VT, typename AT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_rows_kernel(const void* value_, const float* off, const void* att_, void* out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VT* value = static_cast<const VT*>(value_);
  const AT* att = static_cast<const AT*>(att_);
  VT* smem = reinterpret_cast<VT*>(smem_raw);
  const Tile t = make_tile(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[kQueriesPerWarp];
  init_tile(acc, p, t, out, warp, lane);
  for (int j = 0; j < p.n_lv; ++j) {  // the plan gives no finer level
    stage_box(tile_box(p, t, j, smem), level(p, value, t, p.lv[j]), p.D);
    cp_async_wait(0);
    __syncthreads();
    sample_level<VT, AT>(acc, p, t, j, value, off, att, smem, warp, lane);
    __syncthreads();  // every warp is done with the buffer before the next level
  }
  write_tile<VT>(acc, p, t, out, warp, lane);
}

// ---- the D = 32 body ----------------------------------------------------------

using ape_msda::blend4;
using ape_msda::cell;
using ape_msda::kItemLanes;
using ape_msda::touches;

// At most 64 registers a thread (2 blocks an SM).
template <typename VT, typename AT>
__global__ void __launch_bounds__(kD32Threads, 2)
msda_fwd_rows_kernel_d32(const VT* __restrict__ value, const float* __restrict__ off,
                         const AT* __restrict__ att, const float* __restrict__ centers,
                         void* __restrict__ out, const Plan p,
                         __grid_constant__ const TileMaps maps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const D32Header hd = d32_header(smem_raw);
  uint64_t* full = hd.bar;       // full[s]: slot s holds its level's box
  uint64_t* empty = hd.bar + 2;  // empty[s]: every warp with queries is done with slot s
  const Tile t = make_tile(p);
  const int first = p.lv[0];  // the launch's levels are first .. first + n_lv - 1
  const int n = t.ny * t.nx;
  const int warps = (n + kItemsPerWarp - 1) / kItemsPerWarp;  // the warps with queries
  if (threadIdx.x < p.n_lv) {
    const int j = threadIdx.x;
    hd.box_y0[j] = window_base(t.qy0, p.hq, p.lvl_h[first + j], p.win);
    hd.box_x0[j] = window_base(t.qx0, p.wq, p.lvl_w[first + j], p.win);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, warps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // launch level j's box into its slot, j mod 2 (thread 0)
  const auto issue = [&](int j) {
    mbar_expect_tx(full + (j & 1), p.box_h[j] * p.box_w[j] * kD32 * sizeof(VT));
    tma_load_box(smem_raw + p.box_off[j] * sizeof(VT), &maps.map[j], full + (j & 1), 0, t.h,
                 hd.box_x0[j], hd.box_y0[j], t.b);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < 2 && j < p.n_lv; ++j) issue(j);

  const int warp = threadIdx.x >> 5;
  if (warp >= warps) return;  // no query: it takes no slot, and the empty barriers count it not
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item (query) within the warp
  const int c0 = sub * 4;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD32;
  const VT* vb = value + static_cast<int64_t>(t.b) * p.S * row_stride + t.h * kD32 + c0;
  // a lane of a query past the tile's end loads nothing and stores nothing,
  // but takes part in the shuffles with NaN pixels and in the barriers
  const int i = warp * kItemsPerWarp + slot;
  const bool valid = i < n;
  const D32Query r = d32_query(p, t, valid ? i : 0);
  const int64_t samp0 = r.item * p.L * p.P;
  float acc[4];
  d32_start_sums(acc, p, out, valid, r.item, c0);
  float2 center = make_float2(0.f, 0.f);
  if (valid) center = *reinterpret_cast<const float2*>(centers + 2 * r.q);
  const int s_end = (first + p.n_lv) * p.P;
  for (int s0 = first * p.P; s0 < s_end; s0 += kItemLanes) {
    // the query's next 8 samples: lane sub loads sample s0 + sub (coalesced
    // over the 8 lanes), places it as K1's window entry does, and every lane
    // of the item reads them by shuffles
    const int mine = s0 + sub;
    float my_x = NAN, my_y = NAN, my_a = 0.f;
    if (valid && mine < s_end) {
      const int l = mine / p.P;
      const float2 o = *reinterpret_cast<const float2*>(off + 2 * (samp0 + mine));
      my_x = sample_pixel(center.x, o.x, p.radius, p.lvl_w[l]);
      my_y = sample_pixel(center.y, o.y, p.radius, p.lvl_h[l]);
      my_a = to_f32(att[samp0 + mine]);
    }
    const int nn = min(kItemLanes, s_end - s0);        // uniform over the warp
    int l_next = s0 / p.P, point = s0 - l_next * p.P;  // sample s0 + j is (l, point)
    for (int j = 0; j < nn; ++j) {
      const int src = slot * kItemLanes + j;
      const float x = __shfl_sync(0xffffffffu, my_x, src);
      const float y = __shfl_sync(0xffffffffu, my_y, src);
      const float a = __shfl_sync(0xffffffffu, my_a, src);
      const int l = l_next, pt = point;
      if (++point == p.P) {
        point = 0;
        ++l_next;
      }
      const int jl = l - first, s = jl & 1;
      if (pt == 0) mbar_wait(full + s, (jl >> 1) & 1);  // the level's box is in its slot
      const int hl = p.lvl_h[l];
      const int wl = p.lvl_w[l];
      if (touches(x, y, hl, wl)) {
        const Cell c = cell(x, y, hl, wl);
        const VT* v00 = vb + (static_cast<int64_t>(p.lvl_start[l]) +
                              static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride;
        float c00[4] = {0.f, 0.f, 0.f, 0.f}, c01[4] = {0.f, 0.f, 0.f, 0.f};
        float c10[4] = {0.f, 0.f, 0.f, 0.f}, c11[4] = {0.f, 0.f, 0.f, 0.f};
        box_corners(c, reinterpret_cast<const VT*>(smem_raw) + p.box_off[jl] + c0, hd.box_y0[jl],
                    hd.box_x0[jl], p.box_h[jl], p.box_w[jl], v00, row_stride, wl, c00, c01, c10,
                    c11);
        blend4(acc, a, c, c00, c01, c10, c11);
      }
      if (pt == p.P - 1) {  // the warp is done with the level: release its slot
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (threadIdx.x == 0 && jl + 2 < p.n_lv) {
          mbar_wait(empty + s, (jl >> 1) & 1);
          issue(jl + 2);
        }
      }
    }
  }
  d32_store_sums<VT>(acc, p, out, valid, r.item, c0);
}

// Whether a plan's boxes take K7's ring: every launch level staged, level
// j's box in slot j mod 2, the second slot past the first by at least the
// largest box.
bool ring_plan(const Plan& p, int es) {
  int64_t largest = 0;
  for (int j = 0; j < p.n_lv; ++j) {
    if (finer(p, p.lv[j]) || p.box_off[j] != p.box_off[j & 1]) return false;
    const int64_t bytes = static_cast<int64_t>(p.box_h[j]) * p.box_w[j] * kD32 * es;
    largest = bytes > largest ? bytes : largest;
  }
  return p.n_lv < 2 || static_cast<int64_t>(p.box_off[1] - p.box_off[0]) * es >= largest;
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_rows, msda_fwd_rows_kernel)

// K7's D = 32 body: the plan as the general entry's (ops/msda_window_forms.py,
// body "d32": the ring layout) and the (S, 2) f32 grid-center table of K1's
// window entry. Returns the launch's cudaError_t, or kNoTensorMapEncoder /
// kTensorMapRefused (negative) when the tensor maps could not be made, in
// which case nothing is launched.
extern "C" int ape_msda_fwd_rows_d32(const void* value, const float* off, const void* att,
                                     const float* centers, void* out, const int* plan,
                                     float radius, int value_bf16, int att_f32, void* stream) {
  using namespace ape_msda_win;
  Plan p;
  const int es = value_bf16 ? 2 : 4;
  if (!parse_plan(plan, radius, es, p) || !d32_plan(p, es, kD32TileQueries) || !ring_plan(p, es))
    return static_cast<int>(cudaErrorInvalidValue);
  TileMaps maps;
  if (const int err = encode_maps(p, value, value_bf16 != 0, CU_TENSOR_MAP_SWIZZLE_NONE, maps))
    return err;
  return by_dtypes(value_bf16, att_f32, [&](auto v, auto a) {
    using VT = decltype(v);
    using AT = decltype(a);
    return launch_d32(msda_fwd_rows_kernel_d32<VT, AT>, p, kD32Threads,
                      static_cast<cudaStream_t>(stream), static_cast<const VT*>(value), off,
                      static_cast<const AT*>(att), centers, out, p, maps);
  });
}

// Window-MSDA forward, one (query level, value level) pair per launch (K6).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v1.py
// (ms_deform_attn_window_pallas -> _run_pair -> _pair_kernel): one kernel
// per pair, the value level's halo tile DMA'd into VMEM, and for strided
// pairs the level phase-decomposed into s x s planes so that every strided
// window read is a contiguous slice. Computes K1's function (msda_fwd.cu)
// one pair at a time: the pairs of a query level run in order on one stream,
// each continuing the sums of the f32 (B, Q, H * D) partial the one before
// stored (out mode 2), without atomics; the caller casts it.
//
// What bounds it on an H100: the samples' corner reads, about 8 flops for
// each byte read, so latency and bytes, not arithmetic. Read once, value,
// offsets, weights and the output are about 57 MB at the protocol pyramid
// in bf16, 17 us at 3.35 TB/s; K1 reads its corners from L2, one 64-byte row
// each. Beyond that, each layer's 25 launches (most of them small) and the
// f32 partial, read and written again by every pair after a query level's
// first.
//
// Two bodies, chosen by ops/msda_window_forms.py by the head width:
//
//  * D = 32, every MSDA layer of APE: msda_fwd_pair_kernel_d32. One block
//    per (query tile of at most 64 queries, head, batch), 8 warps. For a
//    value level as fine as the query level or coarser, one thread arms an
//    mbarrier and issues the tile's box, the union of its queries' windows,
//    as one TMA load (msda_window.cuh: tma_load_box, encode_maps); that box
//    is the block's only shared memory besides the header, so more blocks
//    fit on an SM than K8's all-level layout allows. A finer value level is
//    not staged: its corners are read from device memory as K1 reads them
//    (the level sits in L2), which replaces the general body's per-query
//    windows. The sampling is K1's D = 32 layout (msda_sample.cuh: 8 lanes
//    an item, 4 channels a lane, one 8-byte bf16 or 16-byte f32 load a
//    corner), the locations K1's window entry's (its grid-center table, the
//    clip, a division and an addition), the blend K1's (cell, blend4). The
//    load pattern is chosen for a pair's P = 4 samples a query: a lane's
//    item takes two queries of the tile one after the other, and its 8
//    lanes load and place both queries' samples at once, lane k sample k of
//    the pair (query k / P, point k mod P), so no lane of a load is idle; a
//    warp holds 8 queries, the 8 warps a 64-query tile. The item keeps one
//    query's 4 sums at a time: it starts them (0, or the f32 partial in out
//    mode 2), adds the query's samples in point order, stores them, then
//    does the same for its second query. So the pairs of a query level,
//    run in level order, add each query's samples in K1's order, and the
//    result equals K1's window entry bit for bit.
//  * any D <= 32: msda_fwd_pair_kernel, the design of msda_window.cuh's
//    general bodies: for a value level as fine as the query level or
//    coarser, the block stages the tile's footprint by cp.async; a finer
//    level has no phase planes here: each warp stages the window of the
//    query it is at, (2 ceil(R) + 3)^2 pixels, the Hopper answer to v1's
//    phase decomposition. 16 queries a warp, lanes over D.

#include "msda_window.cuh"

namespace {

using namespace ape_msda_win;

template <typename VT, typename AT>
__global__ void __launch_bounds__(kThreads)
msda_fwd_pair_kernel(const void* value_, const float* off, const void* att_, void* out, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VT* value = static_cast<const VT*>(value_);
  const AT* att = static_cast<const AT*>(att_);
  VT* smem = reinterpret_cast<VT*>(smem_raw);
  const Tile t = make_tile(p);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (!finer(p, p.lv[0])) {
    stage_box(tile_box(p, t, 0, smem), level(p, value, t, p.lv[0]), p.D);
    cp_async_wait(0);
    __syncthreads();
  }
  float acc[kQueriesPerWarp];
  init_tile(acc, p, t, out, warp, lane);
  sample_level<VT, AT>(acc, p, t, 0, value, off, att, smem, warp, lane);
  write_tile<VT>(acc, p, t, out, warp, lane);
}

// ---- the D = 32 body ----------------------------------------------------------

using ape_msda::blend4;
using ape_msda::cell;
using ape_msda::kItemLanes;
using ape_msda::touches;

// The D = 32 body's block: 8 warps; an item takes two queries, so a warp
// holds 8 and a tile of at most 64 queries takes one pass.
constexpr int kPairWarps = 8;
constexpr int kPairThreads = kPairWarps * 32;
constexpr int kQueriesPerItem = 2;
constexpr int kPairWarpQueries = kItemsPerWarp * kQueriesPerItem;
static_assert(kPairWarps * kPairWarpQueries == kD32TileQueries, "one pass of a D32_TILES tile");

// At most 64 registers a thread (4 blocks an SM where shared memory allows).
template <typename VT, typename AT>
__global__ void __launch_bounds__(kPairThreads, 4)
msda_fwd_pair_kernel_d32(const VT* __restrict__ value, const float* __restrict__ off,
                         const AT* __restrict__ att, const float* __restrict__ centers,
                         void* __restrict__ out, const Plan p,
                         __grid_constant__ const TileMaps maps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = d32_header(smem_raw).bar;
  const Tile t = make_tile(p);
  const int l = p.lv[0];
  const int hl = p.lvl_h[l], wl = p.lvl_w[l];
  const bool staged = !finer(p, l);  // else the corners come from device memory
  const int by0 = window_base(t.qy0, p.hq, hl, p.win);
  const int bx0 = window_base(t.qx0, p.wq, wl, p.win);
  if (staged && threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    mbar_expect_tx(bar, p.box_h[0] * p.box_w[0] * kD32 * sizeof(VT));
    tma_load_box(smem_raw + p.box_off[0] * sizeof(VT), &maps.map[0], bar, 0, t.h, bx0, by0, t.b);
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (kItemLanes - 1);  // lane within the item: channels 4 sub .. 4 sub + 3
  const int slot = lane / kItemLanes;       // item within the warp
  const int c0 = sub * 4;
  const int64_t row_stride = static_cast<int64_t>(p.H) * kD32;
  const VT* vb = value + (static_cast<int64_t>(t.b) * p.S + p.lvl_start[l]) * row_stride +
                 t.h * kD32 + c0;
  const VT* box = reinterpret_cast<const VT*>(smem_raw) + p.box_off[0] + c0;
  const int n = t.ny * t.nx;
  const int s_end = kQueriesPerItem * p.P;  // an item's samples: its two queries' points
  bool landed = !staged;  // the box has landed, as this thread has seen
  for (int i0 = warp * kPairWarpQueries; i0 < n; i0 += kPairWarps * kPairWarpQueries) {
    const int ia = i0 + slot * kQueriesPerItem;  // the item's queries: ia and ia + 1
    // the item of its query k (0 or 1), any item if the query is past the tile's end
    const auto item_of = [&](int k) { return d32_query(p, t, ia + k < n ? ia + k : 0).item; };
    int k = 0;  // the item's query whose sums acc holds
    float acc[4];
    d32_start_sums(acc, p, out, ia < n, item_of(0), c0);
    for (int s0 = 0; s0 < s_end; s0 += kItemLanes) {
      // lane sub loads sample s0 + sub of the item, (query mk, point mpt),
      // and places it; a sample past the tile's end loads nothing but takes
      // part in the shuffles with NaN pixels
      const int mine = s0 + sub;
      const int mk = mine / p.P;
      const int mpt = mine - mk * p.P;
      float my_x = NAN, my_y = NAN, my_a = 0.f;
      if (mine < s_end && ia + mk < n) {
        const D32Query r = d32_query(p, t, ia + mk);
        const int64_t s = (r.item * p.L + l) * p.P + mpt;
        const float2 o = *reinterpret_cast<const float2*>(off + 2 * s);
        const float2 center = *reinterpret_cast<const float2*>(centers + 2 * r.q);
        my_x = sample_pixel(center.x, o.x, p.radius, wl);
        my_y = sample_pixel(center.y, o.y, p.radius, hl);
        my_a = to_f32(att[s]);
      }
      if (!landed) {
        mbar_wait(bar, 0);
        landed = true;
      }
      const int nn = min(kItemLanes, s_end - s0);  // uniform over the warp
      int sk = s0 / p.P, spt = s0 - sk * p.P;       // sample s0 + j is (query sk, point spt)
      for (int j = 0; j < nn; ++j) {
        const int src = slot * kItemLanes + j;
        const float x = __shfl_sync(0xffffffffu, my_x, src);
        const float y = __shfl_sync(0xffffffffu, my_y, src);
        const float a = __shfl_sync(0xffffffffu, my_a, src);
        if (sk != k) {  // the item's first query is done: store it, start the second
          d32_store_sums<VT>(acc, p, out, ia + k < n, item_of(k), c0);
          k = sk;
          d32_start_sums(acc, p, out, ia + k < n, item_of(k), c0);
        }
        if (++spt == p.P) {
          spt = 0;
          ++sk;
        }
        if (!touches(x, y, hl, wl)) continue;
        const Cell c = cell(x, y, hl, wl);
        const VT* v00 = vb + (static_cast<int64_t>(c.y0) * wl + c.x0) * row_stride;
        float c00[4] = {0.f, 0.f, 0.f, 0.f}, c01[4] = {0.f, 0.f, 0.f, 0.f};
        float c10[4] = {0.f, 0.f, 0.f, 0.f}, c11[4] = {0.f, 0.f, 0.f, 0.f};
        if (staged)
          box_corners(c, box, by0, bx0, p.box_h[0], p.box_w[0], v00, row_stride, wl, c00, c01,
                      c10, c11);
        else
          device_corners(c, v00, row_stride, wl, c00, c01, c10, c11);
        blend4(acc, a, c, c00, c01, c10, c11);
      }
    }
    d32_store_sums<VT>(acc, p, out, ia + k < n, item_of(k), c0);
  }
  // warp 0 always has queries, so thread 0 waits for the box before the
  // block's shared memory is given up
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_pair, msda_fwd_pair_kernel)

// K6's D = 32 body: the plan as the general entry's (ops/msda_window_forms.py,
// body "d32", one value level) and the (S, 2) f32 grid-center table of K1's
// window entry. Returns the launch's cudaError_t, or kNoTensorMapEncoder /
// kTensorMapRefused (negative) when the tensor map could not be made, in
// which case nothing is launched.
extern "C" int ape_msda_fwd_pair_d32(const void* value, const float* off, const void* att,
                                     const float* centers, void* out, const int* plan,
                                     float radius, int value_bf16, int att_f32, void* stream) {
  using namespace ape_msda_win;
  Plan p;
  const int es = value_bf16 ? 2 : 4;
  if (!parse_plan(plan, radius, es, p) || p.n_lv != 1 || !d32_plan(p, es, kD32TileQueries))
    return static_cast<int>(cudaErrorInvalidValue);
  TileMaps maps;
  if (const int err = encode_maps(p, value, value_bf16 != 0, CU_TENSOR_MAP_SWIZZLE_NONE, maps))
    return err;
  return by_dtypes(value_bf16, att_f32, [&](auto v, auto a) {
    using VT = decltype(v);
    using AT = decltype(a);
    return launch_d32(msda_fwd_pair_kernel_d32<VT, AT>, p, kPairThreads,
                      static_cast<cudaStream_t>(stream), static_cast<const VT*>(value), off,
                      static_cast<const AT*>(att), centers, out, p, maps);
  });
}

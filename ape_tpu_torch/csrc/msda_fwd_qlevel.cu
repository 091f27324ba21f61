// Window-MSDA forward, per query level: every value level in one launch,
// each level's footprint prefetched at tile entry (K8).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v5.py
// (ms_deform_attn_window_pallas_v5 -> _run_qlevel_fused): all value levels
// of a query level inside one kernel, the f32 accumulator in VMEM across
// levels, every level's slab DMA started at tile entry so that levels
// 1 .. L-1 stream while level 0 computes, and the levels packed greedily
// into groups whose slabs fit the VMEM budget. v5 keeps the partials
// between groups in bf16 for a bf16 value; this kernel adds them in f32.
//
// What bounds it on an H100: as K1 (msda_fwd.cu), the samples' corner
// reads; the bytes it must move are value, offsets, weights and the output
// once, about 57 MB at the protocol pyramid in bf16.
//
// The design: one block per (query tile, head, batch). At entry it issues
// the cp.async copies of every staged level's box (msda_window.cuh), one
// commit group per level, all resident at once in their own slices of
// shared memory. It first samples the finer levels, whose windows each warp
// stages per query with plain loads, while the boxes stream in; then each
// box level in order, waiting only for that level's group. The
// accumulators stay in registers across the levels. Where one block's
// shared memory (227 KB) cannot hold a query level's boxes and windows at
// the default tile, ops/msda_window_forms.py packs the levels greedily into
// groups, one launch each: the first stores the f32 partial, the others add
// to it. A query level of one group writes the output once, in the value's
// dtype.

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
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) acc[k] = 0.f;
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

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_qlevel, msda_fwd_qlevel_kernel)

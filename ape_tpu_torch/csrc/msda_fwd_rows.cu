// Window-MSDA forward, per query level: its same-or-coarser value levels in
// one launch (K7).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v3.py
// (ms_deform_attn_window_pallas_v3 -> _run_row_v3): per query level, every
// value level whose grid is as fine as the query level's or coarser runs as
// the innermost, sequential grid axis of one kernel, the f32 accumulator
// kept in VMEM scratch across those levels and the output written once;
// the finer pairs stay on a pair kernel. Here they go to K6
// (msda_fwd_pair.cu), which continues from the f32 partial this kernel
// stores.
//
// What bounds it on an H100: as K1 (msda_fwd.cu), the samples' corner
// reads; the bytes it must move are value, offsets, weights and the output
// once, about 57 MB at the protocol pyramid in bf16.
//
// The design: the TPU's sequential grid axis becomes a loop inside the
// block. One block per (query tile, head, batch) walks the launch's value
// levels in order, re-using one shared-memory buffer: it stages the tile's
// footprint on the level by cp.async (msda_window.cuh), samples every query
// of the tile from it, and moves to the next level. The accumulators stay
// in registers (16 queries a warp, lanes over the head's channels) across
// the levels, and each output element is stored once. Staging and sampling
// do not overlap here; that is K8's idea (msda_fwd_qlevel.cu).

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

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_rows, msda_fwd_rows_kernel)

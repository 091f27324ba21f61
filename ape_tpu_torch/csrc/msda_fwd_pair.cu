// Window-MSDA forward, one (query level, value level) pair per launch (K6).
//
// Replaces the TPU kernel experiments/msda_window_pallas_v1.py
// (ms_deform_attn_window_pallas -> _run_pair -> _pair_kernel): one kernel
// per pair, the value level's halo tile DMA'd into VMEM, and for strided
// pairs the level phase-decomposed into s x s planes so that every strided
// window read is a contiguous slice. Computes K1's function (msda_fwd.cu)
// one pair at a time: the pairs of a query level run in order on one stream
// and add into one f32 (B, Q, H * D) buffer, without atomics; the caller
// casts it.
//
// What bounds it on an H100: the samples' corner reads, about 8 flops for
// each byte read, so latency and bytes, not arithmetic. Read once, value,
// offsets, weights and the output are about 57 MB at the protocol pyramid
// in bf16, 17 us at 3.35 TB/s; K1 reads its corners from L2, one 64-byte row
// each.
//
// The design (msda_window.cuh): one block per (query tile, head, batch);
// for a value level as fine as the query level or coarser, the block stages
// the tile's footprint, (t + 2 ceil(R) + 3)^2 pixels of one head, by
// cp.async into shared memory and reads every corner there. A finer level
// has no phase planes here: each warp stages the window of the query it is
// at, (2 ceil(R) + 3)^2 pixels, the Hopper answer to v1's phase
// decomposition (a strided box would hold mostly pixels no query reads).
// The cost is 25 launches a layer and a read-modify-write of the f32 buffer
// for every pair after a query level's first.

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
#pragma unroll
  for (int k = 0; k < kQueriesPerWarp; ++k) acc[k] = 0.f;
  sample_level<VT, AT>(acc, p, t, 0, value, off, att, smem, warp, lane);
  write_tile<VT>(acc, p, t, out, warp, lane);
}

}  // namespace

APE_MSDA_WINDOW_ENTRY(ape_msda_fwd_pair, msda_fwd_pair_kernel)

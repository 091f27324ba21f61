// Global self-attention forward: softmax(q k^T * scale) v, flash style.
//
// Replaces the TPU kernel that ape_tpu/modeling/backbone/eva_vit.py:111-136
// (Attention.__call__) calls for the global ViT blocks: JAX's library Pallas
// kernel jax.experimental.pallas.ops.tpu.flash_attention. On APE-Ti it runs
// in 4 global blocks per image at q, k, v = (1, 3, 4096, 64).
//
// What bounds it on an H100: operations. At N = 4096 and head_dim 64 a call
// is 4*N*N*Dh*heads = 12.9 GFLOP against 6 MB of input, far above the card's
// flops-per-byte balance, so the N x N score matrix must never reach device
// memory, and below the 193 us the f32 FMAs would need only the tensor cores
// go.
//
// The design is attn_fwd.cuh's body (shared with the tile sweep K11 in
// attn_fwd_tiles.cu) at the tile BQ = BK = 64: in bf16, 4 warps of 16 query
// rows on mma.sync m16n8k16 with f32 accumulators, key and value tiles
// double-buffered by cp.async, the online softmax in registers and P fed to
// P V without leaving them; in f32 (the parity checks), plain FMAs on a
// 16 x 16 thread grid. Inputs are f32 or bf16, the output is in the input
// dtype, and N is arbitrary: the last key tile is masked, rows past N are
// not stored. With an lse pointer the kernel also writes each row's f32
// log-sum-exp of the scaled scores, the residual attn_bwd.cu recomputes the
// probabilities from (the library kernel saves l and m for the same use).

#include "attn_fwd.cuh"

// q, k, v, out: (BH, N, DH) contiguous, all bf16 (is_bf16) or all f32.
// lse: (BH, N) f32, or null to skip it. Returns the launch's cudaError_t.
extern "C" int ape_attn_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                            int BH, int N, int DH, float scale, int is_bf16, void* stream) {
  return dispatch<64, 64>(q, k, v, out, lse, BH, N, DH, scale, is_bf16,
                          static_cast<cudaStream_t>(stream));
}

// Global self-attention forward: softmax(q k^T * scale) v, flash style.
//
// Replaces the TPU kernel that ape_tpu/modeling/backbone/eva_vit.py:111-136
// (Attention.__call__) calls for the global ViT blocks: JAX's library Pallas
// kernel jax.experimental.pallas.ops.tpu.flash_attention. On APE-Ti it runs
// in 4 global blocks per image at q, k, v = (1, 3, 4096, 64).
//
// What bounds it on an H100: arithmetic. At N = 4096 and head_dim 64 a call
// is 4*N*N*Dh*heads = 12.9 GFLOP against 6 MB of input, far above the card's
// flops-per-byte balance, so the N x N score matrix must never reach device
// memory and the time is set by how fast the block turns FMAs.
//
// The design (the body is attn_fwd.cuh, shared with the tile sweep K11 in
// attn_fwd_tiles.cu): one block of 256 threads per (batch*head, 64-query
// tile). The query tile stays in shared memory; key and value tiles of 64
// rows stream through shared memory; the softmax is online (running max and
// sum per row, in f32), so scores and probabilities live only in registers
// and one 64x64 shared tile. Each thread owns a 4x4 patch of the score tile
// and 4 rows of Dh/16 output channels: every shared-memory float4 read feeds
// 8-16 FMAs. Q and K are stored transposed ([d][row]) so those reads are
// bank-conflict free. This first version uses plain f32 FMAs (no mma.sync,
// wgmma or TMA); tensor cores are later work. Inputs are f32 or bf16, the
// output is in the input dtype, and N is arbitrary: the last key tile is
// masked, rows past N are not stored. With an lse pointer the kernel also
// writes each row's f32 log-sum-exp of the scaled scores, the residual
// attn_bwd.cu recomputes the probabilities from (the library kernel saves l
// and m for the same use).

#include "attn_fwd.cuh"

// q, k, v, out: (BH, N, DH) contiguous, all bf16 (is_bf16) or all f32.
// lse: (BH, N) f32, or null to skip it. Returns the launch's cudaError_t.
extern "C" int ape_attn_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                            int BH, int N, int DH, float scale, int is_bf16, void* stream) {
  return dispatch<64, 64>(q, k, v, out, lse, BH, N, DH, scale, is_bf16,
                          static_cast<cudaStream_t>(stream));
}

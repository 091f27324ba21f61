// The attention tile sweep (K11): K5's flash-attention forward (attn_fwd.cuh)
// at the tiles (BQ queries, BK keys) (32, 32), (64, 64), (64, 128),
// (128, 64) and (128, 128).
//
// Replaces the TPU kernel run by experiments/backbone_fix_probe.py (main):
// JAX's library Pallas flash_attention at its default block sizes and at
// 1024-row blocks, timed beside einsum attention on the global blocks'
// q, k, v = (1, 3, 4096, 64) bf16. On the TPU a block size trades VMEM and
// grid steps; on Hopper a tile trades shared memory a block (4 (DH (BQ + 4) +
// DH (BK + 4) + BK DH + BK (BQ + 4)) bytes: 31 / 67 / 116 / 99 / 164 KB at
// DH 64), blocks in flight an SM and registers a thread against the reuse of
// each shared-memory read (a thread's (BQ / 16) x (BK / 16) score patch).
// JAX's 1024-row blocks would need about 4.8 MB of f32 staging: no Hopper
// block holds that, and the sweep's tool reports them so.
//
// What bounds it on an H100: arithmetic, as K5: 12.9 GFLOP a call at the
// global blocks' shape, 13 us at the bf16 tensor-core peak; these plain-FMA
// tiles are the measurement a tensor-core K5 picks its tile from.
// (64, 64) is K5's own instance: the same code and the same outputs, bit for
// bit. A tile whose shared memory exceeds a block's is refused by the
// wrapper and, if called, returns cudaErrorInvalidValue without launching.

#include "attn_fwd.cuh"

// q, k, v, out: (BH, N, DH) contiguous, all bf16 (is_bf16) or all f32; DH 32,
// 64 or 128; (bq, bk) one of the sweep's tiles. Returns the launch's
// cudaError_t.
extern "C" int ape_attn_fwd_tiles(const void* q, const void* k, const void* v, void* out, int BH,
                                  int N, int DH, float scale, int is_bf16, int bq, int bk,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bq * 1000 + bk) {
    case 32032: return dispatch<32, 32>(q, k, v, out, nullptr, BH, N, DH, scale, is_bf16, st);
    case 64064: return dispatch<64, 64>(q, k, v, out, nullptr, BH, N, DH, scale, is_bf16, st);
    case 64128: return dispatch<64, 128>(q, k, v, out, nullptr, BH, N, DH, scale, is_bf16, st);
    case 128064: return dispatch<128, 64>(q, k, v, out, nullptr, BH, N, DH, scale, is_bf16, st);
    case 128128: return dispatch<128, 128>(q, k, v, out, nullptr, BH, N, DH, scale, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

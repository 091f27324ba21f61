// The tensor-core pieces of the bf16 attention bodies (attn_fwd.cuh's
// forward, attn_bwd.cu's dK/dV): cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 bf16 mma.sync with f32
// accumulators, as PTX for sm_80 and later (sm_90a here).
//
// Fragments of mma.m16n8k16 (PTX ISA), lane = 4 g + t (g = lane / 4, t =
// lane % 4), two bf16 a 32-bit register, the lower column in the low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                           a3 (g + 8, 2t + 8..);
//   B (16 x 8, k x n):      b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g);
//   C (16 x 8, f32):        c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1).
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of a k16 step of the next product (pack_bf16).
//
// Tiles in shared memory are row-major bf16 rows of DH + 8 elements: the
// 16-byte pad puts the 8 rows an ldmatrix reads in 8 different 4-bank
// groups at DH 32, 64 and 128, so its reads are free of bank conflicts.
//
// Included by two translation units: everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b on the tensor cores: (16 x 16 bf16) (16 x 8 bf16), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a k16 step from the C fragments of n8 tiles 2s and 2s + 1.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [r0, r0 + ROWS) of a (N, DH) bf16 head into a [ROWS][DH + 8] shared
// tile by cp.async, 16 bytes a copy, rows past N zero-filled. Commit is the
// caller's.
template <int ROWS, int DH, int THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                        int N) {
  constexpr int kChunks = DH / 8;  // 16-byte pieces a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int r = c / kChunks;
    const int e = (c - r * kChunks) * 8;
    const bool in = r0 + r < N;
    cp_async16(dst + r * (DH + 8) + e, src + (in ? static_cast<int64_t>(r0 + r) * DH + e : 0), in);
  }
}

// Per-lane row and column offsets of the ldmatrix addresses:
//   A of 16 rows x 16 columns (row-major tile):          row a_row, column a_col;
//   B of two n8 tiles x k16, from rows n (non-trans):     row b_row, column b_col,
//     registers b0, b1 of rows +0..7, then b0, b1 of rows +8..15;
//   B of k16 x two n8 tiles, from rows k (trans):         row t_row, column t_col,
//     registers b0, b1 of columns +0..7, then b0, b1 of columns +8..15.
struct LaneOffsets {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ __forceinline__ explicit LaneOffsets(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + ((lane >> 4) << 3)),
        b_col(((lane >> 3) & 1) * 8),
        t_row((lane & 7) + (((lane >> 3) & 1) << 3)),
        t_col((lane >> 4) * 8) {}
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

}  // namespace

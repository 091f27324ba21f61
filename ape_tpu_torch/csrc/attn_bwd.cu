// Global self-attention backward, flash style: dQ, dK, dV of
// O = softmax(Q K^T * scale) V without the N x N matrix in device memory.
//
// Replaces the backward of the TPU kernel attn_fwd.cu replaces: JAX's library
// Pallas flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py),
// whose custom_vjp runs two more kernels, _flash_attention_bwd_dkv (dK, dV;
// :941, pallas_call :1121) and _flash_attention_bwd_dq (dQ; :1287, pallas_call
// :1456), after a plain jnp pass for delta (:273), reached from
// ape_tpu/modeling/backbone/eva_vit.py:136 in the global blocks. APE-Ti
// trains them at q, k, v = (2, 3, 4096, 64). Two kernels, dQ first:
//
//   dq:    per 64-query tile: delta_i = sum_d dO[i, d] * O[i, d] (written out),
//          then a loop over the key tiles:
//            P = exp(Q K^T * scale - lse), dP = dO V^T, dS = P * (dP - delta)
//            dQ += scale * dS K
//   dkv:   per 64-key tile, loop over the query tiles (reading dq's delta):
//            the same P and dS;  dV += P^T dO,  dK += scale * dS^T Q
//
// P is recomputed from the forward's f32 log-sum-exp (attn_fwd.cu's lse
// output), never stored.
//
// What bounds it on an H100: operations. dK/dV does 8 N^2 DH flops a head,
// 51.5 GFLOP at the training shape: 52 us at the 989 TFLOP/s of the bf16
// tensor cores, 770 us at the 67 TFLOP/s of f32 FMAs; dQ 6 N^2 DH, 38.7
// GFLOP, 39 us and 580 us. So both bf16 bodies run on the tensor cores
// (mma.sync m16n8k16, f32 accumulators, bf16_mma.cuh).
//
// dK/dV, FlashAttention-2's dK/dV shape:
//   * a block takes 64 keys with 4 warps of 16 key rows each; K and V for
//     those rows are loaded once (cp.async) and held as mma A fragments in
//     registers (at DH 128, where two 16 x 128 f32 accumulators already take
//     128 registers a lane, they stay in shared memory and are re-read by
//     ldmatrix at each use instead);
//   * per 64-row query tile, Q and dO (bf16) with the tile's 64 lse and delta
//     floats are double-buffered in shared memory by cp.async;
//   * S^T = K Q^T and dP^T = V dO^T, Q and dO as B operands through ldmatrix;
//   * P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in f32
//     registers; queries are the columns, so a lane reads lse and delta for
//     its own two columns of each n8 tile;
//   * P^T and dS^T rounded to bf16 in registers are the A operands of dV +=
//     P^T dO and dK += dS^T Q, with dO and Q through ldmatrix.trans (the
//     rounding SDPA's flash backward does too);
//   * dK is scaled by scale; both are stored bf16. Rows past N are
//     zero-filled: a query past N has zero Q, dO, lse and delta, so it adds
//     P^T dO = 0 and dS^T = 0; a key past N only feeds rows never stored.
// dQ, the same pieces with queries as the block's rows (K5's forward shape):
//   * a block takes 64 queries with 4 warps of 16 query rows; Q and dO are
//     loaded once by cp.async and held as A fragments (in shared memory at
//     DH 128, re-read by ldmatrix), the rows' lse in registers;
//   * delta folded in: in the prologue each quad of lanes sums dO . O of its
//     two rows in f32 from the bf16 inputs (dO from shared memory, O from
//     device memory), keeps it in registers and stores it for dK/dV, so no
//     pre-pass launches;
//   * 64-key tiles of K and V double-buffered by cp.async; S = Q K^T and
//     dP = dO V^T with K and V as B operands through ldmatrix; P and dS =
//     P (dP - delta) in f32 registers, keys past N masked;
//   * dS rounded to bf16 in registers (c_to_a) is the A operand of dQ += dS K,
//     K through ldmatrix.trans (the rounding SDPA's flash backward does);
//   * dQ x scale stored bf16; rows past N are not stored.
// The f32 bodies (for the parity checks: on the tensor cores f32 would be
// TF32) keep plain f32 FMAs, dQ with the same delta prologue: 256 threads in
// a 16 x 16 grid, each owning a 4 x 4 patch of the 64 x 64 score tile, then 4
// rows of DH/16 channels of the output tile; tiles in shared memory in f32,
// transposed where the inner loop reads them across rows so that every read
// is a broadcast or a float4. Gradients are in the input dtype, N arbitrary
// (rows past N are zero-filled and masked).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

constexpr int kBT = 64;       // rows of a query or key tile
constexpr int kLDT = kBT + 4; // row length of the transposed tiles (floats)
constexpr int kThreads = 256; // 16 x 16 threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [r0, r0 + 64) of a (N, DH) head into a row-major [64][DH + 4] tile
template <int DH, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int N) {
  for (int idx = threadIdx.x; idx < kBT * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    dst[r * (DH + 4) + d] = r0 + r < N ? to_f32(src[static_cast<int64_t>(r0 + r) * DH + d]) : 0.f;
  }
}

// the same rows transposed into a [DH][64 + 4] tile
template <int DH, typename T>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, int r0, int N) {
  for (int idx = threadIdx.x; idx < kBT * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    dst[d * kLDT + r] = r0 + r < N ? to_f32(src[static_cast<int64_t>(r0 + r) * DH + d]) : 0.f;
  }
}

// The shared score step. Thread (ty, tx) owns queries ty*4 + r and keys
// tx*4 + c of the (query tile at q0, key tile at k0) pair: P and
// dS = P * (dP - delta) of its 4 x 4 patch. Qs and dOs are row-major
// [64][DH + 4], KsT and VsT transposed [DH][64 + 4].
template <int DH>
__device__ __forceinline__ void score_patch(const float* Qs, const float* dOs, const float* KsT,
                                            const float* VsT, const float* lse_s,
                                            const float* delta_s, int k0, int N, float scale,
                                            float p[4][4], float ds[4][4]) {
  constexpr int LDD = DH + 4;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    const float4 kb = *reinterpret_cast<const float4*>(KsT + d * kLDT + tx * 4);
    const float4 vb = *reinterpret_cast<const float4*>(VsT + d * kLDT + tx * 4);
    const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
    const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float qv = Qs[(ty * 4 + r) * LDD + d];
      const float gv = dOs[(ty * 4 + r) * LDD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv, kv[c], s[r][c]);
        dp[r][c] = fmaf(gv, vv[c], dp[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float lse = lse_s[ty * 4 + r];
    const float dl = delta_s[ty * 4 + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool key_ok = k0 + tx * 4 + c < N;
      p[r][c] = key_ok ? expf(s[r][c] * scale - lse) : 0.f;
      ds[r][c] = p[r][c] * (dp[r][c] - dl);
    }
  }
}

template <int DH>
__device__ __forceinline__ void load_vec(float (&dst)[DH / 16], const float* src) {
  constexpr int CPT = DH / 16;
  if constexpr (CPT % 4 == 0) {
#pragma unroll
    for (int e = 0; e < CPT; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + e);
      dst[e] = t.x; dst[e + 1] = t.y; dst[e + 2] = t.z; dst[e + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < CPT; ++e) dst[e] = src[e];
  }
}

template <int DH>
constexpr int dkv_smem_floats() {
  return 2 * DH * kLDT + 2 * kBT * (DH + 4) + 2 * kBT * kLDT + 2 * kBT;
}

// The f32 dK/dV body.
template <int DH, typename T>
__device__ __forceinline__ void attn_dkv_fma(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, const T* __restrict__ d_out,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, T* __restrict__ dk,
                                             T* __restrict__ dv, int N, float scale, float* smem) {
  constexpr int CPT = DH / 16;
  constexpr int LDD = DH + 4;
  float* KsT = smem;                  // [DH][kLDT]
  float* VsT = KsT + DH * kLDT;       // [DH][kLDT]
  float* Qs = VsT + DH * kLDT;        // [kBT][LDD]
  float* dOs = Qs + kBT * LDD;        // [kBT][LDD]
  float* Ps = dOs + kBT * LDD;        // [query][key], kLDT per row
  float* dSs = Ps + kBT * kLDT;       // [query][key]
  float* lse_s = dSs + kBT * kLDT;    // [kBT]
  float* delta_s = lse_s + kBT;       // [kBT]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBT;
  const int64_t head = static_cast<int64_t>(blockIdx.y);
  const int64_t head_off = head * N * DH;
  load_rows_t<DH>(KsT, k + head_off, k0, N);
  load_rows_t<DH>(VsT, v + head_off, k0, N);

  float acc_dk[4][CPT], acc_dv[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc_dk[r][e] = acc_dv[r][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBT) {
    __syncthreads();  // the previous tile's products are done with Qs, dOs, Ps, dSs
    load_rows<DH>(Qs, q + head_off, q0, N);
    load_rows<DH>(dOs, d_out + head_off, q0, N);
    if (threadIdx.x < kBT) {
      const int row = q0 + threadIdx.x;
      // rows past N: zero Q and dO and delta make dS = 0 and P * dO = 0
      lse_s[threadIdx.x] = row < N ? lse[head * N + row] : 0.f;
      delta_s[threadIdx.x] = row < N ? delta[head * N + row] : 0.f;
    }
    __syncthreads();

    float p[4][4], ds[4][4];
    score_patch<DH>(Qs, dOs, KsT, VsT, lse_s, delta_s, k0, N, scale, p, ds);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(Ps + (ty * 4 + r) * kLDT + tx * 4) =
          make_float4(p[r][0], p[r][1], p[r][2], p[r][3]);
      *reinterpret_cast<float4*>(dSs + (ty * 4 + r) * kLDT + tx * 4) =
          make_float4(ds[r][0], ds[r][1], ds[r][2], ds[r][3]);
    }
    __syncthreads();

    // thread (ty, tx): keys ty*4 + r, channels tx*CPT + e
#pragma unroll 4
    for (int i = 0; i < kBT; ++i) {
      const float4 pa = *reinterpret_cast<const float4*>(Ps + i * kLDT + ty * 4);
      const float4 sa = *reinterpret_cast<const float4*>(dSs + i * kLDT + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
      float gv[CPT], qv[CPT];
      load_vec<DH>(gv, dOs + i * LDD + tx * CPT);
      load_vec<DH>(qv, Qs + i * LDD + tx * CPT);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          acc_dv[r][e] = fmaf(pv[r], gv[e], acc_dv[r][e]);
          acc_dk[r][e] = fmaf(sv[r], qv[e], acc_dk[r][e]);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty * 4 + r;
    if (row >= N) continue;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const int64_t at = head_off + static_cast<int64_t>(row) * DH + tx * CPT + e;
      dk[at] = from_f32<T>(acc_dk[r][e] * scale);
      dv[at] = from_f32<T>(acc_dv[r][e]);
    }
  }
}

// The bf16 dK/dV body: mma.sync on the tensor cores, one warp a 16-key
// slice of the block's 64 keys.
constexpr int kMmaThreads = 128;  // 4 warps

template <int DH>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V: [kBT][DH + 8]; Q, dO: two buffers each; lse and delta: two buffers
  return sizeof(__nv_bfloat16) * 6 * kBT * (DH + 8) + sizeof(float) * 4 * kBT;
}

template <int DH>
__device__ __forceinline__ void attn_dkv_mma(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const __nv_bfloat16* __restrict__ d_out,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             __nv_bfloat16* __restrict__ dk,
                                             __nv_bfloat16* __restrict__ dv, int N, float scale,
                                             unsigned char* smem) {
  constexpr int LD = DH + 8;   // bf16 a shared row
  constexpr int NT = kBT / 8;  // n8 tiles of queries in S^T and dP^T
  constexpr int DT = DH / 8;   // n8 tiles of channels in dK and dV
  constexpr int KD = DH / 16;  // k16 steps over the channels
  constexpr bool kRegs = DH <= 64;  // K and V fragments in registers
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBT][LD]
  __nv_bfloat16* Vs = Ks + kBT * LD;                            // [kBT][LD]
  __nv_bfloat16* Qs = Vs + kBT * LD;                            // [2][kBT][LD]
  __nv_bfloat16* dOs = Qs + 2 * kBT * LD;                       // [2][kBT][LD]
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * kBT * LD);  // [2][lse kBT, delta kBT]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const LaneOffsets at(lane);
  const int k0 = blockIdx.x * kBT;
  const int64_t head = static_cast<int64_t>(blockIdx.y);
  const int64_t head_off = head * N * DH;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* doh = d_out + head_off;
  const int tiles = (N + kBT - 1) / kBT;

  // query tile t into buffer b: Q, dO rows and the tile's lse, delta (0 past N)
  auto load_tile = [&](int t, int b) {
    cp_rows<kBT, DH, kMmaThreads>(Qs + b * kBT * LD, qh, t * kBT, N);
    cp_rows<kBT, DH, kMmaThreads>(dOs + b * kBT * LD, doh, t * kBT, N);
    const int i = threadIdx.x & (kBT - 1);
    const int row = t * kBT + i;
    const bool in = row < N;
    const float* src = (threadIdx.x < kBT ? lse : delta) + head * N + (in ? row : 0);
    cp_async4(rows_s + b * 2 * kBT + threadIdx.x, src, in);
  };
  cp_rows<kBT, DH, kMmaThreads>(Ks, k + head_off, k0, N);
  cp_rows<kBT, DH, kMmaThreads>(Vs, v + head_off, k0, N);
  load_tile(0, 0);
  cp_async_commit();

  const float scale2 = scale * kLog2e;  // exponents in log2 units
  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  uint32_t kf[kRegs ? KD : 1][4], vf[kRegs ? KD : 1][4];
  const __nv_bfloat16* k_rows = Ks + (warp * 16 + at.a_row) * LD + at.a_col;
  const __nv_bfloat16* v_rows = Vs + (warp * 16 + at.a_row) * LD + at.a_col;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      load_tile(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // query tile t (and K, V) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegs) {
      if (t == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldmatrix_x4(kf[kd], k_rows + kd * 16);
          ldmatrix_x4(vf[kd], v_rows + kd * 16);
        }
      }
    }
    const __nv_bfloat16* Qt = Qs + buf * kBT * LD;
    const __nv_bfloat16* dOt = dOs + buf * kBT * LD;
    const float* lse_t = rows_s + buf * 2 * kBT;
    const float* delta_t = lse_t + kBT;

    // S^T (keys x queries) and dP^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kd][e];
          va[e] = vf[kd][e];
        }
      } else {
        ldmatrix_x4(ka, k_rows + kd * 16);
        ldmatrix_x4(va, v_rows + kd * 16);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Qt + (jp * 16 + at.b_row) * LD + kd * 16 + at.b_col);
        mma_bf16(s[2 * jp], ka, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, dOt + (jp * 16 + at.b_row) * LD + kd * 16 + at.b_col);
        mma_bf16(dp[2 * jp], va, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], va, b[2], b[3]);
      }
    }

    // C element e of n8 tile j: key row g + 8 (e / 2), query 8 j + 2 tig + e % 2
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j * 8 + tig * 2 + c;
        const float lse2 = lse_t[col] * kLog2e;
        const float dl = delta_t[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float p = exp2f(s[j][e] * scale2 - lse2);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl);
        }
      }

    // dV += P^T dO, dK += dS^T Q: k16 steps over the tile's queries
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dOt + (kk * 16 + at.t_row) * LD + jp * 16 + at.t_col);
        mma_bf16(acc_dv[2 * jp], pa, b[0], b[1]);
        mma_bf16(acc_dv[2 * jp + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, Qt + (kk * 16 + at.t_row) * LD + jp * 16 + at.t_col);
        mma_bf16(acc_dk[2 * jp], sa, b[0], b[1]);
        mma_bf16(acc_dk[2 * jp + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + r * 8;
    if (row >= N) continue;
    const int64_t at_row = head_off + static_cast<int64_t>(row) * DH + tig * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at_row + j * 8) =
          __floats2bfloat162_rn(acc_dk[j][2 * r] * scale, acc_dk[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at_row + j * 8) =
          __floats2bfloat162_rn(acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
    }
  }
}

template <typename T>
__host__ __device__ constexpr int bwd_threads() {
  return std::is_same<T, float>::value ? kThreads : kMmaThreads;
}

template <int DH, typename T>
constexpr size_t dkv_smem_bytes() {
  return std::is_same<T, float>::value ? dkv_smem_floats<DH>() * sizeof(float)
                                       : dkv_mma_smem_bytes<DH>();
}

template <int DH, typename T>
__global__ void __launch_bounds__(bwd_threads<T>())
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ d_out, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  if constexpr (std::is_same<T, float>::value)
    attn_dkv_fma<DH, T>(q, k, v, d_out, lse, delta, dk, dv, N, scale,
                        reinterpret_cast<float*>(smem_bytes));
  else
    attn_dkv_mma<DH>(q, k, v, d_out, lse, delta, dk, dv, N, scale, smem_bytes);
}

template <int DH>
constexpr int dq_smem_floats() {
  return 2 * DH * kLDT + 3 * kBT * (DH + 4) + kBT * kLDT + 2 * kBT;
}

// The f32 dQ body, with the delta prologue: delta_i = sum_d dO[i, d] O[i, d]
// for the block's 64 rows, written to delta for dK/dV.
template <int DH, typename T>
__device__ __forceinline__ void attn_dq_fma(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, const T* __restrict__ out,
                                            const T* __restrict__ d_out,
                                            const float* __restrict__ lse,
                                            float* __restrict__ delta, T* __restrict__ dq, int N,
                                            float scale, float* smem) {
  constexpr int CPT = DH / 16;
  constexpr int LDD = DH + 4;
  float* KsT = smem;                  // [DH][kLDT]
  float* VsT = KsT + DH * kLDT;       // [DH][kLDT]
  float* Qs = VsT + DH * kLDT;        // [kBT][LDD]
  float* dOs = Qs + kBT * LDD;        // [kBT][LDD]
  float* Ks = dOs + kBT * LDD;        // [kBT][LDD]
  float* dSsT = Ks + kBT * LDD;       // [key][query], kLDT per row
  float* lse_s = dSsT + kBT * kLDT;   // [kBT]
  float* delta_s = lse_s + kBT;       // [kBT]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBT;
  const int64_t head = static_cast<int64_t>(blockIdx.y);
  const int64_t head_off = head * N * DH;
  load_rows<DH>(Qs, q + head_off, q0, N);
  load_rows<DH>(dOs, d_out + head_off, q0, N);
  if (threadIdx.x < kBT) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] = row < N ? lse[head * N + row] : 0.f;
  }
  __syncthreads();  // dOs has landed
  // thread (ty, tx) sums channels tx*CPT + e of rows ty*4 + r, then the 16
  // threads of a row (one half-warp) add their sums; rows past N get 0
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    float sum = 0.f;
    if (row < N) {
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        sum = fmaf(dOs[(ty * 4 + r) * LDD + tx * CPT + e],
                   to_f32(out[head_off + static_cast<int64_t>(row) * DH + tx * CPT + e]), sum);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) {
      delta_s[ty * 4 + r] = sum;
      if (row < N) delta[head * N + row] = sum;
    }
  }

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[r][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBT) {
    __syncthreads();  // delta_s is written; the last tile's products are done with the tiles
    load_rows_t<DH>(KsT, k + head_off, k0, N);
    load_rows_t<DH>(VsT, v + head_off, k0, N);
    load_rows<DH>(Ks, k + head_off, k0, N);
    __syncthreads();

    float p[4][4], ds[4][4];
    score_patch<DH>(Qs, dOs, KsT, VsT, lse_s, delta_s, k0, N, scale, p, ds);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dSsT + (tx * 4 + c) * kLDT + ty * 4) =
          make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
    __syncthreads();

    // thread (ty, tx): queries ty*4 + r, channels tx*CPT + e
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      const float4 sa = *reinterpret_cast<const float4*>(dSsT + j * kLDT + ty * 4);
      const float sv[4] = {sa.x, sa.y, sa.z, sa.w};
      float kv[CPT];
      load_vec<DH>(kv, Ks + j * LDD + tx * CPT);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[r][e] = fmaf(sv[r], kv[e], acc[r][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= N) continue;
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      dq[head_off + static_cast<int64_t>(row) * DH + tx * CPT + e] = from_f32<T>(acc[r][e] * scale);
  }
}

template <int DH>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO: [kBT][DH + 8]; K, V: two buffers each
  return sizeof(__nv_bfloat16) * 6 * kBT * (DH + 8);
}

// The bf16 dQ body: mma.sync on the tensor cores, one warp a 16-query slice
// of the block's 64 queries, with the delta prologue.
template <int DH>
__device__ __forceinline__ void attn_dq_mma(const __nv_bfloat16* __restrict__ q,
                                            const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            const __nv_bfloat16* __restrict__ out,
                                            const __nv_bfloat16* __restrict__ d_out,
                                            const float* __restrict__ lse,
                                            float* __restrict__ delta,
                                            __nv_bfloat16* __restrict__ dq, int N, float scale,
                                            unsigned char* smem) {
  constexpr int LD = DH + 8;   // bf16 a shared row
  constexpr int NT = kBT / 8;  // n8 tiles of keys in S and dP
  constexpr int DT = DH / 8;   // n8 tiles of channels in dQ
  constexpr int KD = DH / 16;  // k16 steps over the channels
  constexpr bool kRegs = DH <= 64;  // Q and dO fragments in registers
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBT][LD]
  __nv_bfloat16* dOs = Qs + kBT * LD;                           // [kBT][LD]
  __nv_bfloat16* Ks = dOs + kBT * LD;                           // [2][kBT][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBT * LD;                        // [2][kBT][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const LaneOffsets at(lane);
  const int q0 = blockIdx.x * kBT;
  const int64_t head = static_cast<int64_t>(blockIdx.y);
  const int64_t head_off = head * N * DH;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  const int tiles = (N + kBT - 1) / kBT;

  cp_rows<kBT, DH, kMmaThreads>(Qs, q + head_off, q0, N);
  cp_rows<kBT, DH, kMmaThreads>(dOs, d_out + head_off, q0, N);
  cp_rows<kBT, DH, kMmaThreads>(Ks, kh, 0, N);
  cp_rows<kBT, DH, kMmaThreads>(Vs, vh, 0, N);
  cp_async_commit();

  // this lane's query rows g and g + 8 of the warp's slice (0 past N)
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < N ? lse[head * N + row] * kLog2e : 0.f;
  }

  const float scale2 = scale * kLog2e;  // exponents in log2 units
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[kRegs ? KD : 1][4], gf[kRegs ? KD : 1][4];
  const __nv_bfloat16* q_rows = Qs + (warp * 16 + at.a_row) * LD + at.a_col;
  const __nv_bfloat16* g_rows = dOs + (warp * 16 + at.a_row) * LD + at.a_col;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      cp_rows<kBT, DH, kMmaThreads>(Ks + (buf ^ 1) * kBT * LD, kh, (t + 1) * kBT, N);
      cp_rows<kBT, DH, kMmaThreads>(Vs + (buf ^ 1) * kBT * LD, vh, (t + 1) * kBT, N);
      cp_async_commit();
      cp_async_wait<1>();  // key tile t (and Q, dO) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      if constexpr (kRegs) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldmatrix_x4(qf[kd], q_rows + kd * 16);
          ldmatrix_x4(gf[kd], g_rows + kd * 16);
        }
      }
      // delta of rows g and g + 8: this lane's channels 8 j + 2 tig (+ 1) of
      // dO (shared) and O (device memory), then the sum over the lane's quad
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lrow = warp * 16 + g + 8 * r;
        const int row = q0 + lrow;
        float sum = 0.f;
        if (row < N) {
          const __nv_bfloat16* o_row = out + head_off + static_cast<int64_t>(row) * DH + tig * 2;
          const __nv_bfloat16* g_row = dOs + lrow * LD + tig * 2;
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            const float2 o =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o_row + j * 8));
            const float2 go =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g_row + j * 8));
            sum = fmaf(go.x, o.x, sum);
            sum = fmaf(go.y, o.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dl[r] = sum;
        if (tig == 0 && row < N) delta[head * N + row] = sum;
      }
    }
    const __nv_bfloat16* Kt = Ks + buf * kBT * LD;
    const __nv_bfloat16* Vt = Vs + buf * kBT * LD;

    // S = Q K^T and dP = dO V^T (queries x keys)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], ga[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[kd][e];
          ga[e] = gf[kd][e];
        }
      } else {
        ldmatrix_x4(qa, q_rows + kd * 16);
        ldmatrix_x4(ga, g_rows + kd * 16);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (jp * 16 + at.b_row) * LD + kd * 16 + at.b_col);
        mma_bf16(s[2 * jp], qa, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, Vt + (jp * 16 + at.b_row) * LD + kd * 16 + at.b_col);
        mma_bf16(dp[2 * jp], ga, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], ga, b[2], b[3]);
      }
    }

    // C element e of n8 tile j: query row g + 8 (e / 2), key t kBT + 8 j +
    // 2 tig + e % 2. dS = P (dP - delta) overwrites dP; keys past N are masked.
    const int k0 = t * kBT;
    const bool ragged = k0 + kBT > N;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(s[j][e] * scale2 - lse2[r]);
        if (ragged && k0 + j * 8 + tig * 2 + (e & 1) >= N) p = 0.f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }

    // dQ += dS K: k16 steps over the tile's keys, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Kt + (kk * 16 + at.t_row) * LD + jp * 16 + at.t_col);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= N) continue;
    const int64_t at_row = head_off + static_cast<int64_t>(row) * DH + tig * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + at_row + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <int DH, typename T>
constexpr size_t dq_smem_bytes() {
  return std::is_same<T, float>::value ? dq_smem_floats<DH>() * sizeof(float)
                                       : dq_mma_smem_bytes<DH>();
}

template <int DH, typename T>
__global__ void __launch_bounds__(bwd_threads<T>())
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ out, const T* __restrict__ d_out,
                   const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq,
                   int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  if constexpr (std::is_same<T, float>::value)
    attn_dq_fma<DH, T>(q, k, v, out, d_out, lse, delta, dq, N, scale,
                       reinterpret_cast<float*>(smem_bytes));
  else
    attn_dq_mma<DH>(q, k, v, out, d_out, lse, delta, dq, N, scale, smem_bytes);
}

template <int DH, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* d_out,
              const float* lse, float* delta, void* dq, int BH, int N, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DH, T>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBT - 1) / kBT, BH);
  attn_bwd_dq_kernel<DH, T><<<grid, bwd_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(d_out), lse, delta, static_cast<T*>(dq),
      N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_out, const float* lse,
               const float* delta, void* dk, void* dv, int BH, int N, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DH, T>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBT - 1) / kBT, BH);
  attn_bwd_dkv_kernel<DH, T><<<grid, bwd_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_out), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int DH) {
  return BH > 65535 || (DH != 32 && DH != 64 && DH != 128);
}

}  // namespace

// All tensors (BH, N, DH) contiguous in one dtype, bf16 (is_bf16) or f32;
// lse and delta (BH, N) f32. Each entry returns its launch's cudaError_t.

extern "C" int ape_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* d_out,
                                const float* lse, const float* delta, void* dk, void* dv,
                                int BH, int N, int DH, float scale, int is_bf16, void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (bad_shape(BH, DH)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APE_DKV(D, T) launch_dkv<D, T>(q, k, v, d_out, lse, delta, dk, dv, BH, N, scale, st)
  if (is_bf16) {
    if (DH == 32) return APE_DKV(32, __nv_bfloat16);
    if (DH == 64) return APE_DKV(64, __nv_bfloat16);
    return APE_DKV(128, __nv_bfloat16);
  }
  if (DH == 32) return APE_DKV(32, float);
  if (DH == 64) return APE_DKV(64, float);
  return APE_DKV(128, float);
#undef APE_DKV
}

// dQ, and delta = rowsum(d_out * out), which the dK/dV launch then reads
extern "C" int ape_attn_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                               const void* d_out, const float* lse, float* delta, void* dq,
                               int BH, int N, int DH, float scale, int is_bf16, void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (bad_shape(BH, DH)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APE_DQ(D, T) launch_dq<D, T>(q, k, v, out, d_out, lse, delta, dq, BH, N, scale, st)
  if (is_bf16) {
    if (DH == 32) return APE_DQ(32, __nv_bfloat16);
    if (DH == 64) return APE_DQ(64, __nv_bfloat16);
    return APE_DQ(128, __nv_bfloat16);
  }
  if (DH == 32) return APE_DQ(32, float);
  if (DH == 64) return APE_DQ(64, float);
  return APE_DQ(128, float);
#undef APE_DQ
}

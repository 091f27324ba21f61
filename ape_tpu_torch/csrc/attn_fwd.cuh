// The flash-attention forward's body, templated on the tile: softmax(q k^T *
// scale) v for (BH, N, DH) tensors, one block of 256 threads per (batch*head,
// BQ-query tile), key and value tiles of BK rows streamed through shared
// memory, the softmax online (running max and sum per row, in f32).
//
// attn_fwd.cu (K5) instantiates it at BQ = BK = 64 for the global ViT blocks;
// attn_fwd_tiles.cu (K11) at the tiles of the sweep. The 16 x 16 thread grid
// stays: each thread owns a (BQ / 16) x (BK / 16) patch of the score tile and
// BQ / 16 rows of DH / 16 output channels, so every shared-memory read of a
// row of the patch feeds its (BQ / 16) (BK / 16) or (BQ / 16) (DH / 16) FMAs.
// Q and K are stored transposed ([d][row]) so those reads are bank-conflict
// free. Plain f32 FMAs (no mma.sync, wgmma or TMA). Inputs are f32 or bf16,
// the output is in the input dtype; N is arbitrary: the last key tile is
// masked, rows past N are not stored. With an lse pointer the kernel also
// writes each row's f32 log-sum-exp of the scaled scores.
//
// Shared memory: 4 (DH (BQ + 4) + DH (BK + 4) + BK DH + BK (BQ + 4)) bytes, as
// ops/attention.py's attn_tile_smem computes it; a tile above the 227 KB a
// block may take is not instantiated and its launch returns
// cudaErrorInvalidValue.
//
// Included by two translation units: everything here has internal linkage,
// so each keeps its own copy of the kernels it launches.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kPad = 4;         // row padding of the transposed tiles (floats)
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on an H100

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

template <int DH, int BQ, int BK>
constexpr int smem_floats() {
  return DH * (BQ + kPad) + DH * (BK + kPad) + BK * DH + BK * (BQ + kPad);
}

// R consecutive floats of shared memory, by float4 (R a multiple of 4) or float2.
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&r)[R]) {
  static_assert(R % 4 == 0 || R == 2, "a thread's patch is 2 or a multiple of 4 wide");
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int e = 0; e < R; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      r[e] = t.x; r[e + 1] = t.y; r[e + 2] = t.z; r[e + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  }
}

template <int R>
__device__ __forceinline__ void store_row(float* p, const float (&r)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int e = 0; e < R; e += 4)
      *reinterpret_cast<float4*>(p + e) = make_float4(r[e], r[e + 1], r[e + 2], r[e + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  }
}

template <int DH, int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int N, float scale) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int RK = BK / 16;   // key columns per thread
  constexpr int CPT = DH / 16;  // output channels per thread
  constexpr int LDQ = BQ + kPad;
  constexpr int LDK = BK + kPad;
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;                 // [DH][LDQ]
  float* KsT = QsT + DH * LDQ;       // [DH][LDK]
  float* Vs = KsT + DH * LDK;        // [BK][DH]
  float* PsT = Vs + BK * DH;         // [BK][LDQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int64_t head_off = static_cast<int64_t>(blockIdx.y) * N * DH;
  const T* qh = q + head_off;
  const T* kh = k + head_off;
  const T* vh = v + head_off;

  for (int idx = tid; idx < BQ * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int row = q0 + r;
    QsT[d * LDQ + r] = row < N ? to_f32(qh[static_cast<int64_t>(row) * DH + d]) : 0.f;
  }

  float o[RQ][CPT];
  float m[RQ];
  float l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous tile's P.V is done with KsT, Vs and PsT
    for (int idx = tid; idx < BK * DH; idx += kThreads) {
      const int c = idx / DH;
      const int d = idx - c * DH;
      const int row = k0 + c;
      const bool in = row < N;
      KsT[d * LDK + c] = in ? to_f32(kh[static_cast<int64_t>(row) * DH + d]) : 0.f;
      Vs[c * DH + d] = in ? to_f32(vh[static_cast<int64_t>(row) * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RQ];
      float kv[RK];
      load_row<RQ>(QsT + d * LDQ + ty * RQ, qv);
      load_row<RK>(KsT + d * LDK + tx * RK, kv);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = (k0 + tx * RK + j < N) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one key < N, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < CPT; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      float col[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) col[i] = s[i][j];
      store_row<RQ>(PsT + (tx * RK + j) * LDQ + ty * RQ, col);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
      load_row<RQ>(PsT + c * LDQ + ty * RQ, pv);
      float vv[CPT];
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int e = 0; e < CPT; e += 4) {
          const float4 t = *reinterpret_cast<const float4*>(Vs + c * DH + tx * CPT + e);
          vv[e] = t.x; vv[e + 1] = t.y; vv[e + 2] = t.z; vv[e + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < CPT; ++e) vv[e] = Vs[c * DH + tx * CPT + e];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int e = 0; e < CPT; ++e) o[i][e] = fmaf(pv[i], vv[e], o[i][e]);
    }
  }

  T* oh = out + head_off;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= N) continue;
    const float inv = 1.f / l[i];
    if (lse != nullptr && tx == 0) lse[static_cast<int64_t>(blockIdx.y) * N + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      oh[static_cast<int64_t>(row) * DH + tx * CPT + e] = from_f32<T>(o[i][e] * inv);
  }
}

template <int DH, int BQ, int BK, typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH, BQ, BK>() * sizeof(float);
  if constexpr (smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<DH, BQ, BK, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BQ - 1) / BQ, BH);
    attn_fwd_kernel<DH, BQ, BK, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), lse, N, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

// One tile at the head widths 32, 64 and 128, f32 or bf16 (is_bf16).
template <int BQ, int BK>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
             int DH, float scale, int is_bf16, cudaStream_t st) {
  if (BH == 0 || N == 0) return 0;
  if (BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (DH * 2 + (is_bf16 ? 1 : 0)) {
    case 64: return launch<32, BQ, BK, float>(q, k, v, out, lse, BH, N, scale, st);
    case 65: return launch<32, BQ, BK, __nv_bfloat16>(q, k, v, out, lse, BH, N, scale, st);
    case 128: return launch<64, BQ, BK, float>(q, k, v, out, lse, BH, N, scale, st);
    case 129: return launch<64, BQ, BK, __nv_bfloat16>(q, k, v, out, lse, BH, N, scale, st);
    case 256: return launch<128, BQ, BK, float>(q, k, v, out, lse, BH, N, scale, st);
    case 257: return launch<128, BQ, BK, __nv_bfloat16>(q, k, v, out, lse, BH, N, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

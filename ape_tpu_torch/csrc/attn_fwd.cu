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
// The design: one block of 256 threads per (batch*head, 64-query tile). The
// query tile stays in shared memory; key and value tiles of 64 rows stream
// through shared memory; the softmax is online (running max and sum per row,
// in f32), so scores and probabilities live only in registers and one 64x64
// shared tile. Each thread owns a 4x4 patch of the score tile and 4 rows of
// Dh/16 output channels: every shared-memory float4 read feeds 8-16 FMAs.
// Q and K are stored transposed ([d][row]) so those reads are bank-conflict
// free. This first version uses plain f32 FMAs (no mma.sync, wgmma or TMA);
// tensor cores are later work. Inputs are f32 or bf16, the output is in the
// input dtype, and N is arbitrary: the last key tile is masked, rows past N
// are not stored. With an lse pointer the kernel also writes each row's
// f32 log-sum-exp of the scaled scores, the residual attn_bwd.cu recomputes
// the probabilities from (the library kernel saves l and m for the same use).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per tile
constexpr int kPad = 4;       // row padding of the transposed tiles (floats)
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

template <int DH>
constexpr int smem_floats() {
  return DH * (kBQ + kPad) + DH * (kBK + kPad) + kBK * DH + kBK * (kBQ + kPad);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int N, float scale) {
  constexpr int CPT = DH / 16;  // output channels per thread
  constexpr int LDQ = kBQ + kPad;
  constexpr int LDK = kBK + kPad;
  extern __shared__ __align__(16) float smem[];
  float* QsT = smem;                 // [DH][LDQ]
  float* KsT = QsT + DH * LDQ;       // [DH][LDK]
  float* Vs = KsT + DH * LDK;        // [kBK][DH]
  float* PsT = Vs + kBK * DH;        // [kBK][LDQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int64_t head_off = static_cast<int64_t>(blockIdx.y) * N * DH;
  const T* qh = q + head_off;
  const T* kh = k + head_off;
  const T* vh = v + head_off;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH;
    const int d = idx - r * DH;
    const int row = q0 + r;
    QsT[d * LDQ + r] = row < N ? to_f32(qh[static_cast<int64_t>(row) * DH + d]) : 0.f;
  }

  float o[4][CPT];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < CPT; ++e) o[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with KsT, Vs and PsT
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int c = idx / DH;
      const int d = idx - c * DH;
      const int row = k0 + c;
      const bool in = row < N;
      KsT[d * LDK + c] = in ? to_f32(kh[static_cast<int64_t>(row) * DH + d]) : 0.f;
      Vs[c * DH + d] = in ? to_f32(vh[static_cast<int64_t>(row) * DH + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(QsT + d * LDQ + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(KsT + d * LDK + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx * 4 + j < N) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one key < N, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(PsT + (tx * 4 + j) * LDQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(PsT + c * LDQ + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < CPT; ++e) o[i][e] = fmaf(pv[i], vv[e], o[i][e]);
    }
  }

  T* oh = out + head_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float inv = 1.f / l[i];
    if (lse != nullptr && tx == 0) lse[static_cast<int64_t>(blockIdx.y) * N + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      oh[static_cast<int64_t>(row) * DH + tx * CPT + e] = from_f32<T>(o[i][e] * inv);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBQ - 1) / kBQ, BH);
  attn_fwd_kernel<DH, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, N, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
             int DH, float scale, cudaStream_t stream) {
  switch (DH) {
    case 32: return launch<32, T>(q, k, v, out, lse, BH, N, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, lse, BH, N, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, lse, BH, N, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (BH, N, DH) contiguous, all bf16 (is_bf16) or all f32.
// lse: (BH, N) f32, or null to skip it. Returns the launch's cudaError_t.
extern "C" int ape_attn_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                            int BH, int N, int DH, float scale, int is_bf16, void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k, v, out, lse, BH, N, DH, scale, st);
  return dispatch<float>(q, k, v, out, lse, BH, N, DH, scale, st);
}

// Global self-attention backward, flash style: dQ, dK, dV of
// O = softmax(Q K^T * scale) V without the N x N matrix in device memory.
//
// Replaces the backward of the TPU kernel attn_fwd.cu replaces: JAX's library
// Pallas flash_attention (jax/experimental/pallas/ops/tpu/flash_attention.py),
// whose custom_vjp runs two more kernels, _flash_attention_bwd_dkv (dK, dV)
// and _flash_attention_bwd_dq (dQ), reached from ape_tpu/modeling/backbone/
// eva_vit.py:136 in the global blocks. APE-Ti trains them at q, k, v =
// (2, 3, 4096, 64). Three kernels, as FA2 and the library:
//
//   delta: delta_i = sum_d dO[i, d] * O[i, d]               (one warp a row)
//   dkv:   per 64-key tile, loop over the query tiles:
//            P = exp(Q K^T * scale - lse), dP = dO V^T, dS = P * (dP - delta)
//            dV += P^T dO,  dK += scale * dS^T Q
//   dq:    per 64-query tile, loop over the key tiles:  dQ += scale * dS K
//
// P is recomputed from the forward's f32 log-sum-exp (attn_fwd.cu's lse
// output), never stored.
//
// What bounds it on an H100: arithmetic, as the forward (the two kernels do
// 2.5x the forward's FMAs between them). The design follows the forward: 256
// threads in a 16 x 16 grid, each owning a 4 x 4 patch of the 64 x 64 score
// tile, then 4 rows of DH/16 channels of the output tile; tiles in shared
// memory in f32, transposed where the inner loop reads them across rows so
// that every read is a broadcast or a float4. Plain f32 FMAs: mma.sync,
// wgmma and TMA are later work. Inputs f32 or bf16, gradients in the input
// dtype, N arbitrary (rows past N are zero-filled and masked).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

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

template <typename T>
__global__ void attn_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ d_out,
                                      float* __restrict__ delta, int64_t rows, int DH) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc += to_f32(out[row * DH + d]) * to_f32(d_out[row * DH + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
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

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ d_out, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int N, float scale) {
  constexpr int CPT = DH / 16;
  constexpr int LDD = DH + 4;
  extern __shared__ __align__(16) float smem[];
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

template <int DH>
constexpr int dq_smem_floats() {
  return 2 * DH * kLDT + 3 * kBT * (DH + 4) + kBT * kLDT + 2 * kBT;
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ d_out, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int N, float scale) {
  constexpr int CPT = DH / 16;
  constexpr int LDD = DH + 4;
  extern __shared__ __align__(16) float smem[];
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
    delta_s[threadIdx.x] = row < N ? delta[head * N + row] : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[r][e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBT) {
    __syncthreads();  // the previous tile's products are done with KsT, VsT, Ks, dSsT
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

template <typename T>
int launch_delta(const void* out, const void* d_out, float* delta, int BH, int N, int DH,
                 cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(BH) * N;
  constexpr int kRowsPerBlock = 8;
  attn_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                             kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(d_out), delta, rows, DH);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_out, const float* lse,
               const float* delta, void* dk, void* dv, int BH, int N, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBT - 1) / kBT, BH);
  attn_bwd_dkv_kernel<DH, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_out), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), N,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* d_out, const float* lse,
              const float* delta, void* dq, int BH, int N, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_floats<DH>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DH, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + kBT - 1) / kBT, BH);
  attn_bwd_dq_kernel<DH, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(d_out), lse, delta, static_cast<T*>(dq), N, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int DH) {
  return BH > 65535 || (DH != 32 && DH != 64 && DH != 128);
}

}  // namespace

// All tensors (BH, N, DH) contiguous in one dtype, bf16 (is_bf16) or f32;
// lse and delta (BH, N) f32. Each entry returns its launch's cudaError_t.

// delta = rowsum(d_out * out)
extern "C" int ape_attn_bwd_delta(const void* out, const void* d_out, float* delta, int BH,
                                  int N, int DH, int is_bf16, void* stream) {
  if (BH == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_delta<__nv_bfloat16>(out, d_out, delta, BH, N, DH, st);
  return launch_delta<float>(out, d_out, delta, BH, N, DH, st);
}

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

extern "C" int ape_attn_bwd_dq(const void* q, const void* k, const void* v, const void* d_out,
                               const float* lse, const float* delta, void* dq, int BH, int N,
                               int DH, float scale, int is_bf16, void* stream) {
  if (BH == 0 || N == 0) return 0;
  if (bad_shape(BH, DH)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APE_DQ(D, T) launch_dq<D, T>(q, k, v, d_out, lse, delta, dq, BH, N, scale, st)
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

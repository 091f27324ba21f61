// The flash-attention forward's body, templated on the tile: softmax(q k^T *
// scale) v for (BH, N, DH) tensors, one block per (batch*head, BQ-query
// tile), key and value tiles of BK rows streamed through shared memory, the
// softmax online (running max and sum per row, in f32).
//
// attn_fwd.cu (K5) instantiates it at BQ = BK = 64 for the global ViT blocks;
// attn_fwd_tiles.cu (K11) at the tiles of the sweep. It replaces JAX's
// library Pallas flash_attention forward (jax/experimental/pallas/ops/tpu/
// flash_attention.py), which ape_tpu/modeling/backbone/eva_vit.py:136 calls.
//
// What bounds it on an H100: operations. At the global blocks' q, k, v =
// (1, 3, 4096, 64) a call is 4 N^2 DH heads = 12.9 GFLOP against 6 MB of
// inputs and output: 13 us at the 989 TFLOP/s of the bf16 tensor cores, 193
// us at the 67 TFLOP/s of f32 FMAs, 1.9 us of memory. Only the tensor cores
// get under the FMA floor, so the bf16 body is built on them; the N x N
// scores never leave registers.
//
// The bf16 body (the main path's dtype), FlashAttention-2's shape: BQ / 16
// warps, each owning 16 query rows (K5: 4 warps, 128 threads).
//   * The query tile is copied once into shared memory by cp.async, then held
//     in registers as mma A fragments (ldmatrix.x4) for the whole key loop.
//   * Key and value tiles are double-buffered in shared memory by cp.async
//     (commit / wait_group): tile j + 1 loads while tile j computes. The
//     ragged last tile is zero-filled by cp.async's source size, its keys
//     >= N masked to -inf.
//   * S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulators), K as the B
//     operand through ldmatrix; the online softmax in f32 registers, in log2
//     units (exp2f), each row's max and sum reduced over the 4 lanes of a
//     quad by __shfl_xor_sync (offsets 1, 2).
//   * O += P V: P rounded to bf16 in registers, two n8 accumulator tiles
//     forming one k16 A fragment, so P never goes to shared memory; V enters
//     as the B operand through ldmatrix.x4.trans.
//   * The epilogue divides by the row sum, stores bf16 pairs and, with an
//     lse pointer, each row's f32 log-sum-exp of the scaled scores from one
//     lane a row (the residual attn_bwd.cu reads).
// Rows padded by 16 bytes keep ldmatrix free of bank conflicts. Shared
// memory: 2 (BQ + 4 BK)(DH + 8) bytes (46 KB at K5's tile, DH 64). A
// 64-row tile would map onto one warpgroup's wgmma (m64nNk16); mma.sync is
// the simpler first design, wgmma later work.
//
// The f32 body, for the parity checks only (an f32 forward or train step
// against the CPU, the probes' f32 checks), keeps plain f32 FMAs: on the
// tensor cores f32 would compute in TF32, whose 10-bit mantissa breaks the
// 1e-4 bound. 256 threads in a 16 x 16 grid; each thread owns a (BQ / 16) x
// (BK / 16) patch of the score tile and BQ / 16 rows of DH / 16 output
// channels, so every shared-memory read of a row of the patch feeds its
// (BQ / 16) (BK / 16) or (BQ / 16) (DH / 16) FMAs. Q and K are stored
// transposed ([d][row]) so those reads are bank-conflict free. Shared memory:
// 4 (DH (BQ + 4) + DH (BK + 4) + BK DH + BK (BQ + 4)) bytes.
//
// ops/attention.py's attn_tile_smem computes both byte counts; a tile above
// the 227 KB a block may take is not instantiated and its launch returns
// cudaErrorInvalidValue. N is arbitrary: rows past N are not stored.
//
// Included by two translation units: everything here has internal linkage,
// so each keeps its own copy of the kernels it launches.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

constexpr int kPad = 4;         // row padding of the f32 body's transposed tiles (floats)
constexpr int kThreads = 256;   // the f32 body's 16 x 16 threads
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take on an H100

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// threads a block: the f32 body's 16 x 16, or BQ / 16 warps
template <int BQ, typename T>
__host__ __device__ constexpr int fwd_threads() {
  return is_f32<T>() ? kThreads : BQ / 16 * 32;
}

template <int DH, int BQ, int BK, typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return is_f32<T>()
             ? sizeof(float) * (DH * (BQ + kPad) + DH * (BK + kPad) + BK * DH + BK * (BQ + kPad))
             : sizeof(__nv_bfloat16) * (BQ + 4 * BK) * (DH + 8);
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

// The f32 body: plain FMAs on a 16 x 16 thread grid.
template <int DH, int BQ, int BK, typename T>
__device__ __forceinline__ void attn_fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             float* __restrict__ lse, int N, float scale,
                                             float* smem) {
  constexpr int RQ = BQ / 16;   // query rows per thread
  constexpr int RK = BK / 16;   // key columns per thread
  constexpr int CPT = DH / 16;  // output channels per thread
  constexpr int LDQ = BQ + kPad;
  constexpr int LDK = BK + kPad;
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

// The bf16 body: mma.sync on the tensor cores, one warp a 16-row slice of
// the query tile.
template <int DH, int BQ, int BK>
__device__ __forceinline__ void attn_fwd_mma(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ out,
                                             float* __restrict__ lse, int N, float scale,
                                             unsigned char* smem) {
  constexpr int THREADS = BQ / 16 * 32;
  constexpr int LD = DH + 8;    // bf16 a shared row
  constexpr int NT = BK / 8;    // n8 tiles of keys in S
  constexpr int DT = DH / 8;    // n8 tiles of channels in O
  constexpr int KD = DH / 16;   // k16 steps over the channels
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DH % 16 == 0, "tiles of 16");
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                             // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                         // [2][BK][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const LaneOffsets at(lane);
  const int q0 = blockIdx.x * BQ;
  const int64_t head_off = static_cast<int64_t>(blockIdx.y) * N * DH;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  const int tiles = (N + BK - 1) / BK;

  cp_rows<BQ, DH, THREADS>(Qs, qh, q0, N);
  cp_rows<BK, DH, THREADS>(Ks, kh, 0, N);
  cp_rows<BK, DH, THREADS>(Vs, vh, 0, N);
  cp_async_commit();

  const float scale2 = scale * kLog2e;  // scores in log2 units
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp's slice
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums
  uint32_t qf[KD][4];

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      cp_rows<BK, DH, THREADS>(Ks + (buf ^ 1) * BK * LD, kh, (t + 1) * BK, N);
      cp_rows<BK, DH, THREADS>(Vs + (buf ^ 1) * BK * LD, vh, (t + 1) * BK, N);
      cp_async_commit();
      cp_async_wait<1>();  // tile t (and Q) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], Qs + (warp * 16 + at.a_row) * LD + kd * 16 + at.a_col);
    }
    const __nv_bfloat16* Kt = Ks + buf * BK * LD;
    const __nv_bfloat16* Vt = Vs + buf * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (jp * 16 + at.b_row) * LD + kd * 16 + at.b_col);
        mma_bf16(s[2 * jp], qf[kd], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kd], b[2], b[3]);
      }

    // C element e of n8 tile j: row g + 8 (e / 2), key t BK + 8 j + 2 tig + e % 2
    const int k0 = t * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = k0 + j * 8 + tig * 2 + (e & 1) < N ? s[j][e] * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // every tile holds at least one key < N, so the new max is finite
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kk * 16 + at.t_row) * LD + dp * 16 + at.t_col);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

  __nv_bfloat16* oh = out + head_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= N) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<int64_t>(row) * DH + j * 8 + tig * 2) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (lse != nullptr && tig == 0)
      lse[static_cast<int64_t>(blockIdx.y) * N + row] = (m[r] + log2f(l[r])) * kLn2;
  }
}

template <int DH, int BQ, int BK, typename T>
__global__ void __launch_bounds__(fwd_threads<BQ, T>())
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ lse, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  if constexpr (is_f32<T>())
    attn_fwd_fma<DH, BQ, BK, T>(q, k, v, out, lse, N, scale, reinterpret_cast<float*>(smem_bytes));
  else
    attn_fwd_mma<DH, BQ, BK>(q, k, v, out, lse, N, scale, smem_bytes);
}

template <int DH, int BQ, int BK, typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int BH, int N,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DH, BQ, BK, T>();
  if constexpr (smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<DH, BQ, BK, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + BQ - 1) / BQ, BH);
    attn_fwd_kernel<DH, BQ, BK, T><<<grid, fwd_threads<BQ, T>(), smem, stream>>>(
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

// Multi-scale deformable attention forward: exact bilinear gather.
//
// Replaces the TPU kernel ape_tpu/ops/msda_window_pallas_v2.py
// (ms_deform_attn_window_pallas_v2 -> _run_pair_v2 -> _pair_kernel_v2), the
// encoder's window-clamped MSDA, and serves the decoder's exact MSDA
// (ape_tpu/ops/msda_decoder.py, an XLA gather in JAX) as well. The TPU kernel
// exists because the TPU has no gather unit: it pre-shifts value planes and
// turns the clamped window into dense shift-and-FMA work. Hopper gathers
// natively, so this is a plain gather in the style of the reference CUDA op;
// the window clamp is done by the caller on the locations it passes in.
//
//   out[b, q, h*D + d] = sum_{l, p} att[b,q,h,l,p] *
//                        bilinear0(value[b, start_l + ., h, d], loc[b,q,h,l,p])
//
// with pixel = loc * size - 0.5 (align_corners=False) and zero padding.
//
// What bounds it on an H100: each sample reads four scattered corner rows of
// D values (64 bytes at D = 32 in bf16), so the kernel is bound by memory
// latency and L2 traffic, not by arithmetic (about 8 flops per byte read).
// The design: one warp per (b, q, h) with the lanes over D, so every corner
// read is one coalesced row of the (B, S, H, D) value tensor; the value
// tensor of APE (11 MB in bf16) stays resident in the 50 MB L2 across the
// queries of a launch. Weights and locations are read once per sample as a
// warp-wide broadcast. Accumulation is in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxLevels = 16;

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

template <typename VT, typename AT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const VT* __restrict__ value,        // (B, S, H, D)
                const float* __restrict__ loc,       // (B, Q, H, L, P, 2)
                const AT* __restrict__ att,          // (B, Q, H, L, P)
                const int64_t* __restrict__ shapes,  // (L, 2) as (H_l, W_l)
                const int64_t* __restrict__ starts,  // (L,)
                VT* __restrict__ out,                // (B, Q, H * D)
                int B, int S, int Q, int H, int D, int L, int P) {
  __shared__ int s_h[kMaxLevels];
  __shared__ int s_w[kMaxLevels];
  __shared__ int s_start[kMaxLevels];
  if (threadIdx.x < L) {
    s_h[threadIdx.x] = static_cast<int>(shapes[2 * threadIdx.x]);
    s_w[threadIdx.x] = static_cast<int>(shapes[2 * threadIdx.x + 1]);
    s_start[threadIdx.x] = static_cast<int>(starts[threadIdx.x]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  if (item >= n_items) return;
  const int h = static_cast<int>(item % H);
  const int64_t bq = item / H;               // b * Q + q
  const int b = static_cast<int>(bq / Q);

  const int64_t samp0 = item * L * P;         // first (l, p) sample of this (b, q, h)
  const VT* vb = value + static_cast<int64_t>(b) * S * H * D + static_cast<int64_t>(h) * D;
  const int64_t row_stride = static_cast<int64_t>(H) * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int hl = s_h[l];
      const int wl = s_w[l];
      const VT* vl = vb + static_cast<int64_t>(s_start[l]) * row_stride;
      for (int p = 0; p < P; ++p) {
        const int64_t s = samp0 + l * P + p;
        const float a = to_f32(att[s]);
        // rounded as torch rounds loc * size - 0.5 (no FMA contraction): floor()
        // then picks the same corners at integer pixels, where d_loc is one-sided
        const float x = __fsub_rn(__fmul_rn(loc[2 * s], static_cast<float>(wl)), 0.5f);
        const float y = __fsub_rn(__fmul_rn(loc[2 * s + 1], static_cast<float>(hl)), 0.5f);
        // also false for NaN: such a sample contributes nothing
        if (!(x > -1.f && y > -1.f && x < wl && y < hl)) continue;
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const float fx = x - xf;
        const float fy = y - yf;
        if (!active) continue;
        float v = 0.f;
        if (y0 >= 0) {
          if (x0 >= 0) v += (1.f - fx) * (1.f - fy) * to_f32(vl[(static_cast<int64_t>(y0) * wl + x0) * row_stride + d]);
          if (x0 + 1 < wl) v += fx * (1.f - fy) * to_f32(vl[(static_cast<int64_t>(y0) * wl + x0 + 1) * row_stride + d]);
        }
        if (y0 + 1 < hl) {
          if (x0 >= 0) v += (1.f - fx) * fy * to_f32(vl[(static_cast<int64_t>(y0 + 1) * wl + x0) * row_stride + d]);
          if (x0 + 1 < wl) v += fx * fy * to_f32(vl[(static_cast<int64_t>(y0 + 1) * wl + x0 + 1) * row_stride + d]);
        }
        acc += a * v;
      }
    }
    if (active) out[item * D + d] = from_f32<VT>(acc);
  }
}

template <typename VT, typename AT>
int launch(const void* value, const float* loc, const void* att, const int64_t* shapes,
           const int64_t* starts, void* out, int B, int S, int Q, int H, int D, int L,
           int P, cudaStream_t stream) {
  const int64_t n_items = static_cast<int64_t>(B) * Q * H;
  const int64_t blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  msda_fwd_kernel<VT, AT><<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const VT*>(value), loc, static_cast<const AT*>(att), shapes, starts,
      static_cast<VT*>(out), B, S, Q, H, D, L, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value_bf16: value and out are bf16 (else f32). att_f32: attention weights
// are f32 (else the value dtype). Returns the launch's cudaError_t.
extern "C" int ape_msda_fwd(const void* value, const float* loc, const void* att,
                            const int64_t* shapes, const int64_t* starts, void* out,
                            int B, int S, int Q, int H, int D, int L, int P,
                            int value_bf16, int att_f32, void* stream) {
  if (L > kMaxLevels || L < 1 || P < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_bf16) {
    if (att_f32)
      return launch<__nv_bfloat16, float>(value, loc, att, shapes, starts, out, B, S, Q, H, D, L, P, st);
    return launch<__nv_bfloat16, __nv_bfloat16>(value, loc, att, shapes, starts, out, B, S, Q, H, D, L, P, st);
  }
  return launch<float, float>(value, loc, att, shapes, starts, out, B, S, Q, H, D, L, P, st);
}

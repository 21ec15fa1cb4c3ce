// Shared by the attention kernels' CUDA-core code: float loads, stores in
// the storage type (float or bf16, sums always in float), warp reductions
// and the online-softmax step.
#pragma once
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace raven_attention {

constexpr int D_MAX = 128;  // the largest head dim the kernels take
constexpr float NEG_INF = -INFINITY;

// Eight consecutive elements from 16-byte aligned storage, as floats.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Four consecutive floats to 8-byte (bf16) or 16-byte (float) aligned
// storage, rounded to nearest.
__device__ __forceinline__ void store4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* x) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                         __floats2bfloat162_rn(x[2], x[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// Eight floats into shared memory (16-byte aligned), scaled.
__device__ __forceinline__ void put8(float* s, const float (&x)[8], float scale) {
  *reinterpret_cast<float4*>(s) =
      make_float4(x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  *reinterpret_cast<float4*>(s + 4) =
      make_float4(x[4] * scale, x[5] * scale, x[6] * scale, x[7] * scale);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One online-softmax step for a row whose new scores are `x` (masked
// entries are -inf): returns p = exp(x - m_new) (0 where masked) and sets
// the rescale factor alpha = exp(m_prev - m_new) and the new max. A row with
// no valid score yet keeps m = -inf, p = 0 and alpha = 1.
__device__ __forceinline__ float online_softmax(float x, float m_prev, float row_max,
                                                float* m_new, float* alpha) {
  const float m = fmaxf(m_prev, row_max);
  *m_new = m;
  if (m == NEG_INF) {
    *alpha = 1.0f;
    return 0.0f;
  }
  *alpha = expf(m_prev - m);
  return x == NEG_INF ? 0.0f : expf(x - m);
}

}  // namespace raven_attention

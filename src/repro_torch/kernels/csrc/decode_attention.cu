// decode_attention: one query token per sequence over a (B, S, KH, D) K/V
// cache, masked by per-sequence lengths.
//
// Replaces the Pallas kernel `decode_attention` of
// src/repro/kernels/decode_attention.py:60 (pallas_call at line 79), reached
// from an LM's decode step through models/layers.py `attention_decode`.
//
// Bound on an H100: bytes. The valid K/V rows are read once and each feeds
// 2 * G * D multiply-adds; at the serving path's decode (B = 16 slots,
// lengths 513..576, KH = 8, D = 128, bf16) that is about 36 MB a layer and
// tick, 11 us at 3.35 TB/s.
//
// Design: as on the TPU, one block owns one (batch, KV head) and all G query
// heads that read that KV head, so each K/V row is read once; the TPU's
// sequential KV grid axis becomes a loop over tiles of BK rows, staged in
// shared memory as floats. The loop stops at lengths[b]: rows past the length
// are never read and contribute nothing. Scores: one thread a (head, key)
// pair. Online softmax in f32, one warp a head. p . V: G * D / 8 groups of
// eight output columns, and the block's remaining threads split the tile's
// keys among them (KP partial sums a column, folded in a fixed order at the
// end), so every thread works at any G. Nothing is written past the end;
// lengths must lie in [1, S] (the wrapper checks). Simple first: no
// double-buffering of the tiles yet, and B * KH blocks (128 on the serving
// path) leave few loads in flight on each SM.
#include "attention.cuh"

namespace {

using namespace raven_attention;

constexpr int G_MAX = 16;   // query heads a KV head serves
constexpr int BK = 64;      // key rows of a K/V tile
constexpr int THREADS = 256;
constexpr int QS = D_MAX + 4;  // 16-byte aligned rows; 8 neighbouring float4
constexpr int KS = D_MAX + 4;  //   reads cover all 32 banks
constexpr int PS = BK + 4;
constexpr int SMEM_FLOATS = G_MAX * QS + BK * KS + BK * D_MAX + G_MAX * PS + 3 * G_MAX;
constexpr int SMEM_BYTES = SMEM_FLOATS * static_cast<int>(sizeof(float));

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int S, int H, int KH, int D,
                        float scale) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // G_MAX x QS, q * scale
  float* sK = sQ + G_MAX * QS;                  // BK x KS
  float* sV = sK + BK * KS;                     // BK x D_MAX
  float* sP = sV + BK * D_MAX;                  // G_MAX x PS, scores then p
  float* sM = sP + G_MAX * PS;
  float* sL = sM + G_MAX;
  float* sA = sL + G_MAX;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const int len = min(lengths[b], S);
  const long long kv_step = static_cast<long long>(KH) * D;
  const T* kb = k + static_cast<long long>(b) * S * kv_step + static_cast<long long>(kh) * D;
  const T* vb = v + static_cast<long long>(b) * S * kv_step + static_cast<long long>(kh) * D;
  const long long q_off = (static_cast<long long>(b) * H + static_cast<long long>(kh) * G) * D;
  const int n8 = D / 8;

  // p . V work split: output group o (head o / n8, columns (o % n8) * 8 + e)
  // for key part kp of KP
  const int n_out = G * n8;
  const int KP = max(1, THREADS / n_out);
  const int kp = tid / n_out, o = tid % n_out;
  const bool pv_thread = kp < KP;
  const int pg = o / n8, pc = (o % n8) * 8;

  for (int i = tid; i < G_MAX * QS; i += THREADS) sQ[i] = 0.0f;
  if (tid < G_MAX) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < G * n8; i += THREADS) {
    const int g = i / n8, c = (i % n8) * 8;
    float x[8];
    load8(q + q_off + static_cast<long long>(g) * D + c, x);
    put8(sQ + g * QS + c, x, scale);
  }

  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int kv0 = 0; kv0 < len; kv0 += BK) {
    __syncthreads();  // the last tile's readers are done
    const int rows = min(BK, len - kv0);
    for (int i = tid; i < BK * n8; i += THREADS) {
      const int r = i / n8, c = (i % n8) * 8;
      float xk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (r < rows) {
        load8(kb + (kv0 + r) * kv_step + c, xk);
        load8(vb + (kv0 + r) * kv_step + c, xv);
      }
      put8(sK + r * KS + c, xk, 1.0f);
      put8(sV + r * D_MAX + c, xv, 1.0f);
    }
    __syncthreads();

    // scores: thread (g, key) for g = tid / BK + 4 m
    {
      const int c = tid % BK;
      for (int g = tid / BK; g < G; g += THREADS / BK) {
        float a = 0.0f;
        for (int d = 0; d < D; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(sQ + g * QS + d);
          const float4 kv = *reinterpret_cast<const float4*>(sK + c * KS + d);
          a = fmaf(qv.x, kv.x, a);
          a = fmaf(qv.y, kv.y, a);
          a = fmaf(qv.z, kv.z, a);
          a = fmaf(qv.w, kv.w, a);
        }
        sP[g * PS + c] = c < rows ? a : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp a head, two keys a lane
    for (int g = warp; g < G; g += THREADS / 32) {
      const float x0 = sP[g * PS + lane], x1 = sP[g * PS + 32 + lane];
      const float row_max = warp_max(fmaxf(x0, x1));
      float m_new, alpha;
      const float p0 = online_softmax(x0, sM[g], row_max, &m_new, &alpha);
      const float p1 = online_softmax(x1, sM[g], row_max, &m_new, &alpha);
      const float sum = warp_sum(p0 + p1);
      sP[g * PS + lane] = p0;
      sP[g * PS + 32 + lane] = p1;
      if (lane == 0) {
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    if (pv_thread) {
      const float a = sA[pg];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= a;
      for (int r = kp; r < rows; r += KP) {
        const float p = sP[pg * PS + r];
        const float4 v0 = *reinterpret_cast<const float4*>(sV + r * D_MAX + pc);
        const float4 v1 = *reinterpret_cast<const float4*>(sV + r * D_MAX + pc + 4);
        acc[0] = fmaf(p, v0.x, acc[0]);
        acc[1] = fmaf(p, v0.y, acc[1]);
        acc[2] = fmaf(p, v0.z, acc[2]);
        acc[3] = fmaf(p, v0.w, acc[3]);
        acc[4] = fmaf(p, v1.x, acc[4]);
        acc[5] = fmaf(p, v1.y, acc[5]);
        acc[6] = fmaf(p, v1.z, acc[6]);
        acc[7] = fmaf(p, v1.w, acc[7]);
      }
    }
  }

  // fold the KP partial sums of each output group in part order; the K tile
  // is free now and holds the partials
  __syncthreads();
  float* red = sK;  // KP * n_out * 8 <= THREADS * 8 floats
  if (pv_thread) put8(red + (kp * n_out + o) * 8, acc, 1.0f);
  __syncthreads();
  if (kp == 0) {
    float tot[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tot[e] = red[o * 8 + e];
    for (int part = 1; part < KP; ++part)
#pragma unroll
      for (int e = 0; e < 8; ++e) tot[e] += red[(part * n_out + o) * 8 + e];
    const float l = fmaxf(sL[pg], 1e-30f);
#pragma unroll
    for (int e = 0; e < 8; ++e) tot[e] /= l;
    T* orow = out + q_off + static_cast<long long>(pg) * D + pc;
    store4(orow, tot);
    store4(orow + 4, tot + 4);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int B, int S, int H, int KH, int D, float scale, cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  decode_attention_kernel<T><<<dim3(KH, B), THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), S, H, KH, D, scale);
  RAVEN_RETURN_LAUNCH_STATUS();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q, out: (B, H, D); k, v: (B, S, KH, D);
// lengths: (B,) int32 in [1, S]; contiguous, 16-byte aligned; D % 8 == 0,
// D <= 128, H % KH == 0, H / KH <= 16.
extern "C" int raven_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, int dtype, int B,
                                      int S, int H, int KH, int D, float scale,
                                      void* stream) {
  cudaStream_t st = RAVEN_STREAM(stream);
  if (dtype == 0) return launch<float>(q, k, v, lengths, out, B, S, H, KH, D, scale, st);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, H, KH, D, scale, st);
}

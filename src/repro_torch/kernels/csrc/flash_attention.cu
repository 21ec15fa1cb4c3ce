// flash_attention for float32: online-softmax attention with GQA, a causal
// mask offset by Skv - Sq and an optional sliding window, on CUDA cores.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py:63 (pallas_call at line 83) for
// float32 inputs; bfloat16, the LM prefill's type, takes the tensor-core
// kernel of flash_attention_wgmma.cu. The tensor cores run float32 only as
// TF32 (10 mantissa bits), which would break the 2e-5 parity of float32
// attention with its plain version, so float32 stays on CUDA-core FMAs.
//
// Bound on an H100: at a prefill of B = 16, Sq = Skv = 512, H = 32, KH = 8,
// D = 128 the causal half of the two contractions is about 3.4e10
// operations, 0.51 ms at the 67 TFLOP/s of f32 FMAs outside the tensor
// cores, against 0.1 ms for reading q, k, v and writing the output once
// (336 MB at 3.35 TB/s): operations.
//
// Design: on the TPU the grid walks the K/V blocks in order and the running
// max, normaliser and accumulator stay in VMEM across grid steps. Here one
// block owns BQ query rows of one (batch, head) and loops over K/V tiles of
// BK rows itself, staged in shared memory; the running max and normaliser
// sit in shared memory, the accumulator in registers, all in f32. The query
// tile is read once and each K/V tile once per block, so K/V are read
// Sq / BQ times per head and G times per KV head. Tiles wholly above the
// causal diagonal are skipped; ragged Sq and Skv are masked (rows past Sq
// are not written, keys past Skv get no weight). A sliding window (query i
// keeps key j only if j > i + Skv - Sq - window; 0 is none) starts the K/V
// loop at the first tile the block's first row reaches and masks the keys
// below each row's window. Query head h reads KV head h / G. Head dims up
// to 128 that are a multiple of 8 are taken.
#include "attention.cuh"

namespace {

using namespace raven_attention;

constexpr int BQ = 64;              // query rows of a block
constexpr int BK = 32;              // key rows of a K/V tile (one per lane)
constexpr int THREADS = 256;        // a 16 x 16 grid of threads
constexpr int QS = D_MAX + 4;       // row strides in floats: 16-byte aligned,
constexpr int KS = D_MAX + 4;       //   and 8 neighbouring float4 reads cover
constexpr int PS = BK + 4;          //   all 32 banks
constexpr int SMEM_FLOATS = BQ * QS + BK * KS + BK * D_MAX + BQ * PS + 3 * BQ;
constexpr int SMEM_BYTES = SMEM_FLOATS * static_cast<int>(sizeof(float));

using T = float;

// WINDOW is a template parameter: a call without a window compiles to a
// loop with no window tests in it.
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int KH, int D, float scale, int causal,
                       int window) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // BQ x QS, q * scale
  float* sK = sQ + BQ * QS;                     // BK x KS
  float* sV = sK + BK * KS;                      // BK x D_MAX
  float* sP = sV + BK * D_MAX;                   // BQ x PS, scores then p
  float* sM = sP + BQ * PS;                      // running max
  float* sL = sM + BQ;                           // running normaliser
  float* sA = sL + BQ;                           // this tile's rescale

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int off = Skv - Sq;
  const long long q_step = static_cast<long long>(H) * D;  // one position
  const long long kv_step = static_cast<long long>(KH) * D;
  const T* qb = q + static_cast<long long>(b) * Sq * q_step + static_cast<long long>(h) * D;
  T* ob = out + static_cast<long long>(b) * Sq * q_step + static_cast<long long>(h) * D;
  const T* kb = k + static_cast<long long>(b) * Skv * kv_step + static_cast<long long>(kh) * D;
  const T* vb = v + static_cast<long long>(b) * Skv * kv_step + static_cast<long long>(kh) * D;
  const int n8 = D / 8;

  // head-dim columns past D stay zero: the loads below never write them
  for (int i = tid; i < BQ * QS + BK * KS + BK * D_MAX; i += THREADS) sQ[i] = 0.0f;
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.0f;
  }
  __syncthreads();
  for (int i = tid; i < BQ * n8; i += THREADS) {
    const int r = i / n8, c = (i % n8) * 8;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < Sq) load8(qb + (q0 + r) * q_step + c, x);
    put8(sQ + r * QS + c, x, scale);
  }

  int kv_end = Skv;
  if (causal) {
    const int q_last = min(q0 + BQ, Sq) - 1;
    kv_end = min(Skv, q_last + off + 1);
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;

  const int kv_begin = WINDOW ? max(0, q0 + off - window + 1) / BK * BK : 0;
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < BK * n8; i += THREADS) {
      const int r = i / n8, c = (i % n8) * 8;
      float xk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (kv0 + r < Skv) {
        load8(kb + (kv0 + r) * kv_step + c, xk);
        load8(vb + (kv0 + r) * kv_step + c, xv);
      }
      put8(sK + r * KS + c, xk, 1.0f);
      put8(sV + r * D_MAX + c, xv, 1.0f);
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kp = kv0 + c;
        const bool ok = kp < Skv && (!causal || q0 + r + off >= kp) &&
                        (!WINDOW || kp > q0 + r + off - window);
        sP[r * PS + c] = ok ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax, one warp a row, one lane a key
    for (int r = warp; r < BQ; r += THREADS / 32) {
      const float x = sP[r * PS + lane];
      float m_new, alpha;
      const float p = online_softmax(x, sM[r], warp_max(x), &m_new, &alpha);
      const float sum = warp_sum(p);
      sP[r * PS + lane] = p;
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V over rows ty + 16 i, head-dim columns
    // tx * 4 + e and 64 + tx * 4 + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[ty + 16 * i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= a;
    }
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = sV + (kk + t) * D_MAX;
        const float4 v0 = *reinterpret_cast<const float4*>(vr + tx * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y : t == 2 ? pv[i].z : pv[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(sL[r], 1e-30f);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = acc[i][e] / l;
    T* orow = ob + (q0 + r) * q_step;
    if (tx * 4 < D) store4(orow + tx * 4, o);
    if (64 + tx * 4 < D) store4(orow + 64 + tx * 4, o + 4);
  }
}

}  // namespace

// q, out: (B, Sq, H, D) float32; k, v: (B, Skv, KH, D) float32; contiguous,
// 16-byte aligned; D % 8 == 0, D <= 128, H % KH == 0; window >= 0 (0: none).
extern "C" int raven_flash_attention_f32(const void* q, const void* k, const void* v,
                                         void* out, int B, int Sq, int Skv, int H, int KH,
                                         int D, float scale, int causal, int window,
                                         void* stream) {
  static unsigned long long done[2] = {0, 0};
  auto* kernel = window > 0 ? flash_attention_kernel<true> : flash_attention_kernel<false>;
  const cudaError_t attr = raven_smem_limit(kernel, SMEM_BYTES, &done[window > 0]);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, SMEM_BYTES, RAVEN_STREAM(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KH, D, scale, causal, window);
  RAVEN_RETURN_LAUNCH_STATUS();
}

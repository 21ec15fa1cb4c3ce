// decode_attention: one query token per sequence over a (B, S, KH, D) K/V
// cache, masked by per-sequence lengths, as a split-KV kernel.
//
// Replaces the Pallas kernel `decode_attention` of
// src/repro/kernels/decode_attention.py:60 (pallas_call at line 79),
// reached from an LM's decode step through models/layers.py
// `attention_decode`.
//
// Bound on an H100: bytes. The valid K/V rows are read once and each feeds
// 2 * G * D multiply-adds, 4 operations a byte in bf16; at the serving
// path's decode (B = 16 slots, lengths 513..576, KH = 8, D = 128, bf16)
// that is about 36 MB a layer and tick, 11 us at 3.35 TB/s.
//
// Design: split-KV, two passes, both launched by the one C entry point.
//   Pass 1, grid (KV head, batch, split): a block takes one chunk of the
//   sequence (`chunk` rows) and all G query heads of its KV head, so each
//   K/V row is read once. It streams the chunk through a ring of two
//   shared-memory stages filled by cp.async, the next tile in flight while
//   the current one is computed, K/V kept in the storage type. It writes
//   unnormalised partials (m, l, acc[G][D]) in f32 to the caller's scratch.
//   A chunk that starts at or past lengths[b] writes m = -inf, l = 0 and
//   returns; rows past the length are never read (a tile's rows past them
//   are zero-filled by cp.async without a read).
//     bf16: tiles of 64 keys, 16 a warp, on the tensor cores: a warp's
//     scores are mma.sync m16n8k16 with the G heads as rows (zero past G),
//     K fed by ldmatrix from rows padded to spread the banks; P, rounded to
//     bf16, is the A operand of P.V (V by ldmatrix.trans). Each warp keeps
//     its own online softmax (exp2, log2(e) folded into the scale) and
//     16 x D accumulator, and the four are merged in warp order. On CUDA
//     cores the loop was bound by the instructions it issued (each K and V
//     element read, converted and multiplied G times), not by the bytes.
//     float32: tiles of 32 rows on CUDA cores (the tensor cores would take
//     f32 as TF32 and break its 2e-5 parity): one thread a (head, key) for
//     the scores, one warp a head for the online softmax, and G * D / 8
//     groups of eight output columns for p.V, the block's other threads
//     splitting the tile's keys among them (folded in a fixed order).
//   Pass 2, grid (KV head, batch): folds the partials in split order
//   (rescale by exp2(m_s - m), sum, divide by l) and writes q's type. No
//   atomics: results repeat bit for bit.
// Splits are the slowest grid axis, so the first chunks of every sequence
// are dispatched first and the empty ones (which exit at once) last. The
// chunk count depends on S and B * KH only (the wrapper's
// `decode_splits`), never on the lengths, which the host does not read.
// Lengths must lie in [1, S] (the wrapper checks).
#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace raven_attention;
using raven_hopper::cp_async16;
using raven_hopper::cp_async_commit;
using raven_hopper::cp_async_wait;
using raven_hopper::smem_addr;

constexpr int G_MAX = 16;  // query heads a KV head serves
constexpr int THREADS = 128;

// ---------------------------------------------------------------------------
// Pass 1 for float32 on CUDA cores.
// ---------------------------------------------------------------------------

constexpr int BK = 32;     // key rows of a K/V tile (one a lane in the softmax)
constexpr int STAGES = 2;
constexpr int QS = D_MAX + 4;  // float row stride of q: 16-byte aligned
constexpr int PS = BK + 1;

// Shared-memory sizes in bytes. A row of a K or V tile is padded by 16
// bytes so that eight neighbouring rows read at one column fall in eight
// bank groups.
constexpr int ROW = D_MAX * 4 + 16;
constexpr int TILE = BK * ROW;
// the K/V ring, then G rows of q, G rows of scores and 3 G floats of softmax
// state: sized by the call's G, so more blocks fit an SM
constexpr int smem_bytes(int G) { return STAGES * 2 * TILE + 4 * G * (QS + PS + 3); }

// Items of the p.V split: output group o (head o / n8, columns (o % n8) * 8)
// and key part kp; at most two items a thread (G = 16, D = 128).
constexpr int ITEMS = G_MAX * (D_MAX / 8) / THREADS;

// q . row over D columns, in four independent sums (a shorter chain of
// dependent FMAs), added in a fixed order.
__device__ __forceinline__ float dot_row(const float* sq, const float* row, int D) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int d = 0; d < D; d += 8) {
    float x[8];
    load8(row + d, x);
    const float4 q0 = *reinterpret_cast<const float4*>(sq + d);
    const float4 q1 = *reinterpret_cast<const float4*>(sq + d + 4);
    a[0] = fmaf(q0.x, x[0], a[0]);
    a[1] = fmaf(q0.y, x[1], a[1]);
    a[2] = fmaf(q0.z, x[2], a[2]);
    a[3] = fmaf(q0.w, x[3], a[3]);
    a[0] = fmaf(q1.x, x[4], a[0]);
    a[1] = fmaf(q1.y, x[5], a[1]);
    a[2] = fmaf(q1.z, x[6], a[2]);
    a[3] = fmaf(q1.w, x[7], a[3]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int S, int H,
                    int KH, int D, float scale_log2, int chunk) {
  extern __shared__ float4 smem4[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem4);  // STAGES x (K tile, V tile)
  const int G = H / KH;
  float* sQ = reinterpret_cast<float*>(stages + STAGES * 2 * TILE);  // G x QS
  float* sP = sQ + G * QS;  // G x PS: scores, then p
  float* sM = sP + G * PS;  // running max (log2 units)
  float* sL = sM + G;       // running normaliser
  float* sA = sL + G;       // this tile's rescale

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const long long part = (static_cast<long long>(b) * KH + kh) * n_split + split;
  float* ml = part_ml + part * G * 2;
  const int len = min(lengths[b], S);
  const int start = split * chunk;
  if (start >= len) {  // an empty chunk: no weight in pass 2
    if (tid < G) {
      ml[2 * tid] = NEG_INF;
      ml[2 * tid + 1] = 0.0f;
    }
    return;
  }
  const int rows = min(len - start, chunk);
  const int n_tiles = (rows + BK - 1) / BK;
  const long long kv_step = static_cast<long long>(KH) * D;
  const float* kb = k + (static_cast<long long>(b) * S + start) * kv_step +
                static_cast<long long>(kh) * D;
  const float* vb = v + (static_cast<long long>(b) * S + start) * kv_step +
                static_cast<long long>(kh) * D;
  const int per_row = D * static_cast<int>(sizeof(float)) / 16;  // 16-byte copies a row

  auto load_tile = [&](int j) {
    uint8_t* dst = stages + (j % STAGES) * 2 * TILE;
    const int n = min(BK, rows - j * BK);
    for (int i = tid; i < 2 * n * per_row; i += THREADS) {
      const int which = i / (n * per_row), rem = i % (n * per_row);
      const int r = rem / per_row, c = rem % per_row;
      const float* src = (which ? vb : kb) + (static_cast<long long>(j) * BK + r) * kv_step;
      cp_async16(smem_addr(dst + which * TILE + r * ROW + c * 16),
                 reinterpret_cast<const uint8_t*>(src) + c * 16, 16);
    }
  };
  for (int t = 0; t < STAGES - 1; ++t) {  // the first tiles in flight at once
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  const long long q_off = (static_cast<long long>(b) * H + static_cast<long long>(kh) * G) * D;
  const int n8 = D / 8;
  for (int i = tid; i < G * n8; i += THREADS) {
    const int g = i / n8, c = (i % n8) * 8;
    float x[8];
    load8(q + q_off + static_cast<long long>(g) * D + c, x);
    put8(sQ + g * QS + c, x, scale_log2);
  }
  if (tid < G) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.0f;
  }

  const int n_out = G * n8;
  const int KP = max(1, THREADS / n_out);
  float acc[ITEMS][8];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[it][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile j is in, for every thread (and sQ, sM, sL)
    const uint8_t* tile = stages + (j % STAGES) * 2 * TILE;
    const int n = min(BK, rows - j * BK);

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, c = i % BK;
      sP[g * PS + c] = c < n ? dot_row(sQ + g * QS,
                                       reinterpret_cast<const float*>(tile + c * ROW), D)
                             : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      const float x = sP[g * PS + lane];
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(x));  // finite: key 0 of the tile is valid
      const float alpha = exp2f(m_prev - m_new);
      const float p = exp2f(x - m_new);
      const float sum = warp_sum(p);
      sP[g * PS + lane] = p;
      if (lane == 0) {
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    const float* vt = reinterpret_cast<const float*>(tile + TILE);
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int item = tid + it * THREADS;
      if (item >= n_out * KP) break;
      const int o = item % n_out, kp = item / n_out;
      const int g = o / n8, col = (o % n8) * 8;
      const float a = sA[g];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[it][e] *= a;
      for (int r = kp; r < n; r += KP) {
        const float p = sP[g * PS + r];
        float x[8];
        load8(reinterpret_cast<const float*>(reinterpret_cast<const uint8_t*>(vt) +
                                         r * ROW) + col, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[it][e] = fmaf(p, x[e], acc[it][e]);
      }
    }
    __syncthreads();  // every reader is done with this stage, sP and sA
  }

  // fold the KP key parts of each output group in part order, through the
  // (now free) first stage, and write the unnormalised partials
  float* red = reinterpret_cast<float*>(stages);  // n_out * KP * 8 floats
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int item = tid + it * THREADS;
    if (item < n_out * KP) put8(red + item * 8, acc[it], 1.0f);
  }
  __syncthreads();
  float* po = part_o + part * G * D;
  for (int o = tid; o < n_out; o += THREADS) {
    float tot[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tot[e] = red[o * 8 + e];
    for (int kp = 1; kp < KP; ++kp)
#pragma unroll
      for (int e = 0; e < 8; ++e) tot[e] += red[(kp * n_out + o) * 8 + e];
    const int g = o / n8, col = (o % n8) * 8;
    store4(po + g * D + col, tot);
    store4(po + g * D + col + 4, tot + 4);
  }
  if (tid < G) {
    ml[2 * tid] = sM[tid];
    ml[2 * tid + 1] = sL[tid];
  }
}

// ---------------------------------------------------------------------------
// Pass 1 for bf16 on the tensor cores. A block's four warps take 16 keys
// each of a 64-key tile; a warp's 16 x 16 scores are one mma.sync
// m16n8k16 product per 16 columns of D and 8 keys, with the G query heads
// as the 16 rows (rows past G are zero), and its P.V is 16 mma.sync over
// D with P kept in registers. Each warp keeps its own online softmax and
// 16 x D accumulator; the four are merged in warp order at the end.
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;              // keys of a tile: 16 a warp
constexpr int TC_ROW = D_MAX * 2 + 16;  // bytes of a bf16 row, padded: ldmatrix's
                                        //   eight rows fall in eight bank groups
constexpr int TC_TILE = TC_BK * TC_ROW;
constexpr int TC_STAGES = 2;
constexpr int TC_SMEM = TC_STAGES * 2 * TC_TILE;  // the merge reuses the ring

__global__ void __launch_bounds__(THREADS)
decode_split_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ part_o, float* __restrict__ part_ml, int S, int H,
                       int KH, int D, float scale_log2, int chunk) {
  using raven_hopper::ldmatrix_x4;
  using raven_hopper::ldmatrix_x4_trans;
  using raven_hopper::mma_m16n8k16;
  using raven_hopper::pack_bf16;
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);  // stage s: K at 2 s TC_TILE, V after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / 4, c = lane % 4;  // mma fragment row and column pair
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = H / KH;
  const long long part = (static_cast<long long>(b) * KH + kh) * n_split + split;
  float* ml = part_ml + part * G * 2;
  const int len = min(lengths[b], S);
  const int start = split * chunk;
  if (start >= len) {  // an empty chunk: no weight in pass 2
    if (tid < G) {
      ml[2 * tid] = NEG_INF;
      ml[2 * tid + 1] = 0.0f;
    }
    return;
  }
  const int rows = min(len - start, chunk);
  const int n_tiles = (rows + TC_BK - 1) / TC_BK;
  const long long kv_step = static_cast<long long>(KH) * D;
  const __nv_bfloat16* kb =
      k + (static_cast<long long>(b) * S + start) * kv_step + static_cast<long long>(kh) * D;
  const __nv_bfloat16* vb =
      v + (static_cast<long long>(b) * S + start) * kv_step + static_cast<long long>(kh) * D;
  const int d16 = (D + 15) / 16;  // 16-column steps; columns past D are zero

  // tile j: rows past the chunk's end and columns past D zero-filled (never
  // read from global memory), so the products see zeros, not stale bytes
  auto load_tile = [&](int j) {
    uint8_t* dst = ring + (j % TC_STAGES) * 2 * TC_TILE;
    const int valid = rows - j * TC_BK;
    for (int i = tid; i < 2 * TC_BK * 2 * d16; i += THREADS) {
      const int which = i / (TC_BK * 2 * d16), rem = i % (TC_BK * 2 * d16);
      const int row = rem / (2 * d16), ch = rem % (2 * d16);
      const bool ok = row < valid && ch * 8 < D;
      const __nv_bfloat16* base = which ? vb : kb;
      const __nv_bfloat16* src =
          ok ? base + (static_cast<long long>(j) * TC_BK + row) * kv_step + ch * 8 : base;
      cp_async16(smem_addr(dst + which * TC_TILE + row * TC_ROW + ch * 16), src, ok ? 16 : 0);
    }
  };
  load_tile(0);
  cp_async_commit();

  // q as the A operand: rows are the G heads (zero past G), scale applied to S
  const __nv_bfloat16* qb =
      q + (static_cast<long long>(b) * H + static_cast<long long>(kh) * G) * D;
  uint32_t qa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e % 2), col = 16 * kk + 2 * c + 8 * (e / 2);
      qa[kk][e] = row < G && col < D ? *reinterpret_cast<const uint32_t*>(
                                           qb + static_cast<long long>(row) * D + col)
                                     : 0u;
    }

  float o[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};  // rows r and r + 8

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_tile(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j is in
    const uint32_t sK = smem_addr(ring + (j % TC_STAGES) * 2 * TC_TILE);
    const uint32_t sV = sK + TC_TILE;
    const int key0 = j * TC_BK + warp * 16;  // this warp's first key, from the chunk's start
    if (key0 < rows) {
      float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      // lane l addresses row (l % 8) of matrix l / 8: keys +0 / +8 (bit 1),
      // the low / high 8 columns of the step (bit 0)
      const int mi = lane / 8;
      const uint32_t k_row = sK + (warp * 16 + (mi / 2) * 8 + lane % 8) * TC_ROW + (mi % 2) * 16;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < d16) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_row + kk * 32);
          mma_m16n8k16(s[0], qa[kk], kf[0], kf[1]);
          mma_m16n8k16(s[1], qa[kk], kf[2], kf[3]);
        }
      }
      // scale, mask keys past the chunk, online softmax of rows r, r + 8
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * nt + 2 * c + e % 2;
          s[nt][e] = key < rows ? s[nt][e] * scale_log2 : NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
        }
      float alpha[2], mu[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        const float m_new = fmaxf(m[h2], mx[h2]);
        mu[h2] = m_new == NEG_INF ? 0.0f : m_new;
        alpha[h2] = m_new == NEG_INF ? 1.0f : exp2f(m[h2] - m_new);
        m[h2] = m_new;
        l[h2] *= alpha[h2];
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e / 2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - mu[e / 2]);
          l[e / 2] += s[nt][e];
        }
      // P (16 x 16 keys) as the A operand of P.V, rounded to bf16
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // V by ldmatrix.trans: lane l addresses key (l % 8) + 8 (bit 0 of l / 8),
      // columns 8 (2 p + bit 1 of l / 8) for the pair p of 8-column tiles
      const uint32_t v_row = sV + (warp * 16 + (mi % 2) * 8 + lane % 8) * TC_ROW + (mi / 2) * 16;
#pragma unroll
      for (int pair = 0; pair < 8; ++pair) {
        if (16 * pair < D) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_row + pair * 32);
          mma_m16n8k16(o[2 * pair], pa, vf[0], vf[1]);
          mma_m16n8k16(o[2 * pair + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // merge the warps in warp order through the (now idle) ring: warp w's
  // rows r, r + 8 of O and its (m, l)
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
  float* wo = reinterpret_cast<float*>(ring);           // 4 x 16 x D_MAX
  float* wml = wo + 4 * 16 * D_MAX;                      // 4 x 16 x (m, l)
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e / 2), col = 8 * nt + 2 * c + e % 2;
      wo[(warp * 16 + row) * D_MAX + col] = o[nt][e];
    }
  if (c == 0) {
    wml[(warp * 16 + r) * 2] = m[0];
    wml[(warp * 16 + r) * 2 + 1] = l[0];
    wml[(warp * 16 + r + 8) * 2] = m[1];
    wml[(warp * 16 + r + 8) * 2 + 1] = l[1];
  }
  __syncthreads();
  float* po = part_o + part * G * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, col = i % D;
    float M = NEG_INF;
    for (int w = 0; w < 4; ++w) M = fmaxf(M, wml[(w * 16 + g) * 2]);
    float acc = 0.0f, L = 0.0f;
    for (int w = 0; w < 4; ++w) {
      const float mw = wml[(w * 16 + g) * 2];
      if (mw == NEG_INF) continue;  // a warp that saw no key
      const float f = exp2f(mw - M);
      acc = fmaf(wo[(w * 16 + g) * D_MAX + col], f, acc);
      L = fmaf(wml[(w * 16 + g) * 2 + 1], f, L);
    }
    po[g * D + col] = acc;
    if (col == 0) {
      ml[2 * g] = M;
      ml[2 * g + 1] = L;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_fold_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   T* __restrict__ out, int H, int KH, int D, int n_split) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / KH;
  const long long part0 = (static_cast<long long>(b) * KH + kh) * n_split;
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < G * n4; i += THREADS) {
    const int g = i / n4, col = (i % n4) * 4;
    const float* ml = part_ml + (part0 * G + g) * 2;  // split s at ml + s * G * 2
    const float* po = part_o + part0 * G * D + g * D + col;  // split s at po + s * G * D
    float m = NEG_INF;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[s * G * 2]);
    float l = 0.0f, o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float l_s = ml[s * G * 2 + 1];
      if (l_s == 0.0f) continue;  // an empty chunk wrote no acc
      const float w = exp2f(ml[s * G * 2] - m);
      const float4 x = *reinterpret_cast<const float4*>(po + static_cast<long long>(s) * G * D);
      l = fmaf(l_s, w, l);
      o[0] = fmaf(x.x, w, o[0]);
      o[1] = fmaf(x.y, w, o[1]);
      o[2] = fmaf(x.z, w, o[2]);
      o[3] = fmaf(x.w, w, o[3]);
    }
    const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] *= inv;
    store4(out + (static_cast<long long>(b) * H + static_cast<long long>(kh) * G + g) * D + col,
           o);
  }
}

// Pass 1 on the CUDA cores (float32) or the tensor cores (bf16), then the
// fold; both launches on the caller's stream.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* scratch, int B, int S, int H, int KH, int D, float scale, int n_split,
           int chunk, cudaStream_t st) {
  const int G = H / KH;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + static_cast<long long>(B) * KH * n_split * G * D;
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(KH, B, n_split);
  static unsigned long long done = 0;
  if constexpr (sizeof(T) == 2) {
    const cudaError_t attr = raven_smem_limit(decode_split_tc_kernel, TC_SMEM, &done);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    decode_split_tc_kernel<<<grid, THREADS, TC_SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(lengths), part_o, part_ml, S, H, KH, D, scale_log2, chunk);
  } else {
    const cudaError_t attr =
        raven_smem_limit(decode_split_kernel, smem_bytes(G_MAX), &done);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    decode_split_kernel<<<grid, THREADS, smem_bytes(G), st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(lengths), part_o, part_ml, S, H, KH, D, scale_log2, chunk);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_fold_kernel<T><<<dim3(KH, B), THREADS, 0, st>>>(part_o, part_ml, static_cast<T*>(out),
                                                         H, KH, D, n_split);
  RAVEN_RETURN_LAUNCH_STATUS();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q, out: (B, H, D); k, v: (B, S, KH, D);
// lengths: (B,) int32 in [1, S]; contiguous, 16-byte aligned; D % 8 == 0,
// D <= 128, H % KH == 0, H / KH <= 16. scratch: B * KH * n_split * G *
// (D + 2) floats; chunk: rows of a split, n_split * chunk >= S.
extern "C" int raven_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* scratch,
                                      int dtype, int B, int S, int H, int KH, int D,
                                      float scale, int n_split, int chunk, void* stream) {
  cudaStream_t st = RAVEN_STREAM(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, out, scratch, B, S, H, KH, D, scale, n_split,
                         chunk, st);
  return launch<__nv_bfloat16>(q, k, v, lengths, out, scratch, B, S, H, KH, D, scale, n_split,
                               chunk, st);
}

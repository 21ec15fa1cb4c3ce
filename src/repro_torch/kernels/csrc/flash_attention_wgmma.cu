// flash_attention for bfloat16 on Hopper's tensor cores: online-softmax
// attention with GQA, a causal mask offset by Skv - Sq and an optional
// sliding window.
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention.py:63 (pallas_call at line 83) for
// bf16 inputs, the LM prefill's type; float32 inputs take the CUDA-core
// kernel of flash_attention.cu.
//
// Bound on an H100: at the serving path's prefill (B = 16, Sq = Skv = 512,
// H = 32, KH = 8, D = 128) reading q, k, v and writing the output once is
// 168 MB, 50 us at 3.35 TB/s, and the causal half of the two products is
// 3.4e10 operations, 35 us at the 989 TFLOP/s of bf16 tensor cores: near
// the ridge, so the kernel needs the tensor cores and one pass over q.
//
// Design (FlashAttention-3's layout, without its warp specialisation): a
// block of two warpgroups owns BM = 128 query rows of one (batch, head), 64
// rows a warpgroup, and two blocks share an SM. All 256 threads fill shared
// memory with cp.async 16-byte copies in the 128-byte swizzled layout that
// wgmma reads: the Q tile once, then K/V tiles of BN = 64 keys through a
// ring of two stages, the next tile in flight while the current one is
// computed; one barrier a tile both publishes tile j and frees tile j - 1's
// stage for tile j + 1.
//   S = Q.K^T   wgmma m64n64k16, both operands in shared memory, eight steps
//               over the 128 (zero-padded) columns;
//   softmax     online, in registers on S's f32 fragment, with exp2 and
//               log2(e) folded into the scale; each thread keeps the max and
//               its share of the normaliser for its two rows;
//   O += P.V    P rounded to bf16 in registers is wgmma's register operand A
//               (the accumulator fragment of S is the A fragment of P.V);
//               V stays as stored, key-major with D contiguous, which is
//               B MN-major: the descriptor's transpose bit takes it.
// The output tile is staged in the idle K/V ring and written as whole
// 16-byte pieces of each row. Sums stay in f32; rounding P to bf16 is the
// one rounding the CUDA-core kernel does not make. Head dims that are a
// multiple of 8 are zero-padded in shared memory to 128 columns (zeros add
// nothing to q.k, and the output columns past D are not written). The
// causal mask is applied only on tiles that cross the diagonal, ragged Sq
// and Skv on the last tiles; tiles wholly above the diagonal are not
// loaded, and a warpgroup skips a loaded tile wholly above its own rows.
// A sliding window (the reference's `_mask`: query i keeps key j only if
// j > i + Skv - Sq - window; 0 is none) is masked on the tiles that cross
// its lower edge; the K/V loop starts at the first tile the block's window
// reaches, so tiles wholly below it are neither loaded nor computed, and a
// warpgroup skips a loaded tile wholly below its own rows' windows.
// The grid runs the longest causal tiles first (query tiles in reverse
// order as the slowest grid axis), with the G query heads of one KV head in
// neighbouring blocks so their K/V re-reads hit L2.
//
// Why float32 keeps the CUDA-core kernel: the tensor cores run f32 only as
// TF32 (10 mantissa bits), which would break the 2e-5 parity of float32
// attention with its plain version and the identical greedy tokens of the
// float32 model on the card and the CPU.
#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace raven_hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // query rows of a block: two warpgroups of 64
constexpr int BN = 64;        // keys of a K/V tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;     // K/V tiles in shared memory
constexpr int ROW = 128;      // bytes of one row of a 64-column slab
constexpr int SLAB_Q = BM * ROW;
constexpr int SLAB_KV = BN * ROW;
constexpr int TILE_Q = 2 * SLAB_Q;    // 128 columns: D zero-padded
constexpr int TILE_KV = 2 * SLAB_KV;
constexpr int SMEM_BYTES = 1024 + TILE_Q + STAGES * 2 * TILE_KV;  // + alignment slack
constexpr float NEG_INF = -INFINITY;

// Copy rows [0, rows) of a tile (row r at src + r * step) into its swizzled
// slabs at dst; rows past `valid` and columns past D are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long step,
                                          int rows, int valid, int D, int tid) {
  const int slab = rows * ROW;
  for (int i = tid; i < rows * 16; i += THREADS) {
    const int r = i / 16, c = i % 16;
    const bool ok = r < valid && c * 8 < D;
    cp_async16(dst + (c / 8) * slab + sw128(r, c), ok ? src + r * step + c * 8 : src,
               ok ? 16 : 0);
  }
}

// Two blocks an SM (at most 128 registers a thread, 97 KB of shared memory
// each): one block's loads, softmax and barriers overlap the other's wgmma.
// WINDOW is a template parameter so that a call without a window compiles
// to a loop with no window tests in it (a runtime `window` read in the
// tile-skip and edge-mask tests cost the window-free path 6-10%).
template <bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                             int Skv, int H, int KH, int D, float scale_log2, int causal,
                             int window) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + TILE_Q;  // stage s: K at sKV + 2 s TILE_KV, V after it

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int kh = h / (H / KH);
  const int off = Skv - Sq;
  const long long q_step = static_cast<long long>(H) * D;  // one position
  const long long kv_step = static_cast<long long>(KH) * D;
  const bf16* qb = q + static_cast<long long>(b) * Sq * q_step + static_cast<long long>(h) * D;
  bf16* ob = out + static_cast<long long>(b) * Sq * q_step + static_cast<long long>(h) * D;
  const bf16* kb = k + static_cast<long long>(b) * Skv * kv_step + static_cast<long long>(kh) * D;
  const bf16* vb = v + static_cast<long long>(b) * Skv * kv_step + static_cast<long long>(kh) * D;

  const int wg_first = q0 + wg * 64;  // this warpgroup's first query row
  const int row0 = wg_first + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, min(q0 + BM, Sq) + off);
  const int n_tiles = (kv_end + BN - 1) / BN;
  // the first tile holding a key of the block's first row's window
  const int first_tile = WINDOW ? max(0, q0 + off - window + 1) / BN : 0;

  auto load_kv = [&](int j) {
    const uint32_t sK = sKV + (j % STAGES) * 2 * TILE_KV;
    const int kv0 = j * BN;
    load_tile(sK, kb + kv0 * kv_step, kv_step, BN, Skv - kv0, D, tid);
    load_tile(sK + TILE_KV, vb + kv0 * kv_step, kv_step, BN, Skv - kv0, D, tid);
  };
  load_tile(sQ, qb + q0 * q_step, q_step, BM, Sq - q0, D, tid);
  load_kv(first_tile);
  cp_async_commit();

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int j = first_tile; j < n_tiles; ++j) {
    cp_async_wait<0>();  // tile j (and the Q tile) have landed
    fence_async_shared();
    __syncthreads();  // for every thread; and every warpgroup is done with tile j - 1
    if (j + 1 < n_tiles) load_kv(j + 1);  // into tile j - 1's stage, while j is computed
    cp_async_commit();

    const int kv0 = j * BN;
    const uint32_t sK = sKV + (j % STAGES) * 2 * TILE_KV, sV = sK + TILE_KV;
    if ((!causal || kv0 <= wg_first + 63 + off) &&
        (!WINDOW || kv0 + BN - 1 > wg_first + off - window)) {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // all 128 columns: past D they are zero
        const uint32_t a = sQ + (kk / 4) * SLAB_Q + wg * 64 * ROW + (kk % 4) * 32;
        const uint32_t bk = sK + (kk / 4) * SLAB_KV + (kk % 4) * 32;
        wgmma_m64n64k16_ss(s, desc_sw128(a, 16, 1024), desc_sw128(bk, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
      if (kv0 + BN > Skv || (causal && kv0 + BN - 1 > wg_first + off) ||
          (WINDOW && kv0 <= wg_first + 63 + off - window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = kv0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int row = row0 + 8 * ((i / 2) % 2);
          if (col >= Skv || (causal && col > row + off) ||
              (WINDOW && col <= row + off - window))
            s[i] = NEG_INF;
        }
      }

      // online softmax over this tile, rows r = 0 (row0) and 1 (row0 + 8)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float alpha[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with no key yet keeps m = -inf: p = 0 and alpha = 1
        mu[r] = m_new == NEG_INF ? 0.0f : m_new;
        alpha[r] = m_new == NEG_INF ? 1.0f : exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // rescale O before P exists: fewer registers live at once
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i / 2) % 2];
      uint32_t p[4][4];  // P.V's A fragments, one per 16 keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float e[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          e[t] = exp2f(s[8 * kk + t] - mu[(t / 2) % 2]);
          l[(t / 2) % 2] += e[t];
        }
        p[kk][0] = pack_bf16(e[0], e[1]);  // row0,     keys 16 kk + 2 (lane % 4) + {0, 1}
        p[kk][1] = pack_bf16(e[2], e[3]);  // row0 + 8, the same keys
        p[kk][2] = pack_bf16(e[4], e[5]);  // row0,     8 keys on
        p[kk][3] = pack_bf16(e[6], e[7]);  // row0 + 8
      }

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 keys a step: 2,048 bytes of the V slab
        wgmma_m64n128k16_rs(o, p[kk], desc_sw128(sV + kk * 16 * ROW, SLAB_KV, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
  // stage the tile's output in the (idle) K/V ring, rows padded by 16 bytes
  // (the stores of a warp's eight rows fall in eight bank groups), then
  // write whole 16-byte pieces of each row
  __syncthreads();
  uint8_t* stage = smem_raw + (sKV - smem_addr(smem_raw));
  constexpr int OROW = 2 * raven_attention::D_MAX + 16;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = row0 - q0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    const float inv = l[(i / 2) % 2];
    *reinterpret_cast<__nv_bfloat162*>(stage + row * OROW + col * 2) =
        __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
  }
  __syncthreads();
  for (int i = tid; i < BM * 16; i += THREADS) {
    const int row = i / 16, ch = i % 16;
    if (q0 + row < Sq && ch * 8 < D)
      *reinterpret_cast<uint4*>(ob + (q0 + row) * q_step + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + row * OROW + ch * 16);
  }
}

}  // namespace

// q, out: (B, Sq, H, D) bf16; k, v: (B, Skv, KH, D) bf16; contiguous,
// 16-byte aligned; D % 8 == 0, D <= 128, H % KH == 0; window >= 0 (0: none).
extern "C" int raven_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* out, int B, int Sq, int Skv, int H, int KH,
                                          int D, float scale, int causal, int window,
                                          void* stream) {
  static unsigned long long done[2] = {0, 0};
  auto* kernel = window > 0 ? flash_attention_wgmma_kernel<true>
                            : flash_attention_wgmma_kernel<false>;
  const cudaError_t attr = raven_smem_limit(kernel, SMEM_BYTES, &done[window > 0]);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (Sq + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, RAVEN_STREAM(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), Sq, Skv, H, KH, D, scale * 1.4426950408889634f, causal,
      window);
  RAVEN_RETURN_LAUNCH_STATUS();
}

// featurize: fused scaler + one-hot + concat, numerics first, reading its
// input columns where they lie.
//
// Replaces the Pallas kernel `featurize` of src/repro/kernels/featurize.py
// (pallas_call at line 82), reached from the MLtoDNN tensor program.
//
// Bound on an H100: memory. Per row it reads Kn floats and Kc int32 codes and
// writes Kn + Vtot floats, two operations per numeric column and one compare
// per one-hot column: on the hospital query's path (Kn = 9, Kc = 14,
// Vtot = 40) 288 bytes a row for ~60 operations, far below the card's
// ~20 operations a byte for fp32.
//
// Design:
//   * Columns in place. The Kn numeric and Kc categorical inputs are separate
//     tensors (the table's columns): each comes as a pointer and a row stride
//     in the kernel's parameters, up to MAXCOLS of them, so no copy gathers
//     them first. The wrapper splits wider inputs into launches that each
//     write their own column range of the same output.
//   * Row tiles. A block takes tiles of R rows in turn. A tile's input values
//     are copied into shared memory by 4-byte cp.async, the lanes of a warp on
//     neighbouring rows of one column (coalesced where the column is
//     contiguous). Two staging buffers: the next tile's copies are issued
//     before this tile is computed and stored, so they are in flight meanwhile.
//   * Compute. Lane l of a warp owns output column 32 q + l of chunk q; it
//     loads that column's constants once a chunk (numeric: offset and scale;
//     one-hot: the input it tests and the value) into registers. Where a row
//     has fewer than eight chunks every warp takes each chunk and the warps
//     split the tile's rows; wider rows (short tiles) split the chunks over
//     the warps instead. Results go to a row-major tile in
//     shared memory (consecutive lanes, consecutive words: no bank
//     conflicts; the staging rows are R + 1 words apart, R + 1 odd).
//   * Store. A tile of a launch that writes whole rows is R * F contiguous
//     floats of the output. R is a multiple of 4, so every tile starts 16-byte
//     aligned and is written as 16-byte vector stores (a tail tile's last
//     floats scalar). A launch of a column range stores row by row.
//   * Stream path. A row too wide for a 4-row tile in shared memory
//     (F beyond ~14,000 columns) skips the tile: values go from registers
//     straight to the output, a warp's lanes on consecutive columns.
//   * Row and column within a tile are 32-bit loop counters: no 64-bit
//     division anywhere.
// The scaler runs as round-to-nearest sub then mul (__fsub_rn / __fmul_rn: no
// FMA contraction) and the one-hot as an exact int32 compare, which is the
// plain version's arithmetic, so the output is bitwise equal to it.
// kernels/featurize.py plans the launch (featurize_plan: R, blocks, path,
// shared memory) and the column ranges (featurize_launches).
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using raven_hopper::cp_async_commit;
using raven_hopper::cp_async_wait;
using raven_hopper::smem_addr;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXCOLS = 64;          // input columns one launch takes (FEAT_MAX_COLS)
constexpr int SMEM_MAX = 232448;     // a block's dynamic shared memory limit

struct Feat {
  const void* col[MAXCOLS];   // Kn numeric (f32) columns, then Kc categorical (int32)
  long long stride[MAXCOLS];  // their row strides, in elements
  const float* offset;        // (Kn,)
  const float* scale;         // (Kn,)
  const int* cat_values;      // (V,) the value each one-hot column tests for
  const int* val_col;         // (V,) the categorical column it tests, from cat_base
  float* out;                 // row 0, first column of this launch's range
  long long N, out_stride, tiles;
  int Kn, Kc, W;              // W = Kn + V output columns
  int cat_base, rows, contiguous;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Issue the copies of one tile's inputs into buf (column j at buf + j * (R + 1))
// and commit them as one group.
__device__ __forceinline__ void stage_tile(const Feat& f, uint32_t* buf, long long row0,
                                           int rows) {
  const int K = f.Kn + f.Kc;
  const int chunks = (rows + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RS = f.rows + 1;
  for (int p = warp; p < K * chunks; p += WARPS) {
    const int j = p / chunks;  // warp-uniform
    const int r = (p - j * chunks) * 32 + lane;
    if (r < rows) {
      const char* src =
          static_cast<const char*>(f.col[j]) + 4 * (row0 + r) * f.stride[j];
      cp_async4(smem_addr(buf + j * RS + r), src);
    }
  }
  cp_async_commit();
}

// The tile's values from its staged inputs: into the shared tile, or (STREAM)
// straight into the output.
template <bool STREAM>
__device__ __forceinline__ void compute_tile(const Feat& f, const uint32_t* buf,
                                             float* tile, long long row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int RS = f.rows + 1;
  // Few chunks (narrow rows): every warp takes each chunk, the warps split
  // the rows. Many (wide rows, short tiles): the warps split the chunks.
  const int chunks = (f.W + 31) >> 5;
  const bool by_chunk = chunks >= WARPS;
  for (int q = by_chunk ? warp : 0; q < chunks; q += by_chunk ? WARPS : 1) {
    const int c = q * 32 + lane;
    if (c >= f.W) break;  // the last chunk only
    const bool numeric = c < f.Kn;
    float off = 0.0f, sc = 0.0f;
    int value = 0, j = c;
    if (!numeric) {
      const int k = c - f.Kn;
      j = f.Kn + __ldg(f.val_col + k) - f.cat_base;
      value = __ldg(f.cat_values + k);
    } else {
      off = __ldg(f.offset + c);
      sc = __ldg(f.scale + c);
    }
    const uint32_t* src = buf + j * RS;
    for (int r = by_chunk ? 0 : warp; r < rows; r += by_chunk ? 1 : WARPS) {
      const uint32_t x = src[r];
      const float v = numeric ? __fmul_rn(__fsub_rn(__uint_as_float(x), off), sc)
                              : (static_cast<int>(x) == value ? 1.0f : 0.0f);
      if (STREAM) {
        f.out[(row0 + r) * f.out_stride + c] = v;
      } else {
        tile[r * f.W + c] = v;
      }
    }
  }
}

__device__ __forceinline__ void store_tile(const Feat& f, const float* tile, long long row0,
                                           int rows) {
  if (f.contiguous) {  // rows * W consecutive floats, 16-byte aligned
    const int n = rows * f.W;
    const int n4 = n >> 2;
    float* dst = f.out + row0 * f.W;
    const float4* s4 = reinterpret_cast<const float4*>(tile);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += THREADS) d4[i] = s4[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += THREADS) dst[i] = tile[i];
  } else {  // a column range of wider rows
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += WARPS) {
      float* dst = f.out + (row0 + r) * f.out_stride;
      for (int c = lane; c < f.W; c += 32) dst[c] = tile[r * f.W + c];
    }
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS) featurize_kernel(const __grid_constant__ Feat f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = f.rows;
  const int staged = (f.Kn + f.Kc) * (R + 1);
  float* tile = reinterpret_cast<float*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + (STREAM ? 0 : 4 * R * f.W));
  long long t = blockIdx.x;
  if (t >= f.tiles) return;
  stage_tile(f, stage, t * R, static_cast<int>(min(static_cast<long long>(R), f.N - t * R)));
  for (int i = 0; t < f.tiles; t += gridDim.x, ++i) {
    const long long row0 = t * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), f.N - row0));
    const long long next = t + gridDim.x;
    if (next < f.tiles) {  // the next tile's copies, in flight from here on
      stage_tile(f, stage + ((i + 1) & 1) * staged, next * R,
                 static_cast<int>(min(static_cast<long long>(R), f.N - next * R)));
    } else {
      cp_async_commit();  // an empty group: the wait below counts groups
    }
    cp_async_wait<1>();
    __syncthreads();
    compute_tile<STREAM>(f, stage + (i & 1) * staged, tile, row0, rows);
    if (!STREAM) {
      __syncthreads();
      store_tile(f, tile, row0, rows);
    }
    __syncthreads();  // the tile and this staging buffer are free again
  }
}

template <bool STREAM>
int launch(const Feat& f, int blocks, int smem, cudaStream_t st) {
  static unsigned long long done = 0;  // devices whose smem limit is raised
  if (smem > 48 * 1024) {
    const cudaError_t err = raven_smem_limit(featurize_kernel<STREAM>, SMEM_MAX, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  featurize_kernel<STREAM><<<blocks, THREADS, smem, st>>>(f);
  RAVEN_RETURN_LAUNCH_STATUS();
}

}  // namespace

// cols / strides: Kn + Kc column pointers and row strides (in elements),
// numerics first. offset / scale point at this launch's Kn numerics,
// cat_values / val_col at its V one-hot columns (val_col counts categorical
// columns from cat_base). out points at row 0 of this launch's first output
// column; out_stride is the output's row stride in floats. rows, stream,
// blocks and smem come from kernels/featurize.py's featurize_plan.
extern "C" int raven_featurize(const void* cols, const void* strides, int Kn, int Kc,
                               const void* offset, const void* scale, const void* cat_values,
                               const void* val_col, int cat_base, int V, void* out,
                               long long out_stride, long long N, int rows, int stream,
                               int blocks, int smem, void* stream_ptr) {
  const int W = Kn + V;
  if (Kn < 0 || Kc < 0 || Kn + Kc > MAXCOLS || V < 0 || rows < 4 || rows % 4 || blocks < 1 ||
      smem > SMEM_MAX || out_stride < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0 || W == 0) return 0;
  Feat f = {};
  const void* const* cp = static_cast<const void* const*>(cols);
  const long long* sp = static_cast<const long long*>(strides);
  for (int j = 0; j < Kn + Kc; ++j) {
    f.col[j] = cp[j];
    f.stride[j] = sp[j];
  }
  f.offset = static_cast<const float*>(offset);
  f.scale = static_cast<const float*>(scale);
  f.cat_values = static_cast<const int*>(cat_values);
  f.val_col = static_cast<const int*>(val_col);
  f.out = static_cast<float*>(out);
  f.N = N;
  f.out_stride = out_stride;
  f.tiles = (N + rows - 1) / rows;
  f.Kn = Kn;
  f.Kc = Kc;
  f.W = W;
  f.cat_base = cat_base;
  f.rows = rows;
  f.contiguous = out_stride == W && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t st = RAVEN_STREAM(stream_ptr);
  return stream ? launch<true>(f, blocks, smem, st) : launch<false>(f, blocks, smem, st);
}

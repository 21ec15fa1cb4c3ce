// segment_agg: masked segmented count / sum / min / max, in one launch.
//
// Replaces the Pallas kernel `segment_agg` of src/repro/kernels/relational.py
// (pallas_call at line 176), reached from the Aggregate step of a pure stage
// (the upstream filter folded in as the weight w).
//
// The function, per segment s and value column j: count = sum of w, sum =
// sum of v * w, min / max over the rows with w > 0 (NaN propagates), over
// the rows with sid == s; an empty segment gives 0, 0, +inf, -inf.
//
// Bound on an H100: memory. Each row is read once (C value floats, one
// weight, one int32 segment id, no id when S == 1) for a few operations a
// column and segment; the (S, 3C + 1) results are a few hundred bytes.
//
// Design: one launch, every row read once, sums in a fixed order and no
// float atomics, so results repeat bit for bit and, on dyadic data, equal
// the plain version's. The C value columns are read in place, each through
// its own pointer and stride (a column of a join's (N, P) output has stride
// P), passed by value in the kernel's parameters.
//   * Block b of the grid (one an SM, 2,048 rows at least) walks rows
//     [b * chunk, (b + 1) * chunk); thread t of it the rows lo + t + 256 k,
//     in order, loading eight before it adds them.
//   * Register path (S <= 8 segments, C <= 3 columns: every fold of the main
//     path): each thread keeps (S, 3C + 1) accumulators in registers (80 at
//     S = 8, C = 3) and one run: the sums of the rows it meets in a row with
//     one segment id, added to that segment's accumulators when the id
//     changes (coalesced requests come as contiguous ranges of rows, so a
//     row costs 3C + 1 operations, not S times that). A row of weight 0
//     with finite values adds exactly 0 to every sum, so it is skipped and
//     ends no run (the stage routes filtered rows to segment 0). Then a
//     butterfly over the warp's lanes, lane 0 of each warp writes to shared
//     memory, and one thread per entry folds the eight warps in warp order.
//   * Shared path (any other S and C up to 64): each warp keeps a slice of
//     (segments, 3C + 1) accumulators in shared memory. It stages its 32
//     rows of a step in shared memory and applies them in row order, one
//     lane per accumulator entry, so no two lanes write one entry. Where
//     eight slices do not fit, the segments are cut into groups (grid.y),
//     each group reading the rows again. Then the warps fold in warp order.
//   * Each block writes its (S, 3C + 1) partial to scratch. The last block
//     to finish, known from an integer atomic on a counter after a
//     __threadfence(), stages the partials in shared memory where they fit
//     (cp.async, all copies in flight at once) and folds them in block
//     order, one thread per entry, then resets the
//     counter itself: the next launch, or the replay of a captured CUDA
//     graph, finds it at 0. The counters are a __device__ array set to 0 at
//     load, one slot per (device, stream) that the wrapper assigns.
// kernels/relational.py plans the launch (path, blocks, groups, shared
// memory); tests/torch_agg_model.py repeats its order of operations in
// plain torch.
#include <cuda_pipeline.h>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXC = 64;     // value columns one launch takes (AGG_MAX_COLS)
constexpr int SLOTS = 1024;  // completion counters (AGG_SLOTS)
constexpr int SMEM_MAX = 232448 - 1024;  // dynamic: room left for the static flag
constexpr unsigned FULL = 0xffffffffu;

__device__ unsigned int g_done[SLOTS] = {};

struct Agg {
  const float* col[MAXC];
  long long stride[MAXC];
  const float* w;
  const int* sid;  // null when S == 1
  float* partials;  // blocks * S * (3C + 1)
  float* counts;
  float* sums;
  float* mins;
  float* maxs;
  long long N, chunk;
  int C, S, blocks, launched, group_segments, stage, slot;
};

// min / max that return NaN where either operand is NaN (torch.amin's rule),
// one instruction each
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Entry e of a segment's accumulators: 0 the count, 1..C the sums, C+1..2C
// the mins, 2C+1..3C the maxs.
__device__ __forceinline__ float fold(float a, float b, int e, int C) {
  return e <= C ? __fadd_rn(a, b) : (e <= 2 * C ? nan_min(a, b) : nan_max(a, b));
}
__device__ __forceinline__ float identity(int e, int C) {
  const float inf = __int_as_float(0x7f800000);
  return e <= C ? 0.0f : (e <= 2 * C ? inf : -inf);
}

// n values `stride` apart folded in order: OP 0 adds, 1 takes the min, 2
// the max. GLOBAL reads them from L2, bypassing L1.
template <int OP, bool GLOBAL>
__device__ __forceinline__ float fold_strided(const float* p, long long stride, int n) {
  float v = GLOBAL ? __ldcg(p) : p[0];
#pragma unroll 8
  for (int b = 1; b < n; ++b) {
    const float x = GLOBAL ? __ldcg(p + b * stride) : p[b * stride];
    v = OP == 0 ? __fadd_rn(v, x) : (OP == 1 ? nan_min(v, x) : nan_max(v, x));
  }
  return v;
}

template <bool GLOBAL>
__device__ __forceinline__ float fold_entry(const float* p, long long stride, int n, int e,
                                            int C) {
  return e <= C ? fold_strided<0, GLOBAL>(p, stride, n)
                : (e <= 2 * C ? fold_strided<1, GLOBAL>(p, stride, n)
                              : fold_strided<2, GLOBAL>(p, stride, n));
}

// The warps' partials (WARPS slices of `slice` floats, `width` of them
// this block's entries from entry `first` on) folded in warp order into the
// block's partial, then the grid's last block folds every block's partial
// in block order and writes the results.
__device__ __forceinline__ void finish(const Agg& a, float* smem, int slice, int first,
                                       int width) {
  const int E = 3 * a.C + 1;
  const long long SE = static_cast<long long>(a.S) * E;
  for (int t = threadIdx.x; t < width; t += THREADS) {
    a.partials[blockIdx.x * SE + first + t] =
        fold_entry<false>(smem + t, slice, WARPS, (first + t) % E, a.C);
  }
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&g_done[a.slot], 1u) == static_cast<unsigned>(a.launched - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.stage) {  // every partial into shared memory, 16 bytes a copy, all in flight
    const long long total = a.blocks * SE, n4 = total / 4;
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
      __pipeline_memcpy_async(smem + 4 * i, a.partials + 4 * i, 16);
    }
    __pipeline_commit();
    for (long long i = 4 * n4 + threadIdx.x; i < total; i += THREADS) smem[i] = __ldcg(a.partials + i);
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  for (long long t = threadIdx.x; t < SE; t += THREADS) {
    const int e = static_cast<int>(t % E);
    const float v = a.stage ? fold_entry<false>(smem + t, SE, a.blocks, e, a.C)
                            : fold_entry<true>(a.partials + t, SE, a.blocks, e, a.C);
    const long long s = t / E;
    if (e == 0) {
      a.counts[s] = v;
    } else if (e <= a.C) {
      a.sums[s * a.C + e - 1] = v;
    } else if (e <= 2 * a.C) {
      a.mins[s * a.C + e - 1 - a.C] = v;
    } else {
      a.maxs[s * a.C + e - 1 - 2 * a.C] = v;
    }
  }
  if (threadIdx.x == 0) g_done[a.slot] = 0;
}

// Adds a thread's current run (the rows it met in a row with one segment
// id) to that segment's accumulators, then empties the run. Every
// accumulator takes an addend, the run's where the segment is `cur` and 0
// (or +-inf) elsewhere: a select, not a branch, so the compiler keeps `acc`
// in registers instead of indexing it in local memory.
template <int ST, int E, int C>
__device__ __forceinline__ void flush(float (&acc)[ST][E], float (&run)[E], int cur) {
#pragma unroll
  for (int s = 0; s < ST; ++s) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[s][e] = fold(acc[s][e], s == cur ? run[e] : identity(e, C), e, C);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) run[e] = identity(e, C);
}

// Register path: ST >= S segments (a power of two up to 8), C columns.
template <int ST, int C>
__global__ void __launch_bounds__(THREADS) agg_registers(const Agg a) {
  constexpr int E = 3 * C + 1;
  constexpr int CC = C > 0 ? C : 1;
  constexpr int UNROLL = 8;  // rows a thread loads before it adds them
  extern __shared__ __align__(16) float smem[];  // WARPS * S * E, then the fold
  float acc[ST][E], run[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run[e] = identity(e, C);
#pragma unroll
    for (int s = 0; s < ST; ++s) acc[s][e] = identity(e, C);
  }
  int cur = -1;  // the segment of the current run
  const long long lo = blockIdx.x * a.chunk;
  const long long hi = lo + a.chunk < a.N ? lo + a.chunk : a.N;
  for (long long b0 = lo; b0 < hi; b0 += THREADS * UNROLL) {
    float wv[UNROLL], vv[UNROLL][CC];
    int sv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = b0 + threadIdx.x + u * THREADS;
      const bool in = i < hi;
      wv[u] = in ? a.w[i] : 0.0f;
      sv[u] = in ? (ST == 1 ? 0 : a.sid[i]) : -1;
#pragma unroll
      for (int j = 0; j < C; ++j) vv[u][j] = in ? a.col[j][i * a.stride[j]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (sv[u] < 0) continue;  // past the block's rows
      const float wi = wv[u];
      if (wi == 0.0f) {  // a filtered row adds exactly 0 everywhere: it ends no run
        bool finite = true;  // unless 0 * inf or 0 * NaN makes its product NaN
#pragma unroll
        for (int j = 0; j < C; ++j) finite = finite && isfinite(vv[u][j]);
        if (finite) continue;
      }
      if (sv[u] != cur) {  // a new run: rare where segment ids come sorted
        flush<ST, E, C>(acc, run, cur);
        cur = sv[u];
      }
      const bool valid = wi > 0.0f;
      run[0] = __fadd_rn(run[0], wi);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        run[1 + j] = __fadd_rn(run[1 + j], __fmul_rn(vv[u][j], wi));
        run[1 + C + j] = nan_min(run[1 + C + j], valid ? vv[u][j] : identity(1 + C, C));
        run[1 + 2 * C + j] = nan_max(run[1 + 2 * C + j], valid ? vv[u][j] : identity(1 + 2 * C, C));
      }
    }
  }
  flush<ST, E, C>(acc, run, cur);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = a.S * E;
#pragma unroll
  for (int s = 0; s < ST; ++s) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float v = acc[s][e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fold(v, __shfl_xor_sync(FULL, v, off), e, C);
      if (lane == 0 && s < a.S) smem[warp * slice + s * E + e] = v;
    }
  }
  __syncthreads();
  finish(a, smem, slice, 0, slice);
}

// Shared path: a group of `group_segments` segments per blockIdx.y, any C.
__global__ void __launch_bounds__(THREADS) agg_shared(const Agg a) {
  extern __shared__ __align__(16) float smem[];  // slices, staged rows; then the fold
  const int C = a.C, E = 3 * C + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = blockIdx.y * a.group_segments;
  const int gs = a.S - g0 < a.group_segments ? a.S - g0 : a.group_segments;
  const int slice = a.group_segments * E;
  float* mine = smem + warp * slice;
  float* rows = smem + WARPS * slice + warp * 32 * (C + 2);  // (sid, w, values) a row
  for (int t = lane; t < gs * E; t += 32) mine[t] = identity(t % E, C);
  const long long lo = blockIdx.x * a.chunk;
  const long long hi = lo + a.chunk < a.N ? lo + a.chunk : a.N;
  for (long long base = lo + 32 * warp; base < hi; base += THREADS) {
    const long long i = base + lane;
    float* row = rows + lane * (C + 2);
    row[0] = __int_as_float(i < hi ? (a.sid ? a.sid[i] : 0) : -1);
    if (i < hi) {
      row[1] = a.w[i];
      for (int j = 0; j < C; ++j) row[2 + j] = a.col[j][i * a.stride[j]];
    }
    __syncwarp();
    for (int r = 0; r < 32; ++r) {  // the warp's rows in order
      const float* rr = rows + r * (C + 2);
      const int s = __float_as_int(rr[0]) - g0;
      if (s < 0 || s >= gs) continue;  // the same for every lane
      const float wr = rr[1];
      float* acc = mine + s * E;
      for (int e = lane; e < E; e += 32) {
        float v = acc[e];
        if (e == 0) {
          v = __fadd_rn(v, wr);
        } else if (e <= C) {
          v = __fadd_rn(v, __fmul_rn(rr[1 + e], wr));
        } else if (wr > 0.0f) {
          v = e <= 2 * C ? nan_min(v, rr[1 + e - C]) : nan_max(v, rr[1 + e - 2 * C]);
        }
        acc[e] = v;
      }
    }
    __syncwarp();
  }
  __syncthreads();
  finish(a, smem, slice, g0 * E, gs * E);
}

template <typename K>
static int launch(K* kernel, const Agg& a, dim3 grid, int smem, unsigned long long* done,
                  cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = raven_smem_limit(kernel, SMEM_MAX, done);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, THREADS, smem, st>>>(a);
  RAVEN_RETURN_LAUNCH_STATUS();
}

template <int ST, int C>
static int launch_registers(const Agg& a, int smem, cudaStream_t st) {
  static unsigned long long done = 0;  // devices whose smem limit is raised
  return launch(agg_registers<ST, C>, a, dim3(a.blocks), smem, &done, st);
}

using RegisterLaunch = int (*)(const Agg&, int, cudaStream_t);
static const RegisterLaunch REGISTER_PATH[4][4] = {
    {launch_registers<1, 0>, launch_registers<1, 1>, launch_registers<1, 2>, launch_registers<1, 3>},
    {launch_registers<2, 0>, launch_registers<2, 1>, launch_registers<2, 2>, launch_registers<2, 3>},
    {launch_registers<4, 0>, launch_registers<4, 1>, launch_registers<4, 2>, launch_registers<4, 3>},
    {launch_registers<8, 0>, launch_registers<8, 1>, launch_registers<8, 2>, launch_registers<8, 3>},
};

// cols / strides: C column pointers and strides (in floats). `registers`
// names the path; blocks, chunk, groups, group_segments, stage and smem
// come from kernels/relational.py's agg_plan; partials holds
// blocks * S * (3C + 1) floats.
extern "C" int raven_segment_agg(const void* cols, const void* strides, int C,
                                 const void* w, const void* sid, void* partials,
                                 void* counts, void* sums, void* mins, void* maxs,
                                 long long N, int S, int registers, int blocks,
                                 long long chunk, int groups, int group_segments,
                                 int stage, int smem, int slot, void* stream) {
  if (C < 0 || C > MAXC || S < 1 || slot < 0 || slot >= SLOTS || blocks < 1 || groups < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Agg a = {};
  const float* const* cp = static_cast<const float* const*>(cols);
  const long long* sp = static_cast<const long long*>(strides);
  for (int j = 0; j < C; ++j) {
    a.col[j] = cp[j];
    a.stride[j] = sp[j];
  }
  a.w = static_cast<const float*>(w);
  a.sid = S == 1 ? nullptr : static_cast<const int*>(sid);
  a.partials = static_cast<float*>(partials);
  a.counts = static_cast<float*>(counts);
  a.sums = static_cast<float*>(sums);
  a.mins = static_cast<float*>(mins);
  a.maxs = static_cast<float*>(maxs);
  a.N = N;
  a.chunk = chunk;
  a.C = C;
  a.S = S;
  a.blocks = blocks;
  a.launched = blocks * groups;
  a.group_segments = group_segments;
  a.stage = stage;
  a.slot = slot;
  cudaStream_t st = RAVEN_STREAM(stream);
  if (registers) {
    if (S > 8 || C > 3) return static_cast<int>(cudaErrorInvalidValue);
    const int row = S == 1 ? 0 : (S == 2 ? 1 : (S <= 4 ? 2 : 3));
    return REGISTER_PATH[row][C](a, smem, st);
  }
  static unsigned long long done = 0;
  return launch(agg_shared, a, dim3(blocks, groups), smem, &done, st);
}

// segment_agg: masked segmented count / sum / min / max.
//
// Replaces the Pallas kernel `segment_agg` of src/repro/kernels/relational.py
// (pallas_call at line 176), reached from the Aggregate step of a pure stage
// (the upstream filter folded in as the weight w).
//
// Bound on an H100: memory. Each row is read once (C value floats, one
// weight, one int32 segment id) for a handful of flops; the (S, C) results
// are a few hundred bytes.
//
// Design: on the TPU the grid walks the row blocks in order and the
// (segments x columns) accumulator stays resident across grid steps. Blocks
// of a GPU run in no order, and float atomics would add in an order that
// changes from run to run. So the work is two passes with no atomics:
//   pass 1: block (b, j) folds row chunk b of column j (j = 0 is the weight,
//           giving counts = sum of w; j >= 1 is value column j - 1, giving
//           sum of v * w, and min / max over rows with w > 0) for every
//           segment, each thread over a fixed strided set of rows and then
//           a fixed shared-memory tree, into a scratch of partials;
//   pass 2: block (j, s) folds the G partials of its (column, segment) in a
//           fixed order and writes the result.
// Every run adds in the same order, so results repeat bit for bit; on dyadic
// data every partial sum is exact, so they equal the plain version bitwise.
// Empty segments give sum 0, min +inf, max -inf, as the plain version does.
// Block b loops over the S segments, re-reading its chunk (from L1/L2) once
// per segment: S = 1 in a global fold, a small power of two in a
// coalesced-serving fold.
#include "common.cuh"

constexpr int THREADS = 256;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// fixed-order shared-memory tree over THREADS values; result in slot 0
__device__ void block_fold(float* ssum, float* smin, float* smax) {
  for (int half = THREADS / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (threadIdx.x < half) {
      ssum[threadIdx.x] = __fadd_rn(ssum[threadIdx.x], ssum[threadIdx.x + half]);
      smin[threadIdx.x] = nan_min(smin[threadIdx.x], smin[threadIdx.x + half]);
      smax[threadIdx.x] = nan_max(smax[threadIdx.x], smax[threadIdx.x + half]);
    }
  }
  __syncthreads();
}

__global__ void segment_partials(const float* __restrict__ vals,
                                 const float* __restrict__ w,
                                 const int* __restrict__ sid,
                                 float* __restrict__ psum,
                                 float* __restrict__ pmin,
                                 float* __restrict__ pmax, long long N, int C,
                                 int S, int G, long long chunk) {
  __shared__ float ssum[THREADS], smin[THREADS], smax[THREADS];
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const long long lo = static_cast<long long>(b) * chunk;
  const long long hi = (lo + chunk < N) ? lo + chunk : N;
  for (int s = 0; s < S; ++s) {
    float acc = 0.0f, mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      if (sid[i] != s) continue;
      const float wi = w[i];
      if (j == 0) {
        acc = __fadd_rn(acc, wi);
      } else {
        const float v = vals[i * C + (j - 1)];
        acc = __fadd_rn(acc, __fmul_rn(v, wi));
        if (wi > 0.0f) {
          mn = nan_min(mn, v);
          mx = nan_max(mx, v);
        }
      }
    }
    ssum[threadIdx.x] = acc;
    smin[threadIdx.x] = mn;
    smax[threadIdx.x] = mx;
    block_fold(ssum, smin, smax);
    if (threadIdx.x == 0) {
      const long long o = (static_cast<long long>(j) * S + s) * G + b;
      psum[o] = ssum[0];
      pmin[o] = smin[0];
      pmax[o] = smax[0];
    }
    __syncthreads();  // slot 0 is read before the next segment overwrites it
  }
}

__global__ void segment_finish(const float* __restrict__ psum,
                               const float* __restrict__ pmin,
                               const float* __restrict__ pmax,
                               float* __restrict__ counts,
                               float* __restrict__ sums,
                               float* __restrict__ mins,
                               float* __restrict__ maxs, int C, int S, int G) {
  __shared__ float ssum[THREADS], smin[THREADS], smax[THREADS];
  const int j = blockIdx.x;
  const int s = blockIdx.y;
  const long long base = (static_cast<long long>(j) * S + s) * G;
  float acc = 0.0f, mn = __int_as_float(0x7f800000), mx = -__int_as_float(0x7f800000);
  for (int b = threadIdx.x; b < G; b += THREADS) {
    acc = __fadd_rn(acc, psum[base + b]);
    mn = nan_min(mn, pmin[base + b]);
    mx = nan_max(mx, pmax[base + b]);
  }
  ssum[threadIdx.x] = acc;
  smin[threadIdx.x] = mn;
  smax[threadIdx.x] = mx;
  block_fold(ssum, smin, smax);
  if (threadIdx.x == 0) {
    if (j == 0) {
      counts[s] = ssum[0];
    } else {
      const long long o = static_cast<long long>(s) * C + (j - 1);
      sums[o] = ssum[0];
      mins[o] = smin[0];
      maxs[o] = smax[0];
    }
  }
}

// `partials` holds 3 * (C + 1) * S * G floats of scratch.
extern "C" int raven_segment_agg(const void* vals, const void* w, const void* sid,
                                 void* partials, void* counts, void* sums,
                                 void* mins, void* maxs, long long N, int C,
                                 int S, int G, void* stream) {
  const long long chunk = (N + G - 1) / G;
  const long long per = static_cast<long long>(C + 1) * S * G;
  float* psum = static_cast<float*>(partials);
  float* pmin = psum + per;
  float* pmax = pmin + per;
  cudaStream_t st = RAVEN_STREAM(stream);
  segment_partials<<<dim3(G, C + 1), THREADS, 0, st>>>(
      static_cast<const float*>(vals), static_cast<const float*>(w),
      static_cast<const int*>(sid), psum, pmin, pmax, N, C, S, G, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_finish<<<dim3(C + 1, S), THREADS, 0, st>>>(
      psum, pmin, pmax, static_cast<float*>(counts), static_cast<float*>(sums),
      static_cast<float*>(mins), static_cast<float*>(maxs), C, S, G);
  RAVEN_RETURN_LAUNCH_STATUS();
}

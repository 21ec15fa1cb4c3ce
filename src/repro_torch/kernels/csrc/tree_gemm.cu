// tree_gemm: GEMM-strategy tree-ensemble scoring.
//
// Replaces the Pallas kernel `tree_gemm` of src/repro/kernels/tree_gemm.py
// (pallas_call at line 65), reached from the MLtoDNN tensor program.
//
// Per row and tree:  S = x.A,  D = (S <= B),  P = D.C,  match = (P == Dcount),
// y += match.V, with y starting at `base`.
//
// Bound on an H100: fp32 operations. A is one-hot per internal node, so the
// function needs S only as a gather, one compare per internal node; the
// path sums P = D.C (2*I*L per tree) and match.V (2*L) dominate. On the
// hospital query's path (T = 150, I = L = 32) that is ~2,100 operations per
// row and tree against ~200 bytes of input per row, so the 67 TFLOP/s fp32
// SIMT rate, not the 3.35 TB/s memory, sets the floor.
//
// Design: tensor cores are not used for S = x.A: TF32 would round x to a
// 10-bit mantissa and flip threshold decisions. S is an fp32 FMA sum over
// the features; A is one-hot, so the sum is exact (x*1 plus exact zeros)
// whatever the order. On the TPU the trees are the sequential grid axis with
// the output block revisited; here a block owns ROWS rows and loops over the
// trees, keeping each row's accumulator in a register. Per tree, the block
// stages the tree's (B, C, Dcount, V) in shared memory, where every thread
// of a warp reads the same word (broadcast). x and A are staged FC features
// at a time (x feature-major, xs[f * ROWS + r]); each row's path sums sit in
// a private column of shared memory, so a warp's accesses hit 32 distinct
// banks. When all F features fit (FC == F, as on the hospital path) x is
// staged once for all trees and each S is decided as soon as it is summed.
// A wider program restages its chunk of x per tree and keeps each row's
// partial S between chunks in a private column too, so shared memory does
// not grow with F and every program of up to 128 internal nodes fits. Columns
// of A past x's width read x as zero, which is how the padded program's
// inert feature rows meet an unpadded x. Path sums and decisions are small integers, exact
// in fp32, and exactly one leaf of a tree matches, so a tree's part is one
// leaf value, exactly. Only the sum over trees rounds: the kernel carries it
// in fp64 (150 adds a row, nothing beside the fp32 work) and rounds it once
// before adding `base`, as the plain version adds `base` after its own fp32
// sum; the two then differ by the plain version's rounding alone (atol 1e-5).
#include "common.cuh"

constexpr int ROWS = 64;

__global__ void tree_gemm_kernel(const float* __restrict__ x,
                                 const float* __restrict__ A,
                                 const float* __restrict__ B,
                                 const float* __restrict__ C,
                                 const float* __restrict__ D,
                                 const float* __restrict__ V,
                                 float* __restrict__ out, float base, long long N,
                                 int Fx, int T, int F, int I, int L, int FC) {
  extern __shared__ float smem[];
  float* xs = smem;            // FC * ROWS, one chunk of x, feature-major
  float* ps = xs + FC * ROWS;  // L * ROWS, path sums of each row
  float* As = ps + L * ROWS;   // FC * I, the chunk's rows of A
  float* Bs = As + FC * I;     // I
  float* Cs = Bs + I;          // I * L
  float* Ds = Cs + I * L;      // L
  float* Vs = Ds + L;          // L
  float* ss = Vs + L;          // I * ROWS, S so far: only when F > FC

  const int r = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const long long rows = (N - row0 < ROWS) ? (N - row0) : ROWS;
  const int chunks = (F > FC) ? (F + FC - 1) / FC : 1;

  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // the previous tree's parameters are no longer read
    for (int k = r; k < I; k += ROWS) Bs[k] = B[static_cast<long long>(t) * I + k];
    const long long tIL = static_cast<long long>(t) * I * L;
    for (int k = r; k < I * L; k += ROWS) Cs[k] = C[tIL + k];
    for (int k = r; k < L; k += ROWS) {
      Ds[k] = D[static_cast<long long>(t) * L + k];
      Vs[k] = V[static_cast<long long>(t) * L + k];
    }
    for (int l = 0; l < L; ++l) ps[l * ROWS + r] = 0.0f;

    for (int c = 0; c < chunks; ++c) {
      const int f0 = c * FC;
      const int fc = (F - f0 < FC) ? (F - f0) : FC;
      if (c > 0) __syncthreads();  // the previous chunk is no longer read
      if (chunks > 1 || t == 0) {
        // x[:, f0 : f0 + fc], coalesced over the block's contiguous rows,
        // zero past N and past x's own width
        for (int k = r; k < ROWS * fc; k += ROWS) {
          const int rr = k / fc;
          const int f = f0 + (k - rr * fc);
          xs[(f - f0) * ROWS + rr] =
              (rr < rows && f < Fx) ? x[(row0 + rr) * Fx + f] : 0.0f;
        }
      }
      const long long a0 = (static_cast<long long>(t) * F + f0) * I;
      for (int k = r; k < fc * I; k += ROWS) As[k] = A[a0 + k];
      __syncthreads();
      const bool last = c == chunks - 1;
      for (int i = 0; i < I; ++i) {
        float s = (c == 0) ? 0.0f : ss[i * ROWS + r];
        for (int f = 0; f < fc; ++f) s = fmaf(xs[f * ROWS + r], As[f * I + i], s);
        if (!last) {
          ss[i * ROWS + r] = s;
        } else if (s <= Bs[i]) {
          for (int l = 0; l < L; ++l) ps[l * ROWS + r] += Cs[i * L + l];
        }
      }
    }
    float part = 0.0f;
    for (int l = 0; l < L; ++l) {
      if (ps[l * ROWS + r] == Ds[l]) part += Vs[l];
    }
    acc += static_cast<double>(part);
  }
  if (r < rows) out[row0 + r] = __fadd_rn(static_cast<float>(acc), base);
}

extern "C" int raven_tree_gemm(const void* x, const void* A, const void* B,
                               const void* C, const void* D, const void* V,
                               void* out, float base, long long N, int Fx, int T,
                               int F, int I, int L, int FC, void* stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(FC) * ROWS + static_cast<size_t>(L) * ROWS +
       static_cast<size_t>(FC) * I + I + static_cast<size_t>(I) * L + 2 * L +
       (F > FC ? static_cast<size_t>(I) * ROWS : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((N + ROWS - 1) / ROWS);
  tree_gemm_kernel<<<blocks, ROWS, smem, RAVEN_STREAM(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(D), static_cast<const float*>(V),
      static_cast<float*>(out), base, N, Fx, T, F, I, L, FC);
  RAVEN_RETURN_LAUNCH_STATUS();
}

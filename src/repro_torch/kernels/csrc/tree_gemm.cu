// tree_gemm: GEMM-strategy tree-ensemble scoring.
//
// Replaces the Pallas kernel `tree_gemm` of src/repro/kernels/tree_gemm.py
// (pallas_call at line 65), reached from the MLtoDNN tensor program.
//
// The function: per row and tree, S = x.A, D = (S <= B), P = D.C,
// match = (P == Dcount), y += match.V, with y starting at `base`. None of it
// is a matrix product at heart. A is one-hot per internal node, so S is
// x[feature]; C is in {-1, 0, 1}, so P == Dcount (Dcount being the leaf's
// count of +1 entries) holds exactly when every left ancestor decided 1 and
// every right ancestor decided 0. kernels/tree_gemm.py packs the program
// once, at compile time, into that form and refuses programs for which the
// two differ: per node its feature and threshold, per live leaf a left and a
// right bit mask over the nodes and its value (leaves that can never match,
// the padding, are left out).
//
// Bound on an H100: bytes. The function needs only the path a row takes
// through each tree (~5 compares on the hospital query's depth-5 trees,
// T = 150) against ~200 bytes of x per row, so reading x at 3.35 TB/s sets
// the floor. This design evaluates every node and tests every live leaf
// (~64 operations per row and tree at I = L = 32), so the SMs' issue rate,
// not memory, is what holds it above that floor.
//
// Design: one thread per row, ROWS rows a block, looping over the trees (the
// TPU's sequential grid axis) with the row's sum in a register. The block
// stages its rows of x once, coalesced, into shared memory with the row
// index fastest (xs[f * XS + r], XS = ROWS + 1 so that both the staging
// stores and a warp's gather of one feature hit 32 banks); a node's decision
// is then one shared load and one compare, setting bit i of W decision words
// held in registers (W templated, one word on the hospital path). A leaf's
// test is one LOP3 per word, ((dec ^ left) & (left | right)) == 0. The packed
// trees are staged in chunks of CHUNK trees through shared memory, where
// every thread of a warp reads the same word (broadcast), so shared memory
// per block stays small and SMs hold several blocks. An x too wide to stage
// is read per node through L1 instead. Nothing is rounded but the sum over
// trees: decisions and masks are exact, a real tree matches one leaf, and
// its value is added exactly; the kernel carries the sum over trees in
// fp64 and rounds it once before adding `base`, as the plain version adds
// `base` after its own fp32 sum, so the two differ by the plain version's
// rounding alone (atol 1e-5).
//
// Non-finite inputs keep the GEMM form's semantics, where 0 * inf = NaN
// poisons S: with nf the row's count of non-finite entries over all of x's
// columns, S = x[f] when nf == 0, or when nf == 1 and x[f] is that entry,
// else NaN (decision 0); a zero column of A, and a feature past x's width,
// has S = 0 when nf == 0, else NaN. A staged row is rewritten so once; x
// read through L1 applies the rule per node.
//
// Past W_MAX = 6 decision words (more than 192 internal nodes, which only an
// explicit gemm strategy asks for) the wide kernel holds each row's words in
// shared memory, one column of ROWS words per decision word (each thread
// reads its own row: no bank conflicts), and reads the packed records from
// global memory through L1, every thread of a warp the same record, since
// one tree may not fit shared memory (~278 KB at 1,024 nodes). It tests
// nodes, leaves and sums in the same order as the templated kernel.
#include <cstdint>

#include "common.cuh"

constexpr int ROWS = 256;
constexpr int XS = ROWS + 1;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float poison(float v, int nf) {
  return (nf == 0 || (nf == 1 && !isfinite(v))) ? v : __int_as_float(0x7fc00000);
}

// Stages x and counts the row's non-finite entries, rewriting the staged
// row as the GEMM form would see it; returns that count.
template <bool STAGE_X>
__device__ __forceinline__ int stage_row(const float* __restrict__ x, float* xs,
                                         const float* xrow, long long row0, int rows,
                                         int Fx) {
  const int r = threadIdx.x;
  int nf = 0;
  if (STAGE_X) {
    const float* xb = x + row0 * Fx;
    const int n = rows * Fx;
    for (int k = r; k < ROWS * Fx; k += ROWS) {
      const int rr = k / Fx;
      xs[(k - rr * Fx) * XS + rr] = k < n ? xb[k] : 0.0f;
    }
    __syncthreads();
    for (int f = 0; f < Fx; ++f) nf += !isfinite(xs[f * XS + r]);
    if (nf) {
      for (int f = 0; f < Fx; ++f) xs[f * XS + r] = poison(xs[f * XS + r], nf);
    }
    xs[Fx * XS + r] = poison(0.0f, nf);  // zero columns and features past Fx
    // each thread reads back only its own row r: no barrier needed here
  } else {
    for (int f = 0; f < Fx; ++f) nf += !isfinite(__ldg(xrow + f));
  }
  return nf;
}

// nodes: (T, I) of (feature, threshold bits); leaves: (T, L, W + 1) of
// (left, right) mask words, then (value bits, column); counts: (T) of
// (nodes to evaluate, live leaves).
template <int W, bool STAGE_X>
__global__ void __launch_bounds__(ROWS) tree_gemm_kernel(
    const float* __restrict__ x, const int2* __restrict__ nodes,
    const uint2* __restrict__ leaves, const int2* __restrict__ counts,
    float* __restrict__ out, float base, long long N, int Fx, int T, int I, int L,
    int CHUNK) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* ns = reinterpret_cast<int2*>(smem);             // CHUNK * I
  uint2* ls = reinterpret_cast<uint2*>(ns + CHUNK * I);  // CHUNK * L * (W + 1)
  int2* cs = reinterpret_cast<int2*>(ls + CHUNK * L * (W + 1));  // CHUNK
  float* xs = reinterpret_cast<float*>(cs + CHUNK);     // (Fx + 1) * XS

  const int r = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(N - row0 < ROWS ? N - row0 : ROWS);
  const float* xrow = x + (row0 + (r < rows ? r : rows - 1)) * Fx;

  const int nf = stage_row<STAGE_X>(x, xs, xrow, row0, rows, Fx);

  double acc = 0.0;
  for (int t0 = 0; t0 < T; t0 += CHUNK) {
    const int tc = T - t0 < CHUNK ? T - t0 : CHUNK;
    __syncthreads();  // the previous chunk is no longer read
    const int2* ng = nodes + static_cast<long long>(t0) * I;
    for (int k = r; k < tc * I; k += ROWS) {
      int2 nd = ng[k];
      const bool zero = nd.x < 0 || nd.x >= Fx;
      nd.x = STAGE_X ? (zero ? Fx : nd.x) * XS : (zero ? -1 : nd.x);
      ns[k] = nd;
    }
    const uint2* lg = leaves + static_cast<long long>(t0) * L * (W + 1);
    for (int k = r; k < tc * L * (W + 1); k += ROWS) ls[k] = lg[k];
    for (int k = r; k < tc; k += ROWS) cs[k] = counts[t0 + k];
    __syncthreads();

    for (int j = 0; j < tc; ++j) {
      const int2 cnt = cs[j];
      const int2* nj = ns + j * I;
      uint32_t dec[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t word = 0;
        const int end = cnt.x - 32 * w < 32 ? cnt.x - 32 * w : 32;
        for (int b = 0; b < end; ++b) {
          const int2 nd = nj[32 * w + b];
          float s;
          if (STAGE_X) {
            s = xs[nd.x + r];
          } else {
            s = poison(nd.x < 0 ? 0.0f : __ldg(xrow + nd.x), nf);
          }
          word |= static_cast<uint32_t>(s <= __int_as_float(nd.y)) << b;
        }
        dec[w] = word;
      }
      const uint2* lj = ls + j * L * (W + 1);
      float part = 0.0f;
      for (int l = 0; l < cnt.y; ++l, lj += W + 1) {
        uint32_t miss = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint2 m = lj[w];
          miss |= (dec[w] ^ m.x) & (m.x | m.y);
        }
        if (miss == 0) part += __uint_as_float(lj[W].x);
      }
      acc += static_cast<double>(part);
    }
  }
  if (r < rows) out[row0 + r] = __fadd_rn(static_cast<float>(acc), base);
}

template <bool STAGE_X>
__global__ void __launch_bounds__(ROWS) tree_gemm_wide_kernel(
    const float* __restrict__ x, const int2* __restrict__ nodes,
    const uint2* __restrict__ leaves, const int2* __restrict__ counts,
    float* __restrict__ out, float base, long long N, int Fx, int T, int I, int L,
    int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem);   // W * ROWS
  float* xs = reinterpret_cast<float*>(dec + W * ROWS);  // (Fx + 1) * XS

  const int r = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(N - row0 < ROWS ? N - row0 : ROWS);
  const float* xrow = x + (row0 + (r < rows ? r : rows - 1)) * Fx;
  const int nf = stage_row<STAGE_X>(x, xs, xrow, row0, rows, Fx);

  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    const int2 cnt = __ldg(counts + t);
    const int2* nt = nodes + static_cast<long long>(t) * I;
    for (int w = 0; w < W; ++w) {
      uint32_t word = 0;
      const int end = cnt.x - 32 * w < 32 ? cnt.x - 32 * w : 32;
      for (int b = 0; b < end; ++b) {
        const int2 nd = __ldg(nt + 32 * w + b);
        const bool zero = nd.x < 0 || nd.x >= Fx;
        const float s = STAGE_X ? xs[(zero ? Fx : nd.x) * XS + r]
                                : poison(zero ? 0.0f : __ldg(xrow + nd.x), nf);
        word |= static_cast<uint32_t>(s <= __int_as_float(nd.y)) << b;
      }
      dec[w * ROWS + r] = word;
    }
    const uint2* lt = leaves + static_cast<long long>(t) * L * (W + 1);
    float part = 0.0f;
    for (int l = 0; l < cnt.y; ++l, lt += W + 1) {
      uint32_t miss = 0;
      for (int w = 0; w < W && miss == 0; ++w) {
        const uint2 m = __ldg(lt + w);
        miss |= (dec[w * ROWS + r] ^ m.x) & (m.x | m.y);
      }
      if (miss == 0) part += __uint_as_float(__ldg(lt + W).x);
    }
    acc += static_cast<double>(part);
  }
  if (r < rows) out[row0 + r] = __fadd_rn(static_cast<float>(acc), base);
}

template <bool STAGE_X>
static int launch_wide(const void* x, const void* nodes, const void* leaves,
                       const void* counts, void* out, float base, long long N, int Fx,
                       int T, int I, int L, int W, void* stream) {
  static unsigned long long done = 0;  // devices whose smem limit is raised
  const size_t smem = 4 * static_cast<size_t>(W) * ROWS +
                      (STAGE_X ? 4 * static_cast<size_t>(Fx + 1) * XS : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = raven_smem_limit(tree_gemm_wide_kernel<STAGE_X>, SMEM_MAX, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((N + ROWS - 1) / ROWS);
  tree_gemm_wide_kernel<STAGE_X><<<blocks, ROWS, smem, RAVEN_STREAM(stream)>>>(
      static_cast<const float*>(x), static_cast<const int2*>(nodes),
      static_cast<const uint2*>(leaves), static_cast<const int2*>(counts),
      static_cast<float*>(out), base, N, Fx, T, I, L, W);
  RAVEN_RETURN_LAUNCH_STATUS();
}

template <int W, bool STAGE_X>
static int launch(const void* x, const void* nodes, const void* leaves,
                  const void* counts, void* out, float base, long long N, int Fx,
                  int T, int I, int L, int chunk, void* stream) {
  static unsigned long long done = 0;  // devices whose smem limit is raised
  const size_t smem =
      8 * (static_cast<size_t>(chunk) * I + static_cast<size_t>(chunk) * L * (W + 1) +
           chunk) +
      (STAGE_X ? 4 * static_cast<size_t>(Fx + 1) * XS : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        raven_smem_limit(tree_gemm_kernel<W, STAGE_X>, SMEM_MAX, &done);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((N + ROWS - 1) / ROWS);
  tree_gemm_kernel<W, STAGE_X><<<blocks, ROWS, smem, RAVEN_STREAM(stream)>>>(
      static_cast<const float*>(x), static_cast<const int2*>(nodes),
      static_cast<const uint2*>(leaves), static_cast<const int2*>(counts),
      static_cast<float*>(out), base, N, Fx, T, I, L, chunk);
  RAVEN_RETURN_LAUNCH_STATUS();
}

template <int W>
static int launch_w(bool stage_x, const void* x, const void* nodes, const void* leaves,
                    const void* counts, void* out, float base, long long N, int Fx,
                    int T, int I, int L, int chunk, void* stream) {
  return stage_x
      ? launch<W, true>(x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream)
      : launch<W, false>(x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
}

extern "C" int raven_tree_gemm(const void* x, const void* nodes, const void* leaves,
                               const void* counts, void* out, float base, long long N,
                               int Fx, int T, int I, int L, int W, int chunk,
                               int stage_x, void* stream) {
  const bool s = stage_x != 0;
  if (chunk == 0) {
    return s ? launch_wide<true>(x, nodes, leaves, counts, out, base, N, Fx, T, I, L, W, stream)
             : launch_wide<false>(x, nodes, leaves, counts, out, base, N, Fx, T, I, L, W, stream);
  }
  switch (W) {
    case 1: return launch_w<1>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    case 2: return launch_w<2>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    case 3: return launch_w<3>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    case 4: return launch_w<4>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    case 5: return launch_w<5>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    case 6: return launch_w<6>(s, x, nodes, leaves, counts, out, base, N, Fx, T, I, L, chunk, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

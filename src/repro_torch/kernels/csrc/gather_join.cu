// gather_join: dim-table equi-join on unique keys, two routes.
//
// Replaces the Pallas kernel `gather_join` of src/repro/kernels/relational.py
// (pallas_call at line 88), reached from the Join step of a pure stage.
//
// Bound on an H100: memory. Each fact row reads one int32 key and writes P
// floats and one hit byte; the dim side (sorted keys, payload, index: under
// a megabyte at M = 2^16) stays in the 50 MB L2. No arithmetic.
//
// Design: the TPU kernel builds a one-hot (rows x M) match matrix and
// gathers with one MXU matmul. Here a thread takes a row and finds its
// match's position in the sorted keys, then copies the P payload floats of
// the sorted payload (built once per dim table and payload columns), or
// zeros on a miss. Pure data movement, so the result is bitwise equal to the
// plain version on every row, misses included. Two routes, chosen by the
// wrapper:
//   * dense: where the keys' range is at most 4 M slots (and 2^24), the
//     dimsort entry holds a direct-address index (slot key - lo holds the
//     key's position or -1), and the Join step turns it, once per payload
//     columns, into records of (position, P payload floats) padded to 16
//     bytes. A row is a range check (in 64 bits: no key wraps) and one
//     16-byte load of its record from L2: one random sector a row instead
//     of two dependent ones (index, then payload), since random sectors of
//     L2, not HBM, bound this route.
//   * search: otherwise a lower-bound search, its top levels in shared
//     memory: every 2^shift-th key (at most SAMPLE keys) is staged per
//     block, a search there picks the bucket of 2^shift keys, and only
//     log2(2^shift) levels go to L2 (6 at M = 2^16 instead of 16). Blocks of
//     1,024 threads, one an SM, walk the rows grid-stride, so the staging is
//     paid once an SM.
#include "common.cuh"

constexpr int SAMPLE = 1024;        // keys staged per block on the search route
constexpr int SEARCH_THREADS = 1024;
constexpr int DENSE_THREADS = 256;

__device__ __forceinline__ void emit(const float* __restrict__ spay, long long pos,
                                     float* __restrict__ out, unsigned char* __restrict__ hit,
                                     long long n, int P) {
  const bool h = pos >= 0;
  const float* src = spay + (h ? pos : 0) * P;
  float* dst = out + n * P;
  for (int p = 0; p < P; ++p) dst[p] = h ? src[p] : 0.0f;
  hit[n] = h ? 1 : 0;
}

__global__ void __launch_bounds__(DENSE_THREADS) gather_join_dense(
    const int* __restrict__ fk, const int* __restrict__ records, long long lo,
    long long span, int width, float* __restrict__ out, unsigned char* __restrict__ hit,
    long long N, int P) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const long long off = static_cast<long long>(fk[n]) - lo;
    const bool inside = off >= 0 && off < span;
    const int* rec = records + (inside ? off : 0) * width;
    const int4 head = inside ? *reinterpret_cast<const int4*>(rec) : make_int4(-1, 0, 0, 0);
    const bool h = head.x >= 0;
    float* dst = out + n * P;
    if (P > 0) dst[0] = h ? __int_as_float(head.y) : 0.0f;
    if (P > 1) dst[1] = h ? __int_as_float(head.z) : 0.0f;
    if (P > 2) dst[2] = h ? __int_as_float(head.w) : 0.0f;
    for (int p = 3; p < P; ++p) dst[p] = h ? __int_as_float(rec[1 + p]) : 0.0f;
    hit[n] = h ? 1 : 0;
  }
}

__global__ void __launch_bounds__(SEARCH_THREADS) gather_join_search(
    const int* __restrict__ fk, const int* __restrict__ skeys, long long M, int shift,
    int n_sample, const float* __restrict__ spay, float* __restrict__ out,
    unsigned char* __restrict__ hit, long long N, int P) {
  __shared__ int sample[SAMPLE];  // skeys[k << shift]
  for (int k = threadIdx.x; k < n_sample; k += blockDim.x) {
    sample[k] = skeys[static_cast<long long>(k) << shift];
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; n < N;
       n += stride) {
    const int key = fk[n];
    int a = 0, b = n_sample;  // samples <= key
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (sample[mid] <= key) {
        a = mid + 1;
      } else {
        b = mid;
      }
    }
    // the lower bound of key lies in [(a - 1) << shift, min(M, a << shift)]
    long long lo = a == 0 ? 0 : static_cast<long long>(a - 1) << shift;
    long long hi = a == 0 ? 0 : static_cast<long long>(a) << shift;
    if (hi > M) hi = M;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (skeys[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    emit(spay, lo < M && skeys[lo] == key ? lo : -1, out, hit, n, P);
  }
}

// records == null takes the search route (`blocks` blocks), else the dense
// route over `span` records of `width` words for keys from lo.
extern "C" int raven_gather_join(const void* fk, const void* skeys, const void* spay,
                                 const void* records, long long lo, long long span,
                                 int width, void* out, void* hit, long long N, long long M,
                                 int P, int blocks, void* stream) {
  cudaStream_t st = RAVEN_STREAM(stream);
  const int* f = static_cast<const int*>(fk);
  const float* pay = static_cast<const float*>(spay);
  float* o = static_cast<float*>(out);
  unsigned char* h = static_cast<unsigned char*>(hit);
  if (records != nullptr) {
    gather_join_dense<<<raven_grid(N, DENSE_THREADS), DENSE_THREADS, 0, st>>>(
        f, static_cast<const int*>(records), lo, span, width, o, h, N, P);
  } else {
    int shift = 0;
    while (((M + (1LL << shift) - 1) >> shift) > SAMPLE) ++shift;
    const int n_sample = static_cast<int>((M + (1LL << shift) - 1) >> shift);
    gather_join_search<<<blocks, SEARCH_THREADS, 0, st>>>(
        f, static_cast<const int*>(skeys), M, shift, n_sample, pay, o, h, N, P);
  }
  RAVEN_RETURN_LAUNCH_STATUS();
}

// gather_join: dim-table equi-join on unique sorted keys.
//
// Replaces the Pallas kernel `gather_join` of src/repro/kernels/relational.py
// (pallas_call at line 88), reached from the Join step of a pure stage.
//
// Bound on an H100: memory. Each fact row reads one int32 key and writes P
// floats and one hit byte; the sorted dim keys and payload (M * (1 + P) * 4
// bytes, 768 KB at M = 2^16, P = 2) stay in the 50 MB L2. No arithmetic.
//
// Design: the TPU kernel builds a one-hot (rows x M) match matrix and gathers
// with one MXU matmul, which is exact only because the matrix unit keeps
// full fp32. Here each thread takes one row, binary-searches the sorted keys
// (log2 M dependent loads, served from L2) and copies the P payload values
// of the match, or zeros on a miss. Pure data movement, so the result is
// bitwise equal to the plain version on every row, misses included.
#include "common.cuh"

__global__ void gather_join_kernel(const int* __restrict__ fk,
                                   const int* __restrict__ skeys,
                                   const float* __restrict__ spay,
                                   float* __restrict__ out,
                                   unsigned char* __restrict__ hit, long long N,
                                   long long M, int P) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       n < N; n += stride) {
    const int key = fk[n];
    long long lo = 0, hi = M;  // lower bound of key in skeys
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (skeys[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const bool h = lo < M && skeys[lo] == key;
    const float* src = spay + lo * P;
    float* dst = out + n * P;
    for (int p = 0; p < P; ++p) dst[p] = h ? src[p] : 0.0f;
    hit[n] = h ? 1 : 0;
  }
}

extern "C" int raven_gather_join(const void* fk, const void* skeys,
                                 const void* spay, void* out, void* hit,
                                 long long N, long long M, int P, void* stream) {
  const int threads = 256;
  gather_join_kernel<<<raven_grid(N, threads), threads, 0, RAVEN_STREAM(stream)>>>(
      static_cast<const int*>(fk), static_cast<const int*>(skeys),
      static_cast<const float*>(spay), static_cast<float*>(out),
      static_cast<unsigned char*>(hit), N, M, P);
  RAVEN_RETURN_LAUNCH_STATUS();
}

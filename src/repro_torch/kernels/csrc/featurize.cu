// featurize: fused scaler + one-hot + concat, numerics first.
//
// Replaces the Pallas kernel `featurize` of src/repro/kernels/featurize.py
// (pallas_call at line 82), reached from the MLtoDNN tensor program.
//
// Bound on an H100: memory. Per row it reads Kn floats and Kc int32 codes and
// writes Kn + Vtot floats, and does two flops per numeric column, so on the
// hospital query's path (Kn = 9, Kc = 14, Vtot = 40) it moves ~250 bytes per
// row for ~60 operations: far below the card's ~20 flop/byte ridge for fp32.
//
// Design: one thread per output element, so neighbouring threads write
// neighbouring addresses of the row-major (N, Kn + Vtot) output and the
// stores coalesce; the inputs of a row are re-read by its Kn + Vtot threads
// and come from L1/L2. The static (start, length) segments of the Pallas
// kernel become `val_col`, one int32 per one-hot column naming the
// categorical input it tests, built once on the device by the program that
// owns the kernel. The scaler runs as round-to-nearest sub then mul
// (__fsub_rn/__fmul_rn: no FMA contraction), which is the plain version's
// arithmetic, so the output is bitwise equal to it.
#include "common.cuh"

__global__ void featurize_kernel(const float* __restrict__ num,
                                 const int* __restrict__ cat,
                                 const float* __restrict__ offset,
                                 const float* __restrict__ scale,
                                 const int* __restrict__ cat_values,
                                 const int* __restrict__ val_col,
                                 float* __restrict__ out, long long N, int Kn,
                                 int Kc, int Vtot) {
  const int F = Kn + Vtot;
  const long long total = N * F;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long n = e / F;
    const int j = static_cast<int>(e - n * F);
    float v;
    if (j < Kn) {
      v = __fmul_rn(__fsub_rn(num[n * Kn + j], offset[j]), scale[j]);
    } else {
      const int k = j - Kn;
      v = (cat[n * Kc + val_col[k]] == cat_values[k]) ? 1.0f : 0.0f;
    }
    out[e] = v;
  }
}

extern "C" int raven_featurize(const void* num, const void* cat,
                               const void* offset, const void* scale,
                               const void* cat_values, const void* val_col,
                               void* out, long long N, int Kn, int Kc, int Vtot,
                               void* stream) {
  const int threads = 256;
  const long long total = N * static_cast<long long>(Kn + Vtot);
  featurize_kernel<<<raven_grid(total, threads), threads, 0, RAVEN_STREAM(stream)>>>(
      static_cast<const float*>(num), static_cast<const int*>(cat),
      static_cast<const float*>(offset), static_cast<const float*>(scale),
      static_cast<const int*>(cat_values), static_cast<const int*>(val_col),
      static_cast<float*>(out), N, Kn, Kc, Vtot);
  RAVEN_RETURN_LAUNCH_STATUS();
}

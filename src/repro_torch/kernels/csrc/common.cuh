// Shared by every kernel source of libraven_kernels.so.
#pragma once
#include <cuda_runtime.h>

// Each C entry point launches on the caller's stream (PyTorch's current
// stream, passed as an opaque pointer) and returns cudaGetLastError(), so a
// launch the driver refuses is reported to the Python wrapper, which raises.
#define RAVEN_STREAM(s) (reinterpret_cast<cudaStream_t>(s))
#define RAVEN_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

// Grid for a grid-stride loop over `work` items: enough blocks to fill the
// card several times over, never more than the work needs.
static inline unsigned raven_grid(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// Raises a kernel's dynamic shared-memory limit the first time it is launched
// on each device, not on every call (`done` is the caller's static bit set of
// devices): the call is not stream-ordered, and leaving it out of later calls
// keeps their launch path short and capturable into a CUDA graph.
template <typename F>
static inline cudaError_t raven_smem_limit(F* kernel, int bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    *done |= bit;
  } else {
    cudaGetLastError();  // reported here: a later launch must not report it again
  }
  return err;
}

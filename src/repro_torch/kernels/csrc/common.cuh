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

// A persistent grid for a grid-stride kernel: as many blocks as the card
// keeps resident at once (SM count x resident blocks per SM, from the
// occupancy calculator), queried once per device and kernel and cached.
// A kernel launched with it walks its work in a loop, so a list padded to
// its cap costs a few hundred blocks, not one block per slot of the cap.

#pragma once

#include <cuda_runtime.h>

namespace kt {

constexpr int kMaxDevices = 64;

// cache: one zeroed array per kernel (a static at the call site);
// max_per_sm > 0 caps the resident blocks an SM. Returns 0 if the query
// failed; the caller's cudaGetLastError() reports why.
template <typename Kernel>
inline int persistent_blocks(Kernel kernel, int threads, int* cache,
                             int max_per_sm = 0) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      0) != cudaSuccess)
      return 0;
    if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

}  // namespace kt

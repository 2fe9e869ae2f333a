// Launch helpers shared by every CUDA source of the port.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rhss {

constexpr int kThreads = 256;  // threads per block of every kernel here

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Blocks for a grid-stride loop over n_vec items at kThreads a block: enough
// resident blocks to fill every SM several times over; the loop covers the
// rest.
inline int grid_for(int64_t n_vec) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * 8;
  }
  const int64_t need = (n_vec + kThreads - 1) / kThreads;
  return (int)(need < max_blocks ? need : max_blocks);
}

}  // namespace rhss

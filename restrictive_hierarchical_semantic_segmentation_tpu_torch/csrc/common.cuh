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

// One kernel's set-up on each device it runs on, done once per device (the
// attributes a launch must ask for, such as dynamic shared memory above 48
// KB), and the device's SM count. A launcher keeps one static DeviceOnce.
struct DeviceOnce {
  static constexpr int kMaxDevices = 64;
  bool configured[kMaxDevices] = {};
  int sms[kMaxDevices] = {};

  // *sms_out = the current device's SM count, after setup() (returning a
  // cudaError_t) has run on it once; returns a CUDA error code, 0 on success
  template <typename Setup>
  int get(int* sms_out, Setup setup) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
      err = setup();
      if (err != cudaSuccess) return (int)err;
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err != cudaSuccess) return (int)err;
      configured[dev] = true;
    }
    *sms_out = sms[dev];
    return (int)cudaSuccess;
  }
};

}  // namespace rhss

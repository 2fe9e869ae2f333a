// Launch helpers shared by every CUDA source of the port.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rhss {

constexpr int kThreads = 256;  // threads per block of kernel 1

// The BatchNorm kernels read a contiguous (rows, C) tensor as rows of
// view_width(C) = lcm(C, 8) elements, L / C image rows each (L = C where
// C % 8 == 0), so 16-byte vectors of 8 channels never straddle a row of the
// view at any C; kernels 1 and 3 take the per-channel vectors tiled to L,
// kernel 2 (scale_bias_act.cu) takes them untiled. kMaxWidth: the
// widest view of a C that is no multiple of 8 (_MAX_WIDTH in
// ops/fused_bn_act.py).
constexpr int kMaxWidth = 16384;

inline int view_width(int channels) {
  int a = channels, b = 8;
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return channels / a * 8;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
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

// Blocks of `threads` threads and `smem` bytes one SM holds at once, asked
// of the occupancy calculator once per device and block shape.
struct Occupancy {
  static constexpr int kSlots = 64;
  int dev[kSlots], threads[kSlots], smem[kSlots], blocks[kSlots];
  int used = 0;

  int get(const void* kernel, int threads_, int smem_, int* out) {
    int d = 0;
    cudaError_t err = cudaGetDevice(&d);
    if (err != cudaSuccess) return (int)err;
    for (int i = 0; i < used; ++i) {
      if (dev[i] == d && threads[i] == threads_ && smem[i] == smem_) {
        *out = blocks[i];
        return 0;
      }
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads_, smem_);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int i = used < kSlots ? used++ : kSlots - 1;
    dev[i] = d;
    threads[i] = threads_;
    smem[i] = smem_;
    blocks[i] = per_sm;
    *out = per_sm;
    return 0;
  }
};

}  // namespace rhss

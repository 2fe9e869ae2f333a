// Per-channel scale, shift and activation over a channels_last tensor:
//     y[r, c] = act(float(x[r, c]) * scale[c] + shift[c])
// with act one of none / relu / leaky_relu(0.01), f32 math, and y in x's
// dtype (bf16 or f32). This is the eval-mode BatchNorm(+ReLU) of every conv
// in the HRNet backbone: the folded running statistics give scale and shift.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py
//   _scale_bias_act_kernel (reached through fused_scale_bias_act).
//
// Bound on the H100: memory. Each element is read once and written once and
// costs 2 flops, so the least time is 2 * numel * elem_bytes / 3.35 TB/s.
//
// Design for this card, not the TPU's tiles:
//  * no padding of the row count to a tile multiple (the TPU version pads to
//    a multiple of its row tile); a grid-stride loop covers rows * C / VEC
//    vectors and stops at the exact end;
//  * each thread loads and stores 16 bytes at a time (8 bf16 or 4 f32).
//    The tensor is read as rows of L = lcm(C, 8) elements (L / C image rows
//    each; L = C where C % 8 == 0), and scale and shift come tiled to L by
//    the wrapper, so a vector never straddles a row of the view and its
//    per-channel values are those at its column .. column + VEC - 1, at any
//    C. The last numel mod VEC elements (none where C % 8 == 0) are a scalar
//    tail in the same launch, taken by the first block's first threads of
//    the TAIL instantiation; where C % 8 == 0 the launch is the one without
//    it, so that path is what it was before any C was taken;
//  * scale and shift (L floats each, at most 64 KB) go through the
//    read-only data cache with __ldg and stay resident in L1.
//
// Plain C interface for ctypes: the function returns cudaGetLastError()
// after the launch (0 on success), and cudaErrorInvalidValue for arguments
// it does not take. It launches on the caller's stream and does not
// synchronise.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using rhss::grid_for;
using rhss::kThreads;
using rhss::ldg4;
using rhss::view_width;

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };
using rhss::kMaxWidth;

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kRelu) return y < 0.f ? 0.f : y;  // NaN passes, as max(y, 0)
  if (ACT == kLeakyRelu) return y >= 0.f ? y : 0.01f * y;
  return y;
}

// x * scale + shift rounded twice (no fused multiply-add), as the plain
// PyTorch version computes it, so the two agree bit for bit.
__device__ __forceinline__ float affine(float x, float s, float b) {
  return __fadd_rn(__fmul_rn(x, s), b);
}

// bf16: one uint4 = 8 values per thread and iteration.
template <int ACT, bool TAIL>
__global__ void __launch_bounds__(kThreads)
scale_bias_act_bf16(const uint4* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, uint4* __restrict__ y,
                    int64_t n_vec, int c_vec, int tail) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const int c = (int)(i % c_vec) * 8;
    const uint4 raw = x[i];
    const float4 s0 = ldg4(scale + c), s1 = ldg4(scale + c + 4);
    const float4 b0 = ldg4(shift + c), b1 = ldg4(shift + c + 4);
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 packed;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(in[k]);
      const float lo = activate<ACT>(affine(v.x, s[2 * k], b[2 * k]));
      const float hi = activate<ACT>(affine(v.y, s[2 * k + 1], b[2 * k + 1]));
      out[k] = __floats2bfloat162_rn(lo, hi);
    }
    y[i] = packed;
  }
  if (TAIL && blockIdx.x == 0 && (int)threadIdx.x < tail) {  // numel mod 8
    const int64_t e = n_vec * 8 + threadIdx.x;
    const int c = (int)(e % ((int64_t)c_vec * 8));
    const float v = __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(x)[e]);
    reinterpret_cast<__nv_bfloat16*>(y)[e] =
        __float2bfloat16_rn(activate<ACT>(affine(v, scale[c], shift[c])));
  }
}

// f32: one float4 = 4 values per thread and iteration.
template <int ACT, bool TAIL>
__global__ void __launch_bounds__(kThreads)
scale_bias_act_f32(const float4* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, float4* __restrict__ y,
                   int64_t n_vec, int c_vec, int tail) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const int c = (int)(i % c_vec) * 4;
    const float4 v = x[i];
    const float4 s = ldg4(scale + c);
    const float4 b = ldg4(shift + c);
    float4 o;
    o.x = activate<ACT>(affine(v.x, s.x, b.x));
    o.y = activate<ACT>(affine(v.y, s.y, b.y));
    o.z = activate<ACT>(affine(v.z, s.z, b.z));
    o.w = activate<ACT>(affine(v.w, s.w, b.w));
    y[i] = o;
  }
  if (TAIL && blockIdx.x == 0 && (int)threadIdx.x < tail) {  // numel mod 4
    const int64_t e = n_vec * 4 + threadIdx.x;
    const int c = (int)(e % ((int64_t)c_vec * 4));
    reinterpret_cast<float*>(y)[e] = activate<ACT>(
        affine(reinterpret_cast<const float*>(x)[e], scale[c], shift[c]));
  }
}

template <int ACT, bool TAIL>
void launch_view(int dtype, const void* x, const float* scale,
                 const float* shift, void* y, int64_t rows, int channels,
                 cudaStream_t stream) {
  const int64_t numel = rows * channels;
  const int width = view_width(channels);
  if (dtype == 1) {
    const int64_t n_vec = numel / 8;
    scale_bias_act_bf16<ACT, TAIL><<<grid_for(n_vec > 0 ? n_vec : 1),
                                     kThreads, 0, stream>>>(
        static_cast<const uint4*>(x), scale, shift, static_cast<uint4*>(y),
        n_vec, width / 8, (int)(numel % 8));
  } else {
    const int64_t n_vec = numel / 4;
    scale_bias_act_f32<ACT, TAIL><<<grid_for(n_vec > 0 ? n_vec : 1),
                                    kThreads, 0, stream>>>(
        static_cast<const float4*>(x), scale, shift, static_cast<float4*>(y),
        n_vec, width / 4, (int)(numel % 4));
  }
}

template <int ACT>
void launch(int dtype, const void* x, const float* scale, const float* shift,
            void* y, int64_t rows, int channels, cudaStream_t stream) {
  if (channels % 8 == 0) {
    launch_view<ACT, false>(dtype, x, scale, shift, y, rows, channels,
                            stream);
  } else {
    launch_view<ACT, true>(dtype, x, scale, shift, y, rows, channels, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// x and y: rows * channels elements, 16-byte aligned; scale and shift:
// lcm(channels, 8) floats (the channels' values tiled), 16-byte aligned;
// channels % 8 == 0 or lcm(channels, 8) <= 16384.
extern "C" int rhss_scale_bias_act(const void* x, const void* scale,
                                   const void* shift, void* y, int64_t rows,
                                   int channels, int dtype, int act,
                                   void* stream) {
  if (rows < 0 || channels <= 0 ||
      (channels % 8 != 0 && view_width(channels) > kMaxWidth) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  switch (act) {
    case kNone: launch<kNone>(dtype, x, sc, sh, y, rows, channels, s); break;
    case kRelu: launch<kRelu>(dtype, x, sc, sh, y, rows, channels, s); break;
    case kLeakyRelu:
      launch<kLeakyRelu>(dtype, x, sc, sh, y, rows, channels, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

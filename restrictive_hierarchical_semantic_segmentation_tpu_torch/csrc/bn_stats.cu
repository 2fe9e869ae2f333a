// Per-channel batch statistics of a channels_last (rows, C) tensor, for the
// train-mode BatchNorm of every conv in the HRNet backbone:
//     mean[c] = sum_r x[r, c] / n
//     var[c]  = max(sum_r x[r, c]^2 / n - mean[c]^2, 0)     (biased)
// x is bf16 or f32; the sums, mean and var are f32.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py
//   _stats_kernel (reached through bn_stats).
//
// Bound on the H100: memory. x is read once (2 flops an element), so the
// least time is numel * elem_bytes / 3.35 TB/s.
//
// Design (bn_reduce.cuh): a split column reduction. Each thread sums Σx and
// Σx² of 8 channels over a strip of rows in f32 registers, with 4 rows'
// 16-byte loads in flight; the block adds its lanes in shared memory; a
// second small kernel adds the strips in double and finalizes. At the stem
// (1,537,600 rows at batch 16 and 620 px) a thread's f32 sum covers ~90
// rows, so the sum keeps f32 accuracy without Kahan terms. The TPU kernel
// pads the row count to its tile; this one masks the ragged strip instead.
//
// Plain C interface for ctypes: each function returns cudaGetLastError()
// after its launches (0 on success), or cudaErrorInvalidValue for arguments
// it does not take. Launches go on the caller's stream; nothing synchronises
// and nothing is allocated here.
#include "bn_reduce.cuh"

namespace {

using rhss::kVec;

template <typename T>
struct StatsOp {
  static constexpr int kUnroll = 4;
  using Row = rhss::Raw<T>;
  struct State {};
  const T* __restrict__ x;

  __device__ __forceinline__ State state(int) const { return State{}; }
  __device__ __forceinline__ void load(int64_t offset, Row& row) const {
    row.load(x + offset);
  }
  __device__ __forceinline__ void add(const State&, const Row& row,
                                      float s0[kVec], float s1[kVec]) const {
    float v[kVec];
    row.to_float(v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s0[k] += v[k];
      s1[k] += v[k] * v[k];
    }
  }
};

struct StatsFin {
  float* mean;
  float* var;
  double n;
  __device__ __forceinline__ void operator()(int c, double sum,
                                             double sumsq) const {
    const double m = sum / n;
    const double v = sumsq / n - m * m;
    mean[c] = (float)m;
    var[c] = (float)(v > 0.0 ? v : 0.0);
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: rows * channels elements, 16-byte
// aligned; workspace: 2 * 528 * channels floats (bn_reduce.cuh's
// kTargetBlocks); mean, var: channels floats.
extern "C" int rhss_bn_stats(const void* x, int64_t rows, int channels,
                             int dtype, void* workspace, void* mean, void* var,
                             void* stream) {
  if (rows <= 0 || channels <= 0 || channels % kVec != 0 ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const StatsFin fin{static_cast<float*>(mean), static_cast<float*>(var),
                     (double)rows};
  if (dtype == 1) {
    const StatsOp<__nv_bfloat16> op{static_cast<const __nv_bfloat16*>(x)};
    return rhss::reduce_columns(op, fin, rows, channels, ws, s);
  }
  const StatsOp<float> op{static_cast<const float*>(x)};
  return rhss::reduce_columns(op, fin, rows, channels, ws, s);
}

// Per-channel column reduction over a channels_last (rows, C) matrix, shared
// by the BatchNorm statistics (bn_stats.cu) and the first pass of the
// BatchNorm backward (bn_backward.cu). Each reduces two f32 sums per channel.
//
// The TPU kernels carry their sums in scratch memory from one grid step to
// the next, because the TPU runs its grid in order on one core. Hopper runs
// blocks in parallel and in no order, so the reduction is split:
//  1. column_partials: block (bx, by) owns channel vectors
//     [bx * tx, (bx + 1) * tx) and a strip of rows; each thread keeps two
//     f32 sums for its 8 channels over every ty-th row of the strip, in
//     registers; the block adds its ty lanes in shared memory in a fixed
//     tree order and writes one row of partials per strip;
//  2. combine_partials: 16 row lanes per channel add the strips' partials
//     in double, then the lanes are added in a fixed tree order.
// No atomics anywhere: the result is the same from run to run.
//
// Loads are 16 bytes a thread (8 bf16, or 8 f32 as two float4), neighbouring
// threads on neighbouring channel vectors of one row, and the rows of a
// block are contiguous, so every warp reads contiguous memory. C % 8 == 0 is
// required (the Python wrapper checks it).
//
// The workspace holds 2 * kTargetBlocks * C floats: geometry() never makes
// more than kTargetBlocks strips, so the caller sizes it from C alone and
// needs no query per launch.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace rhss {

constexpr int kVec = 8;            // channels per thread
constexpr int kTargetBlocks = 528;  // 4 per SM of an H100 SXM (132 SMs)

struct Geometry {
  int tx;                  // channel vectors per block (blockDim.x)
  int ty;                  // row lanes per block (blockDim.y)
  int col_blocks;          // gridDim.x
  int row_blocks;          // gridDim.y: rows of partials in the workspace
  int64_t rows_per_block;  // a multiple of ty
};

// Splits rows >= 1 into contiguous strips of a multiple of ty rows, at
// least ty each, for `blocks` blocks over col_blocks column groups: sets
// rows_per_block and row_blocks <= max(1, blocks / col_blocks) (with per =
// ceil(rows / want), ceil(rows / per) <= want). bn_stats and the BN backward
// both split this way.
inline void split_rows(Geometry& g, int64_t rows, int blocks) {
  int64_t want = blocks / g.col_blocks;
  if (want < 1) want = 1;
  const int64_t most = (rows + g.ty - 1) / g.ty;  // >= ty rows per strip
  if (want > most) want = most;
  const int64_t per = (rows + want - 1) / want;
  g.rows_per_block = (per + g.ty - 1) / g.ty * g.ty;
  g.row_blocks = (int)((rows + g.rows_per_block - 1) / g.rows_per_block);
}

// A function of (rows, channels) only: row_blocks <= kTargetBlocks.
inline Geometry geometry(int64_t rows, int channels) {
  Geometry g;
  const int c_vec = channels / kVec;
  g.tx = c_vec < 32 ? c_vec : 32;
  g.ty = kThreads / g.tx;
  g.col_blocks = (c_vec + g.tx - 1) / g.tx;
  split_rows(g, rows, kTargetBlocks);
  return g;
}

// 8 consecutive f32 values (two aligned float4 loads)
__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = ldg4(p), b = ldg4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 raw values of one row: one uint4 of bf16 or two float4 of f32
template <typename T>
struct Raw;

template <>
struct Raw<__nv_bfloat16> {
  uint4 q;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    q = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_float(float v[kVec]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = ldg4(p);
    b = ldg4(p + 4);
  }
  __device__ __forceinline__ void to_float(float v[kVec]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// Pass 1. Op supplies:
//   Op::kUnroll                          rows in flight per thread
//   typename Op::Row                     what one row's load holds
//   typename Op::State                   per-thread constants of channels
//                                        c..c+7, from State state(int c)
//   void load(int64_t offset, Row&)      offset = row * C + c
//   void add(const State&, const Row&, float s0[8], float s1[8])
// partial: [2][row_blocks][C] f32.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
column_partials(Op op, int64_t rows, int channels, int64_t rows_per_block,
                int row_blocks, float* __restrict__ partial) {
  const int c_vec = channels / kVec;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = v < c_vec;
  const int c = v * kVec;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int ty = blockDim.y;

  float s0[kVec], s1[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s0[k] = s1[k] = 0.f;

  if (active) {
    const typename Op::State st = op.state(c);
    constexpr int U = Op::kUnroll;
    for (int64_t r = r0 + threadIdx.y; r < r1; r += (int64_t)U * ty) {
      typename Op::Row row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // all loads first: U in flight
        const int64_t rr = r + (int64_t)u * ty;
        if (rr < r1) op.load(rr * channels + c, row[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + (int64_t)u * ty < r1) op.add(st, row[u], s0, s1);
      }
    }
  }

  // add the ty lanes of each channel in shared memory: [k][lane] layout, so
  // neighbouring threads touch neighbouring words (no bank conflicts)
  __shared__ float sh0[kVec * kThreads];
  __shared__ float sh1[kVec * kThreads];
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sh0[k * kThreads + t] = s0[k];
    sh1[k * kThreads + t] = s1[k];
  }
  __syncthreads();
  int half = 1;
  while (half * 2 < ty) half *= 2;
  for (; half > 0; half >>= 1) {  // fixed order; ty need not be a power of 2
    if (threadIdx.y < half && threadIdx.y + half < ty) {
      const int o = t + half * blockDim.x;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        sh0[k * kThreads + t] += sh0[k * kThreads + o];
        sh1[k * kThreads + t] += sh1[k * kThreads + o];
      }
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && active) {
    float* p0 = partial + (int64_t)blockIdx.y * channels + c;
    float* p1 = partial + ((int64_t)row_blocks + blockIdx.y) * channels + c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      p0[k] = sh0[k * kThreads + t];
      p1[k] = sh1[k * kThreads + t];
    }
  }
}

// Pass 2: the strips' partials of each channel, in double. A group of
// kCombineX * kCombineY threads owns kCombineX neighbouring channels
// (neighbouring threads read neighbouring words); its kCombineY row lanes
// each add every kCombineY-th strip, and the lanes are then added in shared
// memory in a fixed tree order, so the result does not depend on
// scheduling. One thread per channel would add ~500 strips as a chain of
// dependent loads.
// Fin: void operator()(int c, double sum0, double sum1).
constexpr int kCombineX = 32;
constexpr int kCombineY = 16;

// Channels [grp * kCombineX, + kCombineX) by the block's threads, all of
// which call it (lane = thread index < kCombineX * kCombineY); sa and sb:
// kCombineX * kCombineY doubles of shared memory each, free again on
// return. The partials may have been written earlier in the same launch, so
// they are read through L2 (__ldcg).
template <typename Fin>
__device__ __forceinline__ void combine_group(const float* partial,
                                              int row_blocks, int channels,
                                              int grp, int lane, double* sa,
                                              double* sb, const Fin& fin) {
  const int cx = lane % kCombineX, cy = lane / kCombineX;
  const int c = grp * kCombineX + cx;
  double a = 0.0, b = 0.0;
  if (c < channels) {
#pragma unroll 4
    for (int i = cy; i < row_blocks; i += kCombineY) {
      a += __ldcg(partial + (int64_t)i * channels + c);
      b += __ldcg(partial + ((int64_t)row_blocks + i) * channels + c);
    }
  }
  sa[lane] = a;
  sb[lane] = b;
  __syncthreads();
  for (int half = kCombineY / 2; half > 0; half >>= 1) {
    if (cy < half) {
      sa[lane] += sa[lane + half * kCombineX];
      sb[lane] += sb[lane + half * kCombineX];
    }
    __syncthreads();
  }
  if (cy == 0 && c < channels) fin(c, sa[lane], sb[lane]);
  __syncthreads();
}

template <typename Fin>
__global__ void __launch_bounds__(kCombineX * kCombineY)
combine_partials(const float* __restrict__ partial, int row_blocks,
                 int channels, Fin fin) {
  __shared__ double sa[kCombineY * kCombineX];
  __shared__ double sb[kCombineY * kCombineX];
  combine_group(partial, row_blocks, channels, blockIdx.x,
                threadIdx.y * kCombineX + threadIdx.x, sa, sb, fin);
}

// Launch both passes on `stream`; returns cudaGetLastError() after them.
// workspace: 2 * kTargetBlocks * channels floats.
template <typename Op, typename Fin>
int reduce_columns(const Op& op, const Fin& fin, int64_t rows, int channels,
                   float* workspace, cudaStream_t stream) {
  const Geometry g = geometry(rows, channels);
  if (g.row_blocks > kTargetBlocks) return (int)cudaErrorInvalidValue;
  const dim3 block(g.tx, g.ty);
  const dim3 grid(g.col_blocks, g.row_blocks);
  column_partials<Op><<<grid, block, 0, stream>>>(
      op, rows, channels, g.rows_per_block, g.row_blocks, workspace);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_partials<Fin><<<(channels + kCombineX - 1) / kCombineX,
                          dim3(kCombineX, kCombineY), 0, stream>>>(
      workspace, g.row_blocks, channels, fin);
  return (int)cudaGetLastError();
}

}  // namespace rhss

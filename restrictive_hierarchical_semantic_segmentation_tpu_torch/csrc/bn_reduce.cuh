// Pieces of the per-channel column reduction over a channels_last (rows, C)
// matrix that the BatchNorm statistics (bn_stats.cu) and the BatchNorm
// backward (bn_backward.cu) share. Each reduces two f32 sums per channel.
//
// The TPU kernels carry their sums in scratch memory from one grid step to
// the next, because the TPU runs its grid in order on one core. Hopper runs
// blocks in parallel and in no order, so both kernels split the rows into
// contiguous strips (split_rows): block (bx, by) owns channel vectors of 8
// channels (16-byte loads, Raw) and strip by, sums them in f32 registers,
// adds its row lanes in shared memory in a fixed tree order and writes one
// row of partials; the strips' partials are then added in double in a fixed
// order (bn_stats.cu: by the last block of each column group to arrive,
// last_ticket; the BN backward's fused pass: by every block after a grid
// barrier, combine_group; its reduce entry: by the last blocks of each
// chain of strips and column group, in combine_group's order). No float
// atomics anywhere: the result is the same from run to run.
//
// Loads are 16 bytes a thread (8 bf16, or 8 f32 as two float4), neighbouring
// threads on neighbouring channel vectors of one row, and the rows of a
// block are contiguous, so every warp reads contiguous memory. At any C the
// kernels reduce the view of rows of L = lcm(C, 8) columns (common.cuh:
// view_width; L = C where C % 8 == 0) over its floor(rows / (L / C)) whole
// rows; where L > C the blocks that draw the last tickets then fold the L / C
// columns of each channel (fold_columns, in a fixed order) and add the last
// rows mod (L / C) image rows, the tail, one by one.
//
// The workspace holds 2 * kTargetBlocks * C floats: neither kernel makes
// more than kTargetBlocks strips (the BN backward keeps two more rows), so
// the caller sizes it from C alone (_MAX_STRIPS in ops/fused_bn_act.py must
// equal kTargetBlocks) and needs no query per launch.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace rhss {

constexpr int kVec = 8;            // channels per thread
constexpr int kTargetBlocks = 528;  // 4 per SM of an H100 SXM (132 SMs)
// column groups of 32 channel vectors that the ticket counters cover
// (C <= 64 * 32 * kVec; _STATS_GROUPS in ops/fused_bn_act.py)
constexpr int kMaxGroups = 64;
// a stream's counters: per column group the statistics kernel's group and
// chunk counters (bn_stats.cu; the BN backward's reduce entry uses the first
// 64 * 17), then the one both draw from to fold the columns of a view wider
// than C (_COUNTERS_PER_STREAM in ops/fused_bn_act.py)
constexpr int kFoldCounter = kMaxGroups * (1 + (kTargetBlocks + 15) / 16);

struct Geometry {
  int tx;                  // channel vectors per block
  int ty;                  // row lanes per block
  int col_blocks;          // column groups
  int row_blocks;          // strips: rows of partials in the workspace
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

// 8 consecutive f32 values (two aligned float4 loads)
__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = ldg4(p), b = ldg4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 f32 values written earlier in the same launch, read through L2 (past
// the non-coherent read-only path): two 16-byte loads
__device__ __forceinline__ void load8_cg(const float* p, float v[kVec]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
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

// A value of x's dtype in f32, and back (round to nearest even)
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The two double sums of channel ch of a view `width` columns wide, from
// its columns' sums cols ([2][width] doubles, written earlier in the same
// launch): columns ch, ch + C, ... in that order.
__device__ __forceinline__ void fold_columns(const double* cols, int width,
                                             int C, int ch, double& a,
                                             double& b) {
  a = 0.0;
  b = 0.0;
  for (int j = ch; j < width; j += C) {
    a += __ldcg(cols + j);
    b += __ldcg(cols + width + j);
  }
}

// A ticket for the whole block from *counter, one of n: true for the block
// that draws the last one, which also sets the counter back to 0 (every
// ticket has been drawn). Release-acquire at gpu scope by one thread after
// a block barrier: the block's earlier writes are visible to the block that
// draws the last ticket, and that block's later reads see every writer's.
__device__ __forceinline__ bool last_ticket(int* counter, int n) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    last = old == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  return last;
}

// The BN backward's combine: the strips' partials of each channel, in
// double. A group of kCombineX * kCombineY threads owns kCombineX
// neighbouring channels (neighbouring threads read neighbouring words); its
// kCombineY row lanes each add every kCombineY-th strip, and the lanes are
// then added in shared memory in a fixed tree order, so the result does not
// depend on scheduling.
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

}  // namespace rhss

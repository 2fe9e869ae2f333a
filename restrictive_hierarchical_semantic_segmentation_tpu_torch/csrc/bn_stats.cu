// Per-channel batch statistics of a channels_last (rows, C) tensor, for the
// train-mode BatchNorm of every conv in both donors:
//     mean[c] = sum_r x[r, c] / n
//     var[c]  = max(sum_r x[r, c]^2 / n - mean[c]^2, 0)     (biased)
// x is bf16 or f32; the sums, mean and var are f32.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py:51
//   _stats_kernel (reached through bn_stats, :67).
//
// Bound on the H100 SXM: memory. x is read once (2 flops an element), so the
// least time is numel * elem_bytes / 3.35 TB/s. The train steps call it once
// per BatchNorm, mostly on a few MB (W48: 225 of its 306 calls have a bound
// under 10 us), so a fixed cost per call weighs as much as the streaming.
//
// Design: one launch per call, its grid sized by the call's bytes.
//  * Block (bx, by) owns the channel vectors of column group bx (8
//    channels, 16 bytes of bf16, a thread; at most 32 vectors a group,
//    balanced, on tx lanes, tx the power of 2 at or above them) and a
//    contiguous strip of rows. Each thread keeps 128 bytes of its rows in
//    flight (8 rows of bf16, 4 of f32), adds each such round pairwise and
//    the rounds into two f32 sums; the block adds its row lanes with warp
//    shuffles and then across its 8 warps, in a fixed order, and writes one
//    row of partials.
//  * Strips: as many as give each thread one round, at most one wave (2
//    blocks of 256 threads per SM) and at most kTargetBlocks (bn_reduce.cuh).
//  * The partials are combined in double by the blocks that arrive last, in
//    two levels so that no block reads more than 16 strips' or 33 chunks'
//    partials: each block draws a ticket (an integer atomic, release-acquire
//    at gpu scope, by one thread) from its chunk of 16 strips; the last of a
//    chunk adds the chunk's partials and, if its column group has more than
//    one chunk, writes them and draws a ticket from the group; the last of
//    the group adds the chunks' sums and writes mean and var. Whoever draws
//    the last ticket sets that counter back to 0. A combining block adds on
//    4 row lanes (each every 4th row of partials) and then a fixed tree:
//    more lanes made the tree cost more than the loads saved, fewer made
//    the chain of L2 round trips longer. Which block combines changes the
//    order of no add, and there are no float atomics: the result is the
//    same bits from run to run.
// The counters must be 0 before every launch; the Python wrapper keeps a
// zeroed buffer per (device, stream), and every launch leaves it at 0 again,
// so a launch captured in a CUDA graph replays.
//
// The sums entry (rhss_bn_stats_sums) is the same launch with another last
// step: the column groups' last blocks write the double sums (Σx, Σx²) and n
// instead of mean and var, for a caller that adds them over the ranks of a
// data-parallel group before forming the statistics (global-batch BatchNorm,
// ops/fused_bn_act.py:sync_batch_norm_act). Mean and var are formed with
// explicit __dmul_rn / __dsub_rn (no contraction into an fma), so the caller's
// f64 arithmetic on the sums of one rank gives the same bits as this kernel.
//
// Any C: the blocks reduce the view of rows of L = lcm(C, 8) columns
// (bn_reduce.cuh) over its whole rows, exactly as above with L for C. Where
// L > C the column groups' last blocks write their columns' double sums, and
// the block that draws the last ticket of a third counter (kFoldCounter)
// folds the L / C columns of each channel in order and adds the tail's rows
// (fewer than L / C) one by one before the last step; n stays the count of
// image rows. Where C % 8 == 0 none of this runs: L = C, no tail.
//
// What it cannot do: the smallest calls (under ~1 MB) still pay a launch,
// one round trip to device memory and one or two through L2 and the
// atomics, several times their bound (PERF.md). lcm(C, 8) must be at most
// 16384 (kMaxGroups column groups): any C up to 2048, multiples of 8 up to
// 16384.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.
// The launch goes on the caller's stream; nothing synchronises and nothing is
// allocated here.
#include "bn_reduce.cuh"

namespace {

using rhss::kMaxGroups;
using rhss::kThreads;
using rhss::kVec;
using rhss::Raw;

constexpr int kBlocksPerSm = 2;
constexpr int kRoundBytes = 128;  // of x in flight per thread
constexpr int kChunk = 16;        // strips a chunk's last block adds
constexpr int kCombineLanes = 4;  // row lanes of a combining block
constexpr int kMaxChunks = (rhss::kTargetBlocks + kChunk - 1) / kChunk;
// per column group: the group's ticket counter, then one per chunk
constexpr int kGroupCounters = 1 + kMaxChunks;
static_assert(rhss::kFoldCounter == kMaxGroups * kGroupCounters,
              "the fold counter follows the column groups' counters");
static_assert(rhss::kMaxWidth == kMaxGroups * 32 * kVec,
              "the widest view fills the counters' column groups");

// rows a thread keeps in flight
template <typename T>
__host__ __device__ constexpr int rows_in_flight() {
  return kRoundBytes / (int)sizeof(Raw<T>);
}

struct Args {
  const void* x;
  float* partial;  // [2][row_blocks][channels]
  double* chunks;  // [2][chunks][channels]
  double* cols;    // [2][channels]: the view's column sums, to fold
  int* counters;   // [col_blocks][kGroupCounters], then kFoldCounter: 0
                   // before and after
  float* mean;
  float* var;
  double* sums;  // non-null: [Σx (C), Σx² (C), n] instead of mean and var
  int64_t rows;  // whole rows of the view
  int64_t n;     // image rows
  int64_t rows_per_block;
  int channels;  // the view's width L = lcm(c, 8)
  int c;         // the tensor's channels
  int tail_rows;  // image rows after the view's last whole row
  int tx, ty, row_blocks;
  int vecs;  // channel vectors of a column group, <= tx
};

// Σx and Σx² of one thread's 8 channels over rows [0, N) of a round, added
// pairwise (a fixed order)
template <typename T, int N>
struct RoundSum {
  static __device__ __forceinline__ void add(const Raw<T>* row,
                                             float a[kVec], float q[kVec]) {
    float a2[kVec], q2[kVec];
    RoundSum<T, N / 2>::add(row, a, q);
    RoundSum<T, N - N / 2>::add(row + N / 2, a2, q2);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      a[k] += a2[k];
      q[k] += q2[k];
    }
  }
};

template <typename T>
struct RoundSum<T, 1> {
  static __device__ __forceinline__ void add(const Raw<T>* row,
                                             float a[kVec], float q[kVec]) {
    row->to_float(a);
#pragma unroll
    for (int k = 0; k < kVec; ++k) q[k] = a[k] * a[k];
  }
};

// Adds the ty row lanes of each channel in shared memory (sh: 2 * kVec *
// kThreads values, [k][thread], so neighbouring threads touch neighbouring
// words) in a fixed tree order; ty need not be a power of 2. Lane 0 gets the
// block's sums back in s0, s1. Every thread of the block calls it.
template <typename S>
__device__ __forceinline__ void add_lanes(S* sh, S s0[kVec], S s1[kVec],
                                          int t, int y, int tx, int ty) {
  S* sh1 = sh + kVec * kThreads;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sh[k * kThreads + t] = s0[k];
    sh1[k * kThreads + t] = s1[k];
  }
  __syncthreads();
  int half = 1;
  while (half * 2 < ty) half *= 2;
  for (; half > 0; half >>= 1) {
    if (y < half && y + half < ty) {
      const int o = t + half * tx;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        sh[k * kThreads + t] += sh[k * kThreads + o];
        sh1[k * kThreads + t] += sh1[k * kThreads + o];
      }
    }
    __syncthreads();
  }
  if (y == 0) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s0[k] = sh[k * kThreads + t];
      s1[k] = sh1[k * kThreads + t];
    }
  }
}

// 8 partial sums written earlier in this launch, in double
__device__ __forceinline__ void load_part(const float* p, double v[kVec]) {
  float f[kVec];
  rhss::load8_cg(p, f);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = f[k];
}
__device__ __forceinline__ void load_part(const double* p, double v[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const double2 d = __ldcg(reinterpret_cast<const double2*>(p) + j);
    v[2 * j] = d.x;
    v[2 * j + 1] = d.y;
  }
}

// Rows [first, first + count) of partials part ([2][total][C]) of this
// thread's 8 channels, in double in a fixed order (row lane y <
// kCombineLanes takes every kCombineLanes-th row, then add_lanes): lane 0
// gets the sums in d0, d1.
template <typename P>
__device__ __forceinline__ void combine(const P* part, int64_t total,
                                        int first, int count, int C, int c,
                                        bool active, int t, int y, int tx,
                                        int ty, double* lanes,
                                        double d0[kVec], double d1[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) d0[k] = d1[k] = 0.0;
  const int lanes_used = ty < kCombineLanes ? ty : kCombineLanes;
  if (active && y < lanes_used) {
#pragma unroll 4
    for (int i = y; i < count; i += lanes_used) {
      double p[kVec], q[kVec];
      load_part(part + (int64_t)(first + i) * C + c, p);
      load_part(part + (total + first + i) * C + c, q);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        d0[k] += p[k];
        d1[k] += q[k];
      }
    }
  }
  add_lanes(lanes, d0, d1, t, y, tx, lanes_used);
}

// The block's sums of each channel vector over its ty row lanes (tx a power
// of 2, so lane x of every row of a warp is x + k tx): warp shuffles add
// the rows of each warp, then the threads of row 0 (t < tx) add the 8
// warps' sums in order. w: 2 * 8 * kVec * 32 floats of shared memory.
__device__ __forceinline__ void add_rows(float* w, float s0[kVec],
                                         float s1[kVec], int t, int tx) {
  constexpr int kWarps = kThreads / 32;
  float* w1 = w + kWarps * kVec * 32;
  for (int off = tx; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], off);
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
    }
  }
  const int warp = t / 32, lane = t % 32;
  if (lane < tx) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      w[(warp * kVec + k) * 32 + lane] = s0[k];
      w1[(warp * kVec + k) * 32 + lane] = s1[k];
    }
  }
  __syncthreads();
  if (t < tx) {
    for (int i = 1; i < kWarps; ++i) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s0[k] += w[(i * kVec + k) * 32 + t];
        s1[k] += w1[(i * kVec + k) * 32 + t];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_stats_one_pass(const Args a) {
  constexpr int U = rows_in_flight<T>();
  __shared__ double lanes[2 * kVec * kThreads];
  const int t = threadIdx.x;
  const int tx = a.tx, ty = a.ty, C = a.channels, R = a.row_blocks;
  const int x = t % tx, y = t / tx;
  const int v = blockIdx.x * a.vecs + x;
  const bool active = x < a.vecs && v < C / kVec;
  const int c = v * kVec;
  const int by = blockIdx.y;
  const int64_t r0 = (int64_t)by * a.rows_per_block;
  const int64_t r1 =
      r0 + a.rows_per_block < a.rows ? r0 + a.rows_per_block : a.rows;

  float s0[kVec], s1[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s0[k] = s1[k] = 0.f;
  if (active) {
    const T* xs = static_cast<const T*>(a.x) + c;
    for (int64_t r = r0 + y; r < r1; r += (int64_t)U * ty) {
      Raw<T> row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // all loads first: U in flight
        const int64_t rr = r + (int64_t)u * ty;
        if (rr < r1) {
          row[u].load(xs + rr * C);
        } else {
          row[u] = Raw<T>{};  // past the strip: adds zeros
        }
      }
      float p0[kVec], p1[kVec];
      RoundSum<T, U>::add(row, p0, p1);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s0[k] += p0[k];
        s1[k] += p1[k];
      }
    }
  }

  // the strip's partials
  add_rows(reinterpret_cast<float*>(lanes), s0, s1, t, tx);
  if (y == 0 && active) {
    float* p0 = a.partial + (int64_t)by * C + c;
    float* p1 = a.partial + ((int64_t)R + by) * C + c;
    *reinterpret_cast<float4*>(p0) = make_float4(s0[0], s0[1], s0[2], s0[3]);
    *reinterpret_cast<float4*>(p0 + 4) = make_float4(s0[4], s0[5], s0[6], s0[7]);
    *reinterpret_cast<float4*>(p1) = make_float4(s1[0], s1[1], s1[2], s1[3]);
    *reinterpret_cast<float4*>(p1 + 4) = make_float4(s1[4], s1[5], s1[6], s1[7]);
  }

  // the chunk's last block adds the chunk's strips
  int* cnt = a.counters + blockIdx.x * kGroupCounters;
  const int chunk = by / kChunk, first = chunk * kChunk;
  const int count = R - first < kChunk ? R - first : kChunk;
  const int n_chunks = (R + kChunk - 1) / kChunk;
  if (!rhss::last_ticket(cnt + 1 + chunk, count)) return;
  double d0[kVec], d1[kVec];
  combine(a.partial, R, first, count, C, c, active, t, y, tx, ty, lanes, d0,
          d1);

  // with more than one chunk, the group's last chunk adds the chunks' sums
  if (n_chunks > 1) {
    if (y == 0 && active) {
      double* q0 = a.chunks + (int64_t)chunk * C + c;
      double* q1 = a.chunks + ((int64_t)n_chunks + chunk) * C + c;
#pragma unroll
      for (int k = 0; k < kVec; k += 2) {
        *reinterpret_cast<double2*>(q0 + k) = make_double2(d0[k], d0[k + 1]);
        *reinterpret_cast<double2*>(q1 + k) = make_double2(d1[k], d1[k + 1]);
      }
    }
    if (!rhss::last_ticket(cnt, n_chunks)) return;
    combine(a.chunks, n_chunks, 0, n_chunks, C, c, active, t, y, tx, ty,
            lanes, d0, d1);
  }
  // channel ch's sums: the double sums, or mean and var
  const auto finish = [&](int ch, double sx, double sq) {
    if (a.sums != nullptr) {
      a.sums[ch] = sx;
      a.sums[a.c + ch] = sq;
      return;
    }
    const double inv_n = 1.0 / (double)a.n;
    const double m = __dmul_rn(sx, inv_n);
    const double var = __dsub_rn(__dmul_rn(sq, inv_n), __dmul_rn(m, m));
    a.mean[ch] = (float)m;
    a.var[ch] = (float)(var > 0.0 ? var : 0.0);
  };
  if (a.c == C) {  // the view is the tensor
    if (y == 0 && active) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) finish(c + k, d0[k], d1[k]);
      // n once: by the last block of column group 0
      if (a.sums != nullptr && blockIdx.x == 0 && t == 0)
        a.sums[2 * C] = (double)a.n;
    }
    return;
  }

  // a view wider than C: the last column group to finish folds every
  // channel's columns and adds the tail's rows
  if (y == 0 && active) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      a.cols[c + k] = d0[k];
      a.cols[C + c + k] = d1[k];
    }
  }
  if (!rhss::last_ticket(a.counters + rhss::kFoldCounter, gridDim.x)) return;
  const T* tail = static_cast<const T*>(a.x) + a.rows * C;
  for (int ch = t; ch < a.c; ch += kThreads) {
    double sx, sq;
    rhss::fold_columns(a.cols, C, a.c, ch, sx, sq);
    for (int r = 0; r < a.tail_rows; ++r) {
      const float v = rhss::to_float(tail[(int64_t)r * a.c + ch]);
      sx += v;
      sq += __fmul_rn(v, v);
    }
    finish(ch, sx, sq);
  }
  if (a.sums != nullptr && t == 0) a.sums[2 * a.c] = (double)a.n;
}

struct Geometry : rhss::Geometry {
  int vecs;
};

// A function of (rows, channels, dtype, SM count): strips of one round per
// thread, at most one wave and at most kTargetBlocks blocks.
Geometry geometry(int64_t rows, int channels, int in_flight, int sms) {
  Geometry g;
  const int c_vec = channels / kVec;
  g.col_blocks = (c_vec + 31) / 32;
  g.vecs = (c_vec + g.col_blocks - 1) / g.col_blocks;
  g.tx = 1;
  while (g.tx < g.vecs) g.tx *= 2;
  g.ty = kThreads / g.tx;
  const int64_t round = (int64_t)g.ty * in_flight;
  int64_t strips = (rows + round - 1) / round;
  int64_t wave = (int64_t)sms * kBlocksPerSm;
  if (wave > rhss::kTargetBlocks) wave = rhss::kTargetBlocks;
  wave /= g.col_blocks;
  if (wave < 1) wave = 1;
  if (strips > wave) strips = wave;
  rhss::split_rows(g, rows, (int)(strips * g.col_blocks));
  return g;
}

template <typename T>
int launch(const void* x, int64_t rows, int channels, float* ws,
           int* counters, float* mean, float* var, double* sums,
           cudaStream_t s) {
  static rhss::DeviceOnce once;
  int sms = 0;
  const int set = once.get(&sms, [] { return cudaSuccess; });
  if (set != 0) return set;
  // the view: rows of width = lcm(channels, 8) columns, per image rows each
  const int width = rhss::view_width(channels);
  const int per = width / channels;
  const int64_t view_rows = rows / per;
  const Geometry g = geometry(view_rows > 0 ? view_rows : 1, width,
                              rows_in_flight<T>(), sms);
  if (g.col_blocks > kMaxGroups || g.row_blocks > rhss::kTargetBlocks)
    return (int)cudaErrorInvalidValue;
  // the chunks' sums follow the strips' partials in the workspace, then the
  // view's column sums
  double* chunks = reinterpret_cast<double*>(
      ws + 2 * (int64_t)rhss::kTargetBlocks * width);
  double* cols = chunks + 2 * (int64_t)kMaxChunks * width;
  const Args args{x,    ws,         chunks, cols,  counters, mean,
                  var,  sums,       view_rows, rows, g.rows_per_block,
                  width, channels,  (int)(rows - view_rows * per),
                  g.tx, g.ty, g.row_blocks, g.vecs};
  bn_stats_one_pass<T>
      <<<dim3(g.col_blocks, g.row_blocks), kThreads, 0, s>>>(args);
  return (int)cudaGetLastError();
}

// The checks both entries share; 0 when the arguments are taken.
int check(int64_t rows, int channels, int dtype) {
  if (rows <= 0 || channels <= 0 ||
      rhss::view_width(channels) > rhss::kMaxWidth ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename... A>
int dispatch(int dtype, A... args) {
  if (dtype == 1) return launch<__nv_bfloat16>(args...);
  return launch<float>(args...);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: rows * channels elements, 16-byte
// aligned; workspace: (2 * 528 + 4 * 33 + 4) * L floats, L = lcm(channels, 8)
// (bn_reduce.cuh's kTargetBlocks strips of f32 partials, then kMaxChunks
// chunks of f64 sums, then the view's f64 column sums); counters: 64 * 34 + 1
// ints, 0 (and left at 0); mean, var: channels floats. L <= 16384.
extern "C" int rhss_bn_stats(const void* x, int64_t rows, int channels,
                             int dtype, void* workspace, void* counters,
                             void* mean, void* var, void* stream) {
  const int bad = check(rows, channels, dtype);
  if (bad) return bad;
  return dispatch(dtype, x, rows, channels, static_cast<float*>(workspace),
                  static_cast<int*>(counters), static_cast<float*>(mean),
                  static_cast<float*>(var), static_cast<double*>(nullptr),
                  reinterpret_cast<cudaStream_t>(stream));
}

// The sums entry: as rhss_bn_stats, but sums (2 * channels + 1 doubles,
// 16-byte aligned) gets [Σx, Σx², n] in double in place of mean and var.
extern "C" int rhss_bn_stats_sums(const void* x, int64_t rows, int channels,
                                  int dtype, void* workspace, void* counters,
                                  void* sums, void* stream) {
  const int bad = check(rows, channels, dtype);
  if (bad) return bad;
  return dispatch(dtype, x, rows, channels, static_cast<float*>(workspace),
                  static_cast<int*>(counters), static_cast<float*>(nullptr),
                  static_cast<float*>(nullptr), static_cast<double*>(sums),
                  reinterpret_cast<cudaStream_t>(stream));
}

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
// under 10 us; a rank's band of the space axis halves them), so a fixed cost
// per call weighs as much as the streaming.
//
// Design: one launch per call, whose blocks of a column group form thread
// block clusters (Hopper) that add their strips on the chip.
//  * Block (bx, by) owns the channel vectors of column group bx (8
//    channels, 16 bytes of bf16, a thread; at most 32 vectors a group,
//    balanced, on tx lanes, tx the power of 2 at or above them) and a
//    contiguous strip of rows. Each thread keeps 128 bytes of its rows in
//    flight (8 rows of bf16, 4 of f32), adds each such round pairwise and
//    the rounds into two f32 sums; the block adds its row lanes with warp
//    shuffles and then across its 8 warps, in a fixed order.
//  * The strips of a column group come in clusters of `cluster` blocks
//    (launched with cudaLaunchKernelEx and a cluster dimension). Each block
//    stores its strip's sums into the cluster's first block's shared memory
//    (distributed shared memory, once a relaxed cluster barrier shows every
//    block started, which it passes as soon as its reads are done) and
//    arrives on a release barrier, after which it leaves; the first block
//    waits for every arrival and adds the strips in double, block 0 first.
//    Nothing goes to device memory and no counter is touched.
//  * A call of at most kCluster * kSingleRounds rounds a thread (one round:
//    ty * 128 bytes of rows a column) is one cluster a column group, whose
//    blocks take several rounds each: the first block writes the
//    statistics. Larger calls take clusters of kCluster blocks, as many
//    as the card holds at once over the column groups
//    (cudaOccupancyMaxActiveClusters), at most kMaxClusters a group and at
//    least one; each cluster's first block writes the
//    cluster's double sums to the workspace and draws a ticket (an integer
//    atomic, release-acquire at gpu scope, by one thread), and the first
//    block of the column group's last cluster adds the clusters' sums of
//    each column in cluster order and writes the statistics. It sets the
//    counter back to 0.
//    Which cluster finishes changes the order of no add, and there are no
//    float atomics: the result is the same bits from run to run.
// The counters must be 0 before every launch; the Python wrapper keeps a
// zeroed buffer per (device, stream), and every launch leaves it at 0 again,
// so a launch captured in a CUDA graph replays.
//
// The sums entry (rhss_bn_stats_sums) is the same launch with another last
// step: the finishing block writes the double sums (Σx, Σx²) and n instead
// of mean and var, for a caller that adds them over the ranks of a
// data-parallel group before forming the statistics (global-batch
// BatchNorm, ops/fused_bn_act.py:sync_batch_norm_act). Mean and var are
// formed with explicit __dmul_rn / __dsub_rn (no contraction into an fma),
// so the caller's f64 arithmetic on the sums of one rank gives the same bits
// as this kernel.
//
// Any C: the blocks reduce the view of rows of L = lcm(C, 8) columns
// (bn_reduce.cuh) over its whole rows, exactly as above with L for C. Where
// L > C, the finishing block folds the L / C columns of each channel in
// order and adds the tail's rows (fewer than L / C) one by one before the
// last step; n stays the count of image rows. With one column group (L <=
// 256: every W18 width but the 270-channel head) and one cluster, the
// cluster's first block folds its own sums in shared memory; otherwise one
// ticket for the whole call (kFoldCounter) picks the block that adds every
// group's clusters and folds. Where C % 8 == 0 none of this runs.
//
// What it cannot do: a call still pays a launch, one read of its strip and
// the cluster's barrier; a large call one round trip through L2 and the
// atomic more. lcm(C, 8) must be at most 16384 (kMaxGroups column
// groups): any C up to 2048, multiples of 8 up to 16384. The card must hold
// a cluster of kCluster blocks: a refused launch returns its error and the
// wrapper raises.
//
// Plain C interface for ctypes: returns the launch's error (0 on success),
// or cudaErrorInvalidValue for arguments it does not take. The launch goes
// on the caller's stream; nothing synchronises and nothing is allocated
// here.
#include <cooperative_groups.h>

#include "bn_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

using rhss::kMaxGroups;
using rhss::kThreads;
using rhss::kVec;
using rhss::Raw;

constexpr int kBlocksPerSm = 2;
constexpr int kRoundBytes = 128;  // of x in flight per thread
constexpr int kGroupWidth = 32 * kVec;  // the widest column group
// the blocks of a cluster (of a one-level call: the power of 2 at or above
// its strips, at most this): 8, the portable size (16, which a card must
// allow as non-portable, was slower over the train steps' calls)
constexpr int kCluster = 8;
// rounds a thread may take before a call takes a second cluster a group
constexpr int kSingleRounds = 4;
// the most clusters a column group (the workspace's rows of double sums;
// _STATS_CLUSTERS in ops/fused_bn_act.py)
constexpr int kMaxClusters = 64;
// a column group's ticket counter, in the counters' layout (bn_reduce.cuh)
constexpr int kGroupCounters = 1 + (rhss::kTargetBlocks + 15) / 16;
static_assert(rhss::kFoldCounter == kMaxGroups * kGroupCounters,
              "the fold counter follows the column groups' counters");
static_assert(rhss::kMaxWidth == kMaxGroups * kGroupWidth,
              "the widest view fills the counters' column groups");
static_assert(kCluster <= 8 && (kCluster & (kCluster - 1)) == 0,
              "a portable cluster holds at most 8 blocks, a power of 2");

// rows a thread keeps in flight
template <typename T>
__host__ __device__ constexpr int rows_in_flight() {
  return kRoundBytes / (int)sizeof(Raw<T>);
}

struct Args {
  const void* x;
  double* ws;      // [2][clusters][channels]: the clusters' sums
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
  int tx, ty;
  int vecs;      // channel vectors of a column group, <= tx
  int clusters;  // clusters a column group
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

// The halves of a cluster barrier (PTX barrier.cluster; every thread of
// the cluster's blocks arrives once a phase, and wait returns when all
// have). A relaxed arrival orders nothing; a release arrival and an acquire
// wait make the writes before the arrival, to any block's shared memory,
// visible to the threads past the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
bn_stats_cluster(const Args a) {
  constexpr int U = rows_in_flight<T>();
  // the first block's: every block's strip sums, [block][Σx, Σx²][column]
  __shared__ __align__(16) float strips[kCluster * 2 * kGroupWidth];
  // add_rows' warps' sums; then the first block's column sums, to fold
  __shared__ __align__(16) float warps[2 * (kThreads / 32) * kVec * 32];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started (waited for below)
  const int t = threadIdx.x;
  const int tx = a.tx, ty = a.ty, C = a.channels;
  const int x = t % tx, y = t / tx;
  const int v = blockIdx.x * a.vecs + x;
  const bool active = x < a.vecs && v < C / kVec;
  const int c = v * kVec;
  const int64_t r0 = (int64_t)blockIdx.y * a.rows_per_block;
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

  // the strip's sums (row lane 0 holds them), stored into the first
  // block's shared memory once every block of the cluster has started
  add_rows(warps, s0, s1, t, tx);
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  cluster_wait();
  if (y == 0) {
    float4* dst = reinterpret_cast<float4*>(
        cluster.map_shared_rank(strips, 0) + rank * 2 * kGroupWidth +
        x * kVec);
    dst[0] = make_float4(s0[0], s0[1], s0[2], s0[3]);
    dst[1] = make_float4(s0[4], s0[5], s0[6], s0[7]);
    dst[kGroupWidth / 4] = make_float4(s1[0], s1[1], s1[2], s1[3]);
    dst[kGroupWidth / 4 + 1] = make_float4(s1[4], s1[5], s1[6], s1[7]);
  }
  cluster_arrive();
  // no block reads the others' shared memory: they may leave
  if (rank != 0) return;
  cluster_wait();

  // the first block adds its blocks' strips in double, block 0 first
  const int col0 = blockIdx.x * a.vecs * kVec;  // the group's first column
  const int width = min(a.vecs * kVec, C - col0);  // and its columns
  double d0 = 0.0, d1 = 0.0;
  if (t < width) {
    for (int k = 0; k < blocks; ++k) {
      d0 += strips[k * 2 * kGroupWidth + t];
      d1 += strips[k * 2 * kGroupWidth + kGroupWidth + t];
    }
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
  // the image rows after the view's last whole row, one by one
  const T* tail = static_cast<const T*>(a.x) + a.rows * C;
  const auto add_tail = [&](int ch, double& sx, double& sq) {
    for (int r = 0; r < a.tail_rows; ++r) {
      const float f = rhss::to_float(tail[(int64_t)r * a.c + ch]);
      sx += f;
      sq += __fmul_rn(f, f);
    }
  };
  const bool fold = a.c != C;

  if (a.clusters == 1 && (!fold || gridDim.x == 1)) {  // one level
    if (!fold) {
      if (t < width) finish(col0 + t, d0, d1);
    } else {  // one column group: fold the columns in shared memory
      double* folded = reinterpret_cast<double*>(warps);
      if (t < width) {
        folded[t] = d0;
        folded[kGroupWidth + t] = d1;
      }
      __syncthreads();
      for (int ch = t; ch < a.c; ch += kThreads) {
        double sx = 0.0, sq = 0.0;
        for (int j = ch; j < C; j += a.c) {
          sx += folded[j];
          sq += folded[kGroupWidth + j];
        }
        add_tail(ch, sx, sq);
        finish(ch, sx, sq);
      }
    }
    if (a.sums != nullptr && blockIdx.x == 0 && t == 0)
      a.sums[2 * a.c] = (double)a.n;
    return;
  }

  // two levels: the cluster's sums to the workspace, then a ticket (per
  // column group, or for the whole call where it folds); the block that
  // draws the last adds every cluster's sums of each column, cluster 0
  // first
  const int64_t cl = blockIdx.y / blocks;
  if (t < width) {
    a.ws[cl * C + col0 + t] = d0;
    a.ws[((int64_t)a.clusters + cl) * C + col0 + t] = d1;
  }
  int* cnt = fold ? a.counters + rhss::kFoldCounter
                  : a.counters + blockIdx.x * kGroupCounters;
  if (!rhss::last_ticket(cnt, fold ? (int)gridDim.x * a.clusters
                                   : a.clusters))
    return;
  const int j0 = fold ? 0 : col0;
  const int j1 = fold ? C : col0 + width;
  for (int j = j0 + t; j < j1; j += kThreads) {
    double e0 = 0.0, e1 = 0.0;
#pragma unroll 8
    for (int i = 0; i < a.clusters; ++i) {
      e0 += __ldcg(a.ws + (int64_t)i * C + j);
      e1 += __ldcg(a.ws + ((int64_t)a.clusters + i) * C + j);
    }
    if (fold) {
      a.cols[j] = e0;
      a.cols[C + j] = e1;
    } else {
      finish(j, e0, e1);
    }
  }
  if (fold) {  // every channel's columns, written above by this block
    __syncthreads();
    for (int ch = t; ch < a.c; ch += kThreads) {
      double sx, sq;
      rhss::fold_columns(a.cols, C, a.c, ch, sx, sq);
      add_tail(ch, sx, sq);
      finish(ch, sx, sq);
    }
  }
  if (a.sums != nullptr && (fold || blockIdx.x == 0) && t == 0)
    a.sums[2 * a.c] = (double)a.n;
}

// How many clusters of kCluster blocks the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once per device.
template <typename T>
int active_clusters(int* out) {
  static rhss::DeviceOnce once;
  static int active[rhss::DeviceOnce::kMaxDevices];
  int sms = 0;
  const int set = once.get(&sms, [] {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = (unsigned)kCluster;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void (*fn)(Args) = bn_stats_cluster<T>;
    err = cudaOccupancyMaxActiveClusters(&active[dev], fn, &cfg);
    if (err != cudaSuccess) return err;
    return active[dev] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  });
  if (set != 0) return set;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  *out = active[dev];
  return 0;
}

struct Geometry : rhss::Geometry {
  int vecs;
  int cluster;   // blocks a cluster
  int clusters;  // clusters a column group
};

// A function of (rows, channels, dtype, the clusters the card holds at
// once): one cluster a column group of at most kCluster strips while each
// thread takes at most kSingleRounds rounds; else strips of about one round
// in clusters of kCluster blocks, as many as the card holds at once over the
// column groups, at most kMaxClusters a group and at least one.
Geometry geometry(int64_t rows, int channels, int in_flight, int active) {
  Geometry g;
  const int c_vec = channels / kVec;
  g.col_blocks = (c_vec + 31) / 32;
  g.vecs = (c_vec + g.col_blocks - 1) / g.col_blocks;
  g.tx = 1;
  while (g.tx < g.vecs) g.tx *= 2;
  g.ty = kThreads / g.tx;
  const int64_t round = (int64_t)g.ty * in_flight;
  const int64_t need = (rows + round - 1) / round;  // strips of one round
  if (need <= (int64_t)kCluster * kSingleRounds) {
    rhss::split_rows(g, rows,
                     (int)(need < kCluster ? need : kCluster) * g.col_blocks);
    g.cluster = 1;  // a power of 2: the strips past the rows add zeros
    while (g.cluster < g.row_blocks) g.cluster *= 2;
    g.row_blocks = g.cluster;
    g.clusters = 1;
    return g;
  }
  g.cluster = kCluster;
  int64_t most = active / g.col_blocks;  // clusters a group, all resident
  if (most > kMaxClusters) most = kMaxClusters;
  if (most < 1) most = 1;  // more column groups than the card holds
  int64_t want = (need + g.cluster - 1) / g.cluster;
  if (want > most) want = most;
  rhss::split_rows(g, rows, (int)(want * g.cluster * g.col_blocks));
  g.clusters = (g.row_blocks + g.cluster - 1) / g.cluster;
  g.row_blocks = g.clusters * g.cluster;
  return g;
}

// The launch's geometry for (rows, channels) of dtype T, and the clusters
// the card holds at once.
template <typename T>
int plan_geometry(int64_t rows, int channels, int* active, Geometry* g,
                  int64_t* view_rows) {
  const int set = active_clusters<T>(active);
  if (set != 0) return set;
  // the view: rows of width = lcm(channels, 8) columns, per image rows each
  const int width = rhss::view_width(channels);
  const int per = width / channels;
  *view_rows = rows / per;
  *g = geometry(*view_rows > 0 ? *view_rows : 1, width, rows_in_flight<T>(),
                *active);
  if (g->col_blocks > kMaxGroups || g->clusters > kMaxClusters)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch(const void* x, int64_t rows, int channels, float* ws,
           int* counters, float* mean, float* var, double* sums,
           cudaStream_t s) {
  int active = 0;
  Geometry g;
  int64_t view_rows = 0;
  const int bad = plan_geometry<T>(rows, channels, &active, &g, &view_rows);
  if (bad) return bad;
  const int width = rhss::view_width(channels);
  // the clusters' sums, then the view's column sums
  double* clusters = reinterpret_cast<double*>(ws);
  double* cols = clusters + 2 * (int64_t)kMaxClusters * width;
  const Args args{x,
                  clusters,
                  cols,
                  counters,
                  mean,
                  var,
                  sums,
                  view_rows,
                  rows,
                  g.rows_per_block,
                  width,
                  channels,
                  (int)(rows - view_rows * (width / channels)),
                  g.tx,
                  g.ty,
                  g.vecs,
                  g.clusters};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)g.cluster;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.col_blocks, g.row_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bn_stats_cluster<T>, args);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left pending
    return (int)err;
  }
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
// aligned; workspace: (4 * 64 + 4) * L floats, L = lcm(channels, 8)
// (kMaxClusters clusters' f64 sums, then the view's f64 column sums);
// counters: 64 * 34 + 1 ints, 0 (and left at 0); mean, var: channels
// floats. L <= 16384.
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

// The launch both entries would make for (rows, channels, dtype) on the
// current device, launching nothing: out[0..8] = column groups, strips a
// group, blocks a cluster, clusters a group, rows a strip, tx, ty, levels
// (1: the cluster writes the statistics; 2: a ticket picks the block that
// adds the clusters), then how many clusters of kCluster blocks the card
// holds at once.
extern "C" int rhss_bn_stats_geometry(int64_t rows, int channels, int dtype,
                                      int64_t* out) {
  const int bad = check(rows, channels, dtype);
  if (bad) return bad;
  int active = 0;
  Geometry g;
  int64_t view_rows = 0;
  const int err =
      dtype == 1 ? plan_geometry<__nv_bfloat16>(rows, channels, &active, &g,
                                                &view_rows)
                 : plan_geometry<float>(rows, channels, &active, &g,
                                        &view_rows);
  if (err) return err;
  const int width = rhss::view_width(channels);
  const bool one = g.clusters == 1 && (width == channels || g.col_blocks == 1);
  const int64_t v[8] = {g.col_blocks, g.row_blocks, g.cluster, g.clusters,
                        g.rows_per_block, g.tx, g.ty, one ? 1 : 2};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  out[8] = active;
  return 0;
}

// Per-channel scale, shift and activation over a channels_last tensor:
//     y[r, c] = act(float(x[r, c]) * scale[c] + shift[c])
// with act one of none / relu / leaky_relu(0.01), f32 math, and y in x's
// dtype (bf16 or f32). Two entries:
//  * rhss_scale_bias_act: scale and shift given, the eval-mode
//    BatchNorm(+ReLU) of every conv (the folded running statistics);
//  * rhss_bn_act_forward: the train-mode BatchNorm's whole forward after
//    its statistics. From gamma, beta, eps and either kernel 1's f32 (mean,
//    var) or a group's all-reduced f64 [Σx, Σx², n] it forms
//        mean, var  = kernel 1's last step on the sums (bn_stats.cu)
//        rstd  = rsqrt(var + eps)
//        scale = gamma * rstd
//        shift = beta - mean * gamma * rstd
//    each operation rounded once in the order of the plain version's ops
//    (ops/fused_bn_act.py:_bn_act_forward_ref), streams y as above, writes
//    rstd, scale, shift (and mean, var from sums) as (C,) f32 vectors for the
//    backward, and with `update` moves the running statistics in place:
//        running_mean = m * running_mean + (1 - m) * mean
//        running_var  = m * running_var  + (1 - m) * (var * n / (n - 1))
//    with the f32 roundings of the plain version's PyTorch ops.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py:100
//   _scale_bias_act_kernel (reached through fused_scale_bias_act, and the
//   forward of fused_bn_act with its XLA prologue, :148-163), and in the
//   train entry the running update of models/pallas_bn.py:56-63.
//
// Bound on the H100 SXM: memory. Each element is read once and written once
// and costs 2 flops, so the least time is 2 * numel * elem_bytes / 3.35
// TB/s (plus the (C,) vectors). The forward of a step calls it once per
// BatchNorm, mostly on a few MB, so a fixed cost per call weighs as much as
// the streaming; the train entry also takes in the six small launches that
// formed the coefficients and the nine of the running update.
//
// Design: a streaming kernel in which every thread keeps the same columns.
//  * The tensor is read as rows of L = lcm(C, 8) columns (L / C image rows
//    each; L = C where C % 8 == 0), in units of 16 bytes (8 columns of
//    bf16, 4 of f32). Column j of the view is channel j mod C, so the (C,)
//    vectors come untiled and a unit never straddles a row of the view.
//  * A block is tx unit columns by ty row lanes (threadIdx.x, threadIdx.y:
//    no division to find them). Where a view row has cv <= 512 units, tx =
//    cv and tx * ty is the multiple of cv in [128, 512] that leaves the
//    fewest warp lanes idle (every lane busy at C = 48 * 2^k, 64 * 2^k in
//    bf16; at C = 18, cv = 9, 288 threads); wider views split their columns
//    over column groups of up to 512 units (grid y), ty = 1. A thread's
//    unit column is fixed for the whole launch: no % in the loop, and its
//    scales and shifts are read once, into registers (float4 loads where
//    C is a multiple of the unit), while its first loads fly.
//  * The train entry forms its block's columns' coefficients in shared
//    memory, each column by one thread (scalar loads of the statistics,
//    gamma and beta), then a barrier; exactly one thread per channel (in
//    the block of grid row 0 that holds column c < C) writes the (C,)
//    outputs and moves the running statistics; no other thread reads them.
//  * The grid has a row of the view per row lane, at most one wave (the
//    occupancy calculator's blocks per SM); a thread takes every (grid
//    rows * ty)-th row after its own, 2 units (32 bytes) in flight, all
//    loads first. Measured on the card (PERF.md): 64 or 128 bytes in
//    flight, a block's rows taken 4 at a time, 32-byte units of f32,
//    shared memory for the eval entry's coefficients and more than one
//    wave were each slower at the forwards' many small calls, whose time is
//    the launch and a round trip; capping registers to fit more threads
//    spilled; the train entry forming each thread's own coefficients
//    (scalar loads of four vectors a thread) cost 7-13 % over a step. y is
//    stored evict-first (st.global.cs): the next conv reads it, not this
//    kernel.
//  * The last numel mod L elements (fewer than L / C image rows; none where
//    C % 8 == 0) are a tail taken element by element by the threads of
//    grid row 0 and row lane 0 that hold their columns.
// The arithmetic is x * scale + shift rounded twice (no fused multiply-add),
// then the act, as the plain PyTorch version computes it, so the two agree
// bit for bit; rsqrtf is the function PyTorch's CUDA rsqrt calls.
//
// What it cannot do: the smallest calls (under ~1 MB) still pay a launch
// and one round trip to device memory, several times their bound.
//
// Plain C interface for ctypes: each entry returns cudaGetLastError() after
// the launch (0 on success), and cudaErrorInvalidValue for arguments it
// does not take. It launches on the caller's stream, does not synchronise
// and allocates nothing.
#include "bn_reduce.cuh"  // common.cuh, to_float, from_float

namespace {

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

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

// A unit: 16 bytes of x, V columns of the view (8 of bf16, 4 of f32),
// loaded at once, widened to f32 and stored evict-first.
template <typename T>
struct Unit;

template <>
struct Unit<__nv_bfloat16> {
  static constexpr int V = 8;
  uint4 q;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    q = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void to_float(float v[V]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[V]) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    __stcs(reinterpret_cast<uint4*>(p), o);
  }
};

template <>
struct Unit<float> {
  static constexpr int V = 4;
  float4 q;
  __device__ __forceinline__ void load(const float* p) {
    q = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void to_float(float v[V]) const {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[V]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

constexpr int kInFlight = 2;  // units of x in flight a thread: 32 bytes
constexpr int kMinThreads = 128;
constexpr int kMaxThreads = 512;

// The per-channel inputs and outputs of a launch; (C,) f32 unless named.
struct Params {
  const float* scale;  // the eval entry: the folded scale and shift
  const float* shift;
  const float* gamma;  // the train entry
  const float* beta;
  const float* mean;    // kernel 1's statistics, or null ...
  const float* var;
  const double* sums;   // ... the group's [Σx, Σx², n] (2C + 1 doubles)
  float* running_mean;  // moved in place where update
  float* running_var;
  float* out_mean;  // written from sums only
  float* out_var;
  float* out_rstd;
  float* out_scale;
  float* out_shift;
  double momentum;
  float eps;
  int update;
};

// The train entry's coefficients of channel ch; `writer`: this thread
// writes the channel's outputs. rows: the tensor's image rows (n of one
// rank).
__device__ __forceinline__ void form(const Params& p, int ch, int channels,
                                     int64_t rows, bool writer, float& s,
                                     float& b) {
  float mean, var;
  double n = (double)rows;
  if (p.sums != nullptr) {  // kernel 1's last step (bn_stats.cu: finish)
    n = p.sums[2 * channels];
    const double inv_n = 1.0 / n;
    const double m = __dmul_rn(p.sums[ch], inv_n);
    const double v =
        __dsub_rn(__dmul_rn(p.sums[channels + ch], inv_n), __dmul_rn(m, m));
    mean = (float)m;
    var = (float)(v > 0.0 ? v : 0.0);
  } else {
    mean = p.mean[ch];
    var = p.var[ch];
  }
  const float gamma = p.gamma[ch];
  const float rstd = rsqrtf(__fadd_rn(var, p.eps));
  s = __fmul_rn(gamma, rstd);
  b = __fsub_rn(p.beta[ch], __fmul_rn(__fmul_rn(mean, gamma), rstd));
  if (!writer) return;
  p.out_rstd[ch] = rstd;
  p.out_scale[ch] = s;
  p.out_shift[ch] = b;
  if (p.sums != nullptr) {
    p.out_mean[ch] = mean;
    p.out_var[ch] = var;
  }
  if (p.update) {  // f32 products and sums, each rounded once
    const float m = (float)p.momentum, rest = (float)(1.0 - p.momentum);
    const float bessel =
        (float)(n > 1.0 ? __ddiv_rn(n, __dsub_rn(n, 1.0)) : 1.0);
    p.running_mean[ch] = __fadd_rn(__fmul_rn(m, p.running_mean[ch]),
                                   __fmul_rn(rest, mean));
    p.running_var[ch] = __fadd_rn(__fmul_rn(m, p.running_var[ch]),
                                  __fmul_rn(rest, __fmul_rn(var, bessel)));
  }
}

// Block (bx, by): the unit columns [by * tx, by * tx + tx) of the view;
// thread (tx', lane) holds unit column by * tx + tx' and takes the view's
// rows bx * ty + lane + i * S, S = gridDim.x * ty, kInFlight of them in
// flight at a time. Its V columns' coefficients are read or formed once,
// into registers; the train entry forms its block's columns' once, in
// shared memory ([2][tx * V] floats).
template <typename T, int ACT, bool TRAIN>
__device__ __forceinline__ void stream(const T* __restrict__ x,
                                       T* __restrict__ y, const Params& p,
                                       int64_t view_rows, int64_t rows,
                                       int width, int channels, int tx,
                                       int ty, int tail) {
  constexpr int V = Unit<T>::V, K = kInFlight;
  const int lane = threadIdx.y;
  const int col = (blockIdx.y * tx + threadIdx.x) * V;  // its first column
  if (!TRAIN && col >= width) return;
  const int64_t step = (int64_t)gridDim.x * ty;
  int64_t r = (int64_t)blockIdx.x * ty + lane;
  const int64_t jump = step * width;  // elements between a thread's rows
  const T* xs = x + r * width + col;
  T* ys = y + r * width + col;
  Unit<T> rx[K];
  auto fetch = [&](int64_t r0, const T* p0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (r0 + k * step < view_rows) rx[k].load(p0 + k * jump);
  };
  if (col < width) fetch(r, xs);

  // this thread's columns' coefficients, while its loads fly
  float sc[V], sh[V];
  if (TRAIN) {  // each column of the block formed by one thread
    extern __shared__ __align__(16) float coef[];
    const int c0 = blockIdx.y * tx * V, span = tx * V;
    const int ncols = width - c0 < span ? width - c0 : span;
    for (int j = lane * tx + threadIdx.x; j < ncols; j += tx * ty) {
      const int column = c0 + j;
      // the writer of channel c < C: the block of grid row 0 holding
      // column c
      form(p, column < channels ? column : column % channels, channels,
           rows, blockIdx.x == 0 && column < channels, coef[j],
           coef[span + j]);
    }
    __syncthreads();
    if (col >= width) return;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sc[k] = coef[col - c0 + k];
      sh[k] = coef[span + col - c0 + k];
    }
  } else {
    int ch = col < channels ? col : col % channels;
    if (channels % V == 0) {  // V neighbouring channels, 16-byte aligned
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p.scale + ch + k);
        const float4 b = *reinterpret_cast<const float4*>(p.shift + ch + k);
        sc[k] = a.x; sc[k + 1] = a.y; sc[k + 2] = a.z; sc[k + 3] = a.w;
        sh[k] = b.x; sh[k + 1] = b.y; sh[k + 2] = b.z; sh[k + 3] = b.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sc[k] = p.scale[ch];
        sh[k] = p.shift[ch];
        if (++ch == channels) ch = 0;
      }
    }
  }

  for (; r < view_rows; r += K * step, xs += K * jump, ys += K * jump) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (r + k * step >= view_rows) break;
      float v[V];
      rx[k].to_float(v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = activate<ACT>(affine(v[e], sc[e], sh[e]));
      Unit<T>::store(ys + k * jump, v);
    }
    fetch(r + K * step, xs + K * jump);
  }
  // the tail: its element e has the view's column e
  if (tail > col && blockIdx.x == 0 && lane == 0) {
    const int64_t base = view_rows * width + col;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (col + k < tail)
        y[base + k] = rhss::from_float<T>(activate<ACT>(
            affine(rhss::to_float(x[base + k]), sc[k], sh[k])));
    }
  }
}

// The two entries' kernels, one name each (a profiler's trace tells them
// apart).
template <typename T, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
scale_bias_act(const T* __restrict__ x, T* __restrict__ y, const Params p,
               int64_t view_rows, int64_t rows, int width, int channels,
               int tx, int ty, int tail) {
  stream<T, ACT, false>(x, y, p, view_rows, rows, width, channels, tx, ty,
                        tail);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
bn_act_forward(const T* __restrict__ x, T* __restrict__ y, const Params p,
               int64_t view_rows, int64_t rows, int width, int channels,
               int tx, int ty, int tail) {
  stream<T, ACT, true>(x, y, p, view_rows, rows, width, channels, tx, ty,
                       tail);
}

struct Geometry {
  int threads, tx, ty, col_groups;
};

// The block shape for cv unit columns: tx = cv and the multiple of cv in
// [kMinThreads, kMaxThreads] (or the one multiple, where there is no other)
// that leaves the smallest share of its warps' lanes idle, the smallest
// such; over kMaxThreads columns, column groups of at most kMaxThreads
// (whole warps) and one row lane.
Geometry geometry(int cv) {
  Geometry g;
  if (cv > kMaxThreads) {
    g.col_groups = (cv + kMaxThreads - 1) / kMaxThreads;
    const int per = (cv + g.col_groups - 1) / g.col_groups;
    g.tx = g.threads = (per + 31) / 32 * 32;
    g.ty = 1;
    return g;
  }
  int best = 0, best_idle = 0, best_lanes = 1;
  for (int b = cv; b <= kMaxThreads; b += cv) {
    if (b < kMinThreads && b + cv <= kMaxThreads) continue;
    const int lanes = (b + 31) / 32 * 32, idle = lanes - b;
    if (best == 0 || idle * best_lanes < best_idle * lanes) {
      best = b;
      best_idle = idle;
      best_lanes = lanes;
    }
  }
  g.threads = best;
  g.tx = cv;
  g.ty = best / cv;
  g.col_groups = 1;
  return g;
}

template <typename T, int ACT, bool TRAIN>
int launch(const void* x, void* y, const Params& p, int64_t rows,
           int channels, cudaStream_t s) {
  auto kernel = scale_bias_act<T, ACT>;
  if constexpr (TRAIN) kernel = bn_act_forward<T, ACT>;
  static rhss::DeviceOnce once;
  static rhss::Occupancy occupancy;
  int sms = 0;
  const int set = once.get(&sms, [] { return cudaSuccess; });
  if (set != 0) return set;
  const int width = rhss::view_width(channels);
  const int per = width / channels;
  const int64_t view_rows = rows / per;
  const Geometry g = geometry(width / Unit<T>::V);
  const int smem = TRAIN ? 2 * g.tx * Unit<T>::V * (int)sizeof(float) : 0;
  int per_sm = 0;
  const int occ = occupancy.get((const void*)kernel, g.threads, smem, &per_sm);
  if (occ != 0) return occ;
  // a row of the view per row lane, at most one wave; more rows are each
  // thread's next ones
  int64_t blocks = (view_rows + g.ty - 1) / g.ty;
  int64_t wave = (int64_t)sms * per_sm / g.col_groups;
  if (wave < 1) wave = 1;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;  // a tail alone
  kernel<<<dim3((unsigned)blocks, g.col_groups), dim3(g.tx, g.ty), smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p, view_rows, rows,
      width, channels, g.tx, g.ty,
      (int)((rows - view_rows * per) * channels));
  return (int)cudaGetLastError();
}

template <bool TRAIN>
int dispatch(int dtype, int act, const void* x, void* y, const Params& p,
             int64_t rows, int channels, cudaStream_t s) {
  const bool bf16 = dtype == 1;
  switch (act) {
    case kNone:
      return bf16 ? launch<__nv_bfloat16, kNone, TRAIN>(x, y, p, rows, channels, s)
                  : launch<float, kNone, TRAIN>(x, y, p, rows, channels, s);
    case kRelu:
      return bf16 ? launch<__nv_bfloat16, kRelu, TRAIN>(x, y, p, rows, channels, s)
                  : launch<float, kRelu, TRAIN>(x, y, p, rows, channels, s);
    default:  // kLeakyRelu, eval only (the entries check act)
      return bf16 ? launch<__nv_bfloat16, kLeakyRelu, false>(x, y, p, rows, channels, s)
                  : launch<float, kLeakyRelu, false>(x, y, p, rows, channels, s);
  }
}

bool bad_shape(int64_t rows, int channels, int dtype) {
  return rows < 0 || channels <= 0 ||
         (channels % 8 != 0 && rhss::view_width(channels) > rhss::kMaxWidth) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// x and y: rows * channels elements, 16-byte aligned; scale and shift:
// channels floats, 16-byte aligned where channels % 8 == 0; channels % 8
// == 0 or lcm(channels, 8) <= 16384.
extern "C" int rhss_scale_bias_act(const void* x, const void* scale,
                                   const void* shift, void* y, int64_t rows,
                                   int channels, int dtype, int act,
                                   void* stream) {
  if (bad_shape(rows, channels, dtype) || act < kNone || act > kLeakyRelu)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  Params p = {};
  p.scale = static_cast<const float*>(scale);
  p.shift = static_cast<const float*>(shift);
  return dispatch<false>(dtype, act, x, y, p, rows, channels,
                         reinterpret_cast<cudaStream_t>(stream));
}

// The train entry. act: 0 none, 1 relu. x, y as above, rows >= 1; gamma,
// beta: channels floats; either mean and var (channels floats, kernel 1's)
// or sums (2 * channels + 1 doubles, [Σx, Σx², n] of the group), the other
// null; with update != 0 running_mean and running_var (channels floats) are
// moved in place; out_rstd, out_scale, out_shift and, with sums, out_mean
// and out_var: channels floats each, written.
extern "C" int rhss_bn_act_forward(
    const void* x, void* y, int64_t rows, int channels, int dtype, int act,
    const void* gamma, const void* beta, float eps, const void* mean,
    const void* var, const void* sums, void* running_mean, void* running_var,
    double momentum, int update, void* out_mean, void* out_var,
    void* out_rstd, void* out_scale, void* out_shift, void* stream) {
  const bool from_stats = mean != nullptr && var != nullptr && sums == nullptr;
  const bool from_sums = mean == nullptr && var == nullptr && sums != nullptr &&
                         out_mean != nullptr && out_var != nullptr;
  if (bad_shape(rows, channels, dtype) || rows == 0 ||
      (act != kNone && act != kRelu) || !(from_stats || from_sums) ||
      (update && (running_mean == nullptr || running_var == nullptr)) ||
      out_rstd == nullptr || out_scale == nullptr || out_shift == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.mean = static_cast<const float*>(mean);
  p.var = static_cast<const float*>(var);
  p.sums = static_cast<const double*>(sums);
  p.running_mean = static_cast<float*>(running_mean);
  p.running_var = static_cast<float*>(running_var);
  p.out_mean = static_cast<float*>(out_mean);
  p.out_var = static_cast<float*>(out_var);
  p.out_rstd = static_cast<float*>(out_rstd);
  p.out_scale = static_cast<float*>(out_scale);
  p.out_shift = static_cast<float*>(out_shift);
  p.momentum = momentum;
  p.eps = eps;
  p.update = update;
  return dispatch<true>(dtype, act, x, y, p, rows, channels,
                        reinterpret_cast<cudaStream_t>(stream));
}

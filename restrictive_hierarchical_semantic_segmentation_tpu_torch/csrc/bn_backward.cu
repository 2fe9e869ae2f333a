// Backward of the train-mode BatchNorm + activation over a channels_last
// (rows, C) tensor, y = act(x * scale + shift) with scale = gamma * rstd,
// shift = beta - mean * gamma * rstd and the batch statistics mean, rstd of
// x itself. Given g = dL/dy:
//     dy     = g * [z > 0] (relu) or g (none),   z = x * scale + shift
//     xhat   = (x - mean) * rstd
//     edz    = sum_r dy,  eydz = sum_r dy * xhat
//     dx     = scale * (dy - (xhat * eydz + edz) / n)
//     dgamma = eydz,  dbeta = edz
// x, g and dx are bf16 or f32 (one dtype); every per-channel vector is f32.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py:173
//   _bwd_kernel (the custom VJP _fba_bwd of fused_bn_act, :195), together
//   with the XLA elementwise tail of _fba_bwd that forms dx.
//
// Bound on the H100 SXM: memory. The function reads x and g once and writes
// dx once; the least time is 3 * numel * elem_bytes / 3.35 TB/s. dx needs
// the sums over every row, so a second look at x and g is unavoidable; the
// design makes that look on chip where it can:
//  * one cooperative launch (cudaLaunchKernelEx with
//    cudaLaunchAttributeCooperative), one block of 512 threads per SM; block
//    (bx, by) owns channel vectors [bx * tx, (bx + 1) * tx) and a contiguous
//    strip of rows, each thread 8 channels (16-byte copies) and every ty-th
//    row of the strip;
//  * phase A reads the strip once from device memory with cp.async: the
//    first rows of the strip (as many as fit, up to ~163 KB a block, 21 MB
//    across the card) go straight to where they stay in shared memory, all
//    copies in flight at once; the others stream through a per-thread ring
//    of 4 rows (64 KB a block; a ring of 8 that keeps fewer rows on chip
//    was slower over the W48 step, and L2 eviction hints that keep the rows
//    phase B reads first gained little on it and lost on the largest
//    calls).
//    It forms dy and xhat with the plain version's roundings (so the relu
//    mask is the forward's, bit for bit) and keeps two f32 sums per channel;
//  * the block adds its row lanes in shared memory in a fixed tree order and
//    writes one row of partials; grid.sync(); block i then adds the partials
//    of channels [32 i, 32 i + 32) in double (16 lanes a channel, each every
//    16th strip, then a fixed tree) and writes edz, eydz and, divided by n
//    once in double, edz / n and eydz / n; grid.sync();
//  * phase B writes dx = scale * (dy - (xhat * eydz / n + edz / n)) (within
//    a few f32 ulp of the plain version's (xhat * eydz + edz) / n, with no
//    division per element): first the rows it did not keep, in the reverse
//    of phase A's order through the ring (what L2 kept last is read first),
//    then the kept rows from shared memory; dx is stored evict-first
//    (st.global.cs) so it does not push x and g out of L2.
// No float atomics anywhere, and every sum is taken in an order fixed by the
// shape and the card's SM count (the same rows are kept on chip with or
// without dx): dx, dgamma and dbeta are the same bits from run to run.
//
// What it cannot do: when x and g of a call exceed shared memory and L2
// together (above ~37 MB of x + g, the largest calls of the W48 step and
// most of the UNet's bytes), the re-read comes from device memory and the
// call moves 5 tensors, the floor of a standalone BatchNorm backward whose g
// arrives from another kernel (cuDNN's dgrad). Each call also pays a fixed
// cost of several microseconds (the launch, two grid barriers, the
// combine's round trips through L2): the larger share of the time at the
// W48 step's many small calls (PERF.md).
// A grid that cannot be resident all at once fails the launch (the wrapper
// raises); it never hangs.
//
// Two more entries split the pass for a group of ranks (global-batch
// BatchNorm, ops/fused_bn_act.py:SyncFusedBNAct), whose all-reduce of the
// sums must fall between the sums and dx. Each is a plain launch, written
// for its own work:
//  * rhss_bn_backward_reduce (bn_backward_reduce): phase A and the combine
//    without the cooperative launch, the staging or the grid barriers. The
//    fused pass's blocks and order of adds (its strips and row lanes, the
//    rows it keeps on chip added last, its tree in the block); each thread
//    keeps 4 rows of bf16 (2 of f32) of x and of g in flight in registers.
//    The strips' partials are added in combine_group's order by the blocks
//    that draw the last integer tickets (bn_reduce.cuh: last_ticket, which
//    leaves each counter at 0, so a launch captured in a CUDA graph
//    replays), in two levels: the last block of each of a column group's 16
//    chains of strips adds that chain, the last of the chains adds their
//    tree; no block reads more than a chain's partials or the 16 chains'
//    sums. Out: edz and eydz (f32, the local dbeta and dgamma) and the
//    double sums and n, [Σdy, Σdy·x̂, n], for the all-reduce. Bound: x and g
//    read once. What it cannot do: each call keeps a fixed cost of several
//    microseconds (the launch, the block's tree, two tickets, two rounds
//    through L2), most of its time at the space axis's band shapes
//    (PERF.md).
//  * rhss_bn_backward_dx (bn_backward_dx): dx from those sums added over the
//    group, a streaming elementwise kernel over the flat array of 8-channel
//    units in blocks of a multiple of C / 8 threads (each thread keeps one
//    channel vector): every lane busy where those fill whole warps (C = 48 *
//    2^k, 64 * 2^k), the fewest idle otherwise (1 in 16 at C = 720). The
//    block forms the per-channel coefficients once in shared memory (edz / n
//    and eydz / n in double, rounded once, as the combine does) while its
//    first loads fly; 64 bytes of x and as many of g in flight per thread; a
//    grid of one round per thread, at most one wave; dx stored evict-first.
//    Bound: x and g read once, dx written once.
// dx takes phase B's roundings, so at one rank the split gives the fused
// launch's dx, dgamma and dbeta bit for bit. Between the two, x and g are
// read twice from device memory (5 tensors moved in all, against the fused
// pass's 3 where they stay on chip).
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.
// The launch goes on the caller's stream; nothing synchronises and nothing
// is allocated here.
#include <cooperative_groups.h>

#include <type_traits>

#include "bn_reduce.cuh"

namespace {

namespace cg = cooperative_groups;
using rhss::kCombineX;  // combine_group's lanes
using rhss::kCombineY;
using rhss::kVec;
using rhss::load8_cg;
using rhss::Raw;

constexpr int kThreads = 512;
// Per-thread rings of 16-byte cp.async slots for the rows not kept on chip:
// 4 rows of x and g in bf16, 2 in f32. After phase A the same bytes hold the
// block's lane sums (2 * 8 * 512 floats) and then the combine's doubles.
constexpr int kRingRows = 4;  // in bf16
constexpr int kRingBytes = 2 * kRingRows * kThreads * 16;
constexpr int kSmemCap = 227 * 1024;  // an H100 block's most
static_assert(kCombineX * kCombineY == kThreads, "one combine lane each");

// z, dy and xhat of one element, rounded as the plain version rounds them
template <bool RELU>
__device__ __forceinline__ void dy_xhat(float x, float g, float scale,
                                        float shift, float mean, float rstd,
                                        float& dy, float& xhat) {
  if (RELU) {
    const float z = __fadd_rn(__fmul_rn(x, scale), shift);
    dy = z > 0.f ? g : 0.f;
  } else {
    dy = g;
  }
  xhat = __fmul_rn(__fsub_rn(x, mean), rstd);
}

struct Params {
  const float* scale;
  const float* shift;
  const float* mean;
  const float* rstd;
};

template <typename T>
struct Args {
  const T* x;
  const T* g;
  Params p;
  float* partial;  // [2][row_blocks][channels]
  float* edz;
  float* eydz;
  T* dx;  // null: dgamma and dbeta only
  double* sums;  // non-null: [Σdy (C), Σdy·x̂ (C), n] in double as well
  int64_t rows;
  int64_t rows_per_block;
  int channels;
  int tx, ty, col_blocks, row_blocks;
  int stage_rows;  // rows of each strip kept in shared memory
};

// the 16-byte words of one thread's 8 values of a row: 1 (bf16) or 2 (f32)
template <typename T>
__host__ __device__ constexpr int words() {
  return (int)sizeof(Raw<T>) / 16;
}

// 16 bytes global -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The words of one thread's row of x (or g) lie `stride` uint4 apart:
// neighbouring threads on neighbouring words, so no bank conflicts.
template <typename T>
__device__ __forceinline__ void copy_row(uint4* dst, int64_t stride,
                                         const T* src) {
#pragma unroll
  for (int i = 0; i < words<T>(); ++i)
    cp_async16(dst + i * stride, reinterpret_cast<const uint4*>(src) + i);
}

template <typename T>
__device__ __forceinline__ Raw<T> read_row(const uint4* s, int64_t stride) {
  Raw<T> r;
  uint4* w = reinterpret_cast<uint4*>(&r);
#pragma unroll
  for (int i = 0; i < words<T>(); ++i) w[i] = s[i * stride];
  return r;
}

// 8 values of x's dtype from f32, stored evict-first
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  __stcs(reinterpret_cast<uint4*>(p), q);
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + 4), make_float4(v[4], v[5], v[6], v[7]));
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
bn_backward_fused(const Args<T> args) {
  constexpr int W = words<T>();
  constexpr int D = kRingRows / W;  // ring slots per thread
  constexpr int64_t kRing = (int64_t)D * kThreads;  // uint4 between words
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  const int64_t kStage = (int64_t)args.stage_rows * args.tx;
  uint4* stage_x = reinterpret_cast<uint4*>(smem + kRingBytes);
  uint4* stage_g = stage_x + W * kStage;
  cg::grid_group grid = cg::this_grid();

  const int t = threadIdx.x;
  const int tx = args.tx, ty = args.ty, C = args.channels;
  const int x = t % tx, y = t / tx;
  const int bx = blockIdx.x % args.col_blocks, by = blockIdx.x / args.col_blocks;
  const int v = bx * tx + x;
  const bool active = y < ty && v < C / kVec;
  const int c = v * kVec;
  const int64_t r0 = (int64_t)by * args.rows_per_block;
  const int64_t r1 = r0 + args.rows_per_block < args.rows
                         ? r0 + args.rows_per_block
                         : args.rows;
  // this thread's rows are r0 + y + k ty for k < nk; k < ks are kept in
  // shared memory (with or without dx, so the sums are added in one order),
  // the rest go through the ring
  const int64_t span = r1 - r0 - y;
  const int64_t nk = span > 0 ? (span + ty - 1) / ty : 0;
  const int staged = args.stage_rows;
  const int64_t ks_all = staged > y ? (staged - y + ty - 1) / ty : 0;
  const int64_t ks = ks_all < nk ? ks_all : nk;
  const int64_t step = (int64_t)ty * C;  // elements from row k to k + 1
  const T* xs = args.x + (r0 + y) * C + c;
  const T* gs = args.g + (r0 + y) * C + c;
  uint4* ring_x = ring + t;
  uint4* ring_g = ring + W * kRing + t;
  uint4* st_x = stage_x + (int64_t)y * tx + x;  // row k at + k ty tx
  uint4* st_g = stage_g + (int64_t)y * tx + x;
  // row k into ring slot i % D
  auto fetch = [&](int64_t k, int64_t i) {
    copy_row(ring_x + (i % D) * kThreads, kRing, xs + k * step);
    copy_row(ring_g + (i % D) * kThreads, kRing, gs + k * step);
  };

  float sc[kVec], sh[kVec], mu[kVec], rs[kVec];
  float s0[kVec], s1[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s0[k] = s1[k] = 0.f;
  auto add = [&](const Raw<T>& rx, const Raw<T>& rg) {
    float xv[kVec], gv[kVec];
    rx.to_float(xv);
    rg.to_float(gv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float dy, xhat;
      dy_xhat<RELU>(xv[k], gv[k], sc[k], sh[k], mu[k], rs[k], dy, xhat);
      s0[k] += dy;
      s1[k] += dy * xhat;
    }
  };

  // ------------------------------------------------------------ phase A
  if (active) {
    // the rows kept on chip: every copy in flight at once
    for (int64_t k = 0; k < ks; ++k) {
      copy_row(st_x + k * ty * tx, kStage, xs + k * step);
      copy_row(st_g + k * ty * tx, kStage, gs + k * step);
    }
    cp_async_commit();
    // the others, in order, D - 1 rows ahead
    for (int i = 0; i < D - 1; ++i) {
      if (ks + i < nk) fetch(ks + i, i);
      cp_async_commit();
    }
    rhss::load8(args.p.scale + c, sc);  // while the copies fly
    rhss::load8(args.p.shift + c, sh);
    rhss::load8(args.p.mean + c, mu);
    rhss::load8(args.p.rstd + c, rs);
    for (int64_t k = ks; k < nk; ++k) {
      const int64_t i = k - ks;
      if (k + D - 1 < nk) fetch(k + D - 1, i + D - 1);
      cp_async_commit();
      cp_async_wait<D - 1>();  // row k has landed (and every row kept)
      add(read_row<T>(ring_x + (i % D) * kThreads, kRing),
          read_row<T>(ring_g + (i % D) * kThreads, kRing));
    }
    cp_async_wait<0>();
    for (int64_t k = 0; k < ks; ++k)
      add(read_row<T>(st_x + k * ty * tx, kStage),
          read_row<T>(st_g + k * ty * tx, kStage));
  }

  // the block's row lanes in a fixed tree order, [k][thread] in the ring's
  // bytes (once every thread is done with its ring)
  __syncthreads();
  float* sh0 = reinterpret_cast<float*>(smem);
  float* sh1 = sh0 + kVec * kThreads;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sh0[k * kThreads + t] = s0[k];
    sh1[k * kThreads + t] = s1[k];
  }
  __syncthreads();
  int half = 1;
  while (half * 2 < ty) half *= 2;
  for (; half > 0; half >>= 1) {  // ty need not be a power of 2
    if (y < half && y + half < ty) {
      const int o = t + half * tx;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        sh0[k * kThreads + t] += sh0[k * kThreads + o];
        sh1[k * kThreads + t] += sh1[k * kThreads + o];
      }
    }
    __syncthreads();
  }
  if (y == 0 && active) {
    float* p0 = args.partial + (int64_t)by * C + c;
    float* p1 = args.partial + ((int64_t)args.row_blocks + by) * C + c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      p0[k] = sh0[k * kThreads + t];
      p1[k] = sh1[k * kThreads + t];
    }
  }
  grid.sync();

  // ----------------------------------------------------------- combine
  // block i adds the strips' partials of channels [32 i, 32 i + 32)
  // (bn_reduce.cuh: combine_group)
  float* scaled = args.partial + 2 * (int64_t)args.row_blocks * C;  // [2][C]
  {
    double* da = reinterpret_cast<double*>(smem);  // in the ring's bytes
    const auto fin = [&](int ch, double a, double b) {
      args.edz[ch] = (float)a;
      args.eydz[ch] = (float)b;
      if (args.sums != nullptr) {
        args.sums[ch] = a;
        args.sums[C + ch] = b;
      }
      // and divided by n once, in double, for phase B
      scaled[ch] = (float)(a / (double)args.rows);
      scaled[C + ch] = (float)(b / (double)args.rows);
    };
    const int groups = (C + kCombineX - 1) / kCombineX;
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x)
      rhss::combine_group(args.partial, args.row_blocks, C, grp, t, da,
                          da + kThreads, fin);
    if (args.sums != nullptr && blockIdx.x == 0 && t == 0)
      args.sums[2 * C] = (double)args.rows;
  }
  if (args.dx == nullptr) return;  // uniform over the grid
  grid.sync();

  // ------------------------------------------------------------ phase B
  if (!active) return;
  // dx = scale * (dy - (xhat * eydz / n + edz / n)) with edz / n and eydz /
  // n from the combine: within a few f32 ulp of the plain version's (xhat *
  // eydz + edz) / n, without a division per element
  float ed[kVec], ey[kVec];
  load8_cg(scaled + c, ed);
  load8_cg(scaled + C + c, ey);
  T* dxs = args.dx + (r0 + y) * C + c;
  auto emit = [&](int64_t k, const Raw<T>& rx, const Raw<T>& rg) {
    float xv[kVec], gv[kVec], out[kVec];
    rx.to_float(xv);
    rg.to_float(gv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float dy, xhat;
      dy_xhat<RELU>(xv[j], gv[j], sc[j], sh[j], mu[j], rs[j], dy, xhat);
      const float q = __fmaf_rn(xhat, ey[j], ed[j]);
      out[j] = __fmul_rn(sc[j], __fsub_rn(dy, q));
    }
    store8(dxs + k * step, out);
  };

  // the rows not kept, last read first, D - 1 rows ahead
  const int64_t rest = nk - ks;
  for (int i = 0; i < D - 1; ++i) {
    if (i < rest) fetch(nk - 1 - i, i);
    cp_async_commit();
  }
  for (int64_t i = 0; i < rest; ++i) {
    if (i + D - 1 < rest) fetch(nk - 1 - (i + D - 1), i + D - 1);
    cp_async_commit();
    cp_async_wait<D - 1>();
    emit(nk - 1 - i, read_row<T>(ring_x + (i % D) * kThreads, kRing),
         read_row<T>(ring_g + (i % D) * kThreads, kRing));
  }
  // the rows kept on chip
  for (int64_t k = 0; k < ks; ++k)
    emit(k, read_row<T>(st_x + k * ty * tx, kStage),
         read_row<T>(st_g + k * ty * tx, kStage));
}

// ---------------------------------------------------- the reduce entry
// Phase A of the fused pass and its combine, as a plain launch: the same
// blocks (geometry(): bx, by, tx, ty, the strips), each thread adding its
// rows in the fused pass's order (the rows that pass keeps in shared memory,
// k < ks, after the others), the same tree over the block's row lanes and
// the same row of partials; each thread keeps kReduceRows rows of bf16 in
// flight in registers (16 bytes of x and of g each; half the rows of f32),
// and nothing is staged for a phase B. The blocks that draw the last
// integer tickets add the strips in combine_group's order (below) and write
// edz, eydz and the double sums.
constexpr int kReduceRows = 4;  // of bf16 in flight a thread (2 of f32)
// a column group's tickets: its chains' tree, then one per chain
constexpr int kReduceCounters = 1 + kCombineY;
constexpr int kCombineBatch = 16;  // a combining thread's strips in flight
static_assert(kCombineY == 16, "the chains' tree below is written for 16");

template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
bn_backward_reduce(const Args<T> args, int* counters) {
  constexpr int U = kReduceRows / words<T>();  // rows in flight a thread
  __shared__ __align__(16) float lanes[2 * kVec * kThreads];

  const int t = threadIdx.x;
  const int tx = args.tx, ty = args.ty, C = args.channels;
  const int R = args.row_blocks;
  const int x = t % tx, y = t / tx;
  const int bx = blockIdx.x % args.col_blocks, by = blockIdx.x / args.col_blocks;
  const int v = bx * tx + x;
  const bool active = y < ty && v < C / kVec;
  const int c = v * kVec;
  const int64_t r0 = (int64_t)by * args.rows_per_block;
  const int64_t r1 = r0 + args.rows_per_block < args.rows
                         ? r0 + args.rows_per_block
                         : args.rows;
  // this thread's rows are r0 + y + k ty for k < nk, added as the fused
  // pass adds them: k = ks .. nk - 1, then 0 .. ks - 1
  const int64_t span = r1 - r0 - y;
  const int64_t nk = span > 0 ? (span + ty - 1) / ty : 0;
  const int staged = args.stage_rows;
  const int64_t ks_all = staged > y ? (staged - y + ty - 1) / ty : 0;
  const int64_t ks = ks_all < nk ? ks_all : nk;
  const int64_t step = (int64_t)ty * C;
  const T* xs = args.x + (r0 + y) * C + c;
  const T* gs = args.g + (r0 + y) * C + c;
  Raw<T> rx[U], rg[U];
  // the rows added i0 .. i0 + U - 1, into registers
  auto fetch = [&](int64_t i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = i0 + u;
      if (i < nk) {
        const int64_t k = i < nk - ks ? ks + i : i - (nk - ks);
        rx[u].load(xs + k * step);
        rg[u].load(gs + k * step);
      }
    }
  };

  float s0[kVec], s1[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s0[k] = s1[k] = 0.f;
  if (active) {
    float sc[kVec], sh[kVec], mu[kVec], rs[kVec];
    rhss::load8(args.p.scale + c, sc);
    rhss::load8(args.p.shift + c, sh);
    rhss::load8(args.p.mean + c, mu);
    rhss::load8(args.p.rstd + c, rs);
    for (int64_t i0 = 0; i0 < nk; i0 += U) {
      fetch(i0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < nk) {
          float xv[kVec], gv[kVec];
          rx[u].to_float(xv);
          rg[u].to_float(gv);
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            float dy, xhat;
            dy_xhat<RELU>(xv[k], gv[k], sc[k], sh[k], mu[k], rs[k], dy,
                          xhat);
            s0[k] += dy;
            s1[k] += dy * xhat;
          }
        }
      }
    }
  }

  // the block's row lanes in the fused pass's tree
  float* sh0 = lanes;
  float* sh1 = sh0 + kVec * kThreads;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    sh0[k * kThreads + t] = s0[k];
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
        sh0[k * kThreads + t] += sh0[k * kThreads + o];
        sh1[k * kThreads + t] += sh1[k * kThreads + o];
      }
    }
    __syncthreads();
  }
  if (y == 0 && active) {
    float* p0 = args.partial + (int64_t)by * C + c;
    float* p1 = args.partial + ((int64_t)R + by) * C + c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      p0[k] = sh0[k * kThreads + t];
      p1[k] = sh1[k * kThreads + t];
    }
  }

  // the strips' partials in combine_group's order, chain cy = 0..15 adding
  // strips cy, cy + 16, ... in double, then the chains' tree, in two levels
  // of tickets: the last block of chain by % 16 of the column group adds
  // the chain (one thread per channel and sum, all its strips in flight,
  // coalesced) into chains ([2][16][C] doubles after the partials); the
  // last of the group's chains adds their tree
  int* cnt = counters + bx * kReduceCounters;
  const int chain = by % kCombineY;
  if (!rhss::last_ticket(cnt + 1 + chain, (R - chain + kCombineY - 1) /
                                              kCombineY))
    return;
  const int first = bx * tx * kVec;
  const int width = first + tx * kVec < C ? tx * kVec : C - first;
  double* chains = reinterpret_cast<double*>(args.partial + 2 * (int64_t)R * C);
  for (int w = t; w < 2 * width; w += kThreads) {
    const int which = w / width, ch = first + w % width;
    const float* part = args.partial + (int64_t)which * R * C + ch;
    double a = 0.0;
    for (int i0 = chain; i0 < R; i0 += kCombineY * kCombineBatch) {
      float f[kCombineBatch];
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j) {
        const int i = i0 + j * kCombineY;
        if (i < R) f[j] = __ldcg(part + (int64_t)i * C);
      }
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j)
        if (i0 + j * kCombineY < R) a += f[j];
    }
    chains[(int64_t)(which * kCombineY + chain) * C + ch] = a;
  }
  if (!rhss::last_ticket(cnt, R < kCombineY ? R : kCombineY)) return;
  for (int w = t; w < 2 * width; w += kThreads) {
    const int which = w / width, ch = first + w % width;
    double v[kCombineY];
#pragma unroll
    for (int i = 0; i < kCombineY; ++i) {  // a chain of no strips adds 0
      v[i] = i < R ? __ldcg(chains + (int64_t)(which * kCombineY + i) * C +
                            ch)
                   : 0.0;
    }
    // the tree: halves 8, 4, 2, 1 (kCombineY = 16)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += v[i + 8];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] += v[i + 4];
    v[0] += v[2];
    v[1] += v[3];
    v[0] += v[1];
    if (which == 0) {
      args.edz[ch] = (float)v[0];
      args.sums[ch] = v[0];
    } else {
      args.eydz[ch] = (float)v[0];
      args.sums[C + ch] = v[0];
    }
  }
  if (bx == 0 && t == 0) args.sums[2 * C] = (double)args.rows;
}

// ------------------------------------------------------- the dx entry
// dx of the split backward over the flat array of the tensor's units (8
// channels: 16 bytes of bf16, 32 of f32; unit u is row u / cv, channel
// vector u % cv, cv = C / 8). A block of B threads, B a multiple of cv,
// takes rounds of K * B neighbouring units, thread t units t + k B: its
// channel vector is t % cv in every unit it takes, since B, the round and
// the grid's stride are multiples of cv. The block first forms the
// coefficients of every channel in shared memory ([6][C]: scale, shift,
// mean, rstd, and edz / n, eydz / n in double from the group's sums, sums[2C]
// = n, rounded once as the fused combine rounds them) while its first
// round's loads fly; each thread then keeps its 8 channels' in registers.
template <typename T>
__host__ __device__ constexpr int dx_units() {  // K: 64 bytes of x a round
  return 64 / (int)sizeof(Raw<T>);
}
constexpr int kDxMinThreads = 128;
constexpr int kDxMaxThreads = 512;
constexpr int kDxMaxChannels = 8 * kDxMaxThreads;  // cv <= one block
constexpr int kDxCoefs = 6;
constexpr int kDxSmemCap = kDxCoefs * kDxMaxChannels * (int)sizeof(float);

template <typename T, bool RELU>
__global__ void __launch_bounds__(kDxMaxThreads)
bn_backward_dx(const T* __restrict__ x, const T* __restrict__ g, Params p,
               const double* __restrict__ sums, T* __restrict__ dx,
               int64_t units, int channels) {
  constexpr int K = dx_units<T>();
  extern __shared__ __align__(16) float coef[];
  const int t = threadIdx.x, B = blockDim.x, C = channels;
  const int64_t per_round = (int64_t)B * K;
  const int64_t stride = per_round * gridDim.x;
  int64_t u = (int64_t)blockIdx.x * per_round + t;
  Raw<T> rx[K], rg[K];
  auto fetch = [&](int64_t first) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t uk = first + (int64_t)k * B;
      if (uk < units) {
        rx[k].load(x + uk * kVec);
        rg[k].load(g + uk * kVec);
      }
    }
  };
  fetch(u);

  const double n = sums[2 * C];
  for (int ch = t; ch < C; ch += B) {
    coef[ch] = p.scale[ch];
    coef[C + ch] = p.shift[ch];
    coef[2 * C + ch] = p.mean[ch];
    coef[3 * C + ch] = p.rstd[ch];
    coef[4 * C + ch] = (float)(sums[ch] / n);
    coef[5 * C + ch] = (float)(sums[C + ch] / n);
  }
  __syncthreads();
  const int c = t % (C / kVec) * kVec;
  float sc[kVec], sh[kVec], mu[kVec], rs[kVec], ed[kVec], ey[kVec];
  auto own = [&](int i, float v[kVec]) {  // this thread's 8 of row i
    const float4 lo = *reinterpret_cast<const float4*>(coef + i * C + c);
    const float4 hi = *reinterpret_cast<const float4*>(coef + i * C + c + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  };
  own(0, sc);
  own(1, sh);
  own(2, mu);
  own(3, rs);
  own(4, ed);
  own(5, ey);

  for (; u < units; u += stride) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t uk = u + (int64_t)k * B;
      if (uk >= units) break;
      float xv[kVec], gv[kVec], out[kVec];
      rx[k].to_float(xv);
      rg[k].to_float(gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float dy, xhat;
        dy_xhat<RELU>(xv[j], gv[j], sc[j], sh[j], mu[j], rs[j], dy, xhat);
        const float q = __fmaf_rn(xhat, ey[j], ed[j]);
        out[j] = __fmul_rn(sc[j], __fsub_rn(dy, q));
      }
      store8(dx + uk * kVec, out);
    }
    fetch(u + stride);
  }
}

// B for cv channel vectors: the multiple of cv in [kDxMinThreads,
// kDxMaxThreads] (or the one multiple, where there is no other) that leaves
// the smallest share of its warps' lanes idle; the smallest such B.
int dx_threads(int cv) {
  int best = 0, best_idle = 0, best_lanes = 1;
  for (int b = cv; b <= kDxMaxThreads; b += cv) {
    if (b < kDxMinThreads && b + cv <= kDxMaxThreads) continue;
    const int lanes = (b + 31) / 32 * 32, idle = lanes - b;
    if (best == 0 || idle * best_lanes < best_idle * lanes) {
      best = b;
      best_idle = idle;
      best_lanes = lanes;
    }
  }
  return best;
}

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

// A function of (rows, channels, dtype, SM count): blocks of dx_threads(cv)
// threads, as many as give each thread one round, at most one wave.
template <typename T, bool RELU>
int launch_dx(const void* x, const void* g, Params p, const double* sums,
              void* dx, int64_t rows, int channels, cudaStream_t s) {
  auto kernel = bn_backward_dx<T, RELU>;
  static rhss::DeviceOnce once;
  static Occupancy occupancy;
  int sms = 0;
  const int set = once.get(&sms, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDxSmemCap);
  });
  if (set != 0) return set;
  const int cv = channels / kVec;
  const int threads = dx_threads(cv);
  const int smem = kDxCoefs * channels * (int)sizeof(float);
  int per_sm = 0;
  const int occ = occupancy.get((const void*)kernel, threads, smem, &per_sm);
  if (occ != 0) return occ;
  const int64_t units = rows * cv;
  const int64_t per_round = (int64_t)threads * dx_units<T>();
  int64_t blocks = (units + per_round - 1) / per_round;
  const int64_t wave = (int64_t)sms * per_sm;
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), p, sums,
      static_cast<T*>(dx), units, channels);
  return (int)cudaGetLastError();
}

struct Geometry : rhss::Geometry {
  int stage_rows;
  int smem;
};

// A function of (rows, channels, dtype, SM count): at most one block per SM,
// the rows split by split_rows, as bn_stats splits them.
Geometry geometry(int64_t rows, int channels, int elem_bytes, int sms) {
  Geometry g;
  const int c_vec = channels / kVec;
  g.col_blocks = (c_vec + 31) / 32;
  g.tx = (c_vec + g.col_blocks - 1) / g.col_blocks;
  g.ty = kThreads / g.tx;
  rhss::split_rows(g, rows, sms);
  const int64_t row_bytes = (int64_t)g.tx * 2 * kVec * elem_bytes;
  int64_t stage = (kSmemCap - kRingBytes) / row_bytes;
  if (stage > g.rows_per_block) stage = g.rows_per_block;
  g.stage_rows = (int)stage;
  g.smem = (int)(kRingBytes + stage * row_bytes);
  return g;
}

template <typename T, bool RELU>
int launch(const void* x, const void* g, Params p, int64_t rows, int channels,
           float* ws, float* edz, float* eydz, void* dx, double* sums,
           cudaStream_t s) {
  auto kernel = bn_backward_fused<T, RELU>;
  static rhss::DeviceOnce once;
  int sms = 0;
  const int set = once.get(&sms, [kernel] {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmemCap);
    if (err != cudaSuccess) return err;
    return per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
  });
  if (set != 0) return set;
  const Geometry geo = geometry(rows, channels, (int)sizeof(T), sms);
  // the workspace holds 2 * kTargetBlocks * C floats: the partials and edz /
  // n, eydz / n
  if (geo.row_blocks >= rhss::kTargetBlocks) return (int)cudaErrorInvalidValue;
  const Args<T> args{static_cast<const T*>(x), static_cast<const T*>(g), p,
                     ws, edz, eydz, static_cast<T*>(dx), sums, rows,
                     geo.rows_per_block, channels, geo.tx, geo.ty,
                     geo.col_blocks, geo.row_blocks, geo.stage_rows};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.col_blocks * geo.row_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The reduce entry's launch: the fused pass's geometry, a plain launch.
template <typename T, bool RELU>
int launch_reduce(const void* x, const void* g, Params p, int64_t rows,
                  int channels, float* ws, int* counters, float* edz,
                  float* eydz, double* sums, cudaStream_t s) {
  static rhss::DeviceOnce once;
  int sms = 0;
  const int set = once.get(&sms, [] { return cudaSuccess; });
  if (set != 0) return set;
  const Geometry geo = geometry(rows, channels, (int)sizeof(T), sms);
  // the workspace: the partials, then the chains (2 * 16 * C doubles)
  if (2 * geo.row_blocks + 4 * kCombineY > 2 * rhss::kTargetBlocks ||
      geo.col_blocks > rhss::kMaxGroups)
    return (int)cudaErrorInvalidValue;
  const Args<T> args{static_cast<const T*>(x), static_cast<const T*>(g), p,
                     ws, edz, eydz, static_cast<T*>(nullptr), sums, rows,
                     geo.rows_per_block, channels, geo.tx, geo.ty,
                     geo.col_blocks, geo.row_blocks, geo.stage_rows};
  bn_backward_reduce<T, RELU>
      <<<geo.col_blocks * geo.row_blocks, kThreads, 0, s>>>(args, counters);
  return (int)cudaGetLastError();
}

// The checks every entry shares; 0 when the arguments are taken.
int check(int64_t rows, int channels, int dtype, int act) {
  if (rows <= 0 || channels <= 0 || channels % kVec != 0 ||
      (dtype != 0 && dtype != 1) || (act != 0 && act != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

Params params(const void* scale, const void* shift, const void* mean,
              const void* rstd) {
  return Params{static_cast<const float*>(scale),
                static_cast<const float*>(shift),
                static_cast<const float*>(mean),
                static_cast<const float*>(rstd)};
}

// f(T{}, std::integral_constant<bool, RELU>{}) for the dtype and act codes
template <typename F>
int dispatch(int dtype, int act, F f) {
  if (dtype == 1) {
    return act ? f(__nv_bfloat16{}, std::true_type{})
               : f(__nv_bfloat16{}, std::false_type{});
  }
  return act ? f(0.f, std::true_type{}) : f(0.f, std::false_type{});
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 none, 1 relu. x, g: rows *
// channels elements, 16-byte aligned; scale, shift, mean, rstd, edz, eydz:
// channels floats, 16-byte aligned; workspace: 2 * 528 * channels floats
// (bn_reduce.cuh's kTargetBlocks); dx: rows * channels elements in x's
// dtype, 16-byte aligned, or null for dgamma and dbeta alone.
extern "C" int rhss_bn_backward(const void* x, const void* g, int64_t rows,
                                int channels, int dtype, int act,
                                const void* scale, const void* shift,
                                const void* mean, const void* rstd,
                                void* workspace, void* edz, void* eydz,
                                void* dx, void* stream) {
  const int bad = check(rows, channels, dtype, act);
  if (bad) return bad;
  return dispatch(dtype, act, [&](auto tag, auto relu) {
    return launch<decltype(tag), decltype(relu)::value>(
        x, g, params(scale, shift, mean, rstd), rows, channels,
        static_cast<float*>(workspace), static_cast<float*>(edz),
        static_cast<float*>(eydz), dx, static_cast<double*>(nullptr),
        reinterpret_cast<cudaStream_t>(stream));
  });
}

// The reduce entry: dgamma and dbeta as rhss_bn_backward gives them, and
// sums (2 * channels + 1 doubles) gets [Σdy, Σdy·x̂, n] in double. counters:
// 64 * 17 ints, 0 (and left at 0); channels <= 16384.
extern "C" int rhss_bn_backward_reduce(const void* x, const void* g,
                                       int64_t rows, int channels, int dtype,
                                       int act, const void* scale,
                                       const void* shift, const void* mean,
                                       const void* rstd, void* workspace,
                                       void* counters, void* edz, void* eydz,
                                       void* sums, void* stream) {
  const int bad = check(rows, channels, dtype, act);
  if (bad) return bad;
  if (channels > rhss::kMaxGroups * 32 * kVec)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, act, [&](auto tag, auto relu) {
    return launch_reduce<decltype(tag), decltype(relu)::value>(
        x, g, params(scale, shift, mean, rstd), rows, channels,
        static_cast<float*>(workspace), static_cast<int*>(counters),
        static_cast<float*>(edz), static_cast<float*>(eydz),
        static_cast<double*>(sums), reinterpret_cast<cudaStream_t>(stream));
  });
}

// The dx entry: dx = scale * (dy - (x̂ * eydz / n + edz / n)) from sums =
// [Σdy, Σdy·x̂, n] (2 * channels + 1 doubles), the reduce entry's sums added
// over a group. x, g, dx: rows * channels elements, 16-byte aligned; scale,
// shift, mean, rstd: channels floats, 16-byte aligned; channels <= 4096.
extern "C" int rhss_bn_backward_dx(const void* x, const void* g, int64_t rows,
                                   int channels, int dtype, int act,
                                   const void* scale, const void* shift,
                                   const void* mean, const void* rstd,
                                   const void* sums, void* dx, void* stream) {
  const int bad = check(rows, channels, dtype, act);
  if (bad) return bad;
  if (channels > kDxMaxChannels) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, act, [&](auto tag, auto relu) {
    return launch_dx<decltype(tag), decltype(relu)::value>(
        x, g, params(scale, shift, mean, rstd),
        static_cast<const double*>(sums), dx, rows, channels,
        reinterpret_cast<cudaStream_t>(stream));
  });
}

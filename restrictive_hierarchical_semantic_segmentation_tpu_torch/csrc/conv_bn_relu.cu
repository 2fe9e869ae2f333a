// A 1x1 convolution followed by eval-mode BatchNorm and ReLU, as one GEMM
// with the per-channel epilogue fused in:
//     y[m, n] = bf16(relu(a[n] * sum_k x[m, k] * w[k, n] + b[n]))
// x (M, K) bf16 (rows are NHWC pixels), wt (N, K) bf16: w (K, N) copied
// K-major by the wrapper (see "B operand" below), a and b (N,) f32, y (M, N)
// bf16. The sum is kept in f32, multiplied by a, then b is added (two
// roundings, no fused multiply-add, as the plain PyTorch version computes
// it), and rounded to bf16 once.
//
// Replaces the Pallas TPU kernel
//   tools/pallas_conv_bn_experiment.py:54 kernel (reached through
//   pallas_fused, :61), the HRNet shared head's 720 -> 720 1x1 conv + BN +
//   ReLU at 1/4 resolution.
//
// Bound on the H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): operations. At
// the tool's shape, (96256, 720) x (720, 720), the product is 99.8 GFLOP
// against 278.3 MB of x, w, a, b and y, about 359 FLOP per byte, above the
// ~295 FLOP/B at which the two rates balance: 0.1009 ms. Only wgmma reaches
// the tensor cores' rate on Hopper (the mma.sync kernel this replaces ran at
// 21 % of the bound), so the design is the Hopper GEMM's:
//  * a persistent grid, one block per SM; block b takes output tiles b,
//    b + grid, ...; tile t is (t / n_tiles, t % n_tiles), so the blocks in
//    flight share their 128-row strips of x through L2 across the N tiles,
//    and w (1 MB) stays in L2;
//  * block tile 128 x 240 (720 = 3 x 240; wgmma takes N up to 256), K steps
//    of 64 bf16 = 128 bytes, the width of the 128-byte swizzle;
//  * three warpgroups: warpgroups 0 and 1 are the consumers (rows 0-63 and
//    64-127 of the tile, setmaxnreg 232, 120 f32 accumulators a thread,
//    wgmma.m64n240k16 with both operands read from shared memory), and one
//    thread of warpgroup 2 is the producer (setmaxnreg 40): it keeps TMA
//    loads of x and wt in flight into a ring of 3 stages (46 KB each), with
//    a full and an empty mbarrier per stage, across tile boundaries;
//  * K = 720 is not a multiple of 64 (720 = 11 x 64 + 16): the last K
//    step's TMA box runs past K and TMA fills it with zeros, which add
//    nothing to the sums, so any K % 16 == 0 takes the same path. Every K
//    step runs its four k16 wgmmas unconditionally, so the wgmma sequence
//    has no branch: at K = 720 that is 48 zero columns in 768, 6.25 % of the
//    MMA work. Rows past M and columns past N are zero-filled the same way,
//    and the epilogue does not write them;
//  * B operand: w is (K, N) row-major, N-major for wgmma. The wrapper copies
//    it to (N, K) K-major on every call (1 MB at the tool's shape, in the
//    measured time), so both operands take the plain K-major 128-byte
//    swizzled layout and a stale copy can never be read. wgmma's
//    transposed-B mode reads w in place (four (64 K, 64 N) boxes a stage,
//    the last 16 columns unused); built that way it passed the card tests
//    but was slower than the copy and this kernel together in an A/B run
//    on the card (it also reads 6.7 % more bytes of w a tile);
//  * tensor maps are encoded on the host per call with
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//    -lcuda), and passed as __grid_constant__ kernel parameters;
//  * the epilogue: __fmul_rn, __fadd_rn, relu and one bf16 rounding in
//    registers (a and b of the tile's columns staged in shared memory during
//    the main loop), packed into 60 bf16x2 registers; under the next tile's
//    first wgmmas the consumer writes them into two (64, 120) boxes in
//    shared memory (240-byte rows: no bank conflicts) and copies the boxes
//    to y in coalesced 16-byte stores (stores straight from the accumulator
//    layout write 16 contiguous bytes per quad of threads; TMA stores of the
//    boxes, and a 4-stage ring with one set of boxes the consumers take in
//    turns, were slower in A/B runs on the card).
// What it cannot do (PERF.md): it reaches about half the dense bf16 rate,
// some 15 % behind cuBLAS. The tensor cores wait while the consumers drain
// the last wgmmas of a tile and do the epilogue's arithmetic (a second
// accumulator set would overlap them; 120 + 120 registers do not fit), and
// writing y competes with the loads of x. Each block also reads w's 240
// columns from L2 for every tile; a cluster multicasting the w tile to two
// blocks would halve that.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 on success) and cudaErrorInvalidValue for arguments it does not take.
// It launches on the caller's stream and does not synchronise.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 240, kBK = 64, kStages = 3;
constexpr int kConsumers = 2;                 // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileA = kBM * kBK * 2;         // 16 KB
constexpr int kTileB = kBN * kBK * 2;         // 30 KB
constexpr int kStageBytes = kTileA + kTileB;  // a multiple of 1024
constexpr int kBoxN = kBN / 2;                // output box: 64 x 120
constexpr int kBoxBytes = 64 * kBoxN * 2;     // 15 KB, two per consumer
constexpr int kAbBytes = 2 * kBN * 4;         // a tile's a and b, f32
constexpr int kSmemBytes = kStages * kStageBytes +
                           kConsumers * (2 * kBoxBytes + kAbBytes) +
                           2 * kStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA load
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the 128 threads of one warpgroup (barrier 0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): rows of 128 bytes, 8-row
// groups 1024 bytes apart (stride byte offset 1024 >> 4 = 64); the leading
// byte offset is unused by this layout (1). The tile base is 1024-aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define RHSS_ACC8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 240, f32, 120 registers a thread) = A (64 x 16) * B (16 x 240)
// + (scale_d ? D : 0); A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n240k16(float d[120], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119}, "
      "%120, %121, p, 1, 1, 0, 0;\n}\n"
      : RHSS_ACC8(0), RHSS_ACC8(8), RHSS_ACC8(16), RHSS_ACC8(24),
        RHSS_ACC8(32), RHSS_ACC8(40), RHSS_ACC8(48), RHSS_ACC8(56),
        RHSS_ACC8(64), RHSS_ACC8(72), RHSS_ACC8(80), RHSS_ACC8(88),
        RHSS_ACC8(96), RHSS_ACC8(104), RHSS_ACC8(112)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef RHSS_ACC8

__device__ __forceinline__ float relu(float y) {
  return y < 0.f ? 0.f : y;  // NaN passes, as torch.relu
}

// A consumer's 64 x 240 output tile in registers: a * acc, + b, relu, one
// bf16 rounding, packed two columns to a word. Accumulator i holds row 16
// warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i %
// 2; word i holds row 16 warp + lane / 4 + 8 (i % 2), columns 8 (i / 2) + 2
// (lane % 4) and + 1. ab: the tile's a and b, [2][kBN].
__device__ __forceinline__ void pack(const float (&d)[120], const float* ab,
                                     int lane, uint32_t (&out)[60]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float2 av = *reinterpret_cast<const float2*>(ab + c);
    const float2 bv = *reinterpret_cast<const float2*>(ab + kBN + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = relu(__fadd_rn(__fmul_rn(d[4 * j + 2 * h], av.x), bv.x));
      const float hi =
          relu(__fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1], av.y), bv.y));
      const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      out[2 * j + h] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// The packed tile out through the consumer's two (64, 120) boxes in shared
// memory: each thread writes its words (240-byte box rows, so the 8 rows
// one warp's store touches start 28 banks apart and no two share a bank),
// then the warpgroup copies the boxes to y in 16-byte chunks, neighbouring
// threads on neighbouring chunks of a row; rows past M and columns past N
// are not written (N % 8 == 0: a chunk is all in or all out).
__device__ __forceinline__ void store_tile(const uint32_t (&out)[60],
                                           uint32_t box, int warp, int lane,
                                           int t128, int wg,
                                           __nv_bfloat16* __restrict__ y,
                                           int M, int N, int m0, int n0) {
  warpgroup_sync(wg);  // the last tile's copy has read the boxes
#pragma unroll
  for (int i = 0; i < 60; ++i) {
    const int j = i / 2, h = i % 2;
    const uint32_t addr = box + (j / 15) * kBoxBytes +
                          (warp * 16 + lane / 4 + 8 * h) * (kBoxN * 2) +
                          (8 * (j % 15) + 2 * (lane % 4)) * 2;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(out[i]));
  }
  warpgroup_sync(wg);
  constexpr int kChunks = kBoxN * 2 / 16;  // 16-byte chunks of a box row
#pragma unroll 3
  for (int idx = t128; idx < 2 * 64 * kChunks; idx += 128) {
    const int b = idx / (64 * kChunks), r = idx % (64 * kChunks) / kChunks;
    const int c = idx % kChunks;
    const int m = m0 + r, n = n0 + b * kBoxN + c * 8;
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(box + b * kBoxBytes + r * (kBoxN * 2) + c * 16));
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(y + (int64_t)m * N + n) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv1x1_bn_relu_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       __nv_bfloat16* __restrict__ y, int M, int K, int N,
                       int n_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t boxes = base + kStages * kStageBytes;  // kConsumers boxes
  const uint32_t abs_ = boxes + kConsumers * 2 * kBoxBytes;  // a, b
  const uint32_t full = abs_ + kConsumers * kAbBytes;    // kStages mbarriers
  const uint32_t empty = full + kStages * 8;           // kStages mbarriers
  const int k_steps = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers);  // one arrive per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ------------------------------------------------------- the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * kBN;
        for (int kb = 0; kb < k_steps; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // first round: free
          const uint32_t bar = full + 8 * stage;
          const uint32_t sa = base + stage * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);  // whole boxes, zero fill too
          tma_load_2d(sa, &map_x, bar, kb * kBK, m0);
          tma_load_2d(sa + kTileA, &map_w, bar, kb * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------------------------------------- the two consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t128 = threadIdx.x % 128;
    const int warp = t128 / 32, lane = t128 % 32;
    float d[120];
#pragma unroll
    for (int i = 0; i < 120; ++i) d[i] = 0.f;  // each tile's first wgmma
                                               // overwrites them (scale_d 0)
    const uint32_t box = boxes + wg * 2 * kBoxBytes;
    // this consumer's copy of the tile's a and b: [2][kBN] f32, 0 past N
    float* ab = reinterpret_cast<float*>(smem_raw +
                                         (abs_ + wg * kAbBytes -
                                          smem_addr(smem_raw)));
    uint32_t out[60];  // the last tile's output, not yet stored
    bool pending = false;
    int out_m0 = 0, out_n0 = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM, n0 = (t % n_tiles) * kBN;
      // a and b of the tile's columns, read long before the epilogue needs
      // them, once every thread has packed the last tile
      warpgroup_sync(wg);
      if (t128 < kBN / 2) {
        const int n = n0 + 2 * t128;
        float2 av = make_float2(0.f, 0.f), bv = av;
        if (n < N) {  // N % 8 == 0: both columns in or both out
          av = __ldg(reinterpret_cast<const float2*>(a + n));
          bv = __ldg(reinterpret_cast<const float2*>(b + n));
        }
        *reinterpret_cast<float2*>(ab + 2 * t128) = av;
        *reinterpret_cast<float2*>(ab + kBN + 2 * t128) = bv;
      }
      int prev = 0;
      for (int kb = 0; kb < k_steps; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kStageBytes + wg * (kTileA / 2);
        const uint32_t sb = base + stage * kStageBytes + kTileA;
        const uint64_t da = sw128_desc(sa), db = sw128_desc(sb);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // +32 bytes along K inside the swizzle atom: +2 in 16-byte units
          wgmma_m64n240k16(d, da + 2 * kk, db + 2 * kk, kb > 0 || kk > 0);
        }
        wgmma_commit();
        if (kb == 0 && pending) {  // the last tile's output, under the wgmmas
          store_tile(out, box, warp, lane, t128, wg, y, M, N,
                     out_m0 + wg * 64, out_n0);
          pending = false;
        }
        if (kb > 0) {  // the previous step's wgmmas are done: free its stage
          wgmma_wait<1>();
          if (t128 == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (t128 == 0) mbar_arrive(empty + 8 * prev);

      // the epilogue's arithmetic now; its stores under the next tile's
      // first wgmmas
      warpgroup_sync(wg);  // ab is written
      pack(d, ab, lane, out);
      pending = true;
      out_m0 = m0;
      out_n0 = n0;
    }
    if (pending) {  // the block's last tile
      store_tile(out, box, warp, lane, t128, wg, y, M, N, out_m0 + wg * 64,
                 out_n0);
    }
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) bf16 row-major matrix read in boxes of box_rows x box_cols,
// 128-byte swizzled, zero-filled outside
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int64_t rows,
            int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: rows * k bf16, wt: n * k bf16 (w transposed, K-major), a and b: n
// floats, y: rows * n bf16; every pointer 16-byte aligned; k % 16 == 0,
// n % 8 == 0, rows < 2^31.
extern "C" int rhss_conv1x1_bn_relu(const void* x, const void* wt,
                                    const void* a, const void* b, void* y,
                                    int64_t rows, int k, int n,
                                    void* stream) {
  if (rows < 0 || rows > 0x7fffffff - kBM || k <= 0 || k % 16 != 0 ||
      n <= 0 || n % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  static rhss::DeviceOnce once;
  int sms = 0;
  const int err = once.get(&sms, [] {
    return cudaFuncSetAttribute(conv1x1_bn_relu_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  });
  if (err != 0) return err;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  // x and wt in K steps of 64 bf16 for wgmma
  CUtensorMap map_x, map_w;
  if (!encode(fn, &map_x, x, rows, k, kBM, kBK) ||
      !encode(fn, &map_w, wt, n, k, kBN, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (n + kBN - 1) / kBN;
  const int64_t tiles = (rows + kBM - 1) / kBM * n_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv1x1_bn_relu_kernel<<<grid, kThreads, kSmemBytes,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
      (int)rows, k, n, n_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

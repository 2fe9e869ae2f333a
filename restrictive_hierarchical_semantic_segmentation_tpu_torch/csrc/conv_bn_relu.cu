// A 1x1 convolution followed by eval-mode BatchNorm and ReLU, as one GEMM
// with the per-channel epilogue fused in:
//     y[m, n] = bf16(relu(a[n] * sum_k x[m, k] * w[k, n] + b[n]))
// x (M, K) bf16 (rows are NHWC pixels), w (K, N) bf16 row-major (the layout
// of jnp.dot(x, w)), a and b (N,) f32, y (M, N) bf16. The sum is kept in f32,
// multiplied by a, then b is added (two roundings, no fused multiply-add, as
// the plain PyTorch version computes it), and rounded to bf16 once.
//
// Replaces the Pallas TPU kernel
//   tools/pallas_conv_bn_experiment.py:54 kernel (reached through
//   pallas_fused, :61), the HRNet shared head's 720 -> 720 1x1 conv + BN +
//   ReLU at 1/4 resolution.
//
// Bound on the H100: operations. At the tool's shape, (96256, 720) x
// (720, 720), the product is 99.8 GFLOP against 278.3 MB of x, w, a, b and
// y, about 359 FLOP per byte: above the ~295 FLOP/B at which 989 TFLOP/s of
// dense bf16 and 3.35 TB/s of HBM balance. So the tensor cores, not the
// memory, bound it (0.1009 ms), and y never leaves registers before its
// epilogue: it is written once, in bf16.
//
// Design (a simple kernel that is right; wgmma and TMA are later work):
//  * block tile 128 x 144 with a K step of 48: both 144 and 48 divide 720,
//    so the tool's shape wastes no work in N or K; 8 warps as 4 (M) x 2 (N),
//    each warp 32 x 72 = 2 x 9 mma.sync.m16n8k16 tiles with f32 accumulators
//    in registers;
//  * a three-stage ring of cp.async copies (16 bytes each) in dynamic shared
//    memory (84.75 KB a block, two blocks an SM); rows past M, columns past
//    N and the K tail past K are zero-filled by the copy itself, so any M,
//    any K % 16 == 0 and any N % 8 == 0 work, and the 16-byte chunks never
//    straddle the edge;
//  * shared-memory rows padded (A to 56, B to 152 bf16), so the eight
//    16-byte rows each ldmatrix reads fall in distinct banks;
//  * A fragments by ldmatrix.x4; w is row-major (K, N), so B fragments by
//    ldmatrix.trans (x4 for two n8 tiles, x2 for the ninth);
//  * blocks walk the N tiles of one M tile together (block id % N tiles),
//    so a 128-row strip of x is read from HBM about once and w (1 MB) stays
//    in L2;
//  * the epilogue in registers: __fmul_rn, __fadd_rn, relu, one bf16
//    rounding, masked 4-byte stores.
// mma.sync cannot reach wgmma's rate on Hopper: this kernel is measured
// against its bound in PERF.md, and a wgmma/TMA kernel is a later PR.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch
// (0 on success) and cudaErrorInvalidValue for arguments it does not take.
// It launches on the caller's stream and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 144, kBK = 48, kStages = 3;
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kWM = kBM / kWarpsM;  // 32 rows: 2 m16 tiles
constexpr int kWN = kBN / kWarpsN;  // 72 columns: 9 n8 tiles
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int kLdA = kBK + 8;  // bf16 per shared row of the A tile
constexpr int kLdB = kBN + 8;  // bf16 per shared row of the B tile
constexpr int kStageA = kBM * kLdA;
constexpr int kStageB = kBK * kLdB;
constexpr int kSmemBytes = kStages * (kStageA + kStageB) * 2;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; with valid == false nothing is read and
// the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// D = A * B + D, A 16 x 16 (row), B 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K step of the A tile (kBM x kBK) and the B tile (kBK x kBN) into a
// stage of the ring, zero-filled outside (M, K) and (K, N).
__device__ __forceinline__ void load_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* sa, __nv_bfloat16* sb, int64_t m0, int n0, int k0,
    int64_t M, int K, int N) {
  constexpr int kChunksA = kBK / 8;  // 16-byte chunks per A row
  constexpr int kChunksB = kBN / 8;  // 16-byte chunks per B row
  for (int i = threadIdx.x; i < kBM * kChunksA; i += kThreads) {
    const int r = i / kChunksA, ch = i % kChunksA;
    const int64_t gm = m0 + r;
    const int gk = k0 + ch * 8;
    const bool ok = gm < M && gk < K;
    cp_async16(sa + r * kLdA + ch * 8, ok ? x + gm * K + gk : x, ok);
  }
  for (int i = threadIdx.x; i < kBK * kChunksB; i += kThreads) {
    const int r = i / kChunksB, ch = i % kChunksB;
    const int gk = k0 + r;
    const int gn = n0 + ch * 8;
    const bool ok = gk < K && gn < N;
    cp_async16(sb + r * kLdB + ch * 8, ok ? w + (int64_t)gk * N + gn : w, ok);
  }
}

__device__ __forceinline__ float relu(float y) {
  return y < 0.f ? 0.f : y;  // NaN passes, as torch.relu
}

__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bn_relu_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       __nv_bfloat16* __restrict__ y, int64_t M, int K, int N,
                       int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_a = smem;
  __nv_bfloat16* s_b = smem + kStages * kStageA;

  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / kWarpsN) * kWM;  // warp's rows in the block tile
  const int wn = (warp % kWarpsN) * kWN;  // warp's columns

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles)
      load_tile(x, w, s_a + s * kStageA, s_b + s * kStageB, m0, n0, s * kBK,
                M, K, N);
    cp_async_commit();  // an empty group keeps the count in step
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread; slot kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      const int s = next % kStages;
      load_tile(x, w, s_a + s * kStageA, s_b + s * kStageB, m0, n0,
                next * kBK, M, K, N);
    }
    cp_async_commit();

    const __nv_bfloat16* ta = s_a + (kt % kStages) * kStageA;
    const __nv_bfloat16* tb = s_b + (kt % kStages) * kStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], ta + (wm + i * 16 + lane % 16) * kLdA + kk +
                               (lane / 16) * 8);
      uint32_t bf[kNT][2];
#pragma unroll
      for (int j = 0; j + 1 < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, tb + (kk + lane % 16) * kLdB + wn + j * 8 +
                                 (lane / 16) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
      if (kNT % 2) {
        ldmatrix_x2_trans(bf[kNT - 1],
                          tb + (kk + lane % 16) * kLdB + wn + (kNT - 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: thread (lane) holds rows lane / 4 and lane / 4 + 8 of each
  // m16 tile, columns 2 * (lane % 4) and + 1 of each n8 tile
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n0 + wn + j * 8 + 2 * (lane % 4);
    if (n >= N) continue;  // N % 8 == 0: both columns in or both out
    const float2 av = *reinterpret_cast<const float2*>(a + n);
    const float2 bv = *reinterpret_cast<const float2*>(b + n);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm + i * 16 + lane / 4 + h * 8;
        if (m >= M) continue;
        const float lo = relu(__fadd_rn(__fmul_rn(acc[i][j][2 * h], av.x),
                                        bv.x));
        const float hi = relu(__fadd_rn(__fmul_rn(acc[i][j][2 * h + 1], av.y),
                                        bv.y));
        *reinterpret_cast<__nv_bfloat162*>(y + m * N + n) =
            __floats2bfloat162_rn(lo, hi);
      }
    }
  }
}

}  // namespace

// x: rows * k bf16, w: k * n bf16, a and b: n floats, y: rows * n bf16; every
// pointer 16-byte aligned; k % 16 == 0, n % 8 == 0.
extern "C" int rhss_conv1x1_bn_relu(const void* x, const void* w,
                                    const void* a, const void* b, void* y,
                                    int64_t rows, int k, int n,
                                    void* stream) {
  if (rows < 0 || k <= 0 || k % 16 != 0 || n <= 0 || n % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return (int)cudaSuccess;
  // dynamic shared memory above 48 KB must be asked for, once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(conv1x1_bn_relu_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int n_tiles = (n + kBN - 1) / kBN;
  const int64_t blocks = (rows + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  conv1x1_bn_relu_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), rows, k,
      n, n_tiles);
  return (int)cudaGetLastError();
}

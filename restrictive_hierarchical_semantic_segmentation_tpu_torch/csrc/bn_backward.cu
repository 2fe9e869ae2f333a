// Backward of the train-mode BatchNorm + activation over a channels_last
// (rows, C) tensor, y = act(x * scale + shift) with scale = gamma * rstd,
// shift = beta - mean * gamma * rstd and the batch statistics mean, rstd of
// x itself. Given g = dL/dy:
//     dy     = g * [z > 0] (relu) or g (none),   z = x * scale + shift
//     xhat   = (x - mean) * rstd
//     edz    = sum_r dy,  eydz = sum_r dy * xhat          (pass A)
//     dx     = scale * (dy - (xhat * eydz + edz) / n)      (pass B)
//     dgamma = eydz,  dbeta = edz
// x, g and dx are bf16 or f32 (one dtype); every per-channel vector is f32.
//
// Replaces the Pallas TPU kernel
//   restrictive_hierarchical_semantic_segmentation_tpu/ops/fused_bn_act.py
//   _bwd_kernel (the custom VJP _fba_bwd of fused_bn_act), together with
//   the XLA elementwise tail of _fba_bwd that forms dx.
//
// Bound on the H100: memory. The function reads x and g once and writes dx
// once; the least time is 3 * numel * elem_bytes / 3.35 TB/s. This design
// makes two passes (A reads x and g, B reads them again and writes dx), so
// it moves 5 tensors and can reach at most 60 % of that bound. The Pallas
// kernel also writes dy as an f32 tensor for XLA's tail; here pass B
// recomputes dy instead, so no (rows, C) intermediate is stored.
//
// z, dy and xhat are computed with the same roundings as the plain PyTorch
// version (no fused multiply-add), so the relu mask is the forward's, bit
// for bit. Pass A is the column reduction of bn_reduce.cuh; pass B a
// grid-stride elementwise loop over 16-byte vectors.
//
// Plain C interface for ctypes: each function returns cudaGetLastError()
// after its launches (0 on success), or cudaErrorInvalidValue for arguments
// it does not take. Launches go on the caller's stream; nothing synchronises
// and nothing is allocated here.
#include "bn_reduce.cuh"

namespace {

using rhss::kVec;

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

template <typename T, bool RELU>
struct ReduceOp {
  static constexpr int kUnroll = 2;
  struct Row {
    rhss::Raw<T> x, g;
  };
  struct State {
    float scale[kVec], shift[kVec], mean[kVec], rstd[kVec];
  };
  const T* __restrict__ x;
  const T* __restrict__ g;
  Params p;

  __device__ __forceinline__ State state(int c) const {
    State s;
    rhss::load8(p.scale + c, s.scale);
    rhss::load8(p.shift + c, s.shift);
    rhss::load8(p.mean + c, s.mean);
    rhss::load8(p.rstd + c, s.rstd);
    return s;
  }
  __device__ __forceinline__ void load(int64_t offset, Row& row) const {
    row.x.load(x + offset);
    row.g.load(g + offset);
  }
  __device__ __forceinline__ void add(const State& s, const Row& row,
                                      float s0[kVec], float s1[kVec]) const {
    float xv[kVec], gv[kVec];
    row.x.to_float(xv);
    row.g.to_float(gv);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float dy, xhat;
      dy_xhat<RELU>(xv[k], gv[k], s.scale[k], s.shift[k], s.mean[k],
                    s.rstd[k], dy, xhat);
      s0[k] += dy;
      s1[k] += dy * xhat;
    }
  }
};

struct ReduceFin {
  float* edz;
  float* eydz;
  __device__ __forceinline__ void operator()(int c, double a,
                                             double b) const {
    edz[c] = (float)a;
    eydz[c] = (float)b;
  }
};

// 8 values of x's dtype from f32
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(rhss::kThreads)
bn_backward_dx(const T* __restrict__ x, const T* __restrict__ g, Params p,
               const float* __restrict__ edz, const float* __restrict__ eydz,
               float n, T* __restrict__ dx, int64_t n_vec, int c_vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const int c = (int)(i % c_vec) * kVec;
    rhss::Raw<T> rx, rg;
    rx.load(x + i * kVec);
    rg.load(g + i * kVec);
    float xv[kVec], gv[kVec], sc[kVec], sh[kVec], mu[kVec], rs[kVec],
        ed[kVec], ey[kVec], out[kVec];
    rx.to_float(xv);
    rg.to_float(gv);
    rhss::load8(p.scale + c, sc);
    rhss::load8(p.shift + c, sh);
    rhss::load8(p.mean + c, mu);
    rhss::load8(p.rstd + c, rs);
    rhss::load8(edz + c, ed);
    rhss::load8(eydz + c, ey);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float dy, xhat;
      dy_xhat<RELU>(xv[k], gv[k], sc[k], sh[k], mu[k], rs[k], dy, xhat);
      // scale * (dy - (xhat * eydz + edz) / n), rounded op by op
      const float t = __fdiv_rn(__fadd_rn(__fmul_rn(xhat, ey[k]), ed[k]), n);
      out[k] = __fmul_rn(sc[k], __fsub_rn(dy, t));
    }
    store8(dx + i * kVec, out);
  }
}

template <typename T, bool RELU>
int launch_reduce(const void* x, const void* g, Params p, int64_t rows,
                  int channels, float* ws, float* edz, float* eydz,
                  cudaStream_t s) {
  const ReduceOp<T, RELU> op{static_cast<const T*>(x),
                             static_cast<const T*>(g), p};
  return rhss::reduce_columns(op, ReduceFin{edz, eydz}, rows, channels, ws, s);
}

template <typename T, bool RELU>
int launch_dx(const void* x, const void* g, Params p, const float* edz,
              const float* eydz, int64_t rows, int channels, void* dx,
              cudaStream_t s) {
  const int64_t n_vec = rows * channels / kVec;
  bn_backward_dx<T, RELU><<<rhss::grid_for(n_vec), rhss::kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), p, edz, eydz,
      (float)rows, static_cast<T*>(dx), n_vec, channels / kVec);
  return (int)cudaGetLastError();
}

bool bad_args(int64_t rows, int channels, int dtype, int act) {
  return rows <= 0 || channels <= 0 || channels % kVec != 0 ||
         (dtype != 0 && dtype != 1) || (act != 0 && act != 1);
}

}  // namespace

// Pass A. dtype: 0 = float32, 1 = bfloat16; act: 0 none, 1 relu. x, g:
// rows * channels elements, 16-byte aligned; scale, shift, mean, rstd, edz,
// eydz: channels floats, 16-byte aligned; workspace: 2 * 528 * channels
// floats (bn_reduce.cuh's kTargetBlocks).
extern "C" int rhss_bn_backward_reduce(const void* x, const void* g,
                                       int64_t rows, int channels, int dtype,
                                       int act, const void* scale,
                                       const void* shift, const void* mean,
                                       const void* rstd, void* workspace,
                                       void* edz, void* eydz, void* stream) {
  if (bad_args(rows, channels, dtype, act)) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(scale),
                 static_cast<const float*>(shift),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(rstd)};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  float* e0 = static_cast<float*>(edz);
  float* e1 = static_cast<float*>(eydz);
  if (dtype == 1) {
    return act ? launch_reduce<__nv_bfloat16, true>(x, g, p, rows, channels,
                                                    ws, e0, e1, s)
               : launch_reduce<__nv_bfloat16, false>(x, g, p, rows, channels,
                                                     ws, e0, e1, s);
  }
  return act ? launch_reduce<float, true>(x, g, p, rows, channels, ws, e0, e1,
                                          s)
             : launch_reduce<float, false>(x, g, p, rows, channels, ws, e0,
                                           e1, s);
}

// Pass B: dx in x's dtype, rows * channels elements, 16-byte aligned.
extern "C" int rhss_bn_backward_dx(const void* x, const void* g, int64_t rows,
                                   int channels, int dtype, int act,
                                   const void* scale, const void* shift,
                                   const void* mean, const void* rstd,
                                   const void* edz, const void* eydz, void* dx,
                                   void* stream) {
  if (bad_args(rows, channels, dtype, act)) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(scale),
                 static_cast<const float*>(shift),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(rstd)};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* e0 = static_cast<const float*>(edz);
  const float* e1 = static_cast<const float*>(eydz);
  if (dtype == 1) {
    return act ? launch_dx<__nv_bfloat16, true>(x, g, p, e0, e1, rows,
                                                channels, dx, s)
               : launch_dx<__nv_bfloat16, false>(x, g, p, e0, e1, rows,
                                                 channels, dx, s);
  }
  return act ? launch_dx<float, true>(x, g, p, e0, e1, rows, channels, dx, s)
             : launch_dx<float, false>(x, g, p, e0, e1, rows, channels, dx, s);
}

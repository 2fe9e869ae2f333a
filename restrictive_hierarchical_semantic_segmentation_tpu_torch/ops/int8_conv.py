"""The int8 convolution of post-training quantization: int8 NHWC
activations and int8 HWIO weights in, int32 accumulators out.

It computes what the JAX package's ``train/quantize.py`` gets from
``jax.lax.conv_general_dilated(xq, kq, strides, padding,
dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=int32)``.
XLA computes that outside any Pallas kernel, so it is no TPU kernel of the
repository; on the card it is a library product:

* an im2col in NHWC from int8 strided slices of the zero-padded input, with
  the depth K ordered (kh, kw, c), which is the order of the weight taken
  as (O, kh, kw, C) (a 1x1 conv at stride 1 reads the input as it is);
* ``torch._int_mm``, cuBLASLt's int8 tensor-core GEMM with int32
  accumulation, whose rules the wrapper meets on purpose: more than 16 rows
  (fewer are padded with zero rows), K a multiple of 8 (padded with zero
  columns: the stems have K = 27), N a multiple of 8 (the weight padded
  with zero output channels, whose columns of the product are sliced off:
  HRNet-W18's branches have 18 and 36), both operands K-major: the im2col
  (M, K) row-major and the weight as the transpose of a contiguous (N, K).

The plain version (:func:`_int8_conv_ref`, the CPU's path and the card's
reference) is a float64 ``F.conv2d`` of the integer-valued tensors: every
product is below 2^14 and every sum at most 127^2 * K < 2^53, so it is
exact, and the card path must equal it bit for bit.

The wrapper calls the operator ``torch.ops.rhss.int8_conv2d``
(``torch.library``), which picks by where ``xq`` lies: a CPU tensor goes
through the plain version, a CUDA tensor through the GEMM (or the call
raises). Its fake implementation gives the int32 ``(B, Ho, Wo, N)`` from
the shapes, so ``torch.export`` records one node per conv and a symbolic
batch never meets the card path's branches on the row count. ``CALLS``
counts the card path's calls and nothing else.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["int8_conv2d", "CALLS"]

# card-path calls since the count was last set to 0 (chip_smoke.py reads it)
CALLS = 0

_MIN_ROWS = 17  # torch._int_mm takes more than 16 rows


def _out_hw(h: int, w: int, kh: int, kw: int, stride, padding):
    return ((h + 2 * padding[0] - kh) // stride[0] + 1,
            (w + 2 * padding[1] - kw) // stride[1] + 1)


def _int8_conv_ref(xq: torch.Tensor, kq: torch.Tensor,
                   stride: Tuple[int, int],
                   padding: Tuple[int, int]) -> torch.Tensor:
    """Plain version: the float64 conv of the integers, exact, as int32."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   kq.permute(3, 2, 0, 1).double(),
                   stride=stride, padding=padding)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride, padding,
            k_pad: int) -> torch.Tensor:
    """(B, H, W, C) int8 -> (B * Ho * Wo, kh * kw * C + k_pad) int8, the
    depth ordered (kh, kw, c) and zero-padded at the end."""
    b, h, w, c = xq.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    k = kh * kw * c
    if (kh, kw, stride, padding, k_pad) == (1, 1, (1, 1), (0, 0), 0):
        return xq.reshape(b * h * w, c)
    ph, pw = padding
    xp = xq.new_zeros((b, h + 2 * ph, w + 2 * pw, c))
    xp[:, ph:ph + h, pw:pw + w] = xq
    cols = xq.new_zeros((b, ho, wo, k + k_pad))
    sh, sw = stride
    for i in range(kh):
        for j in range(kw):
            t = (i * kw + j) * c
            cols[..., t:t + c] = xp[:, i:i + sh * (ho - 1) + 1:sh,
                                    j:j + sw * (wo - 1) + 1:sw]
    return cols.reshape(b * ho * wo, k + k_pad)


def _card(xq: torch.Tensor, kq: torch.Tensor, stride, padding
          ) -> torch.Tensor:
    global CALLS
    b, h, w, c = xq.shape
    kh, kw, _, n = kq.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    k = kh * kw * c
    k_pad = -k % 8
    a = _im2col(xq.contiguous(), kh, kw, stride, padding, k_pad)
    # (N, K) with K contiguous, passed transposed: cuBLASLt's int8 GEMM
    # wants both operands K-major (its "TN" layout) and refuses others at
    # some shapes (CUBLAS_STATUS_NOT_SUPPORTED at 96100 x 32 x 64)
    w_nk = kq.permute(3, 0, 1, 2).reshape(n, k)
    if k_pad:
        w_nk = torch.cat([w_nk, w_nk.new_zeros((n, k_pad))], dim=1)
    n_pad = -n % 8  # zero output channels, sliced off the product
    if n_pad:
        w_nk = torch.cat([w_nk, w_nk.new_zeros((n_pad, k + k_pad))])
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_MIN_ROWS - m, a.shape[1]))])
    acc = torch._int_mm(a.contiguous(), w_nk.contiguous().t())
    CALLS += 1
    return acc[:m, :n].reshape(b, ho, wo, n)


@torch.library.custom_op("rhss::int8_conv2d", mutates_args=(),
                         device_types="cuda")
def _int8_conv_op(xq: torch.Tensor, kq: torch.Tensor, stride: List[int],
                  padding: List[int]) -> torch.Tensor:
    """``torch.ops.rhss.int8_conv2d``: the GEMM on a CUDA tensor."""
    return _card(xq, kq, tuple(stride), tuple(padding))


@_int8_conv_op.register_kernel("cpu")
def _int8_conv_op_cpu(xq, kq, stride, padding):
    return _int8_conv_ref(xq, kq, tuple(stride), tuple(padding))


@_int8_conv_op.register_fake
def _int8_conv_op_fake(xq, kq, stride, padding):
    b, h, w, _ = xq.shape
    kh, kw, _, n = kq.shape
    ho, wo = _out_hw(h, w, kh, kw, stride, padding)
    return xq.new_empty((b, ho, wo, n), dtype=torch.int32)


def int8_conv2d(xq: torch.Tensor, kq: torch.Tensor,
                stride: Tuple[int, int] = (1, 1),
                padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """``xq`` (B, H, W, C) int8, ``kq`` (kh, kw, C, O) int8 (HWIO), a
    symmetric zero ``padding`` (ph, pw) and ``stride`` (sh, sw) -> the
    (B, Ho, Wo, O) int32 accumulators."""
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 xq and kq, got {xq.dtype} "
                        f"and {kq.dtype}")
    if xq.dim() != 4 or kq.dim() != 4 or xq.shape[3] != kq.shape[2]:
        raise ValueError(f"int8_conv2d takes NHWC xq and HWIO kq with the "
                         f"same C; got {tuple(xq.shape)}, {tuple(kq.shape)}")
    if kq.device != xq.device:
        raise ValueError(f"kq is on {kq.device}, xq on {xq.device}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv2d runs on cpu or cuda, not {xq.device}")
    return torch.ops.rhss.int8_conv2d(xq, kq, [int(s) for s in stride],
                                      [int(p) for p in padding])

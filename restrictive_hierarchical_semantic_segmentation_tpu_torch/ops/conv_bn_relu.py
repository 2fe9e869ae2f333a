"""A 1x1 convolution + eval-mode BatchNorm + ReLU as one GEMM with a fused
epilogue: ``relu(a * (x @ w) + b)``.

Counterpart of the Pallas ``kernel`` of the JAX package's tool
``tools/pallas_conv_bn_experiment.py`` (``pallas_fused``): the HRNet shared
head's 720 -> 720 1x1 conv followed by its folded BatchNorm and ReLU, with
the pixels of an NHWC activation as the rows of ``x``. The kernel is
``csrc/conv_bn_relu.cu`` (a warp-specialised, persistent ``wgmma`` bf16 GEMM
fed by TMA, for ``sm_90a``, built with ``nvcc`` at first use and called
through ``ctypes``); its plain PyTorch version is
:func:`_conv1x1_bn_relu_ref`. The kernel reads w K-major: the wrapper copies
``w`` (C_in, C_out) to (C_out, C_in) on every call (:func:`_k_major`), so a
weight changed in place is never read stale.

The wrapper picks by where ``x`` lies: a CPU tensor goes through the plain
version, a CUDA tensor through the kernel (or the call raises). ``LAUNCHES``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .fused_bn_act import _call, _device_of, _stream

__all__ = ["conv1x1_bn_relu", "LAUNCHES"]

# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_FN = []


def _fn():
    if not _FN:
        from ._build import load

        fn = load("conv_bn_relu").rhss_conv1x1_bn_relu
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, _P, _P, _P, _I64, _I, _I, _P]
        _FN.append(fn)
    return _FN[0]


def _conv1x1_bn_relu_ref(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 product of the upcast inputs, ``* a``, ``+ b``,
    ReLU, one rounding to bf16."""
    y = torch.matmul(x.float(), w.float()) * a.float() + b.float()
    return torch.relu(y).to(torch.bfloat16)


def _check(x, w, a, b) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"conv1x1_bn_relu takes bf16 x and w, got {x.dtype} "
                        f"and {w.dtype}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"conv1x1_bn_relu takes f32 a and b, got {a.dtype} "
                        f"and {b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"conv1x1_bn_relu needs x (N, C_in) and w (C_in, "
                         f"C_out); got {tuple(x.shape)} and {tuple(w.shape)}")
    c_in, c_out = w.shape
    if a.shape != (c_out,) or b.shape != (c_out,):
        raise ValueError(f"a and b must have shape ({c_out},), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if any(t.device != x.device for t in (w, a, b)):
        raise ValueError("x, w, a and b must be on one device")
    if c_in % 16 or c_out % 8:
        # the kernel copies 16-byte chunks of 8 bf16 and takes K in steps of
        # 16 (one mma); the plain version is held to the same contract
        raise ValueError(f"conv1x1_bn_relu needs C_in % 16 == 0 and C_out % 8"
                         f" == 0; got C_in = {c_in}, C_out = {c_out}")
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"conv1x1_bn_relu needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"conv1x1_bn_relu needs {name} 16-byte aligned")


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """w (C_in, C_out) as the (C_out, C_in) contiguous matrix the kernel's
    TMA loads read K-major (a fresh copy, 16-byte aligned)."""
    return w.t().contiguous()


def _launch(x, w, a, b) -> torch.Tensor:
    global LAUNCHES
    c_in, c_out = w.shape
    wt = _k_major(w)
    y = torch.empty(x.shape[0], c_out, dtype=torch.bfloat16, device=x.device)
    _call(x, "conv1x1_bn_relu", _fn(), x.data_ptr(), wt.data_ptr(),
          a.data_ptr(), b.data_ptr(), y.data_ptr(), x.shape[0], c_in, c_out,
          _stream(x))
    LAUNCHES += 1
    return y


def conv1x1_bn_relu(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """``bf16(relu(a * (x @ w) + b))`` with the sum accumulated in f32.

    x: (N, C_in) bf16, one row per NHWC pixel; w: (C_in, C_out) bf16 (the
    layout of ``jnp.dot(x, w)``); a, b: (C_out,) f32. Returns (N, C_out)
    bf16. Every tensor must be contiguous and 16-byte aligned, with C_in %
    16 == 0 and C_out % 8 == 0 (the kernel's contract, checked on either
    device); anything else raises."""
    _check(x, w, a, b)
    if _device_of(x, "conv1x1_bn_relu") == "cpu":
        return _conv1x1_bn_relu_ref(x, w, a, b)
    return _launch(x, w, a, b)

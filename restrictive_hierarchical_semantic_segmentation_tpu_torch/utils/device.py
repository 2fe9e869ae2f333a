"""Device selection shared by the port's entry points, and the float32
context of their f32 paths on the card.

Entry points run on ``cuda`` unless the caller asks for the CPU. Asking for
``cuda`` on a machine without a card raises: there is no silent fallback.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "float32_convs"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch sees no CUDA device; pass "
            "device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def float32_convs(enabled: bool):
    """While ``enabled``, cuDNN convolutions and cuBLAS matmuls of float32
    inputs compute in float32, not TF32; the flags are restored after.
    Under PyTorch's default (cuDNN TF32 on) the f32 Evaluator and Predictor
    on the card were neither batch-invariant nor equal to the CPU."""
    if not enabled:
        yield
        return
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags

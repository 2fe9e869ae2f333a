"""Bilinear resize with explicit corner alignment; counterpart of the JAX
package's ``ops/resize.py`` in its ``"gather"`` formulation.

Both conventions of the reference:

* ``align_corners=True``: source ``o * (in - 1) / (out - 1)`` (the HRNet and
  UNet interpolations);
* ``align_corners=False``: half-pixel source ``(o + 0.5) * in / out - 0.5``,
  clipped to ``[0, in - 1]`` (torchvision ``Resize(antialias=False)``).

Each axis is one gather-and-lerp pass, ``x_lo + (x_hi - x_lo) * w``, with
the indices and weights computed once per shape in float64 by numpy, as
the JAX package computes them. ``F.interpolate`` computes the same function
but derives source coordinates in float32: at 155 -> 620 px that moves a
sample by up to ~1e-5 of a pixel and the result by ~5e-5 on unit-scale
data, outside the 1e-5 the port holds this op to.

Public functions take NHWC (the JAX layout); :func:`resize_nchw` is the
form the models use on their NCHW activations. It works on the NHWC view,
so a ``channels_last`` input gives a ``channels_last`` output.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_bilinear", "resize_nchw", "upsample2x_align_corners"]


def _linear_indices_weights(in_size: int, out_size: int,
                            align_corners: bool):
    """Gather indices + lerp weights for 1-D linear interpolation."""
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), np.float64)
        else:
            src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


def _make_tables(in_size: int, out_size: int, align_corners: bool,
                 device: torch.device):
    lo, hi, w = _linear_indices_weights(in_size, out_size, align_corners)
    # normal tensors even when first asked for under inference_mode (an
    # eval step): a later train step saves them for its backward
    with torch.inference_mode(False):
        return (torch.from_numpy(lo).to(device),
                torch.from_numpy(hi).to(device),
                torch.from_numpy(w).to(device))


_tables = functools.lru_cache(maxsize=512)(_make_tables)


def _resize_axis(x: torch.Tensor, dim: int, out_size: int,
                 align_corners: bool) -> torch.Tensor:
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    # torch.export traces with tensors that hold no data: tables made then
    # are the program's constants and must not enter the cache
    tables = _make_tables if torch.compiler.is_exporting() else _tables
    lo, hi, w = tables(in_size, out_size, align_corners, x.device)
    shape = [1] * x.dim()
    shape[dim] = out_size
    x_lo = x.index_select(dim, lo)
    x_hi = x.index_select(dim, hi)
    return x_lo + (x_hi - x_lo) * w.view(shape).to(x.dtype)


def _resize_nhwc(x: torch.Tensor, size, align_corners: bool) -> torch.Tensor:
    x = _resize_axis(x, x.dim() - 3, int(size[0]), align_corners)
    return _resize_axis(x, x.dim() - 2, int(size[1]), align_corners)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True
                    ) -> torch.Tensor:
    """Resize NHWC images (or an HWC image) to ``size=(H, W)``."""
    return _resize_nhwc(x, size, align_corners)


def resize_nchw(x: torch.Tensor, size, align_corners: bool = True
                ) -> torch.Tensor:
    """Resize the spatial axes of an NCHW tensor; a no-op when the size
    already matches."""
    if tuple(x.shape[-2:]) == (int(size[0]), int(size[1])):
        return x
    y = _resize_nhwc(x.permute(0, 2, 3, 1), size, align_corners)
    return y.permute(0, 3, 1, 2)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NHWC ``x``, ``align_corners=True``."""
    return resize_bilinear(x, (x.shape[-3] * 2, x.shape[-2] * 2), True)

"""Post-training int8 quantization for serving and offline eval;
counterpart of the JAX package's ``train/quantize.py``.

Forwards installed on the convs for the duration of a call take the place
of flax's method interceptors, and no model code changes:

* :func:`calibrate` runs the forward over calibration batches with an
  observing forward on every plain conv that keeps the running max of its
  input's absolute value, over every call (with ``concat_prev_probs`` the
  backbone runs once per level) and every batch. Keys are the JAX package's
  module paths (``backbone/inc/conv0``, ``head_l0``): the port's module
  names with ``.`` -> ``/``. On bands of rows (``parallel/bands.py``)
  each rank observes its own band of each conv's input, and the maxima
  are then all-reduced over the space group, so every rank holds the
  scales of the whole image.
* :func:`quantized_apply` wraps the forward so that, for its duration,
  every plain conv with a positive scale that ``skip`` does not match
  computes in int8: a per-tensor activation scale (from calibration),
  per-output-channel weight scales, the int8 conv of ``ops/int8_conv.py``
  (int32 accumulators) and a float dequant + bias epilogue, in the JAX
  arithmetic step for step. The weights are quantized once, when the
  wrapper is made. Every other conv runs its float forward. On bands the
  banded conv hands the int8 forward its fetched rows (its band and halo),
  padded in H by 0 and in W as the conv pads: quantizing is elementwise,
  so a rank's rows get the bits of the whole image's.

A plain conv is an ``nn.Conv2d`` with groups 1 and dilation 1, except the
HRNet ``SharedHead1x1``: it is a ``Conv2d`` in the port, but the JAX
package's is a module of its own with an einsum, which its quantizer never
converts, so it stays float here too. ``default_skip`` keeps the per-level
logits heads float (their logits feed the gated-softmax composition).
"""
from __future__ import annotations

import contextlib
import re
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbones.hrnet import SharedHead1x1
from ..ops import int8_conv
from ..parallel.bands import all_reduce_max

__all__ = ["calibrate", "default_skip", "quantized_apply"]

_EPS = 1e-12


def _is_plain_conv(m: nn.Module) -> bool:
    return (isinstance(m, nn.Conv2d) and not isinstance(m, SharedHead1x1)
            and m.groups == 1 and tuple(m.dilation) == (1, 1))


def _plain_convs(model: nn.Module):
    """(JAX path, conv) of every plain conv of ``model``."""
    return [(name.replace(".", "/"), m) for name, m in model.named_modules()
            if _is_plain_conv(m)]


class _Observe:
    """One conv's float forward that keeps the running max of its input's
    absolute value (of its own band, where it runs on bands)."""

    def __init__(self, conv: nn.Conv2d, path: str, amax: dict):
        self.conv, self.path, self.amax = conv, path, amax

    def __call__(self, x: torch.Tensor, padding=None, band=None
                 ) -> torch.Tensor:
        a = (x if band is None else band).detach().abs().amax().float()
        seen = self.amax.get(self.path)
        self.amax[self.path] = a if seen is None else torch.maximum(seen, a)
        c = self.conv
        return F.conv2d(x, c.weight, c.bias, c.stride,
                        c.padding if padding is None else padding,
                        c.dilation, c.groups)


def calibrate(model: nn.Module, batches: Iterable,
              apply_fn: Optional[Callable] = None,
              space=None) -> Dict[str, float]:
    """Run ``apply_fn(x)`` (default ``model(x)``) over ``batches`` (NHWC
    tensors on the model's device, or numpy arrays) without gradients and
    return ``{conv_path: input_absmax}`` for every plain conv that ran.
    With ``space`` (the model's space group: the batches are this rank's
    bands) the maxima are all-reduced over the group."""
    forward = apply_fn or model
    amax: Dict[str, torch.Tensor] = {}
    device = next(model.parameters()).device
    with _forwards([(m, _Observe(m, p, amax))
                    for p, m in _plain_convs(model)]):
        with torch.inference_mode():
            for batch in batches:
                x = (batch if torch.is_tensor(batch)
                     else torch.from_numpy(np.asarray(batch, np.float32)))
                forward(x.to(device))
    paths = sorted(amax)
    if paths:  # every rank of a space group runs the same convs
        maxima = all_reduce_max(torch.stack([amax[p] for p in paths]), space)
        amax = dict(zip(paths, maxima))
    return {p: float(a) for p, a in amax.items()}


_HEAD_RE = re.compile(r"(^|/)head_(l\d+|flat)($|/)")


def default_skip(path: str) -> bool:
    """True for the per-level logits heads (kept float by default): the
    ``head_l<N>`` and ``head_flat`` path components only."""
    return _HEAD_RE.search(path) is not None


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the float conv would give under the caller's autocast."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


class _QuantConv:
    """One conv's int8 forward; its weights quantized when made."""

    def __init__(self, conv: nn.Conv2d, amax: float):
        w = conv.weight.detach().float()
        dev = w.device
        # the JAX arithmetic: amax / 127 in Python double, then f32; the f32
        # weight scale per output channel; a 0-dim tensor on the device, as
        # a CPU scalar would make CUDA divide by multiplying a reciprocal
        self.sx = torch.tensor(np.float32(amax / 127.0), device=dev)
        c127 = torch.tensor(127.0, device=dev)
        self.sw = torch.clamp(w.abs().amax(dim=(1, 2, 3)) / c127, min=_EPS)
        kq = torch.clamp(torch.round(w / self.sw[:, None, None, None]),
                         -127, 127).to(torch.int8)
        self.kq = kq.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
        self.scale = self.sx * self.sw  # the f32 product first (JAX :179)
        self.bias = (None if conv.bias is None
                     else conv.bias.detach().float())
        self.stride = tuple(conv.stride)
        self.padding = tuple(conv.padding)

    def __call__(self, x: torch.Tensor, padding=None, band=None
                 ) -> torch.Tensor:
        """x NCHW (channels_last) -> NCHW channels_last; ``padding`` in
        place of the conv's (the banded conv's rows come padded in H)."""
        xn = x.permute(0, 2, 3, 1)
        xq = torch.clamp(torch.round(xn.float() / self.sx), -127,
                         127).to(torch.int8)
        acc = int8_conv.int8_conv2d(
            xq, self.kq, self.stride,
            self.padding if padding is None else tuple(padding))
        y = acc.float() * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(_out_dtype(x)).permute(0, 3, 1, 2)


@contextlib.contextmanager
def _forwards(convs):
    """Replace each conv's forward by the one given (int8, or observing)
    for the block."""
    for m, q in convs:
        m.forward = q
    try:
        yield
    finally:
        for m, _ in convs:
            del m.forward


def quantized_apply(model: nn.Module, act_scales: Dict[str, float],
                    skip: Optional[Callable[[str], bool]] = None) -> Callable:
    """``apply(x)``: ``model(x)`` with every covered conv in int8. A conv
    with no scale, a scale of 0 or a ``skip`` match (default
    :func:`default_skip`) runs in float."""
    skip = default_skip if skip is None else skip
    convs = [(m, _QuantConv(m, act_scales[p]))
             for p, m in _plain_convs(model)
             if act_scales.get(p, 0.0) > 0.0 and not skip(p)]

    def apply(x):
        with _forwards(convs):
            return model(x)

    return apply

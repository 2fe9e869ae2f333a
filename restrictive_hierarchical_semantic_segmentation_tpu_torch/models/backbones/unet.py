"""UNet donor backbone in PyTorch; counterpart of the JAX package's
``models/backbones/unet.py`` (reference models.py:108-255).

(conv3x3-BN-ReLU) x 2 blocks, a 2x2 max-pool encoder, a bilinear
``align_corners=True`` decoder with pad-to-match skip concatenation, channel
plan 64-128-256-512-512, and a final 64-channel feature map at input
resolution.

Three things follow the JAX file, not the reference torch UNet:

* every conv has a bias (flax ``nn.Conv`` defaults to ``use_bias=True``);
* the decoder concatenates the skip first, ``[skip, upsampled]``;
* the upsample is the port's gather resize (``resize_nchw(x, (2h, 2w),
  True)``), which the JAX ``upsample2x_align_corners`` computes, not
  ``F.interpolate`` (see ``ops/resize.py``).

Modules take and return NCHW tensors in ``torch.channels_last`` memory
format, through the max-pool, the zero pad and the concat, so every
BatchNorm input is already the contiguous ``(rows, C)`` matrix its kernel
reads and ``BatchNormAct`` copies nothing. Submodule names are the flax
names (``inc``, ``down1..4``, ``up1..4``; ``conv`` inside ``Down`` and
``Up``; ``conv0``, ``bn0``, ``conv1``, ``bn1`` inside ``DoubleConv``), so
``bridge.py`` maps the weights without a rule of its own.

Bands (``parallel/bands.py:set_space_group``): each module's ``space`` is
the space group whose ranks hold bands of rows of its activations, and its
``forward`` takes the global height of its input (``h``). The 3x3
convolutions fetch one halo row on each side, a max-pool fetches a row
where a band starts on an odd row, and ``Up`` resizes its band from the
source rows it reads and shifts its rows by the pad's ``dh // 2``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import bands
from ..norm import BatchNormAct

__all__ = ["UNetBackbone"]


class DoubleConv(nn.Module):
    """(conv3x3 -> BN -> ReLU) * 2 (reference models.py:108-123)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=True)
        self.bn0 = BatchNormAct(out_ch, "relu")
        self.conv1 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=True)
        self.bn1 = BatchNormAct(out_ch, "relu")

    space = None  # the space group of the bands (parallel/bands.py)

    def forward(self, x, h=None):
        sp = self.space
        x = self.bn0(bands.conv2d(self.conv0, x, h, sp))
        return self.bn1(bands.conv2d(self.conv1, x, h, sp))


class Down(nn.Module):
    """2x2 max-pool (floor on odd sizes) + DoubleConv (models.py:136-146)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    space = None

    def forward(self, x, h=None):
        return self.conv(bands.max_pool2(x, h, self.space),
                         None if h is None else h // 2)


class Up(nn.Module):
    """2x bilinear upsample + zero pad to the skip's size + concat(skip, x)
    + DoubleConv (models.py:149-174)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    space = None

    def forward(self, x1, x2, h1=None, h2=None):
        """x1 of global height ``h1``, the skip x2 of ``h2`` (None without
        bands: the tensors' own)."""
        sp = self.space
        w = x1.shape[-1]
        if sp is None:
            h1, h2 = x1.shape[-2], x2.shape[-2]
        x1 = bands.resize(x1, h1, (2 * h1, 2 * w), True, sp)
        dh = h2 - 2 * h1
        dw = x2.shape[-1] - 2 * w
        if dh or dw:  # split front/back as the JAX file does
            x1 = F.pad(bands.pad_rows(x1, 2 * h1, dh // 2, dh - dh // 2, sp),
                       (dw // 2, dw - dw // 2))
        return self.conv(torch.cat([x2, x1], dim=1),
                         None if sp is None else h2)


class UNetBackbone(nn.Module):
    """Single UNet pass: (B, in_channels, H, W) -> (B, base_ch, H, W)
    decoder features (models.py:244-255)."""

    feature_stride = 1  # features are at input resolution

    def __init__(self, base_ch: int = 64, in_channels: int = 3):
        super().__init__()
        c = base_ch
        self.base_ch = base_ch
        self.inc = DoubleConv(in_channels, c)
        self.down1 = Down(c, c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.down3 = Down(c * 4, c * 8)
        self.down4 = Down(c * 8, c * 8)
        self.up1 = Up(c * 16, c * 4)
        self.up2 = Up(c * 8, c * 2)
        self.up3 = Up(c * 4, c)
        self.up4 = Up(c * 2, c)

    @property
    def feature_dim(self) -> int:
        return self.base_ch

    space = None

    def out_height(self, h: int) -> int:
        """The global height of the features for an input of ``h``."""
        return h

    def forward(self, x: torch.Tensor, h=None) -> torch.Tensor:
        """x: (B, C, H, W), or this rank's band of an input of global
        height ``h`` under a space group."""
        if self.space is not None and h is None:
            raise ValueError("a banded UNet needs its input's global height")
        hs = [h]
        for _ in range(4):
            hs.append(None if h is None else hs[-1] // 2)
        x1 = self.inc(x, hs[0])
        x2 = self.down1(x1, hs[0])
        x3 = self.down2(x2, hs[1])
        x4 = self.down3(x3, hs[2])
        x5 = self.down4(x4, hs[3])
        d = self.up1(x5, x4, hs[4], hs[3])
        d = self.up2(d, x3, hs[3], hs[2])
        d = self.up3(d, x2, hs[2], hs[1])
        return self.up4(d, x1, hs[1], hs[0])

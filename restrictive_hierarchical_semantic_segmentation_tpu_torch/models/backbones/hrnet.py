"""HRNet donor backbone in PyTorch; counterpart of the JAX package's
``models/backbones/hrnet.py`` (reference models.py:318-749).

Stride-4 stem, Bottleneck stage 1, multi-resolution stages 2-4 built from
``HighResolutionModule`` (parallel branches + full exchange), transition
layers, and the final fusion of all branches (48+96+192+384 = 720
channels for W48) through a shared 1x1 conv-BN-ReLU head (its ``concat``
or ``sum`` dataflow, :class:`SharedHead1x1`).

Modules take and return NCHW tensors, which the port keeps in
``torch.channels_last`` memory format, so every BatchNorm input is already
the contiguous ``(rows, C)`` matrix its kernel reads. Submodule names are
the flax names (``stem_conv0``, ``layer1.block0.conv1``,
``stage3_m2.fuse2_0.conv1``, ``shared_head_conv``, ...), so the weight
bridge (``bridge.py``) is a mechanical rename. Every conv is followed by a
:class:`..norm.BatchNormAct`, the counterpart of ``_bn_act``.

Bands (``parallel/bands.py:set_space_group``): under a space group each
module's ``forward`` takes the global heights of its inputs (``h``,
``hs``). The stem's, the blocks' and the fuse layers' 3x3 convolutions
fetch the halo rows their stride and padding reach, the fuse layers' and
the head's resizes work on bands, and the ``sum`` head picks its order of
convolution and resize from the global sizes, so every band of a layer
takes the same order.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...config.hrnet import HRNetConfig, HRNetStage
from ...parallel import bands
from ..norm import BatchNormAct
from ..remat import remat_mode, run_region

__all__ = ["HRNetBackbone"]


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1) -> nn.Conv2d:
    # flax padding=1 for the 3x3 convs, and 0 ("SAME") for the 1x1 ones
    return nn.Conv2d(in_ch, out_ch, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + residual (models.py:327-356)."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride)
        self.bn1 = BatchNormAct(planes, "relu")
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNormAct(planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_ch, planes, 1, stride)
            self.downsample_bn = BatchNormAct(planes)

    space = None

    def forward(self, x, h=None):
        sp = self.space
        y = self.bn1(bands.conv2d(self.conv1, x, h, sp))
        y = self.bn2(bands.conv2d(self.conv2, y, bands.conv_height(
            self.conv1, h), sp))
        residual = (self.downsample_bn(bands.conv2d(
            self.downsample_conv, x, h, sp)) if self.downsample else x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1/3x3/1x1 bottleneck + residual (models.py:359-397)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 1)
        self.bn1 = BatchNormAct(planes, "relu")
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNormAct(planes, "relu")
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNormAct(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _conv(in_ch, planes * 4, 1, stride)
            self.downsample_bn = BatchNormAct(planes * 4)

    space = None

    def forward(self, x, h=None):
        sp = self.space
        y = self.bn1(bands.conv2d(self.conv1, x, h, sp))
        y = self.bn2(bands.conv2d(self.conv2, y, h, sp))
        y = self.bn3(bands.conv2d(self.conv3, y, bands.conv_height(
            self.conv2, h), sp))
        residual = (self.downsample_bn(bands.conv2d(
            self.downsample_conv, x, h, sp)) if self.downsample else x)
        return torch.relu(y + residual)


_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


HEAD_MODES = ("concat", "sum")


class SharedHead1x1(nn.Conv2d):
    """The shared 1x1 conv head (models.py:613-617) in the JAX module's two
    formulations, which compute the same function (JAX
    ``SharedHead1x1``):

    * ``concat``: upsample every branch to the highest resolution,
      concatenate, one 1x1 conv with bias;
    * ``sum``: a 1x1 conv is linear over channels and the bilinear resize
      over space, so they commute: ``conv(concat_i up(b_i)) = sum_i
      up(conv_i(b_i))`` with ``conv_i`` the i-th channel slice of the same
      weight. A branch already at the target size takes its conv alone;
      each other branch runs conv-then-resize or resize-then-conv,
      whichever the JAX FLOP estimate (:meth:`_resize_flops`) finds
      cheaper. The terms are added in branch order and the bias last.

    A ``Conv2d`` itself in both modes, so its weights are the flax
    ``shared_head_conv`` kernel and bias under the same names: checkpoints,
    donor imports and exported artifacts interchange between the modes.
    An unknown mode raises ``ValueError``; the JAX module computes ``sum``
    for any mode other than ``concat``."""

    def __init__(self, in_ch: int, out_ch: int, align_corners: bool,
                 mode: str = "concat"):
        if mode not in HEAD_MODES:
            raise ValueError(f"unknown HRNet head_mode {mode!r}; expected "
                             f"one of {HEAD_MODES} or 'auto'")
        super().__init__(in_ch, out_ch, 1, bias=True)
        self.align_corners = align_corners
        self.mode = mode

    @staticmethod
    def _resize_flops(ch: int, src_hw, dst_hw) -> int:
        """The JAX estimate of a matmul resize: rows pass, then columns."""
        (h, w), (big_h, big_w) = src_hw, dst_hw
        return ch * (big_h * w * h + big_h * big_w * w)

    space = None

    def forward(self, xs: List[torch.Tensor], target_hw, hs=None
                ) -> torch.Tensor:
        """``target_hw`` and ``hs`` (the branches' heights) global: the
        bands' under a space group."""
        ac, sp = self.align_corners, self.space
        if hs is None:
            hs = [b.shape[-2] for b in xs]
        if self.mode == "concat":
            outs = [xs[0]] + [bands.resize(b, h, target_hw, ac, sp)
                              for b, h in zip(xs[1:], hs[1:])]
            return super().forward(torch.cat(outs, dim=1))
        big_h, big_w = (int(v) for v in target_hw)
        out_ch = self.out_channels
        y = None
        lo = 0
        for b, h in zip(xs, hs):
            ch = b.shape[1]
            w = self.weight[:, lo:lo + ch]
            lo += ch
            src_hw = (int(h), int(b.shape[-1]))
            if src_hw == (big_h, big_w):
                t = F.conv2d(b, w)
            elif (ch * src_hw[0] * src_hw[1] * out_ch
                  + self._resize_flops(out_ch, src_hw, (big_h, big_w))
                  < ch * big_h * big_w * out_ch):
                t = bands.resize(F.conv2d(b, w), h, (big_h, big_w), ac, sp)
            else:
                t = F.conv2d(bands.resize(b, h, (big_h, big_w), ac, sp), w)
            y = t if y is None else y + t
        return y + self.bias.to(y.dtype)[:, None, None]


class Branch(nn.Module):
    """A sequence of residual blocks at one resolution (models.py:438-460)."""

    def __init__(self, block: str, num_blocks: int, planes: int, in_ch: int):
        super().__init__()
        cls = _BLOCKS[block]
        out_ch = planes * cls.expansion
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            ds = i == 0 and in_ch != out_ch
            self.add_module(f"block{i}",
                            cls(in_ch if i == 0 else out_ch, planes, 1, ds))

    def forward(self, x, h=None):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x, h)
        return x


class FuseLayer(nn.Module):
    """Exchange unit: branch j -> branch i (models.py:471-515).

    j > i: 1x1 conv + BN, bilinear upsample to i's resolution.
    j < i: (i-j) stride-2 3x3 conv+BN (ReLU on all but the last).
    """

    def __init__(self, i: int, j: int, out_ch: int, through_ch: int,
                 align_corners: bool):
        super().__init__()
        self.up = j > i
        self.align_corners = align_corners
        self.steps = i - j
        if self.up:
            self.conv = _conv(through_ch, out_ch, 1)
            self.bn = BatchNormAct(out_ch)
            return
        for k in range(self.steps):
            last = k == self.steps - 1
            ch = out_ch if last else through_ch
            self.add_module(f"conv{k}", _conv(through_ch, ch, 3, 2))
            self.add_module(f"bn{k}",
                            BatchNormAct(ch, "none" if last else "relu"))

    space = None

    def forward(self, x, target_hw, h=None):
        """``target_hw`` global, ``h`` x's global height (x's own without
        bands)."""
        sp = self.space
        if h is None:
            h = x.shape[-2]
        if self.up:
            return bands.resize(self.bn(self.conv(x)), h, target_hw,
                                self.align_corners, sp)
        for k in range(self.steps):
            conv = getattr(self, f"conv{k}")
            x = getattr(self, f"bn{k}")(bands.conv2d(conv, x, h, sp))
            h = bands.conv_height(conv, h)
        return x


class HighResolutionModule(nn.Module):
    """Parallel branches + full fusion (models.py:400-544); all modules are
    multi-scale (models.py:665-680)."""

    def __init__(self, stage: HRNetStage, channels: Sequence[int],
                 align_corners: bool):
        super().__init__()
        self.nb = stage.num_branches
        for i in range(self.nb):
            self.add_module(f"branch{i}", Branch(
                stage.block, stage.num_blocks[i], stage.num_channels[i],
                channels[i]))
        if self.nb == 1:
            return
        for i in range(self.nb):
            for j in range(self.nb):
                if j != i:
                    self.add_module(f"fuse{i}_{j}", FuseLayer(
                        i, j, channels[i], channels[j], align_corners))

    def forward(self, xs: List[torch.Tensor], hs=None
                ) -> List[torch.Tensor]:
        """``hs``: the branches' global heights (None: their own)."""
        if hs is None:
            hs = [None] * self.nb
        xs = [getattr(self, f"branch{i}")(xs[i], hs[i])
              for i in range(self.nb)]
        if self.nb == 1:
            return xs
        outs = []
        for i in range(self.nb):
            hw = (xs[i].shape[-2] if hs[i] is None else hs[i],
                  xs[i].shape[-1])
            y = None
            for j in range(self.nb):
                t = xs[j] if j == i else getattr(self, f"fuse{i}_{j}")(
                    xs[j], hw, hs[j])
                y = t if y is None else y + t
            outs.append(torch.relu(y))
        return outs


class Transition(nn.Module):
    """Stage transition (models.py:682-705): channel match at existing
    resolutions, strided convs to open new (lower-res) branches."""

    def __init__(self, prev_channels: Sequence[int],
                 cur_channels: Sequence[int]):
        super().__init__()
        self.n_pre = len(prev_channels)
        self.plan = []  # per output branch: "keep" | "match" | #strided convs
        for i, ch in enumerate(cur_channels):
            if i < self.n_pre:
                if prev_channels[i] != ch:
                    self.add_module(f"t{i}_conv",
                                    _conv(prev_channels[i], ch, 3))
                    self.add_module(f"t{i}_bn", BatchNormAct(ch, "relu"))
                    self.plan.append("match")
                else:
                    self.plan.append("keep")
                continue
            n = i + 1 - self.n_pre
            for j in range(n):
                out_ch = ch if j == i - self.n_pre else prev_channels[-1]
                self.add_module(f"t{i}_conv{j}",
                                _conv(prev_channels[-1], out_ch, 3, 2))
                self.add_module(f"t{i}_bn{j}", BatchNormAct(out_ch, "relu"))
            self.plan.append(n)

    space = None

    def forward(self, xs: List[torch.Tensor], hs=None
                ) -> List[torch.Tensor]:
        """``hs``: the inputs' global heights (None: their own)."""
        sp = self.space
        if hs is None:
            hs = [None] * len(xs)
        outs = []
        for i, step in enumerate(self.plan):
            if step == "keep":
                outs.append(xs[i])
            elif step == "match":
                outs.append(getattr(self, f"t{i}_bn")(bands.conv2d(
                    getattr(self, f"t{i}_conv"), xs[i], hs[i], sp)))
            else:
                y, h = xs[-1], hs[-1]
                for j in range(step):
                    conv = getattr(self, f"t{i}_conv{j}")
                    y = getattr(self, f"t{i}_bn{j}")(
                        bands.conv2d(conv, y, h, sp))
                    h = bands.conv_height(conv, h)
                outs.append(y)
        return outs

    def out_heights(self, hs: List[int]) -> List[int]:
        """The global heights of the outputs for inputs of ``hs``."""
        out = []
        for i, step in enumerate(self.plan):
            if step in ("keep", "match"):
                out.append(hs[i])
            else:
                h = hs[-1]
                for j in range(step):
                    h = bands.conv_height(getattr(self, f"t{i}_conv{j}"), h)
                out.append(h)
        return out


class HRNetBackbone(nn.Module):
    """Full HRNet pass: (B, in_channels, H, W) -> (B, 720, H/4, W/4) fused
    features for W48 (models.py:707-749 ``_forward_backbone``).

    ``use_pallas_bn`` is kept for the JAX signature: in eval mode both BN
    flavours of the JAX package compute the same function, and the port
    runs its kernel for either. ``head_mode``: "concat", "sum" or "auto"
    (the default: ``$RHSS_HRNET_HEAD``, else "concat", read when the
    backbone is built); an unknown mode raises (see :class:`SharedHead1x1`).
    ``remat`` (False, True / "module", "conv") makes each
    ``HighResolutionModule`` a recomputed region (``models/remat.py``), as
    the JAX backbone does."""

    feature_stride = 4

    def __init__(self, config: HRNetConfig, in_channels: int = 3,
                 use_pallas_bn: bool = False, head_mode: str = "auto",
                 remat=False):
        super().__init__()
        self.config = config
        self.remat = remat_mode(remat)
        self.use_pallas_bn = use_pallas_bn
        ac = config.align_corners
        self.stem_conv0 = _conv(in_channels, 64, 3, 2)
        self.stem_bn0 = BatchNormAct(64, "relu")
        self.stem_conv1 = _conv(64, 64, 3, 2)
        self.stem_bn1 = BatchNormAct(64, "relu")

        s1 = config.stage1
        self.layer1 = Branch(s1.block, s1.num_blocks[0], s1.num_channels[0],
                             64)
        prev = [s1.num_channels[0] * _BLOCKS[s1.block].expansion]
        self.stage_modules = []
        for si, stage in enumerate((config.stage2, config.stage3,
                                    config.stage4), start=2):
            cur = [c * _BLOCKS[stage.block].expansion
                   for c in stage.num_channels]
            self.add_module(f"transition{si - 1}", Transition(prev, cur))
            for m in range(stage.num_modules):
                self.add_module(f"stage{si}_m{m}",
                                HighResolutionModule(stage, cur, ac))
            self.stage_modules.append((si, stage.num_modules))
            prev = cur

        if head_mode == "auto":  # as the JAX HRNetBackbone resolves it
            head_mode = os.environ.get("RHSS_HRNET_HEAD", "concat")
        self.shared_head_conv = SharedHead1x1(
            sum(prev), config.last_channels, ac, head_mode)
        self.shared_head_bn = BatchNormAct(config.last_channels, "relu")

    @property
    def feature_dim(self) -> int:
        return self.config.last_channels

    space = None

    def out_height(self, h: int) -> int:
        """The global height of the features for an input of ``h``."""
        return bands.conv_height(self.stem_conv1,
                                 bands.conv_height(self.stem_conv0, h))

    def forward(self, x: torch.Tensor, h=None) -> torch.Tensor:
        """x: (B, C, H, W), or this rank's band of an input of global
        height ``h`` under a space group."""
        sp = self.space
        if sp is not None and h is None:
            raise ValueError("a banded HRNet needs its input's global height")
        x = self.stem_bn0(bands.conv2d(self.stem_conv0, x, h, sp))
        h = bands.conv_height(self.stem_conv0, h)
        x = self.stem_bn1(bands.conv2d(self.stem_conv1, x, h, sp))
        hs = [bands.conv_height(self.stem_conv1, h)]
        xs = [self.layer1(x, hs[0])]
        for si, n_modules in self.stage_modules:
            trans = getattr(self, f"transition{si - 1}")
            xs = trans(xs, hs)
            hs = trans.out_heights(hs) if sp is not None else [None] * len(xs)
            for m in range(n_modules):
                xs = run_region(getattr(self, f"stage{si}_m{m}"), xs, hs,
                                mode=self.remat)
        target = (xs[0].shape[-2] if sp is None else hs[0], xs[0].shape[-1])
        return self.shared_head_bn(self.shared_head_conv(
            xs, target, None if sp is None else hs))

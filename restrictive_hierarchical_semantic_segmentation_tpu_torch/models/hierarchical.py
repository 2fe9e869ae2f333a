"""Hierarchical restrictive segmenter; counterpart of the JAX package's
``models/hierarchical.py`` (reference models.py:192-306 and :554-802).

* flat mode (``model_type == 0``): one head over all leaf classes;
* hierarchical mode (``model_type == 1``): per-level heads; level 0 is a
  sigmoid head; each deeper level FiLM-conditions the backbone features on
  the previous level's probabilities and composes ``P_c = P_p * Q_{c|p}``
  through the gated grouped softmax.

``share_backbone`` (default) runs the backbone once for all levels: FiLM
conditions after the backbone, whose input does not change between levels,
so the D passes of the reference are one (the JAX module docstring has the
argument). ``concat_prev_probs`` concatenates the previous level's
probabilities (resized, zero at level 0, right-padded to the widest level)
to the input, and then pays one backbone pass per level.

In train mode every BatchNorm of a backbone pass updates its running
statistics once. The reference runs the backbone D times per step (D tree
levels), so its running statistics see D updates with the same batch
values; :attr:`HierarchicalSegmenter.bn_updates_per_step` says how many
updates the shared forward stands for, and the train step applies the
closed form (``train/steps.py:bn_ema_correction``).

:meth:`HierarchicalSegmenter.forward` takes NHWC input and returns NHWC
maps, as the JAX module does; inside, activations are NCHW in
``torch.channels_last`` memory format. Outputs are float32 whatever the
compute dtype (``torch.autocast`` decides that), or float64 for a model
converted with ``.double()`` (a reference for the f32 gradients).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from ..hierarchy.tree import ClassTree
from ..ops.resize import resize_nchw
from ..ops.restrictive import gated_grouped_softmax
from .film import FiLM

__all__ = ["HierarchicalSegmenter", "SegmenterOutput", "build_model"]


class SegmenterOutput(NamedTuple):
    """flat mode: ``probs_per_level is None`` and ``logits_per_level ==
    [logits]``. ``q_per_level`` holds the conditionals ``Q_{c|p}`` (None at
    level 0). Every map is NHWC float32."""

    probs_per_level: Optional[List]
    logits_per_level: List
    q_per_level: Optional[List]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class HierarchicalSegmenter(nn.Module):
    def __init__(self, tree: ClassTree, backbone: nn.Module,
                 hierarchical: bool = True, final_conv_kernel: int = 1,
                 align_corners: bool = True, concat_prev_probs: bool = False,
                 share_backbone: bool = True):
        super().__init__()
        self.tree = tree
        self.backbone = backbone
        self.hierarchical = hierarchical
        self.align_corners = align_corners
        self.concat_prev_probs = concat_prev_probs
        self.share_backbone = share_backbone
        feat = backbone.feature_dim
        k = final_conv_kernel
        pad = 1 if k == 3 else 0

        def head(out_ch):
            return nn.Conv2d(feat, out_ch, k, padding=pad, bias=True)

        if not hierarchical:
            self.head_flat = head(tree.num_leaves)
            return
        for L, n in enumerate(tree.classes_per_level):
            self.add_module(f"head_l{L}", head(n))
            if L:
                self.add_module(f"film_l{L}",
                                FiLM(tree.classes_per_level[L - 1], feat))
                self.register_buffer(
                    f"parent_index_l{L}",
                    torch.as_tensor(tree.parent_index[L], dtype=torch.long),
                    persistent=False)

    @property
    def bn_updates_per_step(self) -> int:
        """Running-statistics updates per step of the reference for each
        one this forward makes: D with the shared backbone, else 1 (the
        forward re-runs the backbone D times itself)."""
        if (self.hierarchical and self.share_backbone
                and not self.concat_prev_probs):
            return self.tree.num_levels
        return 1

    def _backbone_input(self, x: torch.Tensor,
                        prev_probs: Optional[torch.Tensor]) -> torch.Tensor:
        """x and prev_probs NCHW."""
        if not self.concat_prev_probs:
            return x
        width = max(self.tree.classes_per_level)
        b, _, h, w = x.shape
        extra = x.new_zeros((b, width, h, w))
        if prev_probs is not None:
            p = resize_nchw(prev_probs, (h, w), self.align_corners)
            extra[:, :p.shape[1]] = p.to(x.dtype)
        return torch.cat([x, extra], dim=1).contiguous(
            memory_format=torch.channels_last)

    def _logits(self, feats, name: str, hw) -> torch.Tensor:
        z = resize_nchw(getattr(self, name)(feats), hw, self.align_corners)
        return z if z.dtype == torch.float64 else z.float()

    def forward(self, x: torch.Tensor) -> SegmenterOutput:
        """x: (B, H, W, C_in) NHWC."""
        hw = x.shape[1:3]
        x = _nchw(x)  # a channels_last view of a contiguous NHWC tensor
        t = self.tree

        if not self.hierarchical:
            feats = self.backbone(self._backbone_input(x, None))
            z = self._logits(feats, "head_flat", hw)
            return SegmenterOutput(None, [_nhwc(z)], None)

        feats = self.backbone(self._backbone_input(x, None))
        z0 = self._logits(feats, "head_l0", hw)
        probs = [torch.sigmoid(z0)]            # NCHW
        logits = [_nhwc(z0)]
        qs: List[Optional[torch.Tensor]] = [None]
        share = self.share_backbone and not self.concat_prev_probs
        for L in range(1, t.num_levels):
            feats_l = feats if share else self.backbone(
                self._backbone_input(x, probs[L - 1]))
            feats_l = getattr(self, f"film_l{L}")(
                feats_l, probs[L - 1].to(feats_l.dtype))
            zL = self._logits(feats_l, f"head_l{L}", hw)
            q, p_child = gated_grouped_softmax(
                _nhwc(zL), _nhwc(probs[L - 1]),
                getattr(self, f"parent_index_l{L}"), t.child_to_parent[L])
            probs.append(_nchw(p_child))
            logits.append(_nhwc(zL))
            qs.append(q)
        return SegmenterOutput([_nhwc(p) for p in probs], logits, qs)


def build_model(tree: ClassTree, model_select: int = 0, model_type: int = 1,
                hrnet_config=None, concat_prev_probs: bool = False,
                use_pallas_bn: bool = False,
                share_backbone: bool = True) -> HierarchicalSegmenter:
    """Factory matching the reference CLI conventions (train.py:456-462):
    ``model_select`` 0 = UNet, 1 = HRNet; ``model_type`` 0 = flat, 1 = hier.
    The model is built on the CPU in train mode; callers move it and call
    ``.eval()``. ``hrnet_config`` and ``use_pallas_bn`` apply to HRNet only."""
    in_ch = 3 + (max(tree.classes_per_level) if concat_prev_probs else 0)
    if model_select == 0:
        from .backbones.unet import UNetBackbone

        backbone = UNetBackbone(in_channels=in_ch)
        final_k, ac = 1, True
    else:
        from ..config.hrnet import hrnet_w48
        from .backbones.hrnet import HRNetBackbone

        cfg = hrnet_config or hrnet_w48()
        backbone = HRNetBackbone(cfg, in_channels=in_ch,
                                 use_pallas_bn=use_pallas_bn)
        final_k, ac = cfg.final_conv_kernel, cfg.align_corners
    return HierarchicalSegmenter(
        tree=tree, backbone=backbone, hierarchical=model_type == 1,
        final_conv_kernel=final_k, align_corners=ac,
        concat_prev_probs=concat_prev_probs, share_backbone=share_backbone)

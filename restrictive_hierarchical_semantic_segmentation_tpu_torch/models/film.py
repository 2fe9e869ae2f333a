"""FiLM top-down conditioning (reference models.py:58-77); counterpart of the
JAX package's ``models/film.py``.

Global-average-pool the previous level's probability map, project it with
one linear layer to per-channel ``(gamma, beta)``, and modulate the backbone
features ``feats * gamma + beta``. Tensors are NCHW here (the JAX module is
NHWC); ``mlp`` is the flax ``Dense`` named ``mlp``.

Bands (``parallel/bands.py``): under a space group the pool is the band's
sum, summed over the group by ``all_reduce_sum`` (whose backward gives
every band the gradient of every rank's use of the mean), over the global
pixel count.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.bands import all_reduce_sum

__all__ = ["FiLM"]


class FiLM(nn.Module):
    """feats: (B, C_feat, H, W); cond_map: (B, C_cond, H', W') probabilities
    or an already pooled (B, C_cond) vector."""

    def __init__(self, cond_channels: int, feat_channels: int):
        super().__init__()
        self.feat_channels = feat_channels
        self.mlp = nn.Linear(cond_channels, 2 * feat_channels)

    space = None  # the space group of the bands (parallel/bands.py)

    def forward(self, feats: torch.Tensor, cond_map: torch.Tensor,
                h=None) -> torch.Tensor:
        """``h``: the global height of a banded ``cond_map``."""
        if cond_map.dim() != 4:
            cond_vec = cond_map
        elif self.space is None:
            cond_vec = cond_map.mean(dim=(2, 3))
        else:
            cond_vec = all_reduce_sum(cond_map.sum(dim=(2, 3)), self.space) \
                / (h * cond_map.shape[-1])
        gamma_beta = self.mlp(cond_vec)
        c = self.feat_channels
        gamma = gamma_beta[:, :c, None, None]
        beta = gamma_beta[:, c:, None, None]
        return feats * gamma + beta

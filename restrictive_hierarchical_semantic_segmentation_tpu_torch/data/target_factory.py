"""Target factory: pixel-coded mask PNG -> per-node channels -> ternary encoding.

A copy of the JAX package's ``data/target_factory.py`` (numpy only), kept in
the port so that the port imports nothing of the JAX package.

Vectorized numpy re-design of the reference's recursive per-node walkers
(Data/dataset.py:41-124 ``_compute_masks_post``/``traverse_tree`` and
dataset.py:227-265 ``process_ignore_values``):

* leaf channels come from a 256-entry pixel-value LUT in one gather;
* parent channels are ORs over precomputed descendant-leaf index lists;
* channels are emitted in the canonical level order (``ClassTree.names``), or
  filtered to leaves for flat mode (dataset.py:97-118);
* ternary restrictive encoding: root channels stay 0/1; every non-root channel
  becomes 1 on the class, 0 inside its direct parent, -1 outside the parent.

This runs host-side (CPU) inside the input pipeline; everything is uint8/float32
numpy with no Python per-pixel work.
"""
from __future__ import annotations

import numpy as np

from ..hierarchy.tree import ClassTree

__all__ = ["leaf_masks", "node_masks", "ternary_encode"]


def leaf_masks(mask_img: np.ndarray, tree: ClassTree) -> np.ndarray:
    """(H, W) uint8 pixel-coded mask -> (H, W, n_leaves) uint8 binary channels
    in flat (BFS-leaf) order."""
    leaf_id = tree.pixel_lut[mask_img]  # (H, W), -1 where unmapped
    out = np.zeros(mask_img.shape + (tree.num_leaves,), np.uint8)
    valid = leaf_id >= 0
    hh, ww = np.nonzero(valid)
    out[hh, ww, leaf_id[valid]] = 1
    return out


def node_masks(mask_img: np.ndarray, tree: ClassTree) -> np.ndarray:
    """(H, W) mask -> (H, W, num_classes) uint8, hierarchical level order:
    leaves from the LUT, parents as the OR of their descendant leaves
    (dataset.py:41-68 post-order == OR over the descendant-leaf closure)."""
    leaves = leaf_masks(mask_img, tree)
    out = np.zeros(mask_img.shape + (tree.num_classes,), np.uint8)
    parent_desc = dict(zip(tree.parent_names_bfs, tree.descendant_leaves))
    for name in tree.names:
        ch = tree.channel_index(name)
        if name in parent_desc:
            out[..., ch] = leaves[..., list(parent_desc[name])].max(-1)
        else:
            out[..., ch] = leaves[..., tree.leaf_index[name]]
    return out


def ternary_encode(binary: np.ndarray, tree: ClassTree) -> np.ndarray:
    """(..., num_classes) binary 0/1 -> ternary restrictive targets
    (dataset.py:227-265):

    root channels: unchanged 0/1; non-root channel c with direct parent p:
    ``1`` where c, ``0`` where p and not c, ``-1`` outside p. The parent is
    read from the *same* (possibly augmented, re-binarized) stack, matching
    the reference's ordering of augmentation before ternary encoding
    (dataset.py:454-464).
    """
    out = binary.astype(np.float32).copy()
    for L in range(1, tree.num_levels):
        a, b = tree.level_slices[L]
        pa, pb = tree.level_slices[L - 1]
        parents = binary[..., pa:pb][..., tree.parent_index[L]]  # (..., C_L)
        child = binary[..., a:b]
        out[..., a:b] = np.where(
            child > 0, 1.0, np.where(parents > 0, 0.0, -1.0)
        ).astype(np.float32)
    return out

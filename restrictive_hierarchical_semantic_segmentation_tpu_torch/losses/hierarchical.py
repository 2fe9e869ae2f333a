"""Hierarchical restrictive losses; counterpart of the JAX package's
``losses/hierarchical.py`` (reference Metrics/losses.py:16-177), with the
same conventions:

* **masked cross-entropy**: per batch item, the mean over classes of
  ``-(target * log_softmax(logits) * w)`` averaged over that class's valid
  pixels (``target != -1``); an item with a class that has no valid pixel
  scores 1.0 (the reference's NaN mapped by ``nan_to_num(nan=1.0)``); the
  loss is the batch mean;
* **masked soft Dice** (smooth 0): per item, the class-weighted
  intersection and union of the softmax probabilities over valid pixels;
  items whose union is 0 are dropped from the batch mean, and when every
  item drops the term is 0;
* **consistency**: the mean over (level, parent) pairs of the mean of
  ``|sum over children of P_c - P_p|``, on the model's soft probabilities;
* **KL stabiliser** (weight 0 by default):
  :func:`..ops.restrictive.grouped_conditional_kl`;
* **level mask**: a per-level 0/1 weight (level-staged pretraining).

Every reduction is f32 whatever the compute dtype (f64 inputs stay f64,
for reference runs). Maps are NHWC.

Over a data-parallel ``group`` (each rank holds an equal share of the
global batch, and the trainer takes the mean of the ranks' gradients), the
loss must be one whose mean over the ranks is the global batch's loss.
Every term is a mean over items, pixels or parents of equal-sized shards
(cross-entropy and OHEM per image, consistency, KL), whose rank mean is the
global mean, except soft Dice: it divides by the number of items whose
union is non-zero, which differs between shards. That count is
all-reduced over the group (forward only, no gradient: a count) and each
rank's Dice sum is scaled by the group size, so the ranks' mean is the
global sum over the global count.

Over a space group (``space``: each rank holds a band of rows of every
image, ``parallel/bands.py``) every term is computed from sums over the
whole image, so each rank of the group computes the same loss, its data
shard's: the per-image cross-entropy's sums and counts, the
Dice intersections and unions, the consistency and KL means and the
OHEM threshold (the image's k-th probability) span the bands. The sums
go through ``all_reduce_sum``, whose backward all-reduces the gradient:
every band then gets the gradient of every rank's use of the sum (a sum
whose backward were the identity would give the FiLM pooling and the Dice
ratio the gradient of one rank's share). The step divides the summed
gradients by the size of its data x space group
(``train/steps.py``).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..hierarchy.tree import ClassTree
from ..ops.restrictive import grouped_conditional_kl
from ..parallel.bands import (active, all_reduce_sum, gather_bands,
                              global_height, spatial_mean)

__all__ = ["masked_cross_entropy", "masked_soft_dice", "ohem_select",
           "consistency_loss", "hierarchical_loss"]


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64."""
    return t if t.dtype == torch.float64 else t.float()


@functools.lru_cache(maxsize=256)
def _device_table(values: tuple, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A constant host table on ``device``, copied once: a copy from host
    memory makes the host wait until the device has run all it was given.
    Built outside inference mode, so a train step may save it."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _table(values, dtype: torch.dtype, device) -> torch.Tensor:
    return _device_table(tuple(np.asarray(values).ravel().tolist()), dtype,
                         torch.device(device))


def _class_weight(class_weight, n: int, device) -> torch.Tensor:
    if class_weight is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return _table(np.asarray(class_weight, np.float32), torch.float32,
                  device)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         class_weight=None, space=None) -> torch.Tensor:
    """logits, targets: (B, H, W, C); targets in {-1, 0, 1}. A scalar.
    ``space``: the space group of the bands of H (module docstring)."""
    logits = _f32(logits)
    targets = _f32(targets)
    logp = torch.log_softmax(logits, dim=-1)
    valid = targets != -1.0
    w = _class_weight(class_weight, logits.shape[-1], logits.device)
    num = -(torch.where(valid, targets * logp, 0.0) * w).sum(dim=(1, 2))
    cnt = valid.sum(dim=(1, 2)).to(num.dtype)            # (B, C)
    if space is not None:
        num, cnt = all_reduce_sum(torch.cat([num, cnt], -1), space).split(
            num.shape[-1], -1)
    per_b = (num / cnt.clamp_min(1.0)).mean(dim=-1)
    has_empty = (cnt == 0.0).any(dim=-1)                 # -> 1.0
    return torch.where(has_empty, 1.0, per_b).mean()


def masked_soft_dice(logits: torch.Tensor, targets: torch.Tensor,
                     class_weight=None, smooth: float = 0.0, space=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the kept items' losses, number of kept items)``; the
    caller divides (items with zero union are dropped)."""
    logits = _f32(logits)
    targets = _f32(targets)
    probs = torch.softmax(logits, dim=-1)
    valid = (targets != -1.0).float()
    w = _class_weight(class_weight, logits.shape[-1], logits.device)
    inter = (probs * targets * valid * w).sum(dim=(1, 2, 3))   # (B,)
    union = ((probs + targets) * valid * w).sum(dim=(1, 2, 3))
    if space is not None:
        inter, union = all_reduce_sum(torch.stack([inter, union]), space)
    ok = union > 0.0
    # a dropped item's union is 0: divide by 1 there so that neither its
    # value nor its gradient is NaN (it is weighted 0 either way)
    dice = (2.0 * inter + smooth) / torch.where(ok, union + smooth, 1.0)
    item_loss = 1.0 - dice
    return torch.where(ok, item_loss, 0.0).sum(), ok.float().sum()


def ohem_select(logits: torch.Tensor, targets: torch.Tensor,
                thres: float = 0.9, min_kept: int = 100000,
                space=None) -> torch.Tensor:
    """Online hard-example mining mask (B, H, W): keep the valid pixels whose
    true-class probability is at most ``max(k-th smallest, thres)``, with
    ``k = min(min_kept, H * W)`` per image (over the whole image's bands
    under ``space``)."""
    probs = torch.softmax(_f32(logits), dim=-1)
    t = _f32(targets)
    pos = t == 1.0
    valid = pos.any(dim=-1)
    p_true = torch.where(pos, probs, 0.0).sum(dim=-1)
    flat = torch.where(valid, p_true, 2.0)
    if space is not None:  # the whole image's probabilities
        h = global_height(flat.shape[1], space, flat.device)
        flat = gather_bands(flat.detach(), h, space, dim=1)
    hw = flat.shape[1] * flat.shape[2]
    k = int(min(min_kept, hw))
    flat = flat.reshape(flat.shape[0], -1)
    kth = torch.kthvalue(flat, k, dim=1).values
    t_eff = torch.clamp(kth, min=thres)[:, None, None]
    return valid & (p_true <= t_eff)


def consistency_loss(probs_per_level: Sequence[torch.Tensor],
                     tree: ClassTree, space=None) -> torch.Tensor:
    """L1 between each parent's probability and the sum of its children's,
    averaged over all (level, parent-with-children) pairs.

    The JAX package has two formulations (per-parent slices up to
    ``GROUP_UNROLL_LIMIT`` parents, a one-hot contraction above). One
    covers both here: the children's sums are an ``index_add`` over the
    channel axis."""
    total = probs_per_level[0].new_zeros((), dtype=torch.float32)
    count = 0
    for L in range(1, tree.num_levels):
        p_prev = _f32(probs_per_level[L - 1])
        p_cur = _f32(probs_per_level[L])
        dev = p_cur.device
        pidx = _table(tree.parent_index[L], torch.long, dev)
        sel = _table(tree.parents_with_children[L], torch.long, dev)
        child_sum = p_cur.new_zeros(p_prev.shape).index_add(-1, pidx, p_cur)
        diff = (child_sum.index_select(-1, sel)
                - p_prev.index_select(-1, sel)).abs()
        # mean over (batch, space) per parent: every parent has the same
        # extent, as in the reference's per-parent .mean()
        total = total + spatial_mean(diff, tuple(range(diff.dim() - 1)),
                                     space).sum()
        count += int(sel.numel())
    if count == 0:
        return total
    return total / count


def hierarchical_loss(
        logits_per_level: Sequence[torch.Tensor],
        targets_per_level: Sequence[torch.Tensor],
        level_weights: Optional[Sequence[Sequence[float]]] = None,
        probs_per_level: Optional[Sequence[torch.Tensor]] = None,
        q_per_level=None, tree: Optional[ClassTree] = None,
        level_mask: Optional[Sequence[float]] = None,
        lambda_cons: float = 1.0, lambda_kl: float = 0.0,
        dice_smooth: float = 0.0, ohem: Optional[tuple] = None,
        group=None, space=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``sum_L m_L * (CE_L + Dice_L) + lambda_cons * consistency
    [+ lambda_kl * KL]``; returns ``(total, per_level)`` with ``per_level``
    the (L,) CE + Dice of every level, masked or not. ``level_mask`` may be
    a sequence or a tensor of 0/1 per level. ``group``: the data-parallel
    process group of more than one rank this batch is a shard of (module
    docstring); one all-reduce of the levels' Dice counts. ``space``: the
    :class:`..parallel.mesh.DataGroup` of the space axis the maps are bands
    of (``group`` is then the data x space group)."""
    n_levels = len(logits_per_level)
    device = logits_per_level[0].device
    space = active(space)
    if level_mask is None:
        mask = torch.ones(n_levels, dtype=torch.float32, device=device)
    else:
        mask = torch.as_tensor(level_mask, dtype=torch.float32,
                               device=device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    terms = []
    for L in range(n_levels):
        w = None if level_weights is None else level_weights[L]
        ce_targets = targets_per_level[L]
        if ohem is not None:
            # de-selected pixels become -1, masked like restrictive targets
            thres, min_kept = ohem
            keep = ohem_select(logits_per_level[L], ce_targets, thres,
                               min_kept, space)
            ce_targets = torch.where(keep[..., None], _f32(ce_targets),
                                     -1.0)
        ce = masked_cross_entropy(logits_per_level[L], ce_targets, w, space)
        dsum, dcnt = masked_soft_dice(logits_per_level[L],
                                      targets_per_level[L], w, dice_smooth,
                                      space)
        terms.append((ce, dsum, dcnt))
    if group is not None:
        # the group's count of kept items per level, and each rank's share
        # of the Dice sum scaled by the group size
        counts = torch.stack([t[2] for t in terms]).detach().clone()
        dist.all_reduce(counts, group=group)
        ranks = dist.get_world_size(group)
        terms = [(ce, dsum * ranks, counts[L])
                 for L, (ce, dsum, _) in enumerate(terms)]
    per_level = []
    for L, (ce, dsum, dcnt) in enumerate(terms):
        lvl = ce + dsum / dcnt.clamp_min(1.0)
        per_level.append(lvl)
        total = total + mask[L] * lvl
    if probs_per_level is not None and tree is not None \
            and tree.num_levels > 1:
        total = total + lambda_cons * consistency_loss(probs_per_level, tree,
                                                       space)
    if lambda_kl and q_per_level is not None and tree is not None \
            and tree.num_levels > 1:
        kl = torch.zeros((), dtype=torch.float32, device=device)
        n = 0
        for L in range(1, tree.num_levels):
            if q_per_level[L] is not None:
                kl = kl + grouped_conditional_kl(_f32(q_per_level[L]),
                                                 tree.child_to_parent[L],
                                                 space)
                n += 1
        if n:
            total = total + lambda_kl * kl / n
    return total, torch.stack(per_level)

"""Restrictive-head math: gated grouped softmax and probabilistic
composition. Counterpart of the JAX package's ``ops/restrictive.py``.

For every level ``L >= 1`` the child logits are grouped by parent; within
the group of parent ``p``::

    Q_g = softmax(z_g + log(P_p + eps))      # gated conditional
    P_c = P_p * Q_g                          # probabilistic composition

The JAX package has two formulations (per-group unrolled slices up to
``GROUP_UNROLL_LIMIT`` groups, one-hot contractions above). One PyTorch
formulation covers both: the parent statistics are gathered to the children
with ``index_select`` on the channel axis, and the per-group max and sum are
``scatter_reduce`` over the same index. Parents without children keep a
group max of ``-inf`` and a sum of 0, which no child reads, so no NaN can
appear.

:func:`grouped_conditional_kl` is the optional KL stabiliser of the loss,
and :func:`static_channel_take` the JAX package's static channel gather
(there a slices-and-concat to avoid an XLA gather; here one
``index_select``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gated_grouped_softmax", "compose_children",
           "grouped_conditional_kl", "static_channel_take"]

_EPS = 1e-6  # reference eps, models.py:274/:761


def _index(parent_index, device) -> torch.Tensor:
    if isinstance(parent_index, torch.Tensor):
        return parent_index.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(parent_index), dtype=torch.long,
                           device=device)


def static_channel_take(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[..., idx]`` for a static integer index list."""
    return x.index_select(-1, _index(idx, x.device).reshape(-1))


def gated_grouped_softmax(z_children: torch.Tensor, p_parent: torch.Tensor,
                          parent_index, child_to_parent
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-parent-group softmax of ``z + log(P_parent + eps)``.

    Args:
      z_children: (..., C_child) child logits, channel axis last.
      p_parent: (..., C_parent) previous-level probabilities.
      parent_index: (C_child,) ints, child -> parent channel (numpy or a
        long tensor on the inputs' device).
      child_to_parent: (C_child, C_parent) one-hot matrix; only its width
        (the parent count) is read.

    Returns:
      (Q, P_child): the conditional ``Q_{c|p}`` and ``P_c = P_p * Q``.
    """
    pidx = _index(parent_index, z_children.device)
    n_parent = int(np.shape(child_to_parent)[1])
    p_gathered = p_parent.index_select(-1, pidx)
    gated = z_children + torch.log(p_gathered + _EPS)
    idx = pidx.expand_as(gated)
    stat_shape = gated.shape[:-1] + (n_parent,)
    # The group max only shifts the softmax for stability; softmax is
    # shift-invariant, so the gradient through it is 0 in exact arithmetic.
    # It is not detached all the same: as in JAX, the max's share of the
    # gradient takes back the rounding of the group's other terms (their
    # sum is 0 in exact arithmetic). Detached, the gradient with respect to
    # the parent probabilities is ~10x further from a float64 run.
    group_max = torch.full(stat_shape, float("-inf"), dtype=gated.dtype,
                           device=gated.device).scatter_reduce(
        -1, idx, gated, reduce="amax", include_self=True)
    e = torch.exp(gated - group_max.index_select(-1, pidx))
    sums = torch.zeros(stat_shape, dtype=e.dtype, device=e.device
                       ).scatter_add(-1, idx, e)
    q = e / sums.index_select(-1, pidx)
    return q, p_gathered * q


def compose_children(z_children: torch.Tensor, p_parent: torch.Tensor,
                     parent_index, child_to_parent) -> torch.Tensor:
    """Only the composed child probabilities ``P_c``."""
    return gated_grouped_softmax(z_children, p_parent, parent_index,
                                 child_to_parent)[1]


def grouped_conditional_kl(q_children: torch.Tensor,
                           child_to_parent) -> torch.Tensor:
    """Mean over parent groups of KL(Q_{c|p} || Uniform_g), the optional
    stabiliser (JAX ``grouped_conditional_kl``): per group ``mean(Q * (log Q
    - log(1/g)))`` over every element, then the mean over groups. Groups all
    see the same spatial extent, so this is a weighted channel mean."""
    a = torch.as_tensor(np.asarray(child_to_parent), dtype=q_children.dtype,
                        device=q_children.device)
    group_size = a.sum(0)                       # (C_parent,)
    g = group_size.index_select(0, a.argmax(-1))  # (C_child,)
    q = q_children.clamp_min(1e-8)
    kl_terms = q * (torch.log(q) + torch.log(g))
    n_groups = int((np.asarray(child_to_parent).sum(axis=0) > 0).sum())
    per_channel = kl_terms.mean(dim=tuple(range(kl_terms.dim() - 1)))
    return (per_channel / g).sum() / n_groups

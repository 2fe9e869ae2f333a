"""The train step (forward, loss, backward, AdamW, BatchNorm running
statistics, confusion matrices) and the eval step; counterpart of the JAX
package's ``train/steps.py``.

PyTorch runs the step eagerly: the model's parameters, BatchNorm running
buffers and optimizer state are updated in place, where the JAX step
returns a new state. Under ``compute_dtype="bfloat16"`` the forward runs in
``torch.autocast`` (parameters and losses stay f32). Every train-mode
BatchNorm of the HRNet backbone runs the port's BN kernels: batch
statistics, scale-bias-act forward, and the two-pass backward.

BatchNorm running statistics: the reference re-runs the backbone once per
tree level, so each BatchNorm updates its running buffers D times a step
with the same batch values; the shared-backbone forward updates them once,
and :func:`bn_ema_correction` turns that one update into D
(``model.bn_updates_per_step``).

Data parallelism (``group``: the process group of a data group of more
than one rank, each holding an equal share of the global batch): the
BatchNorms take the group's statistics (``models/norm.py:set_bn_group``,
set by the caller), the loss divides by the group's Dice counts
(``losses/hierarchical.py``), and after the microbatches the gradients are
all-reduced to their mean over the group, flattened into buckets of at
most ``GRAD_BUCKET_BYTES``. Every rank then applies the same update, so
parameters and running buffers stay the same bits on every rank. The
step's aux is reduced too (one all-reduce): loss and per-level losses are
means over the group, confusion matrices sums, so every rank sees the
global step's numbers. Gradient accumulation keeps its meaning: each rank
holds its share of every microbatch (``data/loader.py:shard_rows``).

Spatial sharding (``space``: the space group of a ``(data, space)`` mesh,
whose ranks hold bands of rows of the same images, ``parallel/bands.py``;
``group`` is then the step group, data x space): the model runs on the
bands (``parallel/bands.py:set_space_group``, set by the caller), the loss
spans them (``losses/hierarchical.py``), so every rank of a space group
computes the same loss, its data shard's, and the gradients are summed
over the step group and divided by its size: the mean over the data
shards of each shard's gradient (the loss's sums give every band the
gradient of every rank's use of them). Loss and per-level losses are then
means over the step group, confusion matrices sums, as on the data axis.
The eval step runs on bands too: its loss spans them, its confusion
matrices are added over the space group and its outputs gathered to the
whole height.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..hierarchy.tree import ClassTree
from ..losses.hierarchical import hierarchical_loss
from ..metrics.segmentation import level_confusion_matrices
from ..models.norm import BN_MOMENTUM, BatchNormAct
from ..parallel.bands import active, gather_bands, global_height
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "split_targets",
           "bn_ema_correction", "GRAD_BUCKET_BYTES"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the most gradient bytes one all-reduce carries (DDP's default bucket)
GRAD_BUCKET_BYTES = 25 * 2 ** 20


def bn_ema_correction(old_stats: Sequence[torch.Tensor],
                      one_update_stats: Sequence[torch.Tensor],
                      momentum: float, d: int) -> List[torch.Tensor]:
    """D EMA updates with one batch value, from one applied update.

    One update gives ``n1 = m*ra + (1-m)*v``; D updates with the same ``v``
    give ``nD = m^D*ra + (1-m^D)*v``. Substituting ``v``::

        nD = ra*(m^D - m*k) + n1*k,   k = (1-m^D)/(1-m)

    Elementwise over lists of per-channel tensors; new tensors out."""
    if d <= 1:
        return list(one_update_stats)
    m = momentum
    k = (1.0 - m ** d) / (1.0 - m)
    c_old = m ** d - m * k
    return torch._foreach_add(torch._foreach_mul(list(old_stats), c_old),
                              torch._foreach_mul(list(one_update_stats), k))


def split_targets(tree: ClassTree, targets: torch.Tensor,
                  hierarchical: bool) -> List[torch.Tensor]:
    """(B, H, W, C_total) -> one tensor per level (train.py:185-193)."""
    if not hierarchical:
        return [targets]
    return tree.split_levels(targets, axis=-1)


def _device_decode(images: torch.Tensor, targets: torch.Tensor):
    """Complete the compact host formats on the device: int8 ternary
    targets to f32, and gray (B, H, W, 1) images to 3 channels."""
    if targets.dtype != torch.float32:
        targets = targets.float()
    if images.shape[-1] == 1:
        images = images.expand(*images.shape[:-1], 3).contiguous()
    return images, targets


def _running_buffers(model) -> List[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, BatchNormAct)
            for t in (m.running_mean, m.running_var)]


def _compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


class TrainStep:
    """``step(state, images, targets, level_mask) -> (state, aux)`` with
    ``aux = {loss, per_level, confmats}`` (tensors on the model's device;
    ``confmats`` only with ``compute_metrics``). :meth:`micro_grads` is one
    microbatch's gradients without the optimizer update."""

    def __init__(self, model, tree: ClassTree, hierarchical: bool,
                 level_weights=None, lambda_cons: float = 1.0,
                 lambda_kl: float = 0.0, dice_smooth: float = 0.0,
                 ohem=None, compute_metrics: bool = True,
                 grad_accum: int = 1, compute_dtype: str = "float32",
                 group=None, space=None):
        self.model = model
        self.group = group
        self.space = active(space)
        self.ranks = 1 if group is None else dist.get_world_size(group)
        self.tree = tree
        self.hierarchical = hierarchical
        self.loss_kw = dict(level_weights=level_weights,
                            lambda_cons=lambda_cons, lambda_kl=lambda_kl,
                            dice_smooth=dice_smooth, ohem=ohem)
        self.compute_metrics = compute_metrics
        self.grad_accum = int(grad_accum)
        self.dtype = _compute_dtype(compute_dtype)
        self.bn_d = int(getattr(model, "bn_updates_per_step", 1))
        self.buffers = _running_buffers(model)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buckets = _buckets(self.params, GRAD_BUCKET_BYTES)

    def _micro(self, images, targets, level_mask):
        """Forward, loss and backward of one microbatch: gradients add into
        ``.grad``; BN running buffers end at the D-update value."""
        model = self.model
        model.train()
        images, targets = _device_decode(images, targets)
        old = (torch._foreach_mul(self.buffers, 1.0) if self.bn_d > 1
               else None)
        with torch.autocast(images.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            out = model(images)
        tgt = split_targets(self.tree, targets, self.hierarchical)
        total, per_level = hierarchical_loss(
            out.logits_per_level, tgt,
            probs_per_level=out.probs_per_level, q_per_level=out.q_per_level,
            tree=self.tree if self.hierarchical else None,
            level_mask=level_mask, group=self.group, space=self.space,
            **self.loss_kw)
        total.backward()
        if old is not None:
            with torch.no_grad():
                new = bn_ema_correction(old, self.buffers, BN_MOMENTUM,
                                        self.bn_d)
                torch._foreach_copy_(self.buffers, new)
        confmats = None
        if self.compute_metrics:  # this rank's pixels (_reduce_aux adds)
            with torch.no_grad():
                confmats = level_confusion_matrices(
                    [z.detach() for z in out.logits_per_level], tgt)
        return total.detach(), per_level.detach(), confmats

    def micro_grads(self, images, targets, level_mask
                    ) -> tuple[Dict[str, torch.Tensor], torch.Tensor,
                               torch.Tensor, Optional[list]]:
        """``(grads by parameter name, loss, per_level, confmats)`` of one
        microbatch; the BN running buffers are updated as in a step, the
        parameters are not."""
        for p in self.params:
            p.grad = None
        loss, per_level, confmats = self._micro(images, targets, level_mask)
        grads = {n: (p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p))
                 for n, p in self.model.named_parameters()
                 if p.requires_grad}
        for p in self.params:
            p.grad = None
        return grads, loss, per_level, confmats

    def __call__(self, state: TrainState, images, targets, level_mask):
        if state.model is not self.model:
            raise ValueError("the state holds another model than the step")
        a = self.grad_accum
        b = images.shape[0]
        if b % a:
            raise ValueError(f"batch {b} not divisible by grad_accum {a}")
        state.optimizer.zero_grad(set_to_none=True)
        results = [self._micro(im, tg, level_mask)
                   for im, tg in zip(images.chunk(a), targets.chunk(a))]
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:  # as in JAX: every parameter updates
                    p.grad = torch.zeros_like(p)
                elif a > 1:
                    p.grad.div_(a)
            if self.group is not None:
                self._all_reduce_grads()
        state.optimizer.step()
        state.step += 1
        aux = {"loss": torch.stack([r[0] for r in results]).mean(),
               "per_level": torch.stack([r[1] for r in results]).mean(0)}
        if self.compute_metrics:
            aux["confmats"] = [sum(r[2][L] for r in results)
                               for L in range(len(results[0][2]))]
        if self.group is not None:
            aux = self._reduce_aux(aux)
        return state, aux

    def _all_reduce_grads(self) -> None:
        """Every gradient to its mean over the group, a bucket per
        all-reduce."""
        for bucket in self.buckets:
            grads = [p.grad for p in bucket]
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.ranks)
            parts = flat.split([g.numel() for g in grads])
            torch._foreach_copy_(grads, [v.view(g.shape)
                                         for v, g in zip(parts, grads)])

    def _reduce_aux(self, aux: dict) -> dict:
        """The group's aux in one f64 all-reduce (counts stay exact): loss
        and per-level losses averaged, confusion matrices added."""
        parts = [aux["loss"].reshape(1), aux["per_level"]]
        parts += aux.get("confmats", [])
        flat = torch.cat([t.reshape(-1).double() for t in parts])
        dist.all_reduce(flat, group=self.group)
        out = [v.view(t.shape).to(t.dtype)
               for v, t in zip(flat.split([t.numel() for t in parts]),
                               parts)]
        reduced = {"loss": out[0].reshape(()) / self.ranks,
                   "per_level": out[1] / self.ranks}
        if "confmats" in aux:
            reduced["confmats"] = out[2:]
        return reduced


def _sum_over(mats: List[torch.Tensor], space) -> List[torch.Tensor]:
    """Confusion matrices added over the ranks of ``space`` (one
    all-reduce)."""
    flat = torch.cat([m.reshape(-1) for m in mats])
    dist.all_reduce(flat, group=space.group)
    return [v.view(m.shape) for v, m in
            zip(flat.split([m.numel() for m in mats]), mats)]


def _buckets(params, most_bytes: int) -> List[list]:
    """``params`` in order, cut into runs of at most ``most_bytes`` of
    gradient (a larger tensor alone)."""
    out, cur, size = [], [], 0
    for p in params:
        nb = p.numel() * p.element_size()
        if cur and size + nb > most_bytes:
            out.append(cur)
            cur, size = [], 0
        cur.append(p)
        size += nb
    if cur:
        out.append(cur)
    return out


def make_train_step(model, tree: ClassTree, hierarchical: bool,
                    level_weights: Optional[Sequence[Sequence[float]]] = None,
                    lambda_cons: float = 1.0, lambda_kl: float = 0.0,
                    dice_smooth: float = 0.0, ohem=None,
                    compute_metrics: bool = True, grad_accum: int = 1,
                    compute_dtype: str = "float32",
                    group=None, space=None) -> TrainStep:
    """The train step of ``model`` (see :class:`TrainStep`).

    ``grad_accum = A`` takes one optimizer step from A sequential
    microbatches: the gradient is their mean, each microbatch normalizes
    with its own BN statistics and updates the running buffers in turn,
    loss and per-level losses are microbatch means and confusion matrices
    sum. ``group``: the process group of the data (x space) ranks
    (module docstring); None on one rank. ``space``: the space group's
    :class:`..parallel.mesh.DataGroup` (None without bands)."""
    return TrainStep(model, tree, hierarchical, level_weights, lambda_cons,
                     lambda_kl, dice_smooth, ohem, compute_metrics,
                     grad_accum, compute_dtype, group, space)


def make_eval_step(model, tree: ClassTree, hierarchical: bool,
                   level_weights: Optional[Sequence[Sequence[float]]] = None,
                   lambda_cons: float = 1.0, lambda_kl: float = 0.0,
                   dice_smooth: float = 0.0, ohem=None,
                   return_outputs: bool = False,
                   per_image_metrics: bool = False,
                   compute_dtype: str = "float32",
                   apply_fn: Optional[Callable] = None,
                   space=None) -> Callable:
    """``eval_step(images, targets) -> {loss, per_level, confmats[,
    outputs]}`` with the running BN statistics (the model in eval mode for
    the call). ``per_image_metrics`` gives (B, C', C') confusion matrices;
    ``outputs`` are the per-level logits whose argmax is scored.

    ``apply_fn(images) -> SegmenterOutput`` stands in for ``model(images)``
    (the test-time augmentation of ``train/evaluate.py:tta_apply``); it runs
    inside the same eval mode, inference mode and autocast.

    ``space``: the space group whose bands of rows ``images`` and
    ``targets`` are (module docstring); the confusion matrices and the
    outputs come back whole on every rank of it."""
    dtype = _compute_dtype(compute_dtype)
    forward = apply_fn or model
    space = active(space)

    def step(images, targets):
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), torch.autocast(
                    images.device.type, dtype=dtype,
                    enabled=dtype != torch.float32):
                images, targets = _device_decode(images, targets)
                out = forward(images)
                tgt = split_targets(tree, targets, hierarchical)
                total, per_level = hierarchical_loss(
                    out.logits_per_level, tgt, level_weights,
                    probs_per_level=out.probs_per_level,
                    q_per_level=out.q_per_level,
                    tree=tree if hierarchical else None,
                    lambda_cons=lambda_cons, lambda_kl=lambda_kl,
                    dice_smooth=dice_smooth, ohem=ohem, space=space)
                scores = list(out.logits_per_level)
                confmats = level_confusion_matrices(
                    scores, tgt, per_image=per_image_metrics)
                if space is not None:
                    confmats = _sum_over(confmats, space)
                res = {"loss": total, "per_level": per_level,
                       "confmats": confmats}
                if return_outputs:
                    if space is not None:
                        h = global_height(images.shape[1], space,
                                          images.device)
                        scores = [gather_bands(z, h, space, dim=1)
                                  for z in scores]
                    res["outputs"] = scores
        finally:
            model.train(was_training)
        return res

    return step

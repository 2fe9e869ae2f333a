"""BatchNorm followed by an activation, through the port's kernels.

One module stands for both BatchNorms of the JAX package,
``models/norm.py:LeanBatchNorm`` and ``models/pallas_bn.py:PallasBatchNormAct``.

Eval mode: both compute ``act(x * a + b)`` per channel with

    a = weight * rsqrt(running_var + eps)        (f32)
    b = bias - running_mean * a                  (f32)

and this module hands ``a`` and ``b`` to
:func:`..ops.fused_bn_act.fused_scale_bias_act`, the Hopper kernel that
replaces the Pallas ``_scale_bias_act_kernel``.

bf16 note: the JAX ``LeanBatchNorm`` rounds ``a`` and ``b`` to bf16 before
its multiply-add (``norm.py:85-87``). The kernel, like the Pallas one, keeps
``a``, ``b`` and the arithmetic in f32 and rounds once, on output. In f32
the two agree.

Train mode: normalize with the batch statistics of x through
:func:`..ops.fused_bn_act.batch_norm_act` (the ``bn_stats`` kernel, then
kernel 2's train entry as the forward of an autograd Function whose
backward is the BN backward kernel), which in the same launch updates the
running buffers in place as both JAX modules do::

    running_mean = m * running_mean + (1 - m) * mean
    running_var  = m * running_var  + (1 - m) * var * n / (n - 1)

with the flax momentum ``m = 0.9`` (torch's 0.1) and the unbiased (Bessel)
batch variance in the running buffer, as ``LeanBatchNorm`` stores it. The
statistics are those of the local batch, or, with a group of more than
one rank (:func:`set_bn_group`: the step group, data x space), of the rows
of every rank of the group (``LeanBatchNorm`` under ``data`` and ``space``
mesh axes: SyncBatchNorm), through
:func:`..ops.fused_bn_act.sync_batch_norm_act`; ``n`` is then the group's
row count, all-reduced with the sums (bands of rows differ in height from
rank to rank). The group is used in train mode only. The update bumps the
buffers' version counters, so ``folded()`` forms eval's ``(a, b)`` anew
after it. Inside the recompute of a
rematerialized region (``models/remat.py``) the buffers are left as they
are: the region's forward already moved them, once. Train mode takes act
"none" or "relu": the JAX backward treats every other act as the
identity, which is wrong for ``leaky_relu``, so the port raises for it
instead.

Export: the ``folded()`` cache is keyed on storage addresses and version
counters, which the tensors ``torch.export`` traces with do not have, so
under ``torch.compiler.is_exporting()`` the forward computes ``(a, b)``
from the parameters and buffers in the graph (the same f32 formula) and
the exported program folds them on every call.

Parameters ``weight``/``bias`` and buffers ``running_mean``/``running_var``
are the flax ``scale``/``bias`` and ``mean``/``var`` (see ``bridge.py``);
eps is 1e-5.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..ops.fused_bn_act import (ACTS, batch_norm_act, fused_scale_bias_act,
                                sync_batch_norm_act)
from .remat import recomputing

__all__ = ["BatchNormAct", "BN_MOMENTUM", "set_bn_group"]

BN_MOMENTUM = 0.9  # flax convention; torch's momentum 0.1


class BatchNormAct(nn.Module):
    """BatchNorm over the channel axis of an NCHW (channels_last) tensor,
    then ``act`` ("none" | "relu" | "leaky_relu")."""

    def __init__(self, num_features: int, act: str = "none",
                 eps: float = 1e-5):
        super().__init__()
        # the process group whose rows the train-mode statistics span
        # (None: this rank's rows); see set_bn_group
        self.group = None
        if act not in ACTS:
            raise ValueError(f"unknown act {act!r}")
        self.act = act
        self.eps = eps
        self.momentum = BN_MOMENTUM
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self._folded = None
        self._folded_key = None

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-channel f32 ``(a, b)`` of ``x * a + b``, kept until a
        parameter or buffer is replaced or written in place (its storage or
        version counter changes), so a forward launches no small kernels
        to recompute them."""
        sources = (self.weight, self.bias, self.running_mean,
                   self.running_var)
        key = tuple((t.data_ptr(), t._version) for t in sources)
        if key != self._folded_key:
            # no_grad, and normal tensors even under inference_mode: an
            # eval-mode forward with autograd on may save them later
            with torch.inference_mode(False), torch.no_grad():
                self._folded = self._fold()
            self._folded_key = key
        return self._folded

    def _fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        a = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        return a, self.bias.float() - self.running_mean.float() * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # channels_last NCHW viewed as NHWC is the contiguous (rows, C)
        # matrix the kernels take; .contiguous() is a no-op for it
        xn = x.permute(0, 2, 3, 1).contiguous()
        if self.training:
            y = self._train(xn)
        else:
            a, b = (self._fold() if torch.compiler.is_exporting()
                    else self.folded())
            y = fused_scale_bias_act(xn, a, b, self.act)
        return y.permute(0, 3, 1, 2)

    def _train(self, xn: torch.Tensor) -> torch.Tensor:
        # fused_bn_act raises for an act other than "none" and "relu"; the
        # forward of a recompute leaves the buffers (this step's forward
        # moved them already)
        running = None if recomputing() else (
            self.running_mean, self.running_var, self.momentum)
        if self.group is None:
            return batch_norm_act(xn, self.weight, self.bias, self.eps,
                                  self.act, running)[0]
        return sync_batch_norm_act(xn, self.weight, self.bias, self.group,
                                   self.eps, self.act, running)[0]

    def extra_repr(self) -> str:
        return f"{self.weight.shape[0]}, act={self.act}, eps={self.eps}"


def set_bn_group(model: nn.Module, group) -> nn.Module:
    """Make every :class:`BatchNormAct` of ``model`` take its train-mode
    statistics over the rows of every rank of the process ``group`` (the
    step group: its data and space ranks; None, or a group of one rank:
    this rank's rows alone, through the single-launch kernels). Eval mode
    ignores it."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    for m in model.modules():
        if isinstance(m, BatchNormAct):
            m.group = group
    return model

"""Rematerialization of backbone regions (``--remat``): the counterpart of
the JAX package's ``nn.remat`` regions, with their placement and modes.

``remat`` is False (save every activation), True or "module" (recompute
the whole region in the backward) or "conv" (save every convolution's
output and recompute the rest: BatchNorm, ReLU, pooling, resize, adds).
The regions are the JAX package's: the whole backbone pass for the UNet
(JAX ``models/hierarchical.py:_run_backbone``), each
``HighResolutionModule`` for HRNet (JAX ``models/backbones/hrnet.py``).

"module" is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``.
"conv" is the same call with the selective-checkpoint contexts of
:func:`keep_convs`, a policy that keeps every ``aten.convolution`` output
(``MUST_SAVE``) and recomputes every other op: the counterpart of JAX's
``save_only_these_names("conv_out")``, where each conv output is tagged
``conv_out`` (JAX ``hrnet.py:_bn_act``, ``unet.py:DoubleConv``). The
port needs no tag: the policy sees the convolution itself.

A recompute re-runs each train-mode BatchNorm of its region: kernel 1 and
kernel 2 launch again inside the backward. Its running statistics must
move once per forward, not again in the recompute, so the recompute
context of both modes raises a flag (:func:`recomputing`) that
``BatchNormAct`` reads before it updates its buffers; for "conv" the flag
is entered together with the selective-checkpoint recompute context. The
flag is a module-level count, not a thread-local: the autograd engine
runs the recompute on its own thread for a CUDA device. The recompute
stops at the region's last saved tensor (the checkpoint's early stop): a
BatchNorm that ends its region (the UNet's last) launches kernels 1 and 2
and saves its tensors, and the recompute stops before the flag is read.

Under a data group, the recompute re-runs ``sync_batch_norm_act``'s
forward all-reduce inside the backward. Every rank recomputes the same
regions in the same order (one graph, one autograd order), and the train
step all-reduces the gradients after the backward
(``train/steps.py:TrainStep._all_reduce_grads``), so the collectives
match on every rank.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["remat_mode", "run_region", "recomputing", "keep_convs"]

_RECOMPUTING = 0


def remat_mode(remat) -> Optional[str]:
    """None (no region), "module" or "conv" from the ``remat`` option
    (False / None, True / "module", "conv")."""
    if remat is None or remat is False:
        return None
    if remat is True or remat == "module":
        return "module"
    if remat == "conv":
        return "conv"
    raise ValueError(f"remat {remat!r}: expected False, True, 'module' or "
                     "'conv'")


def recomputing() -> bool:
    """True inside a region's recompute (the backward re-running its
    forward)."""
    return _RECOMPUTING > 0


@contextlib.contextmanager
def _recompute(inner):
    """``inner`` (a checkpoint recompute context) with the flag raised."""
    global _RECOMPUTING
    with inner:
        _RECOMPUTING += 1
        try:
            yield
        finally:
            _RECOMPUTING -= 1


def keep_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "conv" policy: save convolution outputs, recompute the rest."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _contexts(mode: str):
    if mode == "conv":
        forward, recompute = create_selective_checkpoint_contexts(keep_convs)
        return forward, _recompute(recompute)
    return contextlib.nullcontext(), _recompute(contextlib.nullcontext())


def run_region(fn, *args, mode: Optional[str]):
    """``fn(*args)``, as a recomputed region when ``mode`` is set and
    autograd records (eval and inference forwards run it plainly)."""
    if mode is None or not torch.is_grad_enabled():
        return fn(*args)
    # the regions draw no random numbers: no RNG state to stash
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_contexts, mode))

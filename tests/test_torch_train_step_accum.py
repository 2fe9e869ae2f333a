"""The port's train step with gradient accumulation (2 microbatches of 2)
against the JAX package's ``make_train_step(grad_accum=2)`` with its Pallas
BatchNorm (interpret mode), on the CPU, in fp32: two steps, the second with
``level_mask`` [1, 0]. Each microbatch normalizes with its own BN
statistics and moves the running statistics in turn; the gradient is the
microbatch mean and the confusion matrices add up. The setting and every
tolerance, with its reason, are in ``torch_train_common.py``."""
import pytest
import torch

from torch_train_common import Pair


def test_train_steps_with_grad_accum_match_jax():
    pair = Pair(grad_accum=2, oracle="pallas")
    aux = pair.two_steps()
    assert aux["confmats"][0].sum() == pair.x.shape[0] * pair.x.shape[1] \
        * pair.x.shape[2]


def test_grad_accum_rejects_indivisible_batch():
    pair = Pair(grad_accum=3)
    with pytest.raises(ValueError, match="divisible"):
        pair.pstep(pair.pstate, torch.from_numpy(pair.x),
                   torch.from_numpy(pair.y), torch.ones(2))

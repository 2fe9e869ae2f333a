"""The port's train step against the JAX package's ``make_train_step`` with
its Pallas BatchNorm (``use_pallas_bn=True``, the kernels in interpret
mode), on the CPU, in fp32: shared and unshared backbone, two steps each,
the second with ``level_mask`` [1, 0] (gradient accumulation is in
``test_torch_train_step_accum.py``). The setting and every tolerance, with
its reason, are in ``torch_train_common.py``."""
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
    bn_ema_correction,
)
from torch_train_common import Pair


@pytest.mark.parametrize("share", [True, False], ids=["shared", "unshared"])
def test_train_steps_match_jax(share):
    pair = Pair(share=share, oracle="pallas")
    assert pair.pm.bn_updates_per_step == pair.jm.bn_updates_per_step \
        == (2 if share else 1)
    aux = pair.two_steps()
    # level 1 is masked in the second step: its loss is reported but only
    # level 0 and the consistency term are in the total
    lvl = aux["per_level"].numpy()
    assert aux["loss"].item() != pytest.approx(float(lvl.sum()))


def test_micro_grads_equal_the_step_gradient():
    """``micro_grads`` gives the gradient a step applies; it moves the BN
    running buffers as a step does, and not the parameters."""
    pair = Pair()
    x, y = torch.from_numpy(pair.x), torch.from_numpy(pair.y)
    before = {k: v.clone() for k, v in pair.pm.state_dict().items()}
    grads, loss, per_level, confmats = pair.pstep.micro_grads(
        x, y, torch.ones(2))
    assert all(p.grad is None for p in pair.pm.parameters())
    for k, v in pair.pm.state_dict().items():
        moved = not torch.equal(v, before[k])
        assert moved == k.endswith(("running_mean", "running_var")), k
    pair.pm.load_state_dict(before)
    _, aux = pair.pstep(pair.pstate, x, y, torch.ones(2))
    for n, p in pair.pm.named_parameters():
        assert torch.equal(grads[n], p.grad), n
    assert loss.item() == aux["loss"].item()
    assert torch.equal(per_level, aux["per_level"])
    for a, b in zip(confmats, aux["confmats"]):
        assert torch.equal(a, b)


def test_bn_ema_correction_is_d_updates():
    rng = np.random.default_rng(0)
    ra, v = (torch.from_numpy(rng.standard_normal(6).astype(np.float32))
             for _ in range(2))
    m = 0.9
    one = m * ra + (1 - m) * v
    for d in (1, 2, 3):
        want = ra.clone()
        for _ in range(d):
            want = m * want + (1 - m) * v
        got, = bn_ema_correction([ra], [one], m, d)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_optimizer_settings_and_set_learning_rate():
    """AdamW as the reference trains: b1 0.9, b2 0.999, eps 1e-8, weight
    decay 0.01 on every parameter; the plateau scheduler sets the rate of
    every parameter group."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        create_train_state,
        set_learning_rate,
    )

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    state = create_train_state(model, 0.018)
    group, = state.optimizer.param_groups
    assert isinstance(state.optimizer, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (0.018, (0.9, 0.999), 1e-8, 0.01)
    assert len(group["params"]) == 4 and state.step == 0
    assert set_learning_rate(state, 1e-3) is state
    assert all(g["lr"] == 1e-3 for g in state.optimizer.param_groups)

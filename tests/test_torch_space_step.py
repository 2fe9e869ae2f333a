"""The train step on bands of rows (``train/steps.py`` with a space group,
``losses/hierarchical.py`` over the bands), on ``gloo`` ranks on the CPU:

* a ``(data 2, space 2)`` step of four ranks against the JAX step over
  the JAX ``make_mesh(n_data=2, n_space=2)`` on the suite's fake CPU
  devices (the JAX test ``tests/test_train_steps.py:170-197``), from the
  same variables through ``bridge.py``: loss and per-level losses at rtol
  2e-4 (that test's bound), gradients and running statistics at the bounds
  of ``tests/torch_train_common.py`` for the JAX default BatchNorm (5e-2
  of a tensor's largest gradient; 1e-4 of a buffer's largest value), the
  parameters after AdamW on the significant-update criterion of JAX
  ``tests/test_fold_parallel.py:160-178`` (at most 1 % of the updates
  above lr / 2 off by more than 10 %);
* steps on bands against one process of the port on the whole images
  (without remat): the tiny HRNet over 2 ranks with remat "module" (the
  recompute repeats the halo exchanges in the backward), the UNet over 2
  ranks with remat "conv", OHEM and the KL term (the image's k-th
  probability, the KL mean over the bands) and over 3 ranks at an uneven
  height: loss and per-level losses at rtol 1e-5,
  every gradient at 1e-4 of the tensor's largest value (a conv bias ahead
  of a BatchNorm, 0 in exact arithmetic, at 5e-5 of the step's largest
  gradient), confusion matrices equal but for near-tied pixels, and every
  rank's parameters and buffers bit-equal.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.parallel.mesh import (
    batch_sharding,
    make_mesh as jax_make_mesh,
    replicated,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from torch_dist_common import build_small, rank_threads, run_ranks
from torch_port_common import jax_variables, trees
from torch_space_common import step_job, steps_job
from torch_train_common import (
    GRAD_RTOL,
    LEVEL_WEIGHTS,
    LR,
    STATS_RTOL,
    ZERO_GRAD_TOL,
    adamw_keeping_grads,
    batch,
    check_confmats,
    flat,
    unet_models,
)

JAX_LOSS_RTOL = 2e-4  # tests/test_train_steps.py:196
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def _zero_grad(name, donor):
    """A UNet conv bias ahead of a train-mode BatchNorm: 0 in exact
    arithmetic (``torch_train_common.Pair.zero_grads``)."""
    return donor == "unet" and name.startswith("backbone.") and \
        name.endswith((".conv0.bias", ".conv1.bias"))


def _check_grads(got, want, donor, rel):
    top = max(float(v.abs().max()) for v in want.values())
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        if _zero_grad(n, donor):
            assert err <= ZERO_GRAD_TOL * top, (n, err, top)
        else:
            assert err <= rel * float(w.abs().max()) + 1e-7, (n, err)


def _significant(new, ref, old, lr):
    n_sig = n_bad = 0
    for k, r in ref.items():
        us = torch.as_tensor(r - old[k]).double()
        up = (new[k] - torch.as_tensor(old[k])).double()
        sig = us.abs() > 0.5 * lr
        n_sig += int(sig.sum())
        n_bad += int(((up[sig] - us[sig]).abs()
                      > 0.1 * lr + 0.1 * us[sig].abs()).sum())
    return n_sig, n_bad / max(1, n_sig)


def test_data2_space2_step_tracks_the_jax_step_over_its_mesh(tmp_path):
    jtree, ptree = trees("default")
    jm, _ = unet_models(jtree, ptree)
    x, y = batch(ptree, seed=7, n=4, size=32)
    params, stats = jax_variables(jm, x[:1], seed=0, train=False)
    tx = adamw_keeping_grads(LR)
    mesh = jax_make_mesh(n_data=2, n_space=2)
    jstate = jax.device_put(JaxTrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32)), replicated(mesh))
    jstep = jax_make_train_step(jm, tx, jtree, True,
                                level_weights=LEVEL_WEIGHTS, donate=False)
    shard = batch_sharding(mesh)
    jstate, jaux = jstep(jstate, jax.device_put(x, shard),
                         jax.device_put(y, shard), jnp.ones((2,), jnp.float32))
    sd = state_dict_from_flax(params, stats)
    ranks = run_ranks(steps_job, 4, tmp_path,
                      [("unet", sd, x, y, 2, 2, LR, LEVEL_WEIGHTS)])
    ranks = [r[0] for r in ranks]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jaux["loss"]),
                                   rtol=JAX_LOSS_RTOL)
        np.testing.assert_allclose(r["per_level"].numpy(),
                                   np.asarray(jaux["per_level"]),
                                   rtol=JAX_LOSS_RTOL)
        for k, v in r["state"].items():  # every rank the same bits
            assert torch.equal(v, ranks[0]["state"][k]), k
    check_confmats(jaux, ranks[0])
    want_grads = {k: torch.from_numpy(v)
                  for k, v in flat(jstate.opt_state[1]).items()}
    _check_grads(ranks[0]["grads"], want_grads, "unet", GRAD_RTOL["default"])
    want = flat(jstate.params, jstate.batch_stats)
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            err = float((ranks[0]["state"][k] - torch.from_numpy(v))
                        .abs().max())
            assert err <= STATS_RTOL["default"] * np.abs(v).max(), (k, err)
    old = {k: v.numpy() for k, v in sd.items()}
    n_sig, bad = _significant(
        ranks[0]["state"], {k: v for k, v in want.items()
                            if k in ranks[0]["grads"]}, old, LR)
    assert n_sig > 1000 and bad < 0.01, (n_sig, bad)


# (donor, image height, data ranks, space ranks, make_train_step keywords,
# remat)
BAND_STEPS = [
    ("hrnet", 36, 1, 2, {}, "module"),
    ("unet", 36, 1, 2, {"ohem": (0.9, 300), "lambda_kl": 0.5}, "conv"),
    ("unet", 50, 1, 3, {}, False),
]


@pytest.fixture(scope="module")
def band_steps(tmp_path_factory):
    """Each case's ranks' and one process's step results."""
    _, ptree = trees("default")
    out = {}
    by_world = {}
    for i, (donor, size, nd, ns, kw, remat) in enumerate(BAND_STEPS):
        torch.manual_seed(5)
        sd = copy.deepcopy(build_small(donor).state_dict())
        x, y = batch(ptree, seed=3, n=4, size=size)
        run = (donor, sd, x, y, nd, ns, LR, LEVEL_WEIGHTS, kw, remat)
        with rank_threads():
            out[i] = {"one": step_job(0, 1, *run[:4], 1, 1, *run[6:9])}
        by_world.setdefault(nd * ns, []).append((i, run))
    for world, runs in by_world.items():
        res = run_ranks(steps_job, world,
                        tmp_path_factory.mktemp(f"band_steps_{world}"),
                        [r for _, r in runs])
        for j, (i, _) in enumerate(runs):
            out[i]["ranks"] = [r[j] for r in res]
    return out


@pytest.mark.parametrize("case", range(len(BAND_STEPS)))
def test_step_on_bands_equals_one_process(band_steps, case):
    donor = BAND_STEPS[case][0]
    one, ranks = band_steps[case]["one"], band_steps[case]["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["per_level"].numpy(),
                                   one["per_level"].numpy(), rtol=LOSS_RTOL)
        for k, v in r["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k
    for a, b in zip(ranks[0]["confmats"], one["confmats"]):
        assert int(a.sum()) == int(b.sum())
        assert int((a - b).abs().sum()) <= 4  # near-tied pixels
    _check_grads(ranks[0]["grads"], one["grads"], donor, GRAD_REL)

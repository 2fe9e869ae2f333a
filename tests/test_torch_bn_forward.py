"""Kernel 2's train entry (``ops/fused_bn_act.py:bn_act_forward``, one launch
on the card for a train-mode BatchNorm's forward after its statistics) on
the CPU, where its plain version ``_bn_act_forward_ref`` runs:

- against the JAX ``fused_bn_act`` forward (the Pallas kernel in interpret
  mode) on the JAX statistics, and its running update against
  ``LeanBatchNorm``'s, at one rank and over a group of two halves of the
  batch whose f64 sums are added (each half's rank moves its own copy of
  the buffers), act "none" and "relu", C in {18, 48, 270};
- ``BatchNormAct`` trained two steps and then in eval mode against the JAX
  module (the folded eval coefficients must see the moved buffers: the
  train entry writes them without autograd and bumps their versions);
- the wrapper's contract: the statistics or the sums, the train acts only,
  the buffers' versions moved once, the CPU counting no launch.

Tolerances: y within 1e-5 of its largest value (the statistics are summed
in another order); the statistics and running buffers 1e-6 relative plus
1e-7 (as ``test_torch_bn_train.py`` holds the running statistics).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.norm import (
    LeanBatchNorm,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
    BatchNormAct,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    fused_bn_act as tfba,
)
from torch_port_common import (
    jax_variables,
    load_port,
    nhwc_to_torch,
    torch_to_nhwc,
)

jfba = importlib.import_module(
    "restrictive_hierarchical_semantic_segmentation_tpu.ops.fused_bn_act")

EPS = 1e-5
M = 0.9


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 9, 11, c)) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.5, c).astype(np.float32)
    running = (rng.normal(0, 0.1, c).astype(np.float32),
               rng.uniform(0.5, 1.5, c).astype(np.float32))
    return x, gamma, beta, running


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("route", ["rank", "group"])
@pytest.mark.parametrize("c", [18, 48, 270])
def test_plain_train_entry_matches_jax(c, route, act):
    x, gamma, beta, (rm0, rv0) = _inputs(c, c)
    jm, jv = jfba.bn_stats(jnp.asarray(x))
    jy = jfba.fused_bn_act(jnp.asarray(x), jm, jv, jnp.asarray(gamma),
                           jnp.asarray(beta), EPS, act)
    lean = LeanBatchNorm(use_running_average=False)
    _, jstats = lean.apply(
        {"params": {"scale": gamma, "bias": beta},
         "batch_stats": {"mean": rm0, "var": rv0}},
        jnp.asarray(x), mutable=["batch_stats"])
    jstats = jstats["batch_stats"]
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    if route == "rank":
        parts = [torch.from_numpy(x)]
        mean, var = tfba.bn_stats(parts[0])
        stats = [dict(mean=mean, var=var)]
    else:  # two ranks, each with half of the images
        parts = [torch.from_numpy(x[:1]), torch.from_numpy(x[1:])]
        sums = sum(tfba.bn_stats_sums(p) for p in parts)
        assert float(sums[-1]) == x.size // c
        stats = [dict(sums=sums)] * 2
    before = dict(tfba.TRAIN_LAUNCHES)
    ys = []
    for part, kw in zip(parts, stats):
        rm, rv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
        versions = (rm._version, rv._version)
        y, mean, var, rstd, scale, shift = tfba.bn_act_forward(
            part, tg, tb, EPS, act, running=(rm, rv, M), **kw)
        assert (rm._version, rv._version) == tuple(v + 1 for v in versions)
        ys.append(y)
        _close(mean.numpy(), jm, rel=1e-6)
        _close(var.numpy(), jv, rel=1e-6)
        assert torch.equal(rstd, torch.rsqrt(var + EPS))
        assert torch.equal(scale, tg * rstd)
        assert torch.equal(shift, tb - mean * tg * rstd)
        for ours, theirs in ((rm, jstats["mean"]), (rv, jstats["var"])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-6, atol=1e-7)
    assert tfba.TRAIN_LAUNCHES == before  # the CPU counts no launch
    _close(torch.cat(ys).numpy(), jy)


def test_plain_train_entry_is_the_composition_it_replaces():
    """Without ``running`` the buffers are not touched; y, rstd, scale and
    shift are the forward composition of earlier slices, op for op."""
    x, gamma, beta, _ = _inputs(36, 5)
    tx, tg, tb = map(torch.from_numpy, (x, gamma, beta))
    mean, var = tfba.bn_stats(tx)
    y, m, v, rstd, scale, shift = tfba.bn_act_forward(tx, tg, tb, EPS,
                                                      "relu", mean, var)
    assert m is mean and v is var
    want_rstd = torch.rsqrt(var + EPS)
    want_scale = tg * want_rstd
    want_shift = tb - mean * tg * want_rstd
    assert torch.equal(rstd, want_rstd)
    assert torch.equal(scale, want_scale)
    assert torch.equal(shift, want_shift)
    assert torch.equal(y, tfba.fused_scale_bias_act(tx, want_scale,
                                                    want_shift, "relu"))


def test_train_entry_refuses_what_it_does_not_take():
    x = torch.ones(4, 8)
    one = torch.ones(8)
    with pytest.raises(ValueError, match="leaky_relu"):
        tfba.bn_act_forward(x, one, one, EPS, "leaky_relu", one, one)
    with pytest.raises(ValueError, match="mean and var, or sums"):
        tfba.bn_act_forward(x, one, one, EPS, "relu")
    with pytest.raises(ValueError, match="mean and var, or sums"):
        tfba.bn_act_forward(x, one, one, EPS, "relu", one, one,
                            sums=torch.ones(17, dtype=torch.float64))


@pytest.mark.parametrize("act", ["none", "relu"])
def test_batchnorm_trained_then_evaluated_matches_jax(act):
    """Eval, two train steps, eval: the last eval forward uses the running
    statistics the two steps moved (the JAX module's), not the folded
    coefficients cached by the first eval forward."""
    c = 18
    rng = np.random.default_rng(4)
    xs = [(rng.standard_normal((3, 7, 5, c)) * 2 + 0.4).astype(np.float32)
          for _ in range(3)]
    train = LeanBatchNorm(use_running_average=False)
    params, stats = jax_variables(train, xs[0])
    bn = load_port(BatchNormAct(c, act), params, stats)
    with torch.no_grad():
        bn(nhwc_to_torch(xs[0]))  # folds (a, b) from the loaded buffers
        bn.train()
        for x in xs[:2]:
            bn(nhwc_to_torch(x))
            _, upd = train.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), mutable=["batch_stats"])
            stats = upd["batch_stats"]
        got = torch_to_nhwc(bn.eval()(nhwc_to_torch(xs[2])))
    want = LeanBatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(xs[2]))
    if act == "relu":
        want = jnp.maximum(want, 0.0)
    _close(got, want)

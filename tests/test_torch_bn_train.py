"""Train-mode BatchNorm of the port against the JAX package's, on the CPU:
the batch statistics (the plain version of the ``bn_stats`` kernel against
the Pallas ``bn_stats``, interpret mode), the ``fused_bn_act`` autograd
Function against ``jax.grad`` through the JAX custom VJP, a float64
``gradcheck`` of the plain backward, train-mode ``BatchNormAct`` against
``LeanBatchNorm`` and ``PallasBatchNormAct``, and a whole train step's f32
gradients against the same step in float64.

Tolerances: statistics 1e-5 relative (f32 sums in another order; the
Pallas kernel pads to its row tile with zeros); outputs and gradients 1e-5
of the tensor's largest value in f32, one bf16 ulp in bf16; running
statistics 1e-6 relative + 1e-7.
"""
import ctypes
import importlib
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.norm import (
    LeanBatchNorm,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.pallas_bn import (
    PallasBatchNormAct,
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

# the JAX ops package re-exports a function named fused_bn_act over the
# module's attribute: take the module itself
jfba = importlib.import_module(
    "restrictive_hierarchical_semantic_segmentation_tpu.ops.fused_bn_act")


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (err,
                                                         np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2050, 48), (3, 500, 720), (1, 8),
                                   (2, 7, 9, 64), (20000, 720), (4099, 8)],
                         ids=["ragged_tiles", "multi_tile_720", "one_row",
                              "nhwc", "three_column_groups_720",
                              "narrow_many_rows"])
def test_bn_stats_matches_pallas(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    jm, jv = jfba.bn_stats(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = dict(tfba.TRAIN_LAUNCHES)
    tm, tv = tfba.bn_stats(tx)
    assert tfba.TRAIN_LAUNCHES == before  # the CPU counts no launch
    assert tm.dtype == tv.dtype == torch.float32
    assert tm.shape == tv.shape == (shape[-1],)
    _close(tm.numpy(), jm)
    _close(tv.numpy(), jv)
    assert (tv.numpy() >= 0).all()


def _fba_inputs(c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 9, 11, c)) * 2 + 0.5).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 0.5, c).astype(np.float32)
    return x, ct, gamma, beta


@pytest.mark.parametrize("act", ["relu", "none"])
def test_fused_bn_act_function_matches_jax_vjp(act):
    x, ct, gamma, beta = _fba_inputs(24, 0)

    def jloss(xx, g, b):
        y, _, _ = jfba.batch_norm_act(xx, g, b, 1e-5, act)
        return jnp.sum(y * ct), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y, mean, var = tfba.batch_norm_act(tx, tg, tb, 1e-5, act)
    assert not mean.requires_grad and not var.requires_grad
    (y * torch.from_numpy(ct)).sum().backward()
    _close(y.detach().numpy(), jy)
    for got, want in zip((tx.grad, tg.grad, tb.grad), jgrads):
        _close(got.numpy(), want)


def test_fused_bn_act_bf16_saves_only_x_and_vectors():
    """bf16 activations: y and dx stay bf16, the per-channel gradients f32,
    and the Function keeps x and (C,) vectors only (no y)."""
    x, ct, gamma, beta = _fba_inputs(16, 1)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y, _, _ = tfba.batch_norm_act(tx, tg, tb, 1e-5, "relu")
    assert y.dtype == torch.bfloat16
    saved = y.grad_fn.saved_tensors
    assert sum(t.numel() for t in saved) == x.size + 4 * 16
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert tx.grad.dtype == torch.bfloat16
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    # against the f32 computation on the same bf16-rounded input and
    # cotangent (y is bf16, so the gradient reaching the Function is too)
    xr = tx.detach().float().numpy()
    ctr = torch.from_numpy(ct).bfloat16().float().numpy()

    def jloss(xx, g, b):
        return jnp.sum(jfba.batch_norm_act(xx, g, b, 1e-5, "relu")[0] * ctr)

    jgx, jgg, jgb = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(xr), jnp.asarray(gamma), jnp.asarray(beta))
    _close(tg.grad.numpy(), jgg, rel=1e-5)
    _close(tb.grad.numpy(), jgb, rel=1e-5)
    err = np.abs(tx.grad.float().numpy() - np.asarray(jgx))
    assert (err <= np.abs(np.asarray(jgx)) * 2.0 ** -8 + 1e-6).all()


@pytest.mark.parametrize("act", ["relu", "none"])
def test_plain_backward_gradcheck_float64(act):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((37, 16)) * 2 + 0.3)
    x.requires_grad_()
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 16)).requires_grad_()
    beta = torch.from_numpy(rng.normal(0, 0.5, 16)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, g, b: tfba.batch_norm_act(a, g, b, 1e-5, act)[0],
        (x, gamma, beta))


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("flavour", ["lean", "pallas"])
def test_train_mode_batchnorm_matches_jax(flavour, act):
    c = 24
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 7, 5, c)) * 2 + 0.4).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    if flavour == "lean":
        jm = LeanBatchNorm(use_running_average=False)
    else:
        jm = PallasBatchNormAct(use_running_average=False, act=act)
    params, stats = jax_variables(jm, x)

    def jloss(p, xx):
        y, upd = jm.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        if flavour == "lean" and act == "relu":
            y = jax.nn.relu(y)
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = load_port(BatchNormAct(c, act), params, stats).train()
    tx = nhwc_to_torch(x).clone().requires_grad_()
    y = bn(tx)
    (y * nhwc_to_torch(ct)).sum().backward()
    _close(torch_to_nhwc(y), jy)
    _close(torch_to_nhwc(tx.grad), jgx)
    _close(bn.weight.grad.numpy(), jgp["scale"])
    _close(bn.bias.grad.numpy(), jgp["bias"])
    for ours, theirs in ((bn.running_mean, jstats["mean"]),
                         (bn.running_var, jstats["var"])):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-7)


def test_train_mode_rejects_leaky_relu():
    # the JAX backward treats every act but relu as the identity, which is
    # wrong for leaky_relu: the port refuses it in train mode
    bn = BatchNormAct(8, "leaky_relu").train()
    x = torch.randn(2, 8, 3, 3)
    with pytest.raises(ValueError, match="leaky_relu"):
        bn(x)
    with pytest.raises(ValueError, match="leaky_relu"):
        tfba.fused_bn_act(x, torch.zeros(8), torch.ones(8), torch.ones(8),
                          torch.zeros(8), 1e-5, "leaky_relu")
    bn.eval()(x)  # eval mode takes it


def test_step_gradients_against_float64():
    """A whole tiny-HRNet train step on the synthetic batch: the port's f32
    gradients within 1e-4 of each tensor's largest from the same step in
    float64 (plus 1e-7 for gradients that are 0 in exact arithmetic).
    (The JAX default BatchNorm's f32 gradients of this step are further
    off; ``torch_train_common.py`` has the numbers.)"""
    from torch_train_common import LEVEL_WEIGHTS, Pair

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )

    pair = Pair()
    sd = {k: v.clone() for k, v in pair.pm.state_dict().items()}
    x, y = torch.from_numpy(pair.x), torch.from_numpy(pair.y)
    g32, loss32, _, _ = pair.pstep.micro_grads(x, y, torch.ones(2))
    m64 = pair.pm.double()
    m64.load_state_dict({k: v.double() for k, v in sd.items()})
    step64 = make_train_step(m64, pair.ptree, True,
                             level_weights=LEVEL_WEIGHTS)
    g64, loss64, _, _ = step64.micro_grads(x.double(), y, torch.ones(2))
    assert loss64.dtype == torch.float64
    np.testing.assert_allclose(loss32.item(), loss64.item(), rtol=1e-6)
    for n, g in g64.items():
        scale = g.abs().max().item()
        err = (g32[n].double() - g).abs().max().item()
        assert err <= 1e-4 * scale + 1e-7, (n, err, scale)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_bn_backward_is_one_counted_entry(act):
    """The BN backward is one C entry (one launch per call on the card) with
    dx optional, counted under one name (the split entries of a
    data-parallel group, reduce and dx, under their own); on the CPU the
    plain version runs, counts nothing, and gives the same dgamma, dbeta
    with or without dx."""
    assert set(tfba.TRAIN_LAUNCHES) == {"bn_stats", "bn_backward",
                                        "bn_stats_sums", "bn_backward_reduce",
                                        "bn_backward_dx", "bn_act_forward"}
    bwd = [k for k in tfba._SIGNATURES if k[0] == "bn_backward"]
    assert bwd == [("bn_backward", "rhss_bn_backward"),
                   ("bn_backward", "rhss_bn_backward_reduce"),
                   ("bn_backward", "rhss_bn_backward_dx")]
    # x, g, rows, C, dtype, act, 4 vectors, workspace, edz, eydz, dx, stream
    assert len(tfba._SIGNATURES[bwd[0]]) == 15
    # the reduce entry: ... workspace, ticket counters, edz, eydz, sums,
    # stream; the dx entry: x, g, rows, C, dtype, act, 4 vectors, sums, dx,
    # stream
    assert len(tfba._SIGNATURES[bwd[1]]) == 16
    assert len(tfba._SIGNATURES[bwd[2]]) == 13
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((37, 24)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((37, 24)).astype(np.float32))
    mean, var = tfba.bn_stats(x)
    rstd = torch.rsqrt(var + 1e-5)
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32))
    scale, shift = gamma * rstd, 0.1 - mean * gamma * rstd
    before = dict(tfba.TRAIN_LAUNCHES)
    dx, dg, db = tfba.bn_act_backward(x, g, scale, shift, mean, rstd, act)
    none, dg2, db2 = tfba.bn_act_backward(x, g, scale, shift, mean, rstd,
                                          act, need_dx=False)
    assert tfba.TRAIN_LAUNCHES == before
    assert none is None and dx.shape == x.shape
    assert torch.equal(dg, dg2) and torch.equal(db, db2)



_CSRC = pathlib.Path(tfba.__file__).resolve().parents[1] / "csrc"


def _constant(source: str, name: str) -> int:
    """``constexpr int <name> = <int>;`` of a CUDA source of the port."""
    text = (_CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (source, name, found)
    return int(found[0])


def test_stats_layout_follows_the_cuda_sources():
    """The statistics wrappers size the workspace and the per-stream ticket
    counters the CUDA sources index: ``_STATS_CLUSTERS``, ``_MAX_STRIPS``,
    ``_STATS_GROUPS`` are the sources' ``kMaxClusters``, ``kTargetBlocks``,
    ``kMaxGroups``; a stream's slot ends with ``kFoldCounter``; the
    workspace holds ``(4 * kMaxClusters + 4) * lcm(C, 8)`` floats (two f64
    sums a cluster and column, then two a column), as the C entries' note
    says; the geometry query returns 8 numbers and the clusters of
    ``kCluster`` = 8 blocks the card holds at once."""
    clusters = _constant("bn_stats.cu", "kMaxClusters")
    strips = _constant("bn_reduce.cuh", "kTargetBlocks")
    groups = _constant("bn_reduce.cuh", "kMaxGroups")
    assert (tfba._STATS_CLUSTERS, tfba._MAX_STRIPS, tfba._STATS_GROUPS) == \
        (clusters, strips, groups)
    fold = re.findall(r"constexpr int kFoldCounter = (.+);",
                      (_CSRC / "bn_reduce.cuh").read_text())
    assert fold == ["kMaxGroups * (1 + (kTargetBlocks + 15) / 16)"]
    assert tfba._COUNTERS_PER_STREAM == groups * (1 + (strips + 15) // 16) + 1
    assert tfba._GROUP_COUNTERS == 1 + (strips + 15) // 16
    note = (_CSRC / "bn_stats.cu").read_text()
    assert f"workspace: (4 * {clusters} + 4) * L floats" in note
    for c in (8, 18, 48, 270, 720):
        ws = tfba._stats_workspace(torch.empty(0), c)
        assert ws.dtype == torch.float32
        assert ws.numel() == (4 * clusters + 4) * (c * 8 // math.gcd(c, 8))
    assert _constant("bn_stats.cu", "kCluster") == 8
    assert len(tfba._GEOMETRY_KEYS) == 9
    assert tfba._SIGNATURES[("bn_stats", "rhss_bn_stats_geometry")] == [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with pytest.raises(ValueError, match="on a card"):
        tfba.stats_geometry(torch.ones(4, 8))


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("c,split", [(24, 91), (48, 100)])
def test_split_plain_versions_over_two_halves_match_jax_bwd(act, c, split):
    """The split backward of a group of two ranks on the CPU: the reduce
    entry's plain version on each half of a seeded batch, the halves' f64
    sums added, then the dx entry's plain version on each half, against the
    JAX custom VJP's backward (``_fba_bwd``, Pallas in interpret mode) on
    the whole batch: dx within 1e-5 of its largest value, dgamma and dbeta
    (the halves' added) likewise."""
    x, ct, gamma, beta = _fba_inputs(c, 11)
    x, ct = x.reshape(-1, c), ct.reshape(-1, c)
    mean, var = (x.mean(0), x.var(0))
    jdx, _, _, jdg, jdb = jfba._fba_bwd(
        1e-5, act, tuple(map(jnp.asarray, (x, mean, var, gamma, beta))),
        jnp.asarray(ct))
    tmean, tvar = torch.from_numpy(mean), torch.from_numpy(var)
    rstd = torch.rsqrt(tvar + 1e-5)
    scale = torch.from_numpy(gamma) * rstd
    shift = torch.from_numpy(beta) - tmean * scale
    vecs = (scale, shift, tmean, rstd)
    halves = [(torch.from_numpy(x[a:b]), torch.from_numpy(ct[a:b]))
              for a, b in ((0, split), (split, len(x)))]
    before = dict(tfba.TRAIN_LAUNCHES)
    parts = [tfba.bn_backward_reduce(xx, gg, *vecs, act) for xx, gg in halves]
    sums = parts[0][2] + parts[1][2]
    assert sums.dtype == torch.float64 and float(sums[-1]) == len(x)
    dx = torch.cat([tfba.bn_backward_dx(xx, gg, *vecs, sums, act)
                    for xx, gg in halves])
    assert tfba.TRAIN_LAUNCHES == before  # the CPU counts no launch
    _close(dx.numpy(), np.asarray(jdx).reshape(-1, c))
    _close((parts[0][0] + parts[1][0]).numpy(), jdg)
    _close((parts[0][1] + parts[1][1]).numpy(), jdb)

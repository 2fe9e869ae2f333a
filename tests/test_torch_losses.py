"""The port's losses against the JAX package's, on the CPU, in f32: the
masked cross-entropy (with the empty-class 1.0 rule), the masked soft Dice
(zero-union items dropped), ``ohem_select``, the consistency loss on the
default, extended and wide trees (the wide tree takes the JAX package's
one-hot path above ``GROUP_UNROLL_LIMIT`` parents), the KL stabiliser,
``hierarchical_loss`` with level weights, ``level_mask``, ``lambda_kl`` and
OHEM, and the gradients of each with respect to the logits, through the
gated grouped softmax too.

Tolerances: values 1e-5 relative (f32 sums in another order); gradients
1e-5 of the tensor's largest |g| plus 1e-9 (a softmax over a group of one
child has a gradient of 0 in exact arithmetic, which either side may
compute as rounding noise), except 5e-5 for the gradient with respect to
the parent probabilities on the wide tree: it carries ``1 / (p + eps)``
for p down to 1e-3, and the JAX package's one-hot contractions round
otherwise (there the port is 1.3e-5 and JAX 5.8e-6 from a float64 run);
the OHEM masks are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.hierarchy.tree import (
    ClassTree as JaxTree,
)
from restrictive_hierarchical_semantic_segmentation_tpu.losses import (
    hierarchical as jloss,
)
from restrictive_hierarchical_semantic_segmentation_tpu.ops import (
    restrictive as jrestrictive,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.target_factory import (
    node_masks,
    ternary_encode,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
    ClassTree as PortTree,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.losses import (
    hierarchical as tloss,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    restrictive as trestrictive,
)
from torch_port_common import trees, wide_tree_dict

LEVEL_WEIGHTS = [[0.0297, 1.577, 0.9619, 0.1770],
                 [1.5432, 0.2638, 1.0413, 3.9722]]


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rel * np.abs(want).max(initial=0.0) + 1e-9, (
        err, np.abs(want).max(initial=0.0))


def _trees(name):
    if name == "wide":
        tree, cmap = wide_tree_dict()
        return JaxTree.from_dict(tree, cmap), PortTree.from_dict(tree, cmap)
    return trees(name)


def _targets(tree, rng, b=2, h=9, w=10):
    """Ternary targets (B, H, W, C_total) from random pixel-coded masks."""
    codes = np.array([v for v in tree.pixel_value.values() if v is not None],
                     np.uint8)
    masks = rng.choice(codes, size=(b, h, w))
    return np.stack([ternary_encode(node_masks(m, tree), tree)
                     for m in masks]).astype(np.float32)


def _grad(fn, *arrays):
    """``(value, grads)`` of a scalar torch function of numpy arrays."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 6, 7, 4)).astype(np.float32) * 2
    t = rng.integers(-1, 2, logits.shape).astype(np.float32)
    # item 1: class 2 has no valid pixel -> the item scores 1.0
    t[1, ..., 2] = -1.0
    w = np.asarray(LEVEL_WEIGHTS[1], np.float32) if weighted else None
    want, jg = jax.value_and_grad(
        lambda z: jloss.masked_cross_entropy(z, jnp.asarray(t), w))(
        jnp.asarray(logits))
    got, (tg,) = _grad(
        lambda z: tloss.masked_cross_entropy(z, torch.from_numpy(t), w),
        logits)
    _close(got, want)
    _close(tg, jg)
    assert not tg[1].any()  # the 1.0 of an empty-class item is a constant
    # every item empty: the loss is exactly 1
    empty = np.full_like(t, -1.0)
    assert tloss.masked_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(empty)).item() == 1.0


def test_masked_soft_dice_matches_jax_and_drops_zero_union_items():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 5, 6, 4)).astype(np.float32)
    t = rng.integers(-1, 2, logits.shape).astype(np.float32)
    w = np.asarray(LEVEL_WEIGHTS[0], np.float32)
    jsum, jcnt = jloss.masked_soft_dice(jnp.asarray(logits), jnp.asarray(t), w)
    tsum, tcnt = tloss.masked_soft_dice(torch.from_numpy(logits),
                                        torch.from_numpy(t), w)
    _close(tsum.numpy(), jsum)
    assert tcnt.item() == float(jcnt) == 3.0
    jg = jax.grad(lambda z: jloss.masked_soft_dice(z, jnp.asarray(t), w)[0])(
        jnp.asarray(logits))
    _, (tg,) = _grad(lambda z: tloss.masked_soft_dice(
        z, torch.from_numpy(t), w)[0], logits)
    _close(tg, jg)
    # item 2 fully masked: union 0, dropped from the sum and the count; the
    # port's gradient stays finite (0 for the dropped item)
    t[2] = -1.0
    jsum, jcnt = jloss.masked_soft_dice(jnp.asarray(logits), jnp.asarray(t), w)
    val, (tg,) = _grad(lambda z: tloss.masked_soft_dice(
        z, torch.from_numpy(t), w)[0], logits)
    tcnt = tloss.masked_soft_dice(torch.from_numpy(logits),
                                  torch.from_numpy(t), w)[1]
    _close(val, jsum)
    assert tcnt.item() == float(jcnt) == 2.0
    assert np.isfinite(tg).all() and not tg[2].any()


@pytest.mark.parametrize("thres,min_kept", [(0.3, 40), (0.9, 40),
                                            (0.5, 10 ** 6)])
def test_ohem_select_matches_jax(thres, min_kept):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 8, 9, 4)).astype(np.float32) * 2
    t = np.zeros(logits.shape, np.float32)
    cls = rng.integers(0, 4, logits.shape[:-1])
    np.put_along_axis(t, cls[..., None], 1.0, axis=-1)
    t[0, :2] = -1.0  # rows without a positive class are never kept
    want = np.asarray(jloss.ohem_select(jnp.asarray(logits), jnp.asarray(t),
                                        thres, min_kept))
    got = tloss.ohem_select(torch.from_numpy(logits), torch.from_numpy(t),
                            thres, min_kept).numpy()
    assert got.dtype == bool and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert not got[0, :2].any()


def _level_inputs(jt, rng, b=2, h=6, w=7):
    return [rng.standard_normal((b, h, w, c)).astype(np.float32) * 2
            for c in jt.classes_per_level]


def _compose(mod, z, tree, sigmoid):
    """Probabilities and conditionals per level, as the model composes
    them, in either framework."""
    probs = [sigmoid(z[0])]
    qs = [None]
    for L in range(1, tree.num_levels):
        q, pc = mod.gated_grouped_softmax(z[L], probs[L - 1],
                                          tree.parent_index[L],
                                          tree.child_to_parent[L])
        probs.append(pc)
        qs.append(q)
    return probs, qs


@pytest.mark.parametrize("name", ["default", "extended", "wide"])
def test_gated_grouped_softmax_gradients_match_jax(name):
    jt, _ = _trees(name)
    rng = np.random.default_rng(3)
    for L in range(1, jt.num_levels):
        cp, cc = jt.classes_per_level[L - 1], jt.classes_per_level[L]
        z = rng.standard_normal((2, 5, 6, cc)).astype(np.float32) * 3
        p = rng.uniform(0.0, 1.0, (2, 5, 6, cp)).astype(np.float32)
        cq = rng.standard_normal(z.shape).astype(np.float32)
        cpc = rng.standard_normal(z.shape).astype(np.float32)
        args = (jt.parent_index[L], jt.child_to_parent[L])

        def jf(zz, pp):
            q, pc = jrestrictive.gated_grouped_softmax(zz, pp, *args)
            return jnp.sum(q * cq) + jnp.sum(pc * cpc)

        def tf(zz, pp):
            q, pc = trestrictive.gated_grouped_softmax(zz, pp, *args)
            return (q * torch.from_numpy(cq)).sum() \
                + (pc * torch.from_numpy(cpc)).sum()

        want, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(z),
                                                          jnp.asarray(p))
        got, (tgz, tgp) = _grad(tf, z, p)
        _close(got, want)
        _close(tgz, jg[0])
        _close(tgp, jg[1], 5e-5 if name == "wide" else 1e-5)


@pytest.mark.parametrize("name", ["default", "extended", "wide"])
def test_consistency_loss_matches_jax(name):
    jt, pt = _trees(name)
    rng = np.random.default_rng(4)
    probs = [rng.uniform(0, 1, (2, 5, 6, c)).astype(np.float32)
             for c in jt.classes_per_level]
    if name == "wide":  # the JAX package's one-hot path
        wide = len(jt.parents_with_children[1])
        assert wide > jrestrictive.GROUP_UNROLL_LIMIT
    want, jg = jax.value_and_grad(
        lambda ps: jloss.consistency_loss(ps, jt))([jnp.asarray(p)
                                                     for p in probs])
    got, tg = _grad(lambda *ps: tloss.consistency_loss(ps, pt), *probs)
    _close(got, want)
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("name", ["default", "wide"])
def test_grouped_conditional_kl_matches_jax(name):
    jt, _ = _trees(name)
    rng = np.random.default_rng(5)
    c = jt.classes_per_level[1]
    q = rng.uniform(0, 1, (2, 5, 6, c)).astype(np.float32)
    q[0, 0, 0, 0] = 0.0  # clipped to 1e-8 on both sides
    a = jt.child_to_parent[1]
    want, jg = jax.value_and_grad(
        lambda qq: jrestrictive.grouped_conditional_kl(qq, a))(jnp.asarray(q))
    got, (tg,) = _grad(lambda qq: trestrictive.grouped_conditional_kl(qq, a),
                       q)
    _close(got, want)
    _close(tg, jg)


@pytest.mark.parametrize("name,weights,mask,lambda_kl,ohem", [
    ("default", LEVEL_WEIGHTS, None, 0.0, None),
    ("default", LEVEL_WEIGHTS, (1.0, 0.0), 0.1, None),
    ("default", None, (0.0, 1.0), 0.0, (0.7, 30)),
    ("extended", None, None, 0.1, None),
    ("wide", None, (1.0, 1.0), 0.1, (0.9, 50)),
], ids=["default", "mask10_kl", "mask01_ohem", "extended_kl", "wide"])
def test_hierarchical_loss_matches_jax(name, weights, mask, lambda_kl, ohem):
    """The total and per-level losses of logits composed as the model
    composes them, and the gradients with respect to every level's logits
    (through the sigmoid and the gated grouped softmax)."""
    jt, pt = _trees(name)
    rng = np.random.default_rng(6)
    z = _level_inputs(jt, rng)
    tgt = _targets(pt, rng, h=6, w=7)
    jtg = jt.split_levels(jnp.asarray(tgt), axis=-1)
    ttg = pt.split_levels(torch.from_numpy(tgt), axis=-1)
    kw = dict(level_weights=weights, level_mask=mask, lambda_cons=1.0,
              lambda_kl=lambda_kl, ohem=ohem)

    def jf(zs):
        probs, qs = _compose(jrestrictive, zs, jt, jax.nn.sigmoid)
        return jloss.hierarchical_loss(zs, jtg, probs_per_level=probs,
                                       q_per_level=qs, tree=jt, **kw)

    def tf(*zs):
        probs, qs = _compose(trestrictive, zs, pt, torch.sigmoid)
        return tloss.hierarchical_loss(zs, ttg, probs_per_level=probs,
                                       q_per_level=qs, tree=pt, **kw)

    jz = [jnp.asarray(a) for a in z]
    (jtotal, jper), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jz)
    ts = [torch.from_numpy(a).requires_grad_() for a in z]
    total, per_level = tf(*ts)
    total.backward()
    _close(total.detach().numpy(), jtotal)
    _close(per_level.detach().numpy(), jper)
    assert per_level.shape == (jt.num_levels,)
    for t, g in zip(ts, jg):
        _close(t.grad.numpy(), g)

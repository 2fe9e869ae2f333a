"""The port's metrics against the JAX package's, on the CPU: the first-max
one-hots of ``level_onehots``, ``classmaps_from_outputs`` and the
confusion matrices of ``level_confusion_matrices`` (summed and per image),
fed the same scores and targets, on the default, extended and wide trees;
then ``metrics_from_confusion`` and ``MetricAccumulator`` on the same
matrices.

The scores are drawn from a few values so that ties are frequent (the
first maximum wins), the targets hold multi-hot pixels (the first positive
channel wins), pixels masked on some channels and pixels masked on every
channel. Everything is compared for equality: the one-hots and counts are
exact on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.hierarchy.tree import (
    ClassTree as JaxTree,
)
from restrictive_hierarchical_semantic_segmentation_tpu.metrics import (
    segmentation as jmet,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
    ClassTree as PortTree,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.metrics import (
    segmentation as tmet,
)
from torch_port_common import trees, wide_tree_dict


def _trees(name):
    if name == "wide":
        tree, cmap = wide_tree_dict()
        return JaxTree.from_dict(tree, cmap), PortTree.from_dict(tree, cmap)
    return trees(name)


def _inputs(tree, seed, b=3, h=7, w=9):
    """Per-level scores with many ties, and ternary-like targets with
    multi-hot, partly masked and fully masked pixels."""
    rng = np.random.default_rng(seed)
    scores, targets = [], []
    for L, c in enumerate(tree.classes_per_level):
        scores.append(rng.integers(0, 3, (b, h, w, c)).astype(np.float32))
        t = np.zeros((b, h, w, c), np.float32)
        cls = rng.integers(0, c, (b, h, w))
        np.put_along_axis(t, cls[..., None], 1.0, axis=-1)
        t[rng.uniform(size=t.shape) < 0.1] = 1.0      # multi-hot pixels
        if L:
            t[rng.uniform(size=t.shape) < 0.2] = -1.0  # masked channels
            t[0, 0] = -1.0                             # fully masked row
            t[1, :, 0] = 0.0                           # no positive class
        scores[-1][2, 1, :3] = 1.0                     # all channels tie
        targets.append(t)
    return scores, targets


@pytest.mark.parametrize("name", ["default", "extended", "wide"])
@pytest.mark.parametrize("per_image", [False, True])
def test_confusion_matrices_equal_jax(name, per_image):
    jt, _ = _trees(name)
    scores, targets = _inputs(jt, seed=len(name) + per_image)
    want = jmet.level_confusion_matrices(
        [jnp.asarray(s) for s in scores], [jnp.asarray(t) for t in targets],
        per_image=per_image)
    got = tmet.level_confusion_matrices(
        [torch.from_numpy(s) for s in scores],
        [torch.from_numpy(t) for t in targets], per_image=per_image)
    assert len(got) == len(want) == jt.num_levels
    for L, (g, w) in enumerate(zip(got, want)):
        c = jt.classes_per_level[L] + (L > 0)
        b = scores[L].shape[0]
        assert g.dtype == torch.int64
        assert g.shape == ((b, c, c) if per_image else (c, c))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if per_image:  # the per-image matrices add up to the batch's
        summed = tmet.level_confusion_matrices(
            [torch.from_numpy(s) for s in scores],
            [torch.from_numpy(t) for t in targets])
        for g, s in zip(got, summed):
            assert torch.equal(g.sum(0), s)


@pytest.mark.parametrize("name", ["default", "wide"])
def test_onehots_and_classmaps_equal_jax(name):
    jt, _ = _trees(name)
    scores, targets = _inputs(jt, seed=7)
    jargs = ([jnp.asarray(s) for s in scores],
             [jnp.asarray(t) for t in targets])
    targs = ([torch.from_numpy(s) for s in scores],
             [torch.from_numpy(t) for t in targets])
    for got, want in zip(tmet.level_onehots(*targs),
                         jmet.level_onehots(*jargs)):
        p, t, valid, c, child = got
        assert (c, child) == (want[3], want[4])
        for a, b in zip((p, t, valid), want[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # exact one-hot rows
        assert (p.sum(-1) == 1).all() and (t.sum(-1) == 1).all()
    for got, want in zip(tmet.classmaps_from_outputs(*targs),
                         jmet.classmaps_from_outputs(*jargs)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2:] == want[2:]


def test_first_max_breaks_ties_to_the_first_channel():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                      [0.0, 0.0, 0.0, 5.0]])
    want = torch.tensor([[0.0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1]])
    assert torch.equal(tmet._first_max_onehot(x), want)


@pytest.mark.parametrize("child", [False, True])
def test_metrics_from_confusion_equal_jax(child):
    rng = np.random.default_rng(8)
    cm = rng.integers(0, 50, (5, 5))
    cm[3] = 0  # a class with no support: its recall is 0, not NaN
    got = tmet.metrics_from_confusion(cm, child)
    want = jmet.metrics_from_confusion(cm, child)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.isfinite(got[k]).all()
        assert len(got[k]) == 5 - child


def test_metric_accumulator_equals_jax():
    jt, _ = _trees("default")
    jacc = jmet.MetricAccumulator(jt.classes_per_level)
    tacc = tmet.MetricAccumulator(jt.classes_per_level)
    for seed in range(3):
        scores, targets = _inputs(jt, seed=seed)
        mats = tmet.level_confusion_matrices(
            [torch.from_numpy(s) for s in scores],
            [torch.from_numpy(t) for t in targets])
        assert tacc.update([m.numpy() for m in mats]) == jacc.update(
            [m.numpy() for m in mats])
    assert tacc.epoch_overall() == jacc.epoch_overall()
    assert tacc.epoch_per_class() == jacc.epoch_per_class()
    assert tacc.selection_metric() == jacc.selection_metric()
    assert len(tacc.epoch_per_class()) == sum(jt.classes_per_level)

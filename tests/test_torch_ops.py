"""Parity of the PyTorch port's ops with the JAX package's, on the CPU:
the plain version of the scale-bias-act kernel against the Pallas kernel
(interpret mode), the bilinear resize against ``method="gather"``, and the
gated grouped softmax on the default, extended and wide trees."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.hierarchy.tree import (
    ClassTree as JaxTree,
)
from restrictive_hierarchical_semantic_segmentation_tpu.ops import (
    resize as jresize,
    restrictive as jrestrictive,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    fused_bn_act as tfba,
    resize as tresize,
    restrictive as trestrictive,
)
from torch_port_common import trees, wide_tree_dict

# the JAX ops package re-exports a function named fused_bn_act over the
# module's attribute: take the module itself
jfba = importlib.import_module(
    "restrictive_hierarchical_semantic_segmentation_tpu.ops.fused_bn_act")


def _bf16_ulp(ref):
    return np.abs(ref) * 2.0 ** -7 + 2.0 ** -133


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("c", [48, 720, 18])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_bias_act_plain_matches_pallas(act, c, dtype):
    # 2 * 25 * 41 = 2050 rows: not a multiple of the TPU kernel's row tile
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 25, 41, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    shift = rng.normal(0.0, 0.5, c).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jfba.fused_scale_bias_act(
        jx, jnp.asarray(scale), jnp.asarray(shift), act).astype(jnp.float32))
    got_t = tfba.fused_scale_bias_act(tx, torch.from_numpy(scale),
                                      torch.from_numpy(shift), act)
    assert got_t.dtype == tx.dtype and got_t.shape == tx.shape
    got = got_t.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


def test_scale_bias_act_rejects_bad_arguments():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unknown act"):
        tfba.fused_scale_bias_act(x, torch.ones(8), torch.zeros(8), "gelu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfba.fused_scale_bias_act(x.to("meta"), torch.ones(8),
                                  torch.zeros(8), "relu")


@pytest.mark.parametrize("c,width", [(1, 8), (4, 8), (6, 24), (12, 24),
                                     (18, 72), (36, 72), (270, 1080),
                                     (48, 48), (720, 720), (2047, 16376)])
def test_kernels_view_rows_of_lcm_c_8(c, width):
    """The kernels read (rows, C) as rows of lcm(C, 8) elements; the
    per-channel vectors come tiled to that width (the same tensor where C
    % 8 == 0)."""
    assert tfba._view_width(c) == width
    t = torch.arange(c, dtype=torch.float32)
    tiled = tfba._tiled(t, c)
    assert torch.equal(tiled, t[torch.arange(width) % c])
    assert (tiled is t) == (width == c)
    pair = tfba._tiled(torch.stack([t, -t]), c)
    assert pair.shape == (2, width) and torch.equal(pair[1], -tiled)


def test_layout_checks_take_any_c_up_to_the_limit():
    """Every C up to 2048 passes the checks the kernels and the exported
    operator's fake kernel share (a meta tensor: no data is read), and
    every multiple of 8; beyond, the message names the limit."""
    for c in (1, 3, 18, 270, 2047, 2048, 16384, 20000):
        assert tfba._check_layout(torch.empty(2, c, device="meta"),
                                  "k") == c
    for c in (2049, 4095):
        with pytest.raises(ValueError, match="C <= 2048 otherwise"):
            tfba._check_layout(torch.empty(2, c, device="meta"), "k")


def test_scale_bias_act_cpu_never_counts_launches():
    before = tfba.LAUNCHES
    tfba.fused_scale_bias_act(torch.ones(3, 16), torch.ones(16),
                              torch.zeros(16), "relu")
    assert tfba.LAUNCHES == before


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("src,dst", [((20, 20), (155, 155)),
                                     ((155, 155), (620, 620)),
                                     ((155, 150), (78, 61))])
def test_resize_bilinear_matches_gather(align, src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    x = rng.standard_normal((1,) + src + (3,)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), dst, align,
                                              method="gather"))
    got = tresize.resize_bilinear(torch.from_numpy(x), dst, align).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_upsample2x_align_corners_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 13, 9, 5)) \
        .astype(np.float32)
    want = np.asarray(jresize.upsample2x_align_corners(jnp.asarray(x)))
    got = tresize.upsample2x_align_corners(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 26, 18, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _tree_pair(name):
    if name == "wide":
        tree, cmap = wide_tree_dict()
        return JaxTree.from_dict(tree, cmap)
    return trees(name)[0]


@pytest.mark.parametrize("name", ["default", "extended", "wide"])
def test_gated_grouped_softmax_matches_jax(name):
    tree = _tree_pair(name)
    rng = np.random.default_rng(3)
    for L in range(1, tree.num_levels):
        cp, cc = tree.classes_per_level[L - 1], tree.classes_per_level[L]
        z = rng.standard_normal((2, 6, 7, cc)).astype(np.float32) * 3
        p = rng.uniform(0.0, 1.0, (2, 6, 7, cp)).astype(np.float32)
        p[..., 0] = 0.0  # a parent with zero probability: log(eps)
        args = (tree.parent_index[L], tree.child_to_parent[L])
        jq, jpc = jrestrictive.gated_grouped_softmax(
            jnp.asarray(z), jnp.asarray(p), *args)
        tq, tpc = trestrictive.gated_grouped_softmax(
            torch.from_numpy(z), torch.from_numpy(p), *args)
        for got, want in ((tq, jq), (tpc, jpc)):
            got = got.numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(
            trestrictive.compose_children(torch.from_numpy(z),
                                          torch.from_numpy(p), *args),
            tpc.numpy())


@pytest.mark.parametrize("idx", [[2, 0, 3], [1, 2, 3], [4, 4, 0, 1]])
def test_static_channel_take_matches_jax(idx):
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 5)) \
        .astype(np.float32)
    want = np.asarray(jrestrictive.static_channel_take(jnp.asarray(x), idx))
    got = trestrictive.static_channel_take(torch.from_numpy(x), idx)
    np.testing.assert_array_equal(got.numpy(), want)

"""HRNet at W18's widths, which are no multiples of 8, against the JAX
package on the CPU from bridged weights; and a ``torch.export`` artifact at
such widths.

* HRNet-W18's widths (branches of 18, 36, 72 and 144 channels, the
  270-channel concat head; ``config/hrnet.py:hrnet_w18``) at one module per
  stage (its blocks and widths as published; the JAX step compiles in
  tens of seconds at this depth), the hierarchical segmenter on the
  default tree, 64 px, batch 1, f32: the eval-mode forward at the HRNet
  parity tests' ``RTOL``/``ATOL`` (``torch_port_common.py``), and one train
  step (``torch_train_common.Pair`` against the JAX Pallas-BatchNorm step
  in interpret mode): losses to 1e-5 relative, the gradients to
  ``GRAD_RTOL["default"]`` (5e-2) of each tensor's largest and the head
  conv's bias (ahead of a train-mode BatchNorm: 0 in exact arithmetic) to
  ``ZERO_GRAD_TOL`` of the step's largest gradient. The tiny HRNet's 1e-4
  does not hold here: at batch 1 the lowest branch's BatchNorms normalize
  four values each and the step loses digits in f32 on both sides
  (measured: the JAX step's gradients up to 3.0e-2 of a tensor's largest
  from the port's in float64, the port's own up to 3.3e-3; the two f32
  steps 3.0e-2 apart).
* A tiny-HRNet-shaped model with branches of 6, 12, 18 and 36 channels
  exported through ``train/export.py`` (kernel 2 as the operator
  ``rhss::scale_bias_act``, whose fake kernel takes such widths) and
  loaded: equal to the eager ``Predictor`` at ``test_torch_export.py``'s
  tolerances and to the JAX ``Predictor`` within its ``JAX_ATOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.config import (
    hrnet as jhrnet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config import (
    hrnet as thrnet,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
    build_model as port_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    export as pexport,
)
from test_torch_export import JAX_ATOL, TIE, _check_eager
from torch_port_common import ATOL, RTOL, trees
from torch_serving_common import (
    images,
    jax_predictor,
    port_predictor,
    variables,
)
from torch_train_common import (
    GRAD_RTOL,
    ZERO_GRAD_TOL,
    Pair,
    check_confmats,
    check_losses,
    flat,
)


def w18_cut(mod):
    """``hrnet_w18`` of the config module ``mod`` with one module per stage
    and one block per branch: every width of W18."""
    cfg = mod.hrnet_w18()
    return dataclasses.replace(cfg, **{
        f"stage{i}": dataclasses.replace(
            st, num_modules=1, num_blocks=(1,) * len(st.num_blocks))
        for i, st in enumerate(cfg.stages, start=1)})


def odd_widths(mod):
    """The tiny HRNet's layout with branches of 6, 12, 18 and 36 channels."""
    S = mod.HRNetStage
    return mod.HRNetConfig(
        stage1=S(1, 1, "BOTTLENECK", (1,), (6,)),
        stage2=S(1, 2, "BASIC", (1, 1), (6, 12)),
        stage3=S(1, 3, "BASIC", (1, 1, 1), (6, 12, 18)),
        stage4=S(1, 4, "BASIC", (1, 1, 1, 1), (6, 12, 18, 36)),
    )


@pytest.fixture(scope="module")
def w18():
    """The eval-mode forwards of both sides from the same variables, then
    one train step of each."""
    pair = Pair(oracle="pallas", hrnet=(w18_cut(jhrnet), w18_cut(thrnet)),
                n=1)
    assert pair.pm.backbone.config.last_channels == 270
    variables = {"params": pair.jstate.params,
                 "batch_stats": pair.jstate.batch_stats}
    want = jax.jit(lambda v, x: pair.jm.apply(v, x, train=False))(
        variables, jnp.asarray(pair.x))
    with torch.no_grad():
        got = pair.pm.eval()(torch.from_numpy(pair.x))
    pair.pm.train()
    step = pair.step()
    return pair, (got, want), step


def test_w18_widths_forward_matches_jax(w18):
    _, (got, want), _ = w18
    pairs = [(got.logits_per_level, want.logits_per_level),
             (got.probs_per_level, want.probs_per_level)]
    for gl, wl in pairs:
        assert len(gl) == len(wl) == 2
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_w18_widths_train_step_matches_jax(w18):
    pair, _, (jaux, paux, jgrads) = w18
    check_losses(jaux, paux)
    check_confmats(jaux, paux)
    want = flat(jgrads)
    got = {n: p.grad.numpy() for n, p in pair.pm.named_parameters()}
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for n, g in got.items():
        err = np.abs(g - want[n]).max()
        if n == "backbone.shared_head_conv.bias":
            assert err <= ZERO_GRAD_TOL * top, (n, err, top)
        else:
            scale = np.abs(want[n]).max()
            assert err <= GRAD_RTOL["default"] * scale + 1e-7, (n, err, scale)


def test_export_at_widths_no_multiple_of_8(tmp_path, monkeypatch):
    jtree, ptree = trees("default")
    jm = jax_build_model(jtree, 1, 1, odd_widths(jhrnet))
    weights = variables(jm, seed=3)
    pred = port_predictor(
        monkeypatch, lambda: port_build_model(ptree, 1, 1,
                                              odd_widths(thrnet)), weights)
    path = tmp_path / "odd.pt2"
    pexport.export_predictor(pred, str(path), batch=2)
    x = images(2, 4)
    got = pexport.load_exported(str(path))(x)
    _check_eager(got, pred(x))
    want = jax_predictor(monkeypatch, jm, {"w": weights}, "w")(x)
    for lv, (g, w) in enumerate(zip(got["probs"], want["probs"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL)
        top2 = np.sort(w, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TIE
        np.testing.assert_array_equal(got["class_maps"][lv][clear],
                                      want["class_maps"][lv][clear])

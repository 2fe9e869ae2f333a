"""The port's post-training quantization (``train/quantize.py``) and its
quantized ``Predictor`` against the JAX package on the CPU, on the same
weights.

- ``calibrate``: the same keys as JAX ``calibrate`` (the tiny HRNet's 55,
  without ``backbone/shared_head_conv``, which the JAX quantizer never
  converts; the base-8 UNet's 20) and values within rtol 1e-5 (XLA and
  oneDNN sum the convs in other orders); a running max over every call and
  batch (``concat_prev_probs`` runs the backbone once per level).
- ``default_skip``: the JAX test's cases (``tests/test_quantize.py:225``).
- The quantized Predictor against the JAX quantized Predictor: composed
  probabilities within a mean |d| of 1e-3 and a max |d| of 2e-2 per level,
  class maps equal on at least 99 % of pixels. The float noise upstream of
  a ``round()`` can move an int8 value by one step, and the next layers
  carry that step on; the bounds allow for it. Against the float port
  within the JAX test's mean 0.02 (``tests/test_quantize.py:155``).
"""
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models import (
    hierarchical as JH,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.unet import (
    UNetBackbone as JaxUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    quantize as jq,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    hierarchical as PH,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (
    UNetBackbone as PortUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    int8_conv,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    quantize as pq,
)
from torch_port_common import load_port, trees
from torch_serving_common import (
    images,
    jax_predictor,
    models,
    port_predictor,
    variables,
)

N_KEYS = {"hrnet": 55, "unet": 20}
PROB_MEAN, PROB_MAX, AGREE = 1e-3, 2e-2, 0.99


def _scales(name, seed, batches):
    jm, make = models(name)
    params, stats = variables(jm, seed)
    want = jq.calibrate(jm.apply, {"params": params, "batch_stats": stats},
                        batches, train=False)
    pm = load_port(make(), params, stats)
    return want, pq.calibrate(pm, batches), pm


@pytest.mark.parametrize("name", ["hrnet", "unet"])
def test_calibrate_equals_jax(name):
    want, got, pm = _scales(name, 1, [images(2, 2)])
    assert len(want) == N_KEYS[name]
    assert set(got) == set(want) == {p for p, _ in pq._plain_convs(pm)}
    assert {"head_l0", "head_l1"} <= set(got)
    assert "backbone/shared_head_conv" not in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
        assert got[k] > 0


def test_calibrate_keeps_the_max_over_calls_and_batches():
    """concat_prev_probs: the backbone runs once per level, each call with
    other inputs; two batches of other scales. Against JAX ``calibrate``
    (its ``sow`` reduces with ``jnp.maximum``)."""
    jtree, ptree = trees("default")
    jm = JH.HierarchicalSegmenter(tree=jtree, backbone=JaxUNet(base_ch=8),
                                  concat_prev_probs=True)
    params, stats = variables(jm, 3)
    batches = [images(1, 4), 3.0 * images(2, 5)]
    want = jq.calibrate(jm.apply, {"params": params, "batch_stats": stats},
                        batches, train=False)
    pm = load_port(PH.HierarchicalSegmenter(
        tree=ptree, backbone=PortUNet(base_ch=8, in_channels=3 + 4),
        concat_prev_probs=True), params, stats)
    got = pq.calibrate(pm, batches)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    # the stem's input is the batch concatenated with the level's probs:
    # its max is over both levels' calls and both batches
    first = pq.calibrate(pm, batches[:1])
    assert got["backbone/inc/conv0"] == pytest.approx(
        float(np.abs(batches[1]).max()), rel=1e-6)
    assert any(got[k] > first[k] for k in got)


@pytest.mark.parametrize("path,skipped", [
    ("head_l0", True), ("head_l12", True), ("head_flat", True),
    ("wrapper/head_l1", True), ("backbone/shared_head_conv", False),
    ("backbone/stage4_m0_b1_conv2", False), ("overhead_conv", False)])
def test_default_skip_equals_jax(path, skipped):
    assert pq.default_skip(path) is skipped
    assert jq.default_skip(path) is skipped


def test_skipped_and_uncalibrated_convs_run_in_float():
    _, scales, pm = _scales("unet", 6, [images(1, 7)])
    x = torch.from_numpy(images(1, 8))
    with torch.inference_mode():
        want = pm(x).logits_per_level
        for apply in (pq.quantized_apply(pm, scales, skip=lambda _: True),
                      pq.quantized_apply(pm, {}, skip=lambda _: False)):
            for g, w in zip(apply(x).logits_per_level, want):
                assert torch.equal(g, w)


def test_quantized_conv_under_autocast_gives_the_autocast_dtype():
    """Under bf16 autocast a float conv gives bf16: so does the int8 one,
    whatever its input's dtype (the stem takes the f32 image)."""
    _, scales, pm = _scales("unet", 6, [images(1, 7)])
    apply = pq.quantized_apply(pm, scales)
    dtypes = {}

    def record(name):
        def hook(mod, args, out):
            dtypes[name] = (args[0].dtype, out.dtype)
        return hook

    hooks = [m.register_forward_hook(record(p))
             for p, m in pq._plain_convs(pm)]
    try:
        with torch.inference_mode(), torch.autocast("cpu",
                                                    dtype=torch.bfloat16):
            apply(torch.from_numpy(images(1, 8)))
    finally:
        for h in hooks:
            h.remove()
    assert dtypes["backbone/inc/conv0"] == (torch.float32, torch.bfloat16)
    assert {o for _, o in dtypes.values()} == {torch.bfloat16}


@pytest.mark.parametrize("name,calib", [("unet", "given"),
                                        ("hrnet", "default")])
def test_quantized_predictor_against_jax(name, calib, monkeypatch):
    jm, make = models(name)
    w = variables(jm, 11)
    batches = [images(2, 12)] if calib == "given" else None
    jpred = jax_predictor(monkeypatch, jm, {"w": w}, "w", quantize=True,
                          calib_batches=batches)
    pred = port_predictor(monkeypatch, make, w, quantize=True,
                          calib_batches=batches)
    floats = port_predictor(monkeypatch, make, w)
    assert set(pred.act_scales) == set(jpred.act_scales)
    for k, v in jpred.act_scales.items():
        assert pred.act_scales[k] == pytest.approx(v, rel=1e-5), k
    # inputs in the range the scales were calibrated on: the default batch
    # is uniform in (-1, 1), the training normalization's range
    x = (images(2, 13) if calib == "given" else np.random.default_rng(
        13).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    int8_conv.CALLS = 0
    want, got, flt = jpred(x), pred(x), floats(x)
    assert int8_conv.CALLS == 0  # the CPU runs the plain version
    tree = trees("default")[1]
    for L in range(tree.num_levels):
        d = np.abs(got["probs"][L] - np.asarray(want["probs"][L]))
        assert d.mean() <= PROB_MEAN and d.max() <= PROB_MAX, (L, d.mean(),
                                                               d.max())
        agree = (got["class_maps"][L] == np.asarray(want["class_maps"][L]))
        assert agree.mean() >= AGREE, (L, agree.mean())
        assert np.abs(got["probs"][L] - flt["probs"][L]).mean() < 0.02
        assert np.abs(got["probs"][L] - flt["probs"][L]).max() > 0
    # the composition invariant survives quantization by construction
    np.testing.assert_allclose(
        got["probs"][1].sum(-1),
        got["probs"][0][..., tree.parents_with_children[1]].sum(-1),
        rtol=1e-3, atol=1e-3)

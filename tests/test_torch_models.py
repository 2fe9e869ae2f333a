"""Parity of the port's modules with the JAX package's, on the CPU, fp32,
with weights converted from the JAX variables and non-trivial running
statistics: BatchNorm+act, FiLM, the tiny HRNet backbone, and the
hierarchical segmenter in hierarchical and flat mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.hrnet import (
    HRNetBackbone as JaxHRNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.film import (
    FiLM as JaxFiLM,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.norm import (
    LeanBatchNorm,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.pallas_bn import (
    PallasBatchNormAct,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    BatchNormAct,
    FiLM,
    HRNetBackbone,
    UNetBackbone,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
    build_model as port_build_model,
)
from torch_port_common import (
    ATOL,
    RTOL,
    jax_variables,
    load_port,
    nhwc_to_torch,
    tiny_configs,
    torch_to_nhwc,
    trees,
)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("flavour", ["lean", "pallas"])
def test_batchnorm_act_matches_jax(flavour, act):
    c = 24
    x = np.random.default_rng(0).standard_normal((2, 5, 7, c)) \
        .astype(np.float32) * 2
    if flavour == "lean":
        jm = LeanBatchNorm(use_running_average=True)
    else:
        jm = PallasBatchNormAct(use_running_average=True, act=act)
    params, stats = jax_variables(jm, x)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    if flavour == "lean" and act == "relu":
        want = jax.nn.relu(want)
    port = load_port(BatchNormAct(c, act), params, stats)
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_batchnorm_act_train_mode_is_a_later_slice():
    # train mode came with the train slice (test_torch_bn_train.py holds it
    # against the JAX BatchNorms): it normalizes with the batch statistics
    # and moves the running buffers by the flax momentum 0.9, the variance
    # Bessel-corrected
    bn = BatchNormAct(8).train()
    x = torch.arange(64.0).reshape(2, 8, 2, 2).contiguous(
        memory_format=torch.channels_last)
    y = bn(x)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    want = (x - mean[:, None, None]) / torch.sqrt(var + 1e-5)[:, None, None]
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var * 8 / 7)


def test_film_matches_jax():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 6, 5, 12)).astype(np.float32)
    cond = rng.uniform(0, 1, (2, 9, 10, 4)).astype(np.float32)
    jm = JaxFiLM()
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(cond))
    params = jax.tree_util.tree_map(np.asarray, dict(v["params"]))
    want = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(cond))
    port = load_port(FiLM(4, 12), params, {})
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(feats), nhwc_to_torch(cond)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pallas", [False, True])
def test_hrnet_backbone_matches_jax(pallas):
    jcfg, pcfg = tiny_configs()
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)) \
        .astype(np.float32)
    jm = JaxHRNet(config=jcfg, use_pallas_bn=pallas)
    params, stats = jax_variables(jm, x, train=False)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    port = load_port(HRNetBackbone(pcfg, use_pallas_bn=pallas), params, stats)
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    assert got.shape == (2, 16, 16, pcfg.last_channels)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_hrnet_head_modes():
    """The sum head computes the concat head's function on the same weights
    (f32, atol 1e-5: the terms are summed in another order); an unknown
    mode raises (tests/test_torch_hrnet_sum_head.py holds both against the
    JAX module)."""
    _, pcfg = tiny_configs()
    torch.manual_seed(0)
    concat = HRNetBackbone(pcfg, head_mode="concat").eval()
    head_sum = HRNetBackbone(pcfg, head_mode="sum").eval()
    head_sum.load_state_dict(concat.state_dict(), strict=True)
    x = nhwc_to_torch(np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(torch_to_nhwc(head_sum(x)),
                                   torch_to_nhwc(concat(x)), rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        HRNetBackbone(pcfg, head_mode="concatenate")
    # model_select 0, the default, is the UNet donor: 9 DoubleConvs of two
    # BatchNorms each (test_torch_unet.py holds it against the JAX UNet)
    unet = port_build_model(trees("default")[1], model_select=0)
    assert isinstance(unet.backbone, UNetBackbone)
    assert sum(isinstance(m, BatchNormAct) for m in unet.modules()) == 18


@pytest.mark.parametrize("concat", [False, True], ids=["film", "concat"])
@pytest.mark.parametrize("tree_name", ["default", "extended"])
@pytest.mark.parametrize("model_type", [1, 0], ids=["hier", "flat"])
def test_segmenter_matches_jax(model_type, tree_name, concat):
    jtree, ptree = trees(tree_name)
    jcfg, pcfg = tiny_configs()
    x = np.random.default_rng(3).standard_normal((2, 48, 48, 3)) \
        .astype(np.float32)
    jm = jax_build_model(jtree, 1, model_type, jcfg, concat_prev_probs=concat)
    params, stats = jax_variables(jm, x, train=False)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    port = load_port(port_build_model(ptree, 1, model_type, pcfg,
                                      concat_prev_probs=concat),
                     params, stats)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    pairs = [(got.logits_per_level, want.logits_per_level)]
    if model_type == 1:
        assert len(got.probs_per_level) == jtree.num_levels
        pairs += [(got.probs_per_level, want.probs_per_level),
                  (got.q_per_level[1:], want.q_per_level[1:])]
    else:
        assert got.probs_per_level is None and got.q_per_level is None
    for gl, wl in pairs:
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            g = g.numpy()
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=ATOL)

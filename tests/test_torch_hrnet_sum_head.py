"""HRNet's shared head in ``sum`` mode (``models/backbones/hrnet.py:
SharedHead1x1``) against the port's ``concat`` head and the JAX module's
``sum`` head, and ``head_mode="auto"`` reading ``RHSS_HRNET_HEAD`` in
both packages. The tiny HRNet at 64 px (branches at 16, 8, 4 and 2 px), f32
on the CPU with seeded numpy weights.

Tolerances: against the port's concat head, atol 1e-5 (the same
function; the terms are summed in another order); against the JAX module,
the port tests' f32 rtol = atol = 1e-4 (XLA and oneDNN sum the convs in
other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones import (
    hrnet as jhrnet,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones import (
    hrnet as phrnet,
)
from torch_port_common import (
    ATOL,
    RTOL,
    jax_variables,
    load_port,
    nhwc_to_torch,
    tiny_configs,
    torch_to_nhwc,
)

SIZE = 64


def _x(seed=2, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _jax_backbone(jcfg, x, mode):
    jm = jhrnet.HRNetBackbone(config=jcfg, head_mode=mode)
    return jm, jax_variables(jm, x, train=False)


@pytest.mark.parametrize("size", [64, 48])
def test_sum_head_equals_concat_head(size):
    _, pcfg = tiny_configs()
    torch.manual_seed(0)
    concat = phrnet.HRNetBackbone(pcfg, head_mode="concat").eval()
    head_sum = phrnet.HRNetBackbone(pcfg, head_mode="sum").eval()
    head_sum.load_state_dict(concat.state_dict(), strict=True)
    x = nhwc_to_torch(_x(size=size))
    with torch.no_grad():
        got = torch_to_nhwc(head_sum(x))
        want = torch_to_nhwc(concat(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [64, 48])
def test_sum_head_matches_jax_sum_head(size):
    jcfg, pcfg = tiny_configs()
    x = _x(size=size)
    jm, (params, stats) = _jax_backbone(jcfg, x, "sum")
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    port = load_port(phrnet.HRNetBackbone(pcfg, head_mode="sum"), params,
                     stats)
    assert port.shared_head_conv.mode == "sum"
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_head_alone_matches_jax_on_both_orders():
    """The SharedHead1x1 modules alone on four branches whose FLOP estimate
    picks conv-first for some and resize-first for others."""
    rng = np.random.default_rng(5)
    chans, hws, out_ch = (4, 8, 16, 32), (16, 8, 4, 2), 6
    xs = [rng.standard_normal((2, hw, hw, c)).astype(np.float32)
          for c, hw in zip(chans, hws)]
    decisions = [
        c * hw * hw * out_ch
        + phrnet.SharedHead1x1._resize_flops(out_ch, (hw, hw), (16, 16))
        < c * 16 * 16 * out_ch for c, hw in zip(chans[1:], hws[1:])]
    assert True in decisions and False in decisions
    for c, hw in zip(chans, hws):
        assert phrnet.SharedHead1x1._resize_flops(c, (hw, hw), (16, 16)) == \
            jhrnet.SharedHead1x1._resize_flops(c, (hw, hw), (16, 16))
    jm = jhrnet.SharedHead1x1(in_ch=sum(chans), out_ch=out_ch,
                              align_corners=True, mode="sum")
    kernel = rng.standard_normal((1, 1, sum(chans), out_ch)).astype(np.float32)
    bias = rng.standard_normal((out_ch,)).astype(np.float32)
    want = jm.apply({"params": {"kernel": kernel, "bias": bias}},
                    [jnp.asarray(t) for t in xs], (16, 16))
    head = phrnet.SharedHead1x1(sum(chans), out_ch, True, "sum")
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        head.bias.copy_(torch.from_numpy(bias))
        got = torch_to_nhwc(head([nhwc_to_torch(t) for t in xs], (16, 16)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _jax_head_mode(jm, variables, x):
    """The mode of the JAX SharedHead1x1 that ran in ``jm.apply``."""
    seen = []

    def spy(next_fun, args, kwargs, context):
        if isinstance(context.module, jhrnet.SharedHead1x1):
            seen.append(context.module.mode)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(spy):
        out = jm.apply(variables, jnp.asarray(x), train=False)
    return set(seen), out


@pytest.mark.parametrize("env", [None, "sum", "concat"])
def test_auto_reads_rhss_hrnet_head_in_both_packages(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("RHSS_HRNET_HEAD", raising=False)
    else:
        monkeypatch.setenv("RHSS_HRNET_HEAD", env)
    want_mode = env or "concat"
    jcfg, pcfg = tiny_configs()
    x = _x(n=1)
    jm, (params, stats) = _jax_backbone(jcfg, x, "auto")
    modes, want = _jax_head_mode(jm, {"params": params,
                                      "batch_stats": stats}, x)
    assert modes == {want_mode}
    port = load_port(phrnet.HRNetBackbone(pcfg), params, stats)  # "auto"
    assert port.shared_head_conv.mode == want_mode
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_unknown_mode_raises_in_the_port_only(monkeypatch):
    """The JAX module computes ``sum`` for any mode but ``concat``; the port
    refuses a mode it does not know, also from the environment."""
    _, pcfg = tiny_configs()
    with pytest.raises(ValueError, match="head_mode"):
        phrnet.HRNetBackbone(pcfg, head_mode="summ")
    monkeypatch.setenv("RHSS_HRNET_HEAD", "summ")
    with pytest.raises(ValueError, match="head_mode"):
        phrnet.HRNetBackbone(pcfg)


@pytest.mark.parametrize("mode", ["concat", "sum"])
def test_quantizer_leaves_the_shared_head_float_in_both_modes(mode):
    """The JAX quantizer converts only ``nn.Conv`` modules, so its
    ``SharedHead1x1`` stays float; the port's does in both head modes."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        quantize,
    )

    _, pcfg = tiny_configs()
    model = phrnet.HRNetBackbone(pcfg, head_mode=mode)
    paths = [p for p, _ in quantize._plain_convs(model)]
    assert paths and "shared_head_conv" not in paths
    assert "stem_conv0" in paths

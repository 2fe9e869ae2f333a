"""The port's UNet donor (``models/backbones/unet.py``), the JAX package's
default model, against the JAX UNet on the CPU, fp32, with weights
converted from the JAX variables: the backbone in eval and train mode
(outputs and running statistics) at an odd size (the pad path) and an even
one, the hierarchical and flat segmenter on it, ``build_model(0, ...)`` at
full width, the weight bridge's round trip, one train step against the JAX
step and against its own float64 run, and the serving path (``Predictor``
and the serve CLI at its defaults).

Tolerances: 1e-4 (``torch_port_common.RTOL``/``ATOL``: conv sums in
another order in XLA:CPU and oneDNN) for forward outputs and running
statistics; the train step's are those of ``torch_train_common.py`` for
the JAX default BatchNorm (the JAX UNet has no other).
"""
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.unet import (
    UNetBackbone as JaxUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    serve as port_serve,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    decode_png,
    encode_png_gray8,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    BatchNormAct,
    UNetBackbone,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
    build_model as port_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.serving import (
    Predictor,
)
from torch_port_common import (
    ASSETS,
    ATOL,
    RTOL,
    jax_variables,
    load_port,
    nhwc_to_torch,
    torch_to_nhwc,
    trees,
)
from torch_train_common import (
    LEVEL_WEIGHTS,
    LR,
    ZERO_GRAD_TOL,
    Pair,
    batch,
    unet_models,
)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [50, 36])
def test_unet_backbone_matches_jax(size, train):
    # 50 px: 50 -> 25 -> 12 -> 6 -> 3; the decoder pads 24 to 25 (0, 1) and
    # 48 to 50 (1, 1). 36 px: every level halves exactly
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)) \
        .astype(np.float32)
    jm = JaxUNet(base_ch=8)
    params, stats = jax_variables(jm, x, train=False)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, upd = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
    port = load_port(UNetBackbone(base_ch=8), params, stats).train(train)
    assert port.feature_dim == 8 and port.feature_stride == 1
    with torch.no_grad():
        got = torch_to_nhwc(port(nhwc_to_torch(x)))
    assert got.shape == (2, size, size, 8)
    _close(got, want)
    if train:
        sd = state_dict_from_flax(params, upd["batch_stats"])
        for k, v in port.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                _close(v.numpy(), sd[k].numpy())


def test_unet_keeps_channels_last_and_conv_biases():
    # every BatchNorm input is the contiguous (rows, C) matrix its kernel
    # reads (BatchNormAct copies nothing), through the pad and the concat
    port = UNetBackbone(base_ch=8).eval()
    seen = []
    for m in port.modules():
        if isinstance(m, BatchNormAct):
            m.register_forward_pre_hook(
                lambda mod, a: seen.append(
                    a[0].permute(0, 2, 3, 1).is_contiguous()))
    x = torch.randn(1, 3, 50, 50).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = port(x)
    assert len(seen) == 18 and all(seen)
    assert y.is_contiguous(memory_format=torch.channels_last)
    convs = [m for m in port.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 18 and all(c.bias is not None for c in convs)


@pytest.mark.parametrize("model_type", [1, 0], ids=["hier", "flat"])
def test_segmenter_on_unet_matches_jax(model_type):
    jtree, ptree = trees("default")
    x = np.random.default_rng(3).standard_normal((2, 40, 40, 3)) \
        .astype(np.float32)
    jm, pm = unet_models(jtree, ptree, model_type)
    params, stats = jax_variables(jm, x, train=False)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    port = load_port(pm, params, stats)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    pairs = [(got.logits_per_level, want.logits_per_level)]
    if model_type == 1:
        pairs += [(got.probs_per_level, want.probs_per_level),
                  (got.q_per_level[1:], want.q_per_level[1:])]
    for gl, wl in pairs:
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            _close(g.numpy(), w)


@pytest.fixture(scope="module")
def full_width():
    """``build_model(tree)`` at its defaults on both sides (UNet, hier,
    base width 64) with the same seeded variables."""
    jtree, ptree = trees("default")
    jm = jax_build_model(jtree)
    x = np.random.default_rng(4).standard_normal((1, 32, 32, 3)) \
        .astype(np.float32)
    params, stats = jax_variables(jm, x, train=False)
    return jm, params, stats, ptree, x


def test_build_model_default_is_the_full_width_unet(full_width):
    jm, params, stats, ptree, x = full_width
    pm = port_build_model(ptree)
    assert isinstance(pm.backbone, UNetBackbone) and pm.hierarchical
    n_backbone = sum(p.numel() for p in pm.backbone.parameters())
    assert n_backbone == 13_395_264
    port = load_port(pm, params, stats)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got.logits_per_level + got.probs_per_level,
                    want.logits_per_level + want.probs_per_level):
        _close(g.numpy(), w)


def test_bridge_round_trip_is_exact(full_width):
    _, params, stats, _, _ = full_width
    sd = state_dict_from_flax(params, stats)
    assert set(sd) == set(port_build_model(trees("default")[1])
                          .state_dict())
    p2, s2 = flax_from_state_dict(sd)
    for a, b in ((params, p2), (stats, s2)):
        la = jax.tree_util.tree_leaves_with_path(a)
        lb = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(la) == len(lb)
        for path, v in la:
            assert np.array_equal(np.asarray(v), lb[path]), path


def test_unet_train_step_matches_jax():
    paux = Pair(donor="unet", oracle="default").two_steps()
    assert np.isfinite(paux["loss"].item())


def test_unet_step_gradients_against_float64():
    """The port's f32 UNet step gradients within 1e-4 of each tensor's
    largest from the same step in float64, as ``test_torch_bn_train.py``
    holds the HRNet step. One float64 step settles the seeded weights
    first: from them, the first DoubleConv's gradients are sums that
    nearly cancel, and f32 sits as far as 1e-2 of a tensor's largest from
    float64 there (this test without the settling step). The conv
    biases, whose gradient is 0 in exact arithmetic, are held to
    ``ZERO_GRAD_TOL`` of the step's largest gradient."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        create_train_state,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )

    pair = Pair(donor="unet", oracle="default")
    m64 = pair.pm.double()
    step64 = make_train_step(m64, pair.ptree, True,
                             level_weights=LEVEL_WEIGHTS)
    x1, y1 = batch(pair.ptree, seed=1)
    step64(create_train_state(m64, LR), torch.from_numpy(x1).double(),
           torch.from_numpy(y1), torch.ones(2))
    m32 = unet_models(pair.jtree, pair.ptree)[1].to(
        memory_format=torch.channels_last)
    m32.load_state_dict(m64.state_dict())
    step32 = make_train_step(m32, pair.ptree, True,
                             level_weights=LEVEL_WEIGHTS)
    x, y = torch.from_numpy(pair.x), torch.from_numpy(pair.y)
    g32, loss32, _, _ = step32.micro_grads(x, y, torch.ones(2))
    g64, loss64, _, _ = step64.micro_grads(x.double(), y, torch.ones(2))
    assert loss64.dtype == torch.float64
    np.testing.assert_allclose(loss32.item(), loss64.item(), rtol=1e-6)
    top = max(g.abs().max().item() for g in g64.values())
    zero = pair.zero_grads()
    assert len(zero) == 18
    for n, g in g64.items():
        scale = g.abs().max().item()
        err = (g32[n].double() - g).abs().max().item()
        if n in zero:
            assert err <= ZERO_GRAD_TOL * top, (n, err, top)
        else:
            assert err <= 1e-4 * scale, (n, err, scale)


def test_predictor_unet_matches_jax(full_width):
    jm, params, stats, ptree, _ = full_width
    cfg = RunConfig(tree_root=str(ASSETS / "class_tree_tl.json"),
                    class_map=str(ASSETS / "class_map.csv"), img_size=32,
                    model_select=0, model_type=1, compute_dtype="float32")
    pred = Predictor(cfg, state_dict_from_flax(params, stats), tree=ptree,
                     device="cpu")
    x = np.random.default_rng(8).standard_normal((2, 32, 32, 3)) \
        .astype(np.float32)
    want = jm.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    got = pred(x)
    for L in range(ptree.num_levels):
        _close(got["logits"][L], want.logits_per_level[L])
        _close(got["probs"][L], want.probs_per_level[L])


def test_serve_cli_defaults_serve_the_unet_on_cpu(tmp_path):
    """The serve CLI at its defaults (UNet, flat, 352 px, bf16, f32 input)
    with only the required flags and ``--device cpu --port 0``: one POSTed
    PNG comes back as a 352x352 class map over the tree's leaf classes."""
    _, ptree = trees("default")
    weights = tmp_path / "unet_flat.pt"
    torch.save(port_build_model(ptree, 0, 0).state_dict(), str(weights))
    args = port_serve.get_args([
        "--model-weights", str(weights),
        "--tree-root", str(ASSETS / "class_tree_tl.json"),
        "--class-map", str(ASSETS / "class_map.csv"),
        "--device", "cpu", "--port", "0"])
    assert (args.model_select, args.model_type, args.img_size,
            args.compute_dtype) == (0, 0, 352, "bfloat16")
    server = port_serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(2).integers(0, 256, (60, 80)).astype(np.uint8)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/predict",
            data=encode_png_gray8(img), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and r.headers["X-Level"] == "0"
            cmap = decode_png(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert cmap.shape == (352, 352)
    assert int(cmap.max()) < ptree.num_leaves

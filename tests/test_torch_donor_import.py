"""The port's donor-checkpoint import (``train/torch_import.py``) against the
JAX package's on the CPU, and the ``--model-weights`` rule of every reader.

Held: the copied ``translate_flax_path`` equals the JAX function on every
leaf of the tiny HRNet and the base-width-8 UNet (whose flax paths, through
``bridge``, equal the JAX models'); the JAX importer's own cases
(``tests/test_torch_import.py``: the milesial round trip, prefix
stripping, a shape mismatch) on the port; a full-coverage synthetic
``.pth`` gives equal parameters and the same coverage line through both
packages, and their ``Predictor`` outputs agree within the serving tests'
tolerance (rtol = atol = 1e-4: XLA and oneDNN sum the convs in other
orders; class maps equal where the two largest probabilities differ by
more than that); a partial donor sets the leaves it matches and leaves the
rest at the port's initialization; the ``Predictor``, the ``Trainer``, the
``Evaluator`` and the train, predict_eval and serve CLIs read a donor
``.pth`` and still read the port's own ``.pt``."""
import contextlib
import io
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    serving as jserving,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.torch_import import (
    load_donor_weights as jax_load_donor,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.torch_import import (
    translate_flax_path as jax_translate,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    predict_eval as pe_cli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    serve as serve_cli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    train as train_cli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    serving as pserving,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    torch_import as pti,
)
from torch_donor_common import donor_state_dict, leaves
from torch_eval_common import IMG, small_models
from torch_port_common import ASSETS, ATOL, RTOL
from torch_serving_common import TREE, images, models, variables
from torch_trainer_common import small_model

MS = {"unet": 0, "hrnet": 1}
TIE = 1e-4
TREE_ARGS = ["--tree-root", TREE["tree_root"], "--class-map",
             TREE["class_map"]]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["unet", "hrnet"])
def test_translate_flax_path_equals_jax(name):
    jm, make = models(name)
    params, stats = variables(jm, 0)
    pparams, pstats = flax_from_state_dict(make().state_dict())
    for coll, jtree, ptree in (("params", params, pparams),
                               ("batch_stats", stats, pstats)):
        jpaths = [p for p, _ in leaves(jtree)]
        assert sorted(jpaths) == sorted(p for p, _ in leaves(ptree))
        for path in jpaths:
            for ms in (0, 1):
                assert pti.translate_flax_path(path, coll, ms) == \
                    jax_translate(path, coll, ms), (path, coll, ms)


def test_unet_donor_roundtrip(tmp_path):
    """JAX ``test_unet_donor_roundtrip`` on the port: milesial names, the
    OIHW layout, a ``module.`` prefix; unmatched leaves keep their init."""
    _, make = models("unet", model_type=0)
    model = make()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    k = model.backbone.inc.conv0.weight  # (8, 3, 3, 3) OIHW
    donor_conv = torch.arange(k.numel(), dtype=torch.float32).reshape(k.shape)
    sd = {
        "inc.double_conv.0.weight": donor_conv,
        "inc.double_conv.0.bias": torch.zeros(8) + 7.0,
        "inc.double_conv.1.weight": torch.zeros(8) + 3.0,  # bn scale
        "module.down1.maxpool_conv.1.double_conv.0.weight":
            torch.zeros(16, 8, 3, 3) + 0.5,
    }
    pth = str(tmp_path / "donor.pth")
    torch.save(sd, pth)
    pti.load_donor_weights(pth, model, model_select=0)
    got = model.state_dict()
    assert torch.equal(got["backbone.inc.conv0.weight"], donor_conv)
    assert torch.equal(got["backbone.inc.conv0.bias"], torch.full((8,), 7.0))
    assert torch.equal(got["backbone.inc.bn0.weight"], torch.full((8,), 3.0))
    assert torch.equal(got["backbone.down1.conv.conv0.weight"],
                       torch.full((16, 8, 3, 3), 0.5))
    assert torch.equal(got["head_flat.weight"], before["head_flat.weight"])


def test_prefix_stripping(tmp_path):
    sd = {"model.module.net.layer.weight": torch.ones(2, 2)}
    pth = str(tmp_path / "p.pth")
    torch.save({"state_dict": sd}, pth)
    assert list(pti.load_torch_state_dict(pth)) == ["layer.weight"]
    torch.save({"model_state_dict": {"net.a.bias": torch.ones(2),
                                     "step": 3}}, pth)
    assert list(pti.load_torch_state_dict(pth)) == ["a.bias"]


def test_shape_mismatch_is_skipped(tmp_path):
    _, make = models("unet", model_type=0)
    model = make()
    before = model.backbone.inc.conv0.weight.detach().clone()
    pth = str(tmp_path / "bad.pth")
    torch.save({"inc.double_conv.0.weight": torch.zeros(99, 3, 3, 3)}, pth)
    pti.load_donor_weights(pth, model, model_select=0)
    assert torch.equal(model.backbone.inc.conv0.weight, before)


def _jax_predictor(monkeypatch, jm, init, path, ms):
    """The JAX Predictor on ``path``, starting from the variables
    ``init`` (no ``model.init``)."""
    monkeypatch.setattr(jserving, "build_model", lambda *a, **k: jm)
    monkeypatch.setattr(jserving, "create_train_state", lambda *a, **k: (
        SimpleNamespace(params=init[0], batch_stats=init[1]), None))
    cfg = JaxRunConfig(img_size=IMG, model_type=1, model_select=ms, **TREE)
    return jserving.Predictor(cfg, path)


def _port_predictor(monkeypatch, make, weights, ms):
    monkeypatch.setattr(pserving, "build_model", lambda *a, **k: make())
    cfg = RunConfig(img_size=IMG, model_type=1, model_select=ms, **TREE)
    return pserving.Predictor(cfg, weights, device="cpu")


@pytest.mark.parametrize("name", ["unet", "hrnet"])
def test_full_coverage_donor_equals_jax(name, tmp_path, monkeypatch):
    ms = MS[name]
    jm, make = models(name)
    params, stats = variables(jm, 3)
    init = variables(jm, 4)
    pth = str(tmp_path / "donor.pth")
    torch.save(donor_state_dict(params, stats, ms), pth)

    (jp, js), jline = _printed(jax_load_donor, pth, init[0], init[1], ms)
    model = make()
    _, pline = _printed(pti.load_donor_weights, pth, model, ms)
    assert pline == jline
    n = sum(1 for _ in leaves(params)) + sum(1 for _ in leaves(stats))
    assert pline == f"Loaded {n} / {n} layers.\n"
    _same_state(model.state_dict(), state_dict_from_flax(_np(jp), _np(js)))
    _same_state(model.state_dict(), state_dict_from_flax(params, stats))

    x = images(2, seed=5)
    want = _jax_predictor(monkeypatch, jm, init, pth, ms)(x)
    got = _port_predictor(monkeypatch, make, pth, ms)(x)
    for lv, (g, w) in enumerate(zip(got["probs"], want["probs"])):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
        top2 = np.sort(np.asarray(w), -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TIE
        np.testing.assert_array_equal(
            got["class_maps"][lv][clear],
            np.asarray(want["class_maps"][lv])[clear])


@pytest.mark.parametrize("name", ["unet", "hrnet"])
def test_partial_donor(name, tmp_path):
    ms = MS[name]
    jm, make = models(name)
    params, stats = variables(jm, 3)
    init = variables(jm, 4)

    def keep(path):
        return any(p.startswith(("inc", "down1", "stem", "layer1"))
                   for p in path)

    pth = str(tmp_path / "partial.pth")
    torch.save(donor_state_dict(params, stats, ms, keep), pth)
    (jp, js), jline = _printed(jax_load_donor, pth, init[0], init[1], ms)
    model = make()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, pline = _printed(pti.load_donor_weights, pth, model, ms)
    assert pline == jline and "Missing" in pline
    donor = state_dict_from_flax(params, stats)
    jinit = state_dict_from_flax(init[0], init[1])
    jgot = state_dict_from_flax(_np(jp), _np(js))
    got = model.state_dict()
    # the leaves JAX left at its init are the unmatched ones (the exact
    # names, and the shape-checked suffix fallback, which may also match
    # a leaf outside ``keep`` to a donor entry of the same shape)
    unmatched = {k for k in got if torch.equal(jgot[k], jinit[k])}
    assert 0 < len(unmatched) < len(got)
    for k in got:
        if k in unmatched:
            assert torch.equal(got[k], before[k]), k
        else:
            assert torch.equal(got[k], jgot[k]), k
        if keep(tuple(k.split("."))):
            assert torch.equal(got[k], donor[k]), k


def _unet_donor(tmp_path, seed=6):
    jm, make = models("unet")
    params, stats = variables(jm, seed)
    pth = str(tmp_path / "unet_donor.pth")
    torch.save(donor_state_dict(params, stats, 0), pth)
    own = str(tmp_path / "own.pt")
    torch.save(state_dict_from_flax(params, stats), own)
    return make, pth, own, state_dict_from_flax(params, stats)


def test_predictor_reads_donor_and_own_weights(tmp_path, monkeypatch):
    make, pth, own, sd = _unet_donor(tmp_path)
    for w in (pth, own):
        pred = _port_predictor(monkeypatch, make, w, 0)
        _same_state(pred.model.state_dict(), sd)
    # a partial donor: the unmatched leaves' init is drawn from seed 0, so
    # two Predictors agree
    jm, _ = models("unet")
    params, stats = variables(jm, 7)
    part = str(tmp_path / "part.pth")
    torch.save(donor_state_dict(params, stats, 0,
                                lambda p: p[0] == "backbone"), part)
    a = _port_predictor(monkeypatch, make, part, 0)
    b = _port_predictor(monkeypatch, make, part, 0)
    _same_state(a.model.state_dict(), b.model.state_dict())


def test_trainer_reads_donor_and_own_weights(tmp_path, monkeypatch):
    small_model(monkeypatch)
    make, pth, own, sd = _unet_donor(tmp_path)
    root = str(tmp_path / "data")
    write_synth_dataset(root, 4, size=IMG, seed=1, folds=1)
    for w in (pth, own):
        args = train_cli.get_args([
            "--save-path", str(tmp_path / "run"), "--data-root", root,
            "--model-type", "1", "--img-size", str(IMG), "--batch-size", "2",
            "--epochs", "1", "--model-weights", w, "--device", "cpu",
            "--folds", "1", "--num-workers", "0"] + TREE_ARGS)
        cfg = train_cli.config_from_args(args)
        tree = pserving.ClassTree.from_json(cfg.tree_root, cfg.class_map)
        trainer = loop.Trainer(cfg, tree, f"{root}/fold_1/train",
                               f"{root}/fold_1/val",
                               str(tmp_path / "t"), device="cpu")
        try:
            got = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
            _same_state(got, sd)
            assert trainer.start_epoch == 1  # weights only, no resume
        finally:
            trainer.close()


def test_cli_train_and_serve_read_a_donor(tmp_path, monkeypatch, capsys):
    small_model(monkeypatch)
    make, pth, _, sd = _unet_donor(tmp_path)
    root = str(tmp_path / "data")
    write_synth_dataset(root, 4, size=IMG, seed=1, folds=1)
    train_cli.main([
        "--save-path", str(tmp_path / "run"), "--data-root", root,
        "--model-type", "1", "--img-size", str(IMG), "--batch-size", "2",
        "--epochs", "1", "--model-weights", pth, "--device", "cpu",
        "--learning-rate", "[1e-3]", "--folds", "1",
        "--num-workers", "0"] + TREE_ARGS)
    assert f"Loaded {len(sd)} / {len(sd)} layers." in capsys.readouterr().out
    assert (tmp_path / "run" / "fold_1" / "best.ckpt").is_dir()

    args = serve_cli.get_args(["--model-weights", pth, "--model-type", "1",
                               "--img-size", str(IMG), "--device", "cpu",
                               "--port", "0"] + TREE_ARGS)
    # the Predictor build_server hands to make_server
    monkeypatch.setattr(serve_cli, "make_server", lambda pred, *a, **k: pred)
    _same_state(serve_cli.build_server(args).model.state_dict(), sd)


@pytest.mark.parametrize("which", ["donor", "own"])
def test_evaluator_and_predict_eval_cli_read_pt_weights(which, tmp_path,
                                                        monkeypatch, capsys):
    small_models(monkeypatch, jax_side=False)
    monkeypatch.chdir(tmp_path)
    _, pth, own, sd = _unet_donor(tmp_path)
    root = str(tmp_path / "data")
    write_synth_dataset(root, 3, size=IMG, seed=2)
    res = pe_cli.main(["--save-loc", which, "--full-ds", root,
                       "--model-weights", pth if which == "donor" else own,
                       "--inc-cross-val", "False", "--model-type", "1",
                       "--img-size", str(IMG), "--device", "cpu"] + TREE_ARGS)
    out = capsys.readouterr().out
    assert (f"Loaded {len(sd)} / {len(sd)} layers." in out) == \
        (which == "donor")
    assert "FINISHED TESTING" in out and len(res) == 1
    assert (tmp_path / "Predictions" / which / "fold_1" / "metrics.csv") \
        .is_file()

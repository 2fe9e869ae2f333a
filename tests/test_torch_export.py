"""The port's deployment artifact (``train/export.py``, ``cli/export.py``)
on the CPU: a ``torch.export`` program of the ``Predictor``'s forward,
held to the port's eager ``Predictor`` and to the JAX package's
``train/export.py`` artifact on the same weights.

The model is the hierarchical UNet at base width 8, 32 px, f32, seeded
numpy weights carried by ``bridge``. Tolerances: against the eager
``Predictor`` (the same operators in the same order), class maps equal and
probabilities and logits within rtol 1e-5, atol 1e-6; against the JAX
artifact, probabilities within atol 1e-5 and class maps equal where the
two largest probabilities differ by more than 1e-5 (XLA and oneDNN sum
the convs in other orders)."""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    export as jax_export_cli,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    export as jexport,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    export as port_export_cli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    fused_bn_act as fba,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    int8_conv,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    export as pexport,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    serving as pserving,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.quantize import (
    default_skip,
)
from torch_serving_common import (
    TREE,
    images,
    jax_predictor,
    models,
    port_predictor,
    variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "restrictive_hierarchical_semantic_segmentation_tpu_torch"
RTOL, ATOL = 1e-5, 1e-6
JAX_ATOL = TIE = 1e-5


@pytest.fixture(scope="module")
def unet():
    jm, make = models("unet")
    return jm, make, [variables(jm, seed) for seed in (11, 12, 13)]


def _check_eager(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None
            continue
        for g, w in zip(got[k], want[k], strict=True):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k == "class_maps":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _roundtrip(pred, path, x, batches, **kw):
    pexport.export_predictor(pred, str(path), **kw)
    loaded = pexport.load_exported(str(path))
    for b in batches:
        _check_eager(loaded(x[:b]), pred(x[:b]))
    with open(str(path) + ".json") as f:
        return loaded, json.load(f)


def test_symbolic_batch_serves_batch_1_and_3(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0])
    loaded, meta = _roundtrip(pred, tmp_path / "u.pt2", images(3, 0), (1, 3))
    assert meta["batch"] == "symbolic" and meta["platforms"] == ["cpu"]
    assert meta["input"]["shape"] == ["b", "32", "32", "3"]
    assert meta["outputs"]["keys"] == ["class_maps", "logits", "probs"]
    assert meta["ensemble"] is None and meta["format"] == "torch.export"
    assert meta["artifact_bytes"] == os.path.getsize(tmp_path / "u.pt2")
    assert loaded.platforms == ("cpu",)
    # one operator node per eval-mode BatchNorm, running its plain version
    # on the CPU (no kernel launch)
    nodes = [n for m in loaded.program.graph_module.modules()
             for n in m.graph.nodes
             if n.op == "call_function"
             and "rhss.scale_bias_act" in str(n.target)]
    assert len(nodes) == 18
    fba.LAUNCHES = 0
    loaded(images(2, 1))
    assert fba.LAUNCHES == 0


def test_static_batch_and_output_subset(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0],
                          outputs=("class_maps",))
    loaded, meta = _roundtrip(pred, tmp_path / "s.pt2", images(2, 2), (2,),
                              batch=2)
    assert meta["batch"] == 2 and meta["outputs"]["keys"] == ["class_maps"]
    assert meta["input"]["shape"] == ["2", "32", "32", "3"]
    with pytest.raises(Exception):
        loaded(images(3, 2))  # the batch is part of the program


def test_tta(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0], tta=True)
    _roundtrip(pred, tmp_path / "t.pt2", images(3, 3), (1, 3))


def test_three_fold_ensemble_is_one_file(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, list(ws),
                          outputs=("probs", "class_maps"))
    _, meta = _roundtrip(pred, tmp_path / "e.pt2", images(3, 4), (1, 3))
    assert meta["ensemble"] == {"folds": 3, "weights_file": None}
    assert sorted(os.listdir(tmp_path)) == ["e.pt2", "e.pt2.json"]


def test_int8(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0], quantize=True)
    loaded, meta = _roundtrip(pred, tmp_path / "q.pt2", images(3, 5), (1, 3))
    assert meta["model"]["quantized"] is True
    nodes = [n for m in loaded.program.graph_module.modules()
             for n in m.graph.nodes
             if n.op == "call_function"
             and "rhss.int8_conv2d" in str(n.target)]
    assert len(nodes) == sum(1 for p, a in pred.act_scales.items()
                             if a > 0 and not default_skip(p)) > 0
    int8_conv.CALLS = 0
    loaded(images(1, 5))
    assert int8_conv.CALLS == 0  # the CPU runs the plain version


def test_artifact_against_jax_artifact(unet, tmp_path, monkeypatch):
    jm, make, ws = unet
    jpred = jax_predictor(monkeypatch, jm, {"w": ws[0]}, "w")
    pred = port_predictor(monkeypatch, make, ws[0])
    jexport.export_predictor(jpred, str(tmp_path / "j.stablehlo"))
    pexport.export_predictor(pred, str(tmp_path / "p.pt2"))
    x = images(3, 6)
    want = jexport.load_exported(str(tmp_path / "j.stablehlo"))(x)
    got = pexport.load_exported(str(tmp_path / "p.pt2"))(x)
    assert set(got) == set(want)
    for lv, (g, w) in enumerate(zip(got["probs"], want["probs"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_ATOL)
        top2 = np.sort(w, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > TIE
        np.testing.assert_array_equal(got["class_maps"][lv][clear],
                                      want["class_maps"][lv][clear])
    with open(tmp_path / "j.stablehlo.json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "p.pt2.json") as f:
        pmeta = json.load(f)
    assert set(jmeta) - {"jax_version"} == set(pmeta) - {"torch_version"}
    assert pmeta["format"] != jmeta["format"]
    for k in ("input", "outputs", "model"):
        assert set(pmeta[k]) == set(jmeta[k]), k
    for k in ("img_size", "batch", "outputs", "model", "ensemble"):
        assert pmeta[k] == jmeta[k], k
    assert pmeta["input"]["shape"] == jmeta["input"]["shape"]


def test_loading_needs_only_torch_and_ops(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0])
    path = str(tmp_path / "u.pt2")
    pexport.export_predictor(pred, path)
    x = images(2, 7)
    np.save(tmp_path / "x.npy", x)
    want = pred(x)
    script = f"""
import sys, numpy as np
from {PORT}.train.export import load_exported
out = load_exported({path!r})(np.load({str(tmp_path / 'x.npy')!r}))
np.save({str(tmp_path / 'got.npy')!r}, out["probs"][1])
bad = sorted(m for m in sys.modules
             if m.startswith(("{PORT}.models", "{PORT}.train.serving"))
             or m == "jax" or m.startswith("jax."))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    _check_eager({"probs": [np.load(tmp_path / "got.npy")]},
                 {"probs": [want["probs"][1]]})


def test_platforms(unet, tmp_path, monkeypatch):
    _, make, ws = unet
    pred = port_predictor(monkeypatch, make, ws[0])
    path = str(tmp_path / "u.pt2")
    pexport.export_predictor(pred, path, platforms=("cuda", "cpu"))
    with open(path + ".json") as f:
        assert json.load(f)["platforms"] == ["cpu", "cuda"]  # exporter first
    pexport.export_predictor(pred, path)
    with pytest.raises(ValueError, match="platforms"):
        pexport.load_exported(path, device="cuda")
    assert pexport.load_exported(path, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="platforms"):
        pexport.export_predictor(pred, path, platforms=("tpu",))
    # bf16: the autocast region belongs to the exporting device type
    pred16 = port_predictor(monkeypatch, make, ws[0])
    pred16.cfg.compute_dtype = "bfloat16"
    with pytest.raises(ValueError, match="float32 for several platforms"):
        pexport.export_predictor(pred16, path, platforms=("cpu", "cuda"))


def _parser(module, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, argv=None: self)
        return module.get_args([])


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_match_jax(monkeypatch):
    ported = _flags(_parser(port_export_cli, monkeypatch))
    reference = _flags(_parser(jax_export_cli, monkeypatch))
    assert ported.pop("device") == (("--device",), "cuda", None, str, False)
    assert ported == reference


@pytest.mark.parametrize("ensemble", ["", "best"])
def test_cli_exports_a_checkpoint_and_an_ensemble(ensemble, unet, tmp_path,
                                                  monkeypatch, capsys):
    _, make, ws = unet
    monkeypatch.setattr(pserving, "build_model", lambda *a, **k: make())
    for i, w in enumerate(ws[:2], start=1):
        os.makedirs(tmp_path / "run" / f"fold_{i}")
        torch.save(state_dict_from_flax(*w),
                   tmp_path / "run" / f"fold_{i}" / "own.pt")
    monkeypatch.setattr(pserving.Predictor, "fold_checkpoints", staticmethod(
        lambda run, which: [str(tmp_path / "run" / f"fold_{i}" / "own.pt")
                            for i in (1, 2)]))
    out = str(tmp_path / "cli.pt2")
    weights = (str(tmp_path / "run") if ensemble
               else str(tmp_path / "run" / "fold_1" / "own.pt"))
    port_export_cli.main([
        "--model-weights", weights, "--out", out, "--model-type", "1",
        "--img-size", "32", "--batch", "2", "--outputs", "logits",
        "--ensemble", ensemble, "--device", "cpu",
        "--tree-root", TREE["tree_root"], "--class-map", TREE["class_map"]])
    printed = capsys.readouterr().out
    assert f"exported {out} (" in printed and "batch=2)" in printed
    with open(out + ".json") as f:
        meta = json.load(f)
    if ensemble:
        assert "--ensemble cannot export 'logits'" in printed
        assert meta["outputs"]["keys"] == ["probs"]
        assert meta["ensemble"]["folds"] == 2
    else:
        assert meta["outputs"]["keys"] == ["logits"]
    got = pexport.load_exported(out)(images(2, 8))
    assert set(got) == set(meta["outputs"]["keys"])

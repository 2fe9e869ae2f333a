"""The port's serving options on the CPU against the JAX package: fold
ensembles and TTA in the ``Predictor``, ``fold_checkpoints``, and the serve
CLI's ``--ensemble``, ``--tta`` and ``--quantize`` flags.

Tolerances: probabilities within the port tests' f32 tolerance (rtol =
atol = 1e-4, ``torch_port_common.RTOL``: XLA and oneDNN sum the convs in
other orders); class maps equal wherever the two largest mean
probabilities differ by more than 1e-4 (closer ones may order either way
under that noise). Against the mean of the port's own single-fold
Predictors: within 1e-6 (the same forwards; only the mean's order of
summation may differ)."""
import argparse
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    serve as jax_serve,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.serving import (
    Predictor as JaxPredictor,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
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
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    checkpoint as pckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    serving as pserving,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from torch_eval_common import IMG
from torch_port_common import ATOL, RTOL
from torch_serving_common import (
    TREE,
    images,
    jax_predictor,
    models,
    port_predictor,
    variables,
)

TIE = 1e-4


def test_fold_checkpoints_in_fold_order_without_fold_avg(tmp_path):
    for d in ("fold_10", "fold_2", "fold_1", "fold_avg", "other"):
        os.makedirs(tmp_path / d / "best.ckpt")
    os.makedirs(tmp_path / "fold_3" / "last.ckpt")
    got = pserving.Predictor.fold_checkpoints(str(tmp_path), "best")
    assert got == [str(tmp_path / f"fold_{i}" / "best.ckpt")
                   for i in (1, 2, 10)]
    assert got == JaxPredictor.fold_checkpoints(str(tmp_path), "best")
    assert pserving.Predictor.fold_checkpoints(str(tmp_path), "last") == [
        str(tmp_path / "fold_3" / "last.ckpt")]
    with pytest.raises(FileNotFoundError, match="fold_<N>/best.ckpt"):
        pserving.Predictor.fold_checkpoints(str(tmp_path / "other"))


def _check_ensemble(got, want, singles):
    """``got`` against the JAX ensemble's ``want`` and the port's
    single-fold outputs ``singles``."""
    assert got["logits"] is None and want["logits"] is None
    for L, (g, w) in enumerate(zip(got["probs"], want["probs"])):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=L)
        top2 = np.sort(w, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > TIE
        assert clear.mean() > 0.9
        cm = got["class_maps"][L]
        assert cm.dtype == np.int32 and cm.shape == w.shape[:3]
        np.testing.assert_array_equal(
            cm[clear], np.asarray(want["class_maps"][L])[clear])
        mean = np.stack([s["probs"][L] for s in singles]).mean(0)
        np.testing.assert_allclose(g, mean, rtol=0, atol=1e-6, err_msg=L)
        np.testing.assert_array_equal(cm, mean.argmax(-1))


@pytest.mark.parametrize("model_type,tta", [(1, False), (1, True),
                                            (0, False)])
def test_ensemble_equals_jax(model_type, tta, monkeypatch):
    """Two folds: the hierarchical UNet's composed probabilities, with and
    without TTA, and the flat UNet's softmax of its logits."""
    jm, make = models("unet", model_type)
    folds = {"fold_1": variables(jm, 21), "fold_2": variables(jm, 22)}
    names = sorted(folds)
    jpred = jax_predictor(monkeypatch, jm, folds, names, tta=tta)
    pred = port_predictor(monkeypatch, make, [folds[n] for n in names],
                          tta=tta)
    assert pred.ensemble and len(pred.models) == 2
    singles = [port_predictor(monkeypatch, make, folds[n], tta=tta)
               for n in names]
    x = images(2, 23)
    got = pred(x)
    outs = [s(x) for s in singles]
    if model_type == 0:  # the flat model's probs are its logits' softmax
        for o in outs:
            o["probs"] = [torch.softmax(torch.from_numpy(z), -1).numpy()
                          for z in o["logits"]]
    _check_ensemble(got, jpred(x), outs)


def test_one_fold_list_is_the_single_predictor(monkeypatch):
    jm, make = models("unet")
    w = variables(jm, 24)
    one = port_predictor(monkeypatch, make, [w])
    single = port_predictor(monkeypatch, make, w)
    assert not one.ensemble
    x = images(1, 25)
    got, want = one(x), single(x)
    for k in ("logits", "probs", "class_maps"):
        for g, s in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, s)


def test_quantize_with_an_ensemble_raises(monkeypatch):
    jm, make = models("unet")
    w = variables(jm, 26)
    with pytest.raises(ValueError, match="fold ensemble"):
        port_predictor(monkeypatch, make, [w, w], quantize=True)


def _parser(module, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, argv=None: self)
        return module.get_args([])


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required)
            for a in parser._actions if a.dest != "help"}


def test_serve_cli_flags_match_jax(monkeypatch):
    ported = _flags(_parser(port_serve, monkeypatch))
    reference = _flags(_parser(jax_serve, monkeypatch))
    assert ported.pop("device") == (("--device",), "cuda", None, str, False)
    assert ported == reference
    args = port_serve.get_args(["--model-weights", "w", "--tree-root", "t",
                                "--class-map", "c"])
    assert (args.quantize, args.ensemble, args.tta) == ("False", "", "False")


def _run_dir(tmp_path, make, folds):
    for i, w in enumerate(folds, start=1):
        model = make()
        model.load_state_dict(state_dict_from_flax(*w), strict=True)
        pckpt.save_checkpoint(str(tmp_path / f"fold_{i}" / "best.ckpt"),
                              create_train_state(model, 0.0), epoch=1)
    return str(tmp_path)


def _post(server, png):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/predict",
            data=png, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            return decode_png(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("flags", [["--ensemble", "best", "--tta", "True"],
                                   ["--quantize", "True"]])
def test_build_server_serves_the_options_on_cpu(flags, tmp_path,
                                                monkeypatch):
    """The serve CLI's server over a run directory of two folds (the
    ensemble with TTA), or over one fold quantized: a POSTed PNG comes back
    as the class map the Predictor gives for the same bytes."""
    jm, make = models("unet")
    run = _run_dir(tmp_path, make, [variables(jm, 27), variables(jm, 28)])
    monkeypatch.setattr(pserving, "build_model", lambda *a, **k: make())
    weights = run if "--ensemble" in flags else f"{run}/fold_1/best.ckpt"
    args = port_serve.get_args([
        "--model-weights", weights, "--tree-root", TREE["tree_root"],
        "--class-map", TREE["class_map"], "--model-type", "1",
        "--img-size", str(IMG), "--compute-dtype", "float32",
        "--device", "cpu", "--port", "0"] + flags)
    server = port_serve.build_server(args)
    img = np.random.default_rng(29).integers(0, 256, (40, 50)).astype(
        np.uint8)
    png = encode_png_gray8(img)
    got = _post(server, png)
    cfg = RunConfig(img_size=IMG, model_type=1, **TREE)
    if "--ensemble" in flags:
        pred = pserving.Predictor(
            cfg, pserving.Predictor.fold_checkpoints(run), tta=True,
            device="cpu")
        assert pred.ensemble
    else:
        pred = pserving.Predictor(cfg, weights, quantize=True, device="cpu")
        assert pred.act_scales
    want = pred(port_serve.preprocess_bytes(png, IMG))["class_maps"][-1][0]
    assert got.shape == (IMG, IMG)
    np.testing.assert_array_equal(got, want.astype(np.uint8))

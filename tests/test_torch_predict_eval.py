"""The port's predict_eval CLI (``cli/predict_eval.py``) and the batching
contracts of its ``Evaluator`` on the CPU: flag parity with the JAX CLI,
the cross-validation fold expansion, the output under
``./Predictions/<save-loc>``, the printed parameter count against the JAX
model's, donor ``.pt``/``.pth`` weights read (also under ``--quantize
True``) and a JAX orbax checkpoint refused, ``--quantize True``
(with and without ``--tta``) against the JAX CLI's quantized run on the
same weights within the JAX test's 0.05 Dice
(``tests/test_quantize.py:222``), ``--val-batch 3`` (a padded ragged tail) against
``--val-batch 1`` at the JAX test's rtol 1e-6, the bounded in-flight
window (``eval_inflight=1``), and the context that keeps the card's f32
convolutions out of TF32."""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    predict_eval as jcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    predict_eval as pcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    decode_png,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    checkpoint as pckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    evaluate as pev,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from torch_donor_common import donor_state_dict
from torch_eval_common import (
    IMG,
    csv_numbers,
    read_csv,
    seeded_variables,
    small_models,
    write_weights,
)
from torch_port_common import ASSETS, TREE_FILES, trees

TREE_ARGS = ["--tree-root", str(ASSETS / TREE_FILES["default"][0]),
             "--class-map", str(ASSETS / TREE_FILES["default"][1])]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pe_data"))
    write_synth_dataset(root, 5, size=IMG, seed=7)
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jtree, ptree = trees("default")
    return {mt: write_weights(str(tmp_path_factory.mktemp(f"pw{mt}")), jtree,
                              ptree, mt, seed=6)
            for mt in (1, 0)}


def _parser(module, monkeypatch):
    """The ArgumentParser that ``module.get_args`` builds."""
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args",
                  lambda self, argv=None: self)
        return module.get_args([])


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.required)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_match_jax(monkeypatch):
    ported = _flags(_parser(pcli, monkeypatch))
    reference = _flags(_parser(jcli, monkeypatch))
    assert ported.pop("device") == (("--device",), "cuda", None, str, False)
    assert ported == reference


def test_cli_expands_folds(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(pev, "predict_eval",
                        lambda *a, **k: calls.append((a, k)) or ["done"])
    os.makedirs(tmp_path / "w" / "fold_1" / "best.ckpt")
    argv = ["--save-loc", "run", "--full-ds", str(tmp_path / "d"),
            "--model-weights", str(tmp_path / "w"), "--folds", "2",
            "--val-batch", "3", "--tta", "True", "--device", "cpu",
            "--num-workers", "-1"] + TREE_ARGS
    assert pcli.main(argv) == ["done"]
    (cfg, weights, roots, save_root, save_images), kw = calls[0]
    assert roots == [str(tmp_path / "d" / f"fold_{i}" / "val")
                     for i in (1, 2)]
    # fold 2 has no best.ckpt: the reference's best.pt name
    assert weights == [str(tmp_path / "w" / "fold_1" / "best.ckpt"),
                       str(tmp_path / "w" / "fold_2" / "best.pt")]
    assert save_root == os.path.join("./Predictions", "run")
    assert save_images is True and kw == {"device": "cpu"}
    assert (cfg.val_batch, cfg.tta, cfg.num_workers, cfg.model_type,
            cfg.compute_dtype, cfg.eval_inflight) == (3, True, 8, 0,
                                                      "float32", 4)
    # without cross-validation: the paths as given
    pcli.main(argv + ["--inc-cross-val", "False"])
    _, weights, roots, _, _ = calls[1][0]
    assert (weights, roots) == ([str(tmp_path / "w")], [str(tmp_path / "d")])


def test_cli_at_full_width_prints_the_jax_parameter_count(
        tmp_path, data_root, monkeypatch, capsys):
    """The CLI end to end at the default model's full width (the
    hierarchical UNet, base width 64) on the CPU, at 32 px: the printed
    parameter count equals the JAX model's, and the output lands under
    ./Predictions/<save-loc>/."""
    jtree, ptree = trees("default")
    model = build_model(ptree, 0, 1)
    ckpt = str(tmp_path / "best.ckpt")
    pckpt.save_checkpoint(ckpt, create_train_state(model, 0.0), epoch=1)
    jmodel = jax_build_model(jtree, 0, 1)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))
    monkeypatch.chdir(tmp_path)
    res = pcli.main(["--save-loc", "full", "--full-ds", data_root,
                     "--model-weights", ckpt, "--inc-cross-val", "False",
                     "--model-type", "1", "--img-size", str(IMG),
                     "--val-batch", "2", "--device", "cpu"] + TREE_ARGS)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("Number of model parameters: "))
    assert int(line.split(":")[1]) == want == sum(
        p.numel() for p in model.parameters())
    assert "FINISHED TESTING" in out
    fold = tmp_path / "Predictions" / "full" / "fold_1"
    rows = read_csv(fold / "metrics.csv")
    assert len(rows) == 1 + 1 + 8 and np.isfinite(csv_numbers(rows)).all()
    assert len(os.listdir(fold / "7")) == 5
    assert set(res[0]["seconds"]) == {"total", "loader_wait"}


def _refusal_argv(weights_path, root="unused"):
    return ["--save-loc", "x", "--full-ds", root, "--model-weights",
            weights_path, "--inc-cross-val", "False", "--device", "cpu",
            "--model-type", "1"] + TREE_ARGS


@pytest.mark.parametrize("case", ["quantize", ".pt", ".pth", "orbax"])
def test_cli_refusals(case, data_root, weights, tmp_path, monkeypatch,
                      capsys):
    """A JAX orbax checkpoint is refused; donor ``.pt``/``.pth`` weights
    (the reference's names) load, as in the JAX CLI, also under
    ``--quantize True``."""
    monkeypatch.chdir(tmp_path)
    jax_ckpt, port_ckpt = weights[1]
    if case == "orbax":
        # the JAX trainer's fold_N/best.ckpt name, through the fold expansion
        os.makedirs(tmp_path / "run" / "fold_1")
        os.symlink(jax_ckpt, tmp_path / "run" / "fold_1" / "best.ckpt")
        write_synth_dataset(str(tmp_path / "data"), 4, size=IMG, seed=1,
                            folds=1)
        argv = ["--save-loc", "x", "--full-ds", str(tmp_path / "data"),
                "--model-weights", str(tmp_path / "run"), "--folds", "1",
                "--device", "cpu", "--model-type", "1"] + TREE_ARGS
        match = r"holds no state\.pt.*JAX package's orbax checkpoint"
        with pytest.raises(NotImplementedError, match=match):
            pcli.main(argv)
        return
    small_models(monkeypatch, jax_side=False)
    params, stats = seeded_variables(trees("default")[0], 1, seed=6)
    donor = tmp_path / f"donor{'.pt' if case == 'quantize' else case}"
    torch.save(donor_state_dict(params, stats, 0), donor)
    argv = _refusal_argv(str(donor), data_root) + ["--img-size", str(IMG)]
    if case == "quantize":
        argv += ["--quantize", "True"]
    pcli.main(argv)
    n = len(pckpt.load_state(port_ckpt)["model"])
    assert f"Loaded {n} / {n} layers." in capsys.readouterr().out
    assert (tmp_path / "Predictions" / "x" / "fold_1" / "metrics.csv") \
        .is_file()


@pytest.mark.parametrize("tta", ["False", "True"])
def test_cli_quantize_against_jax(tta, data_root, weights, tmp_path,
                                  monkeypatch):
    """--quantize True through both CLIs on the same weights and files, at
    --val-batch 2: calibration on the first --calib-batches 4 batches,
    whose ragged third is padded. Per-class Dice within 0.05 of the JAX
    CLI's, as the JAX test holds the quantized run to the float one."""
    small_models(monkeypatch)
    monkeypatch.chdir(tmp_path)
    jax_ckpt, port_ckpt = weights[1]
    common = ["--full-ds", data_root, "--inc-cross-val", "False",
              "--model-type", "1", "--img-size", str(IMG), "--val-batch",
              "2", "--quantize", "True", "--tta", tta] + TREE_ARGS
    jres = jcli.main(["--save-loc", "jax", "--model-weights", jax_ckpt]
                     + common)
    pres = pcli.main(["--save-loc", "port", "--model-weights", port_ckpt,
                      "--device", "cpu"] + common)
    jd = np.array([c["dice"] for c in jres[0]["per_class"]])
    pd = np.array([c["dice"] for c in pres[0]["per_class"]])
    assert len(pd) == len(jd) == 8
    assert np.abs(pd - jd).max() < 0.05, (pd, jd)
    fold = tmp_path / "Predictions" / "port" / "fold_1"
    rows = read_csv(fold / "metrics.csv")
    assert len(rows) == 1 + 1 + 8 and np.isfinite(csv_numbers(rows)).all()
    # the scoring pass, after calibration, starts from the first image
    assert sorted(os.listdir(fold / "7")) == sorted(
        os.listdir(os.path.join(data_root, "labels")))


def _run(cfg_kw, data_root, weights_path, save_root):
    tree, cmap = (str(ASSETS / f) for f in TREE_FILES["default"])
    cfg = RunConfig(tree_root=tree, class_map=cmap, model_select=0,
                    img_size=IMG, num_workers=2, **cfg_kw)
    return pev.predict_eval(cfg, [weights_path], [data_root], save_root,
                            device="cpu")[0]


@pytest.mark.parametrize("model_type", [1, 0])
def test_val_batch_3_equals_val_batch_1(model_type, data_root, weights,
                                        tmp_path, monkeypatch):
    """5 images at val_batch 3: a full batch, then 2 images padded to 3."""
    small_models(monkeypatch, jax_side=False)
    w = weights[model_type][1]
    r1 = _run(dict(model_type=model_type, val_batch=1), data_root, w,
              str(tmp_path / "b1"))
    r3 = _run(dict(model_type=model_type, val_batch=3), data_root, w,
              str(tmp_path / "b3"))
    for m1, m3 in zip(r1["per_class"], r3["per_class"]):
        for k in m1:
            np.testing.assert_allclose(m3[k], m1[k], rtol=1e-6,
                                       err_msg=f"{model_type} {k}")
    np.testing.assert_allclose(r3["measure"], r1["measure"], rtol=1e-6)
    d1, d3 = tmp_path / "b1" / "fold_1", tmp_path / "b3" / "fold_1"
    np.testing.assert_allclose(csv_numbers(read_csv(d3 / "metrics.csv")),
                               csv_numbers(read_csv(d1 / "metrics.csv")),
                               rtol=1e-6)
    for c in range(8):
        names = sorted(os.listdir(d1 / str(c)))
        assert names == sorted(os.listdir(d3 / str(c))) and len(names) == 5
        for n in names:
            with open(d1 / str(c) / n, "rb") as a, \
                    open(d3 / str(c) / n, "rb") as b:
                np.testing.assert_array_equal(decode_png(a.read()),
                                              decode_png(b.read()))


def test_evaluator_bounded_inflight(data_root, weights, monkeypatch):
    """With eval_inflight=1 the evaluator consumes results WHILE
    dispatching: the oldest batch is consumed before the next dispatch, so
    at most one batch's results are on the device at any moment (the JAX
    test_round3_safety.py::test_evaluator_bounded_inflight)."""
    small_models(monkeypatch, jax_side=False)
    tree, cmap = (str(ASSETS / f) for f in TREE_FILES["default"])
    cfg = RunConfig(tree_root=tree, class_map=cmap, model_select=0,
                    model_type=1, img_size=IMG, val_batch=1, num_workers=2,
                    eval_inflight=1)
    ev = pev.Evaluator(cfg, trees("default")[1], data_root, weights[1][1],
                       save_dir=None, save_images=False, device="cpu")
    assert ev.inflight == 1
    events = []
    real_step, real_consume = ev.eval_step, ev._consume

    def step_spy(*a, **k):
        events.append("dispatch")
        return real_step(*a, **k)

    def consume_spy(*a, **k):
        events.append("consume")
        return real_consume(*a, **k)

    ev.eval_step = step_spy
    ev._consume = consume_spy
    res = ev.run()
    n_batches = events.count("dispatch")
    assert n_batches == 5 and events.count("consume") == n_batches
    # dispatch, consume, dispatch, ...: append-then-pop would hold two
    assert events == ["dispatch"] + ["consume", "dispatch"] * 4 + ["consume"]
    assert 0.0 <= res["overall"]["dice"] <= 1.0


@pytest.mark.parametrize("enabled", [True, False])
def test_float32_convs_sets_tf32_off_and_restores(enabled, monkeypatch):
    """The Evaluator's f32 runs on the card compute their convolutions and
    matmuls in float32 (PyTorch allows TF32 for cuDNN by default), and
    leave the flags as they found them."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pev._float32_convs(enabled):
        assert torch.backends.cudnn.allow_tf32 is not enabled
        assert torch.backends.cuda.matmul.allow_tf32 is not enabled
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(RuntimeError):
        with pev._float32_convs(enabled):
            raise RuntimeError
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32

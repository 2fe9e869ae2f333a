"""The port's training entry point end to end on the CPU (``--device cpu``):
``cli/train.py`` -> ``train/loop.py:Trainer`` -> the augmenting data chain
-> the train and eval steps, with the UNet shrunk to base width 8 (as
``tests/test_resume.py`` does for the JAX trainer) at 32 px.

Held: two folds train and dump prediction images (``tests/test_e2e.py``);
2 epochs and a resume to 4, and ``--auto-resume``, equal an uninterrupted
4-epoch run to rtol 1e-4 with the same best epoch and final ``sched_lr``
(``tests/test_resume.py``); the same seed writes a byte-identical
metrics.csv; the ``Predictor`` and the serve CLI read the trainer's
``best.ckpt``; the CLI has every flag of the JAX CLI with its default and
choices, and refuses grain (``--fold-parallel`` trains:
``tests/test_torch_fold_parallel.py``, as ``--dist-coordinator`` does:
``tests/test_torch_distributed.py`` and ``--n-space`` above 1:
``tests/test_torch_space_trainer.py``; donor ``.pth`` weights are read:
``tests/test_torch_donor_import.py``); ``--remat True|module|conv`` and
``--profile-dir`` train (also beside ``--dist-coordinator``) and write the
same metrics.csv as the run without them, ``--profile-dir`` one trace
file (``tests/test_torch_remat.py``, ``tests/test_torch_profiling.py``);
``--device-data True`` trains, and resumes as an unbroken run.
"""
import argparse
import csv
import glob
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    train as jcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.loop import (
    CSV_HEADER as JAX_CSV_HEADER,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    train as pcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop,
)

from torch_trainer_common import numbers, small_model

RESUME_RTOL = 1e-4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_trainer")
    write_synth_dataset(str(root), 6, size=96, seed=3, folds=2)
    return str(root)


def argv(save, root, assets_dir, *extra, epochs=2, folds=1):
    return ["--save-path", str(save), "--data-root", root,
            "--tree-root", str(assets_dir / "class_tree_tl.json"),
            "--class-map", str(assets_dir / "class_map.csv"),
            "--model-type", "1", "--img-size", "32", "--batch-size", "2",
            "--learning-rate", "[1e-3]", "--num-workers", "2",
            "--folds", str(folds), "--epochs", str(epochs),
            "--device", "cpu", *extra]


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_two_folds_train_and_dump_images(tmp_path, data, assets_dir,
                                         monkeypatch):
    small_model(monkeypatch)
    results = pcli.main(argv(tmp_path / "run", data, assets_dir,
                             "--save-images-batch", "True",
                             "--save-images-batch-num", "1", folds=2))
    assert len(results) == 2 and all(np.isfinite(results))
    for fold in (1, 2):
        d = tmp_path / "run" / f"fold_{fold}"
        for name in ("best.ckpt", "last.ckpt"):
            assert sorted(os.listdir(d / name)) == ["rhss_meta.json",
                                                    "state.pt"]
        rows = read_csv(d / "metrics.csv")
        assert rows[0] == JAX_CSV_HEADER
        assert [r[0] for r in rows[1:]] == ["1", "2"]
        assert all(np.isfinite(float(r[1])) and float(r[1]) > 0
                   for r in rows[1:])
        with open(d / "logs" / "metrics.jsonl") as f:
            assert [json.loads(ln)["step"] for ln in f] == [1, 1, 2, 2]
    imgs = glob.glob(str(tmp_path / "run" / "fold_1" / "images" / "*" /
                         "*.png"))
    # 4 + 4 classes, epochs 1 and 2
    assert len(imgs) == 16


def _assert_rows_close(rows_a, rows_b, rtol=RESUME_RTOL):
    assert rows_b[0] == rows_a[0]
    assert [r[0] for r in rows_b] == [r[0] for r in rows_a]
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        for name, ca, cb in zip(rows_a[0], ra, rb):
            np.testing.assert_allclose(numbers(cb), numbers(ca), rtol=rtol,
                                       atol=1e-6,
                                       err_msg=f"epoch {ra[0]}, {name}")


def _meta(d, name):
    with open(os.path.join(d, name, "rhss_meta.json")) as f:
        return json.load(f)


def test_resume_and_auto_resume_match_uninterrupted(tmp_path, data,
                                                    assets_dir, monkeypatch):
    small_model(monkeypatch)
    total = 4
    pcli.main(argv(tmp_path / "a", data, assets_dir, epochs=total))
    dir_a = tmp_path / "a" / "fold_1"
    rows_a = read_csv(dir_a / "metrics.csv")
    assert len(rows_a) == total + 1

    # 2 epochs, then --model-weights last.ckpt to 4
    pcli.main(argv(tmp_path / "b", data, assets_dir, epochs=2))
    dir_b = tmp_path / "b" / "fold_1"
    first = read_csv(dir_b / "metrics.csv")
    pcli.main(argv(tmp_path / "b", data, assets_dir, "--model-weights",
                   str(dir_b / "last.ckpt"), epochs=total))
    rows_b = read_csv(dir_b / "metrics.csv")
    assert rows_b[:3] == first  # the resume keeps rows 1-2 as written

    # 2 epochs, then --auto-resume True to 4
    pcli.main(argv(tmp_path / "c", data, assets_dir, epochs=2))
    pcli.main(argv(tmp_path / "c", data, assets_dir, "--auto-resume", "True",
                   epochs=total))
    dir_c = tmp_path / "c" / "fold_1"
    rows_c = read_csv(dir_c / "metrics.csv")

    for d, rows in ((dir_b, rows_b), (dir_c, rows_c)):
        _assert_rows_close(rows_a, rows)
        ma, mb = _meta(dir_a, "best.ckpt"), _meta(d, "best.ckpt")
        assert ma["epoch"] == mb["epoch"]
        np.testing.assert_allclose(mb["test_measure_mean"],
                                   ma["test_measure_mean"], rtol=RESUME_RTOL)
        np.testing.assert_allclose(_meta(d, "last.ckpt")["sched_lr"],
                                   _meta(dir_a, "last.ckpt")["sched_lr"],
                                   rtol=1e-6)
        assert _meta(d, "last.ckpt")["epoch"] == total


def test_same_seed_writes_the_same_metrics_csv(tmp_path, data, assets_dir,
                                               monkeypatch):
    small_model(monkeypatch)
    for run in ("x", "y"):
        pcli.main(argv(tmp_path / run, data, assets_dir, "--seed", "7"))
    a = (tmp_path / "x" / "fold_1" / "metrics.csv").read_bytes()
    b = (tmp_path / "y" / "fold_1" / "metrics.csv").read_bytes()
    assert a == b


def test_predictor_and_serve_cli_read_the_trainers_checkpoint(
        tmp_path, data, assets_dir, monkeypatch):
    small_model(monkeypatch)
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
        serve,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.serving import (
        Predictor,
    )

    args = pcli.get_args(argv(tmp_path / "p", data, assets_dir, epochs=1))
    cfg = pcli.config_from_args(args)
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    fold = os.path.join(data, "fold_1")
    trainer = loop.Trainer(cfg, tree, os.path.join(fold, "train"),
                           os.path.join(fold, "val"),
                           str(tmp_path / "p" / "fold_1"), device="cpu")
    try:
        trainer.run()  # one epoch: best.ckpt holds the final state
    finally:
        trainer.close()
    best = str(tmp_path / "p" / "fold_1" / "best.ckpt")
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    trainer.model.eval()
    with torch.inference_mode():
        want = trainer.model(torch.from_numpy(x))

    pred = Predictor(cfg, best, tree=tree, device="cpu")
    got = pred(x)
    for g, w in zip(got["logits"], want.logits_per_level):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-6)
    # the serve CLI takes the same directory
    sargs = serve.get_args(["--model-weights", best, "--tree-root",
                            cfg.tree_root, "--class-map", cfg.class_map,
                            "--img-size", "32", "--model-type", "1",
                            "--compute-dtype", "float32", "--device", "cpu",
                            "--warmup", "False", "--port", "0"])
    server = serve.build_server(sargs)
    server.server_close()


def _parser_actions(get_args):
    """The argparse actions of a CLI's ``get_args`` (its parser captured at
    ``parse_args``)."""
    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        return argparse.Namespace()

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        get_args([])
    return {a.dest: a for a in seen["parser"]._actions if a.dest != "help"}


def test_cli_has_every_jax_flag_with_its_default():
    want, got = _parser_actions(jcli.get_args), _parser_actions(pcli.get_args)
    assert len(want) == 51
    assert set(got) == set(want) | {"device"}
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices, b.type, b.required) \
            == (a.option_strings, a.default, a.choices, a.type, a.required), \
            dest
    assert got["device"].default == "cuda"


@pytest.mark.parametrize("flags,item", [
    (["--loader", "grain"], "grain is a JAX input pipeline with no "
                            "counterpart"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, assets_dir, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        pcli.main(argv(tmp_path / "r", str(tmp_path / "no_data"),
                       assets_dir) + flags)
    assert not (tmp_path / "r").exists() or not any(
        (tmp_path / "r").rglob("*.ckpt"))


@pytest.mark.parametrize("flags", [
    ["--remat", "True"],
    ["--remat", "module"],
    ["--remat", "conv"],
    ["--profile-dir", "PROFILE"],
    ["--dist-coordinator", "COORDINATOR", "--remat", "True"],
])
def test_cli_trains_with_remat_and_profile_dir(tmp_path, data, assets_dir,
                                               monkeypatch, flags):
    """The options the CLI refused until the rest of ROADMAP item 8 was
    ported: each trains two epochs and writes the metrics.csv of the run
    without it (the same ops, recomputed or traced); ``--profile-dir``
    writes one trace, of epoch 2; the coordinator runs at world size 1."""
    from torch_dist_common import free_port

    small_model(monkeypatch)
    subst = {"PROFILE": str(tmp_path / "prof"),
             "COORDINATOR": f"127.0.0.1:{free_port()}"}
    flags = [subst.get(f, f) for f in flags]
    if "--dist-coordinator" in flags:
        flags += ["--dist-procs", "1", "--dist-proc-id", "0"]
    plain = pcli.main(argv(tmp_path / "plain", data, assets_dir))
    got = pcli.main(argv(tmp_path / "r", data, assets_dir) + flags)
    assert got == plain and np.isfinite(got[0])
    assert read_csv(tmp_path / "r" / "fold_1" / "metrics.csv") == \
        read_csv(tmp_path / "plain" / "fold_1" / "metrics.csv")
    if "--profile-dir" in flags:
        traces = os.listdir(tmp_path / "prof")
        assert len(traces) == 1 and traces[0].startswith("rank0.") \
            and traces[0].endswith(".pt.trace.json"), traces


def test_cli_device_data_trains_on_cpu(tmp_path, data, assets_dir,
                                      monkeypatch):
    """``--device-data True`` trains with the training set on ``--device``
    (here the CPU); validation stays on the host chain."""
    small_model(monkeypatch)
    results = pcli.main(argv(tmp_path / "dd", data, assets_dir,
                             "--device-data", "True"))
    assert len(results) == 1 and np.isfinite(results[0])
    rows = read_csv(tmp_path / "dd" / "fold_1" / "metrics.csv")
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert all(np.isfinite(float(r[1])) and float(r[1]) > 0
               for r in rows[1:])


def test_device_data_resume_matches_uninterrupted(tmp_path, data, assets_dir,
                                                  monkeypatch):
    """A ``--device-data True`` run of 1 epoch resumed to 3 equals an
    unbroken 3-epoch run: each batch's draws depend on (seed, epoch,
    batch) alone."""
    small_model(monkeypatch)
    flags = ("--device-data", "True")
    pcli.main(argv(tmp_path / "a", data, assets_dir, *flags, epochs=3))
    pcli.main(argv(tmp_path / "b", data, assets_dir, *flags, epochs=1))
    dir_b = tmp_path / "b" / "fold_1"
    pcli.main(argv(tmp_path / "b", data, assets_dir, *flags,
                   "--model-weights", str(dir_b / "last.ckpt"), epochs=3))
    _assert_rows_close(read_csv(tmp_path / "a" / "fold_1" / "metrics.csv"),
                       read_csv(dir_b / "metrics.csv"))


def test_fold_parallel_over_one_fold_trains_as_usual():
    cfg = pcli.config_from_args(pcli.get_args(
        ["--save-path", "s", "--data-root", "d", "--tree-root", "t",
         "--class-map", "c", "--fold-parallel", "True", "--folds", "1"]))
    loop.check_supported(cfg)  # one fold: nothing to run in parallel


def test_cuda_without_a_card_raises(tmp_path, data, assets_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = argv(tmp_path / "g", data, assets_dir)
    args = args[:args.index("--device")]  # the default: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(args)


def test_multi_gpu_flag_prints_the_jax_message(tmp_path, assets_dir, capsys):
    with pytest.raises(NotImplementedError):
        pcli.main(argv(tmp_path / "m", "x", assets_dir, "--multi-gpu", "true",
                       "--loader", "grain"))
    assert "--multi-gpu is ignored" in capsys.readouterr().out

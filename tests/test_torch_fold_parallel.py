"""Fold-parallel training in the port (``train/fold_parallel.py``) on the
CPU, against the JAX ``FoldParallelTrainer`` and the port's sequential
``Trainer`` (the UNet at base width 8, 32 px, batch 2, two folds of 8 + 2
synthetic images, as JAX ``tests/test_fold_parallel.py`` cuts it).

* One lockstep step equals the JAX ``FoldParallelTrainer``'s per fold
  (its ``(fold=2, data=2)`` mesh over the 8 CPU devices: global-batch
  BatchNorm inside each fold group), from the JAX trainer's initial
  weights through ``bridge.py`` and on the JAX batches, with the JAX test's
  tolerances (``test_step_parity_with_sequential``: loss rtol 1e-5,
  per-level rtol 1e-4 / atol 1e-6, parameters on the significant-update
  criterion) and the port's against JAX's default BatchNorm for the
  statistics (1e-4 of each tensor's largest value).
* A fold-parallel epoch equals the port's sequential ``Trainer`` per fold:
  the same metrics.csv rows, the same best metric (each fold is the same
  computation; only the order of the folds' steps differs). So do its
  compositions with ``grad_accum`` and ``device_data``; two ranks each
  training one fold (``(fold=2, data=1)`` mesh) agree with one process
  within rtol 1e-4 (one process at the ranks' two threads each).
* Lockstep ``auto_resume`` (all or nothing), ``best_save="end"`` through
  the checkpoint manager's defer hooks, the refusal of a ``.ckpt``
  ``model_weights``, the surplus batches of a longer fold dropped and
  logged, and the train CLI's ``--fold-parallel True`` with its
  ``concurrent_folds`` log key.
* ``tools/multirank_check.py`` (the train CLI on N ranks against one
  process) on two CPU ranks.
"""
import csv
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    loop as jloop,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.fold_parallel import (
    FoldParallelTrainer as JaxFoldParallelTrainer,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    train as pcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop as ploop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.fold_parallel import (
    FoldParallelTrainer,
)
from torch_dist_common import rank_threads, run_ranks, train_job
from torch_port_common import trees
from torch_trainer_common import JAX_PKG, jax_small_model, numbers, small_model

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
RESUME_RTOL = 1e-4  # tests/test_torch_trainer.py
# BatchNorm statistics against JAX's LeanBatchNorm: 1e-4 of the tensor's
# largest value (tests/torch_train_common.py:STATS_RTOL["default"]; its
# batch variance cancels in f32)
STATS_RTOL = 1e-4
# one process against ranks of their own (both at the ranks' two threads,
# rank_threads; the folds' batches still differ in order of adds): the
# resume tolerance
PROCESS_RTOL = 1e-4


def _kw(data, save, **kw):
    base = dict(save_path=str(save), data_root=data,
                tree_root=str(ASSETS / "class_tree_tl.json"),
                class_map=str(ASSETS / "class_map.csv"), model_select=0,
                model_type=1, img_size=32, epochs=1, batch_size=2,
                folds=2, inc_cross_val=True, lr=1e-3, num_workers=2, seed=0)
    base.update(kw)
    return base


def _cfg(data, save, **kw):
    return RunConfig(**_kw(data, save, **kw))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("fp_data")
    write_synth_dataset(str(root), 8, size=64, seed=3, folds=2)
    return str(root)


def _same_runs(a, b, folds=(1, 2)):
    """metrics.csv of each fold equal, row for row."""
    for fold in folds:
        rows_a = _rows(os.path.join(a, f"fold_{fold}", "metrics.csv"))
        rows_b = _rows(os.path.join(b, f"fold_{fold}", "metrics.csv"))
        assert rows_a == rows_b, fold


def test_step_parity_with_the_jax_fold_parallel_trainer(data, tmp_path,
                                                        monkeypatch):
    small_model(monkeypatch)
    jax_small_model(monkeypatch)
    # the JAX fold-parallel trainer builds through its own name
    monkeypatch.setattr(f"{JAX_PKG}.train.fold_parallel.build_model",
                        jloop.build_model)
    jtree, ptree = trees("default")
    kw = _kw(data, tmp_path / "j")
    jfp = JaxFoldParallelTrainer(JaxRunConfig(**kw), jtree, [1, 2])
    try:
        assert jfp.mesh.devices.shape == (2, 2, 1)
        params0, stats0 = jax.device_get(jax.tree_util.tree_map(
            lambda l: l[0], (jfp.state.params, jfp.state.batch_stats)))
        x, y = next(jfp._stacked_batches(1))
        x, y = np.asarray(x), np.asarray(y)
        mask = jnp.ones((jfp.n_levels,), jnp.float32)
        new, aux = jax.device_get(jfp.train_step(jfp.state, x, y, mask))
    finally:
        jfp.close()
    sd0 = state_dict_from_flax(params0, stats0)
    fp = FoldParallelTrainer(_cfg(data, tmp_path / "p"), ptree, [1, 2],
                             device="cpu")
    try:
        for f, t in enumerate(fp.trainers):
            t.model.load_state_dict(sd0, strict=True)
            paux = t.step(torch.from_numpy(x[f]), torch.from_numpy(y[f]),
                          torch.ones(2), 1, 1)
            want = state_dict_from_flax(*jax.tree_util.tree_map(
                lambda l: np.asarray(l)[f], (new.params, new.batch_stats)))
            np.testing.assert_allclose(float(paux["loss"]),
                                       float(np.asarray(aux["loss"])[f]),
                                       rtol=1e-5)
            np.testing.assert_allclose(paux["per_level"].numpy(),
                                       np.asarray(aux["per_level"])[f],
                                       rtol=1e-4, atol=1e-6)
            got = t.model.state_dict()
            n_sig = n_bad = 0
            for k, v in want.items():
                g = got[k].numpy()
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(
                        g, v.numpy(), rtol=0,
                        atol=STATS_RTOL * np.abs(v.numpy()).max(), err_msg=k)
                    continue
                up, us = g - sd0[k].numpy(), v.numpy() - sd0[k].numpy()
                sig = np.abs(us) > 0.5 * 1e-3
                n_sig += int(sig.sum())
                n_bad += int((~np.isclose(up[sig], us[sig], rtol=0.1,
                                          atol=0.1 * 1e-3)).sum())
            assert n_sig > 1000 and n_bad / n_sig < 0.01, (f, n_sig, n_bad)
    finally:
        fp.close()


def test_epoch_matches_sequential(data, tmp_path, monkeypatch):
    small_model(monkeypatch)
    seq = ploop.train(_cfg(data, tmp_path / "seq"), device="cpu")
    par = ploop.train(_cfg(data, tmp_path / "par", fold_parallel=True),
                      device="cpu")
    assert len(seq) == len(par) == 2 and seq == par
    _same_runs(tmp_path / "seq", tmp_path / "par")
    for fold in (1, 2):
        for name in ("best.ckpt", "last.ckpt"):
            assert (tmp_path / "par" / f"fold_{fold}" / name).exists()


@pytest.mark.parametrize("kw", [dict(batch_size=4, grad_accum=2),
                                dict(device_data=True)],
                         ids=["grad_accum", "device_data"])
def test_composes_as_sequential(kw, data, tmp_path, monkeypatch):
    small_model(monkeypatch)
    ploop.train(_cfg(data, tmp_path / "seq", **kw), device="cpu")
    ploop.train(_cfg(data, tmp_path / "par", fold_parallel=True, **kw),
                device="cpu")
    _same_runs(tmp_path / "seq", tmp_path / "par")


def test_auto_resume_lockstep(data, tmp_path, monkeypatch, capsys):
    small_model(monkeypatch)
    out = tmp_path / "resume"
    ploop.train(_cfg(data, out, fold_parallel=True), device="cpu")
    ploop.train(_cfg(data, out, fold_parallel=True, epochs=2,
                     auto_resume=True), device="cpu")
    assert "all 2 folds at epoch 1, resuming" in capsys.readouterr().out
    ploop.train(_cfg(data, tmp_path / "whole", fold_parallel=True, epochs=2),
                device="cpu")
    for fold in (1, 2):
        rows = _rows(out / f"fold_{fold}" / "metrics.csv")
        whole = _rows(tmp_path / "whole" / f"fold_{fold}" / "metrics.csv")
        assert [r[0] for r in rows] == [r[0] for r in whole] == [
            "Epoch", "1", "2"]
        for ra, rb in zip(whole[1:], rows[1:]):
            for name, a, b in zip(whole[0], ra, rb):
                np.testing.assert_allclose(numbers(b), numbers(a),
                                           rtol=RESUME_RTOL, atol=1e-6,
                                           err_msg=name)


def test_partial_resume_starts_fresh(data, tmp_path, monkeypatch, capsys):
    small_model(monkeypatch)
    out = tmp_path / "partial"
    ploop.train(_cfg(data, out, fold_parallel=True), device="cpu")
    shutil.rmtree(out / "fold_2" / "last.ckpt")
    ploop.train(_cfg(data, out, fold_parallel=True, epochs=2,
                     auto_resume=True), device="cpu")
    assert "not every fold has a last.ckpt — starting fresh" in \
        capsys.readouterr().out
    for fold in (1, 2):
        rows = _rows(out / f"fold_{fold}" / "metrics.csv")
        assert [r[0] for r in rows] == ["Epoch", "1", "2"]


def test_best_save_end_through_the_defer_hooks(data, tmp_path, monkeypatch):
    """best_save="end": each fold's improvements are kept by the trainer's
    snapshot hook, and finalize() writes a best.ckpt whose meta is the
    fold's best metrics.csv row."""
    small_model(monkeypatch)
    snaps = []
    real = FoldParallelTrainer._snap_best
    monkeypatch.setattr(FoldParallelTrainer, "_snap_best",
                        lambda self, f: snaps.append(f) or real(self, f))
    out = tmp_path / "defer"
    ploop.train(_cfg(data, out, fold_parallel=True, epochs=3,
                     best_save="end", ckpt_every=100), device="cpu")
    assert set(snaps) == {0, 1}
    for fold in (1, 2):
        loc = out / f"fold_{fold}"
        rows = _rows(loc / "metrics.csv")
        measures = [float(r[16]) for r in rows[1:]]
        with open(loc / "best.ckpt" / "rhss_meta.json") as f:
            meta = json.load(f)
        assert meta["epoch"] == int(np.argmax(measures)) + 1
        np.testing.assert_allclose(meta["test_measure_mean"], max(measures),
                                   rtol=1e-6)


def test_rejects_a_ckpt_model_weights(data, tmp_path):
    cfg = _cfg(data, tmp_path / "x", fold_parallel=True,
               model_weights="some/dir/last.ckpt")
    with pytest.raises(ValueError, match="auto-resume"):
        ploop.train(cfg, device="cpu")


def test_surplus_batches_of_a_longer_fold_are_dropped(data, tmp_path,
                                                      monkeypatch, capsys):
    small_model(monkeypatch)
    root = tmp_path / "uneven"
    shutil.copytree(data, root)
    for sub in ("images", "labels"):
        d = root / "fold_2" / "train" / sub
        for name in sorted(os.listdir(d))[:2]:
            os.remove(d / name)
    ploop.train(_cfg(str(root), tmp_path / "out", fold_parallel=True),
                device="cpu")
    assert "folds have [4, 3] batches; running 3 lockstep steps" in \
        capsys.readouterr().out
    for fold in (1, 2):
        with open(tmp_path / "out" / f"fold_{fold}" / "logs" /
                  "metrics.jsonl") as f:
            train_line = json.loads(f.readline())
        assert train_line["train/concurrent_folds"] == 2


def test_cli_fold_parallel_trains_every_fold(data, tmp_path, assets_dir,
                                             monkeypatch):
    small_model(monkeypatch)
    res = pcli.main(["--save-path", str(tmp_path / "cli"), "--data-root",
                     data, "--tree-root",
                     str(assets_dir / "class_tree_tl.json"), "--class-map",
                     str(assets_dir / "class_map.csv"), "--model-type", "1",
                     "--img-size", "32", "--batch-size", "2",
                     "--learning-rate", "[1e-3]", "--num-workers", "2",
                     "--folds", "2", "--epochs", "1", "--fold-parallel",
                     "True", "--device", "cpu"])
    assert len(res) == 2 and all(np.isfinite(res))
    for fold in (1, 2):
        d = tmp_path / "cli" / f"fold_{fold}"
        assert {"best.ckpt", "last.ckpt", "metrics.csv"} <= set(os.listdir(d))


def test_two_ranks_train_a_fold_each(data, tmp_path, monkeypatch):
    """Two ranks, two folds, batch 2: a (fold=2, data=1) mesh, so rank r
    trains fold r + 1 alone and writes its files; the runs equal one
    process's, and every rank returns both folds' best metrics."""
    small_model(monkeypatch)
    with rank_threads():
        one = ploop.train(_cfg(data, tmp_path / "one", fold_parallel=True),
                          device="cpu")
    two = run_ranks(train_job, 2, tmp_path,
                    _kw(data, tmp_path / "two", fold_parallel=True))
    assert two[0] == two[1]
    np.testing.assert_allclose(two[0], one, rtol=PROCESS_RTOL)
    for fold in (1, 2):
        want = _rows(tmp_path / "one" / f"fold_{fold}" / "metrics.csv")
        got = _rows(tmp_path / "two" / f"fold_{fold}" / "metrics.csv")
        assert got[0] == want[0] and len(got) == len(want) == 2
        for name, a, b in zip(want[0], want[1], got[1]):
            np.testing.assert_allclose(numbers(b), numbers(a),
                                       rtol=PROCESS_RTOL, atol=1e-6,
                                       err_msg=name)


def test_multirank_check_on_two_cpu_ranks(tmp_path):
    """``tools/multirank_check.py`` on two gloo ranks of the CPU: the data
    axis and two folds over (fold=2, data=1), each against one process of
    the train CLI, within its stated tolerances."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.tools import (
        multirank_check,
    )

    with pytest.raises(SystemExit):
        multirank_check.main(["--ranks", "3", "--device", "cpu"])
    assert multirank_check.main([
        "--ranks", "2", "--device", "cpu", "--img-size", "32",
        "--images", "16", "--epochs", "1", "--out", str(tmp_path)]) == 0
    for run in ("data_axis", "fold_parallel"):
        assert (tmp_path / run / "ranks" / "fold_1" / "best.ckpt").is_dir()


def test_multirank_check_runs_its_commands_at_once():
    """The tool's runner (the reference beside ranks that share cards):
    every command's own wall time, and a failing command raises with its
    exit code and output."""
    import sys

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.tools import (
        multirank_check,
    )

    walls = multirank_check._run(
        [[sys.executable, "-c", "pass"],
         [sys.executable, "-c", "import time; time.sleep(3.0)"]], 60)
    assert len(walls) == 2 and walls[1] >= 3.0
    assert walls[0] < walls[1]  # each command's own end, not the last's
    with pytest.raises(RuntimeError, match=r"exit codes \[0, 3\]"):
        multirank_check._run(
            [[sys.executable, "-c", "pass"],
             [sys.executable, "-c", "import sys; sys.exit(3)"]], 60)

"""The space axis through the port's entry points, on two ``gloo`` ranks of
the CPU at ``--n-space 2`` (a ``(data 1, space 2)`` mesh: each rank holds
a band of the rows of every image), against one process on the same data
and seed, with the base-width-8 UNet at 36 px (bands of 18, 9 as 5 / 4, 4
and 2 rows, and a pad from 8 to 9 rows):

* the train CLI, 2 epochs (the ``Trainer``: banded loaders, model, loss,
  validation with the batch whole and H banded, the prediction PNGs of
  epoch 1 gathered to the writer): every ``metrics.csv`` number;
* the fold-parallel trainer over two folds (``make_fold_mesh``: fold 1 x
  data 1 x space 2), 1 epoch: each fold's ``metrics.csv``;
* ``predict_eval`` (the ``Evaluator`` over the ``(data, space)`` mesh of
  the caller's group) of the one-process CLI's best checkpoint:
  ``metrics.csv`` and every PNG, written by the first rank only;
* ``--n-space 2`` on one process raises, sequential or fold-parallel.

The runs train at lr 1e-6, the regime of ``tools/multirank_check.py``:
AdamW's first updates are about lr * sign(g), so at a trained rate an
element whose gradient is noise moves by a whole lr on one side and not
the other, and the runs separate from the second step on; at 1e-6 they
cannot. Tolerances: the losses at rtol 1e-4 (f32 sums in another order),
every other metrics.csv number within 1e-3 absolute (a near-tied pixel of
a barely trained net may move a per-class ratio); the Evaluator's
metrics.csv to 1e-9 and its PNGs on 99.9 % of the pixels (the same
weights: only a pixel whose logits tie within 1e-6 can differ).
"""
import os

import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    train as pcli,
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
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    evaluate,
    loop,
)
from torch_dist_common import ASSETS_MAP, ASSETS_TREE, build_small, run_ranks
from torch_space_common import space_runs_job
from torch_trainer_common import numbers, small_model

SIZE = 36
LOSS_RTOL = 1e-4
CELL_ATOL = 1e-3
EVAL_ATOL = 1e-9
PNG_AGREE = 0.999


def _cli_argv(save, data):
    return ["--save-path", str(save), "--data-root", data,
            "--tree-root", ASSETS_TREE, "--class-map", ASSETS_MAP,
            "--model-type", "1", "--img-size", str(SIZE), "--batch-size", "2",
            "--learning-rate", "[1e-6]", "--num-workers", "2", "--folds", "1",
            "--epochs", "2", "--device", "cpu", "--save-images-batch", "True"]


def _fold_kw(save, data):
    return dict(save_path=str(save), data_root=data, tree_root=ASSETS_TREE,
                class_map=ASSETS_MAP, model_select=0, model_type=1,
                img_size=SIZE, epochs=1, batch_size=2, val_batch=1, lr=1e-6,
                num_workers=2, folds=2, seed=0, fold_parallel=True)


EVAL_KW = dict(img_size=SIZE, model_type=1, val_batch=2, num_workers=2)


def _rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_runs_close(got, want):
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    loss_cols = {i for i, name in enumerate(want[0]) if "Loss" in name}
    for rg, rw in zip(got[1:], want[1:]):
        for i, (a, b) in enumerate(zip(rw[1:], rg[1:]), start=1):
            a, b = numbers(a), numbers(b)
            if i in loss_cols:
                np.testing.assert_allclose(b, a, rtol=LOSS_RTOL,
                                           err_msg=want[0][i])
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=CELL_ATOL,
                                           err_msg=want[0][i])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's runs, then the two ranks' (one spawn for all three)."""
    mp = pytest.MonkeyPatch()
    try:
        small_model(mp)
        mp.setattr(evaluate, "build_model",
                   lambda *a, **k: build_small("unet"))
        tmp = tmp_path_factory.mktemp("space_runs")
        data = str(tmp / "data")
        write_synth_dataset(data, 8, size=96, seed=5, folds=2)
        pcli.main(_cli_argv(tmp / "one_cli", data))
        loop.train(RunConfig(**_fold_kw(tmp / "one_fp", data)), device="cpu")
        weights = str(tmp / "one_cli" / "fold_1" / "best.ckpt")
        eval_root = os.path.join(data, "fold_1", "val")
        cfg = RunConfig(tree_root=ASSETS_TREE, class_map=ASSETS_MAP,
                        **EVAL_KW)
        one_eval = evaluate.predict_eval(cfg, [weights], [eval_root],
                                         str(tmp / "one_eval"), device="cpu")
    finally:
        mp.undo()
    ranks = run_ranks(space_runs_job, 2, tmp,
                      _cli_argv(tmp / "two_cli", data),
                      _fold_kw(tmp / "two_fp", data), EVAL_KW, weights,
                      eval_root, str(tmp / "two_eval"))
    return tmp, one_eval, ranks


def test_cli_at_n_space_2_equals_one_process(runs):
    tmp, _, ranks = runs
    assert ranks[0]["cli"] == ranks[1]["cli"]
    _assert_runs_close(_rows(tmp / "two_cli" / "fold_1" / "metrics.csv"),
                       _rows(tmp / "one_cli" / "fold_1" / "metrics.csv"))
    # epoch 1's prediction PNGs, gathered to the writer
    one = tmp / "one_cli" / "fold_1" / "images"
    two = tmp / "two_cli" / "fold_1" / "images"
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    for cls in os.listdir(one):
        a = decode_png(open(one / cls / "Epoch1.png", "rb").read())
        b = decode_png(open(two / cls / "Epoch1.png", "rb").read())
        assert a.shape == b.shape == (SIZE, SIZE)
        assert (a == b).mean() >= PNG_AGREE, cls


def test_fold_parallel_at_n_space_2_equals_one_process(runs):
    tmp, _, ranks = runs
    assert ranks[0]["fold_parallel"] == ranks[1]["fold_parallel"]
    for fold in (1, 2):
        _assert_runs_close(
            _rows(tmp / "two_fp" / f"fold_{fold}" / "metrics.csv"),
            _rows(tmp / "one_fp" / f"fold_{fold}" / "metrics.csv"))


def test_evaluator_over_data_1_space_2_equals_one_process(runs):
    tmp, one_eval, ranks = runs
    assert ranks[0]["eval"] == ranks[1]["eval"]
    want = _rows(tmp / "one_eval" / "fold_1" / "metrics.csv")
    got = _rows(tmp / "two_eval" / "rank0" / "fold_1" / "metrics.csv")
    assert got[0] == want[0] and len(got) == len(want)
    for rg, rw in zip(got[1:], want[1:]):
        assert rg[:2] == rw[:2]
        np.testing.assert_allclose(np.array(rg[2:], float),
                                   np.array(rw[2:], float), rtol=0,
                                   atol=EVAL_ATOL)
    assert not (tmp / "two_eval" / "rank1").exists()  # one writer
    n = agree = 0
    root = tmp / "one_eval" / "fold_1"
    for cls in sorted(p for p in os.listdir(root) if p.isdigit()):
        for name in os.listdir(root / cls):
            a = decode_png(open(root / cls / name, "rb").read())
            b = decode_png(open(tmp / "two_eval" / "rank0" / "fold_1" / cls
                                / name, "rb").read())
            n += a.size
            agree += int((a == b).sum())
    assert n and agree / n >= PNG_AGREE


@pytest.mark.parametrize("extra,match", [
    ([], "needs 2 ranks, have 1"),
    (["--fold-parallel", "True", "--folds", "2"], "n_space=2 with 1 ranks"),
])
def test_n_space_2_on_one_process_raises(tmp_path, extra, match):
    data = str(tmp_path / "data")
    write_synth_dataset(data, 4, size=64, seed=1, folds=2)
    argv = _cli_argv(tmp_path / "r", data)
    argv[argv.index("--folds") + 1] = "1"
    with pytest.raises(ValueError, match=match):
        pcli.main(argv + ["--n-space", "2"] + extra)

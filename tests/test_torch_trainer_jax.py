"""The port's trainer against the JAX package's on the CPU: the same
synthetic files, the same initial weights (the JAX trainer's init, through
``bridge.state_dict_from_flax``, loaded into the port's ``Trainer`` before
``run()``), one epoch of the hierarchical UNet at base width 8, 32 px.

Tolerances, on the metrics.csv row: the train loss within rtol 1e-3; the
other losses and per-level losses within rtol 5e-3; the epoch's accuracy,
IoU, Dice, precision, recall and selection metric within atol 5e-3; the
per-class metric lists within atol 2e-2 (one pixel whose argmax moves
shifts a small class's Dice on a 32 px image). The two sides differ by the
order of float32 sums (XLA against oneDNN), which AdamW's sign-like first
updates amplify, by the data chain's 1e-6 (``test_torch_transforms.py``),
and the JAX trainer uses its native target path (equal to its numpy path
seed for seed, ``tests/test_native_runtime.py``).
"""
import csv
import os

import jax
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    loop as jloop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop as ploop,
)
from torch_trainer_common import jax_small_model, numbers, small_model
from torch_port_common import trees

TRAIN_LOSS_RTOL = 1e-3
LOSS_RTOL = 5e-3
METRIC_ATOL = 5e-3
CLASS_METRIC_ATOL = 2e-2


def _tolerance(column: str) -> dict:
    if column == "Train Loss":
        return dict(rtol=TRAIN_LOSS_RTOL, atol=0)
    if "Loss" in column:
        return dict(rtol=LOSS_RTOL, atol=0)
    if "Class Metrics" in column:
        return dict(rtol=0, atol=CLASS_METRIC_ATOL)
    return dict(rtol=0, atol=METRIC_ATOL)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_traj")
    write_synth_dataset(str(root), 8, size=96, seed=4, folds=1)
    return str(root)


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_first_epoch_tracks_the_jax_trainer(tmp_path, data, assets_dir,
                                            monkeypatch):
    small_model(monkeypatch)
    jax_small_model(monkeypatch)
    kw = dict(tree_root=str(assets_dir / "class_tree_tl.json"),
              class_map=str(assets_dir / "class_map.csv"), model_select=0,
              model_type=1, img_size=32, epochs=1, batch_size=2,
              val_batch=1, lr=1e-3, num_workers=2, folds=1, seed=0)
    jtree, ptree = trees("default")
    fold = os.path.join(data, "fold_1")
    roots = (os.path.join(fold, "train"), os.path.join(fold, "val"))

    jt = jloop.Trainer(JaxRunConfig(save_path=str(tmp_path / "j"),
                                    data_root=data, **kw),
                       jtree, *roots, str(tmp_path / "j"))
    params, stats = jax.device_get((jt.state.params, jt.state.batch_stats))
    pt = ploop.Trainer(RunConfig(save_path=str(tmp_path / "p"),
                                 data_root=data, **kw),
                       ptree, *roots, str(tmp_path / "p"), device="cpu")
    pt.model.load_state_dict(state_dict_from_flax(params, stats),
                             strict=True)
    try:
        jt.run()
        pt.run()
    finally:
        jt.close()
        pt.close()

    want = _read(tmp_path / "j" / "metrics.csv")
    got = _read(tmp_path / "p" / "metrics.csv")
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert got[1][0] == want[1][0] == "1"
    for name, a, b in zip(want[0][1:], want[1][1:], got[1][1:]):
        np.testing.assert_allclose(numbers(b), numbers(a), err_msg=name,
                                   **_tolerance(name))

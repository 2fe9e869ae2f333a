"""The port's ``utils/profiling.py`` on the CPU, against the JAX package's
``utils/profiling.py``, and ``--profile-dir`` through the trainers.

Held:
- ``StepTimer`` equals the JAX class on the same clock readings (warm-up
  discarded, mean, images/s), and passes the JAX test's case
  (``tests/test_utils.py:40``);
- ``trace(dir)`` writes one Chrome trace file (``rank0.<ms>.pt.trace.json``)
  holding the name of an ``annotate`` span inside it; ``trace(None)``
  writes nothing; the package re-exports the three names, as JAX's
  ``utils/__init__.py`` does;
- the ``Trainer`` at 32 px with ``profile_dir`` traces epoch 2 and no other
  (JAX ``train/loop.py:364-373``): one file after three epochs, holding
  one ``AdamW.step`` span per step of an epoch; the fold-parallel trainer
  (JAX ``train/fold_parallel.py:383-387``) one file holding both folds'
  steps of epoch 2.
"""
import json
import os

import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.utils import (
    profiling as jprof,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch import utils
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils import (
    profiling as pprof,
)
from torch_dist_common import ASSETS_MAP, ASSETS_TREE
from torch_trainer_common import small_model

TRAIN_IMAGES = 8  # 4 steps of 2 an epoch (write_synth_dataset adds 2 val)
ADAMW_SPAN = "Optimizer.step#AdamW.step"


def _timed(cls, monkeypatch):
    """A ``cls`` timer over four tic/toc pairs of 0.5, 0.25, 0.75 and
    0.125 s on a patched clock, after a toc without a tic."""
    ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 3.125])
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    t = cls(warmup=2)
    t.toc()  # without a tic: ignored
    for _ in range(4):
        t.tic()
        t.toc()
    return t


def test_step_timer_equals_jax_on_the_same_clock(monkeypatch):
    j = _timed(jprof.StepTimer, monkeypatch)
    p = _timed(pprof.StepTimer, monkeypatch)
    assert p._times == j._times == [0.75, 0.125]
    assert p.mean == j.mean == 0.4375
    assert p.images_per_sec(7) == j.images_per_sec(7) == 16.0
    empty = pprof.StepTimer()
    assert empty.mean == 0.0 == empty.images_per_sec(4)


def test_step_timer_case_of_the_jax_test():
    import time

    t = pprof.StepTimer(warmup=1)
    for _ in range(4):
        t.tic()
        time.sleep(0.01)
        t.toc()
    assert 0.005 < t.mean < 0.1
    assert t.images_per_sec(8) > 0


def test_utils_reexports_the_jax_names():
    assert pprof.__all__ == jprof.__all__ == ["StepTimer", "trace",
                                              "annotate"]
    for name in pprof.__all__:
        assert getattr(utils, name) is getattr(pprof, name)


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_file_holding_an_annotate_name(tmp_path):
    with pprof.trace(str(tmp_path / "t"), device="cpu"):
        with pprof.annotate("rhss_annotated_span"):
            torch.ones(8).add_(1)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].startswith("rank0.") \
        and files[0].endswith(".pt.trace.json"), files
    names = [e.get("name") for e in _trace_events(tmp_path / "t" / files[0])]
    assert names.count("rhss_annotated_span") == 1


def test_trace_without_a_directory_does_nothing(tmp_path):
    for log_dir in (None, ""):
        with pprof.trace(log_dir):
            with pprof.annotate("nothing"):
                torch.ones(2).add_(1)
    assert not torch.autograd._profiler_enabled()
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("profile_data"))
    write_synth_dataset(root, TRAIN_IMAGES, size=64, seed=2, folds=2)
    return root


def _cfg(tmp_path, data, **kw):
    return RunConfig(save_path=str(tmp_path / "run"), data_root=data,
                     tree_root=ASSETS_TREE, class_map=ASSETS_MAP,
                     model_select=0, model_type=1, img_size=32,
                     batch_size=2, val_batch=2, lr=1e-3, num_workers=2,
                     epochs=3, seed=0, profile_dir=str(tmp_path / "prof"),
                     **kw)


def _traces(monkeypatch):
    """The directory each epoch's ``trace`` was given, in call order."""
    dirs = []
    real = loop.trace

    def trace(log_dir, device=None):
        dirs.append(log_dir)
        return real(log_dir, device=device)

    monkeypatch.setattr(loop, "trace", trace)
    return dirs


def _adamw_steps(prof_dir):
    files = os.listdir(prof_dir)
    assert len(files) == 1 and files[0].startswith("rank0."), files
    return [e.get("name") for e in _trace_events(
        os.path.join(prof_dir, files[0]))].count(ADAMW_SPAN)


def test_trainer_traces_epoch_2_only(tmp_path, data, monkeypatch):
    small_model(monkeypatch)
    dirs = _traces(monkeypatch)
    loop.train(_cfg(tmp_path, data, folds=2, fold=1), device="cpu")
    assert dirs == [None, str(tmp_path / "prof"), None]
    assert _adamw_steps(tmp_path / "prof") == TRAIN_IMAGES // 2


def test_fold_parallel_traces_epoch_2_only(tmp_path, data, monkeypatch):
    small_model(monkeypatch)
    dirs = _traces(monkeypatch)
    loop.train(_cfg(tmp_path, data, folds=2, fold_parallel=True),
               device="cpu")
    # one trace an epoch around both folds' lockstep steps
    assert dirs == [None, str(tmp_path / "prof"), None]
    assert _adamw_steps(tmp_path / "prof") == 2 * TRAIN_IMAGES // 2

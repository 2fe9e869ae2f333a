"""The port's checkpoints (``train/checkpoint.py``), plateau scheduler
(``train/plateau.py``) and metrics logger (``utils/logging.py``).

The checkpoint cases are those of ``tests/test_async_ckpt.py`` for the JAX
manager (ordering, a snapshot isolated from a later in-place update, worker
errors surfacing, sync mode, cadence, ``best_save="end"``, bad cadence or
policy rejected), on a torch state; the port's train step updates the live
tensors in place, so isolation is checked against in-place writes. A round
trip holds model, AdamW moments, step and meta bit for bit. The scheduler
gives the JAX package's learning rates on a fixed metric sequence, exactly.
"""
import json
import os
import time

import numpy as np
import pytest
import torch
from torch import nn

from restrictive_hierarchical_semantic_segmentation_tpu.train.plateau import (
    ReduceLROnPlateau as JaxPlateau,
)
from restrictive_hierarchical_semantic_segmentation_tpu.utils.logging import (
    MetricsLogger as JaxLogger,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    checkpoint as ck,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.plateau import (
    ReduceLROnPlateau,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils.logging import (
    MetricsLogger,
)

CKPT = "restrictive_hierarchical_semantic_segmentation_tpu_torch.train.checkpoint"


def _tiny_state(value: float):
    model = nn.Linear(8, 8, bias=False)
    with torch.no_grad():
        model.weight.fill_(value)
    return create_train_state(model, 1e-3)


def _w(state):
    return state.model.weight.detach().numpy()


def _load(path):
    return ck.load_checkpoint(path, _tiny_state(0.0))


def _wait_done(mgr):
    for _ in range(100):
        if mgr._pending.done():
            return
        time.sleep(0.05)


class TestAsyncCheckpoint:
    def test_ordering_and_completion(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path))
        mgr.update(_tiny_state(1.0), 1, 0.5, 0.3, 0.0)
        mgr.update(_tiny_state(2.0), 2, 0.4, 0.6, 0.0)  # waits for save 1
        mgr.wait()
        st, meta = _load(mgr.last_path)
        assert meta["epoch"] == 2
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 2.0))
        _, bmeta = _load(mgr.best_path)
        assert bmeta["epoch"] == 2 and mgr.prev_best == 0.6

    def test_snapshot_isolated_from_later_in_place_update(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path))
        state = _tiny_state(3.0)
        mgr.update(state, 1, 0.0, 0.1, 0.0)
        with torch.no_grad():  # the next train step writes in place
            state.model.weight.mul_(0.0)
        mgr.wait()
        st, _ = _load(mgr.last_path)
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 3.0))

    def test_worker_errors_surface(self, tmp_path, monkeypatch):
        mgr = ck.CheckpointManager(str(tmp_path))

        def boom(*a, **k):
            raise RuntimeError("disk full")

        monkeypatch.setattr(f"{CKPT}.save_checkpoint", boom)
        mgr.update(_tiny_state(1.0), 1, 0.0, 0.1, 0.0)
        with pytest.raises(RuntimeError, match="disk full"):
            mgr.wait()

    def test_sync_mode(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), async_save=False)
        mgr.update(_tiny_state(5.0), 1, 0.0, 0.1, 0.0)
        st, meta = _load(mgr.last_path)
        assert meta["epoch"] == 1
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 5.0))

    def test_save_last_cadence(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path))
        mgr.update(_tiny_state(1.0), 1, 0.0, 0.5, 0.0, save_last=False)
        mgr.wait()
        assert os.path.exists(mgr.best_path)
        assert not os.path.exists(mgr.last_path)
        mgr.update(_tiny_state(2.0), 2, 0.0, 0.4, 0.0, save_last=False)
        mgr.wait()
        assert not os.path.exists(mgr.last_path)
        mgr.update(_tiny_state(3.0), 3, 0.0, 0.3, 0.0, save_last=True)
        mgr.wait()
        assert _load(mgr.last_path)[1]["epoch"] == 3
        assert _load(mgr.best_path)[1]["epoch"] == 1

    def test_internal_cadence(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), ckpt_every=2,
                                   final_epoch=5)
        mgr.update(_tiny_state(1.0), 1, 0.0, 0.5, 0.0)  # best; off-cadence
        mgr.update(_tiny_state(2.0), 2, 0.0, 0.4, 0.0)  # on-cadence
        mgr.update(_tiny_state(3.0), 3, 0.0, 0.3, 0.0)  # neither
        mgr.wait()
        assert _load(mgr.last_path)[1]["epoch"] == 2
        mgr.update(_tiny_state(5.0), 5, 0.0, 0.2, 0.0)  # final epoch
        mgr.wait()
        assert _load(mgr.last_path)[1]["epoch"] == 5

    def test_failed_save_surfaces_on_next_update(self, tmp_path,
                                                 monkeypatch):
        mgr = ck.CheckpointManager(str(tmp_path), ckpt_every=100)

        def boom(*a, **k):
            raise RuntimeError("disk full")

        monkeypatch.setattr(f"{CKPT}.save_checkpoint", boom)
        mgr.update(_tiny_state(1.0), 1, 0.0, 0.5, 0.0)  # best -> async fail
        _wait_done(mgr)
        with pytest.raises(RuntimeError, match="disk full"):
            mgr.update(_tiny_state(2.0), 2, 0.0, 0.4, 0.0)

    def test_rejects_bad_cadence(self, tmp_path):
        with pytest.raises(ValueError, match="ckpt_every"):
            ck.CheckpointManager(str(tmp_path), ckpt_every=0)


class TestDeferredBest:
    def test_defers_until_finalize_and_picks_best_epoch(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), best_save="end",
                                   ckpt_every=100)
        assert mgr.update(_tiny_state(1.0), 1, 0.5, 0.3, 0.0)
        assert mgr.update(_tiny_state(2.0), 2, 0.4, 0.7, 0.0)
        assert not mgr.update(_tiny_state(3.0), 3, 0.3, 0.6, 0.0)
        mgr.wait()
        assert not os.path.exists(mgr.best_path)
        mgr.finalize()
        st, meta = _load(mgr.best_path)
        assert meta["epoch"] == 2 and meta["test_measure_mean"] == 0.7
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 2.0))

    def test_device_copy_isolated_from_in_place_update(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), best_save="end",
                                   ckpt_every=100)
        state = _tiny_state(5.0)
        mgr.update(state, 1, 0.5, 0.9, 0.0)
        with torch.no_grad():
            state.model.weight.fill_(-1.0)
        mgr.finalize()
        st, _ = _load(mgr.best_path)
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 5.0))

    def test_cadence_flush_and_resume_gate(self, tmp_path):
        mgr = ck.CheckpointManager(str(tmp_path), best_save="end",
                                   ckpt_every=2)
        mgr.update(_tiny_state(1.0), 1, 0.5, 0.9, 0.0)  # improve (defer)
        mgr.update(_tiny_state(2.0), 2, 0.4, 0.4, 0.0)  # cadence -> flush
        mgr.wait()
        st, bmeta = _load(mgr.best_path)
        assert bmeta["epoch"] == 1 and bmeta["test_measure_mean"] == 0.9
        np.testing.assert_array_equal(_w(st), np.full((8, 8), 1.0))
        assert _load(mgr.last_path)[1]["epoch"] == 2
        # a resumed manager re-seeds its gate from best.ckpt's meta
        mgr2 = ck.CheckpointManager(str(tmp_path), best_save="end",
                                    ckpt_every=2)
        assert mgr2.prev_best == 0.9
        assert not mgr2.update(_tiny_state(3.0), 3, 0.3, 0.5, 0.0)
        mgr2.finalize()
        assert _load(mgr2.best_path)[1]["epoch"] == 1

    def test_defer_early_return_surfaces_failed_save(self, tmp_path,
                                                     monkeypatch):
        mgr = ck.CheckpointManager(str(tmp_path), best_save="end",
                                   ckpt_every=2)
        mgr.update(_tiny_state(1.0), 1, 0.5, 0.3, 0.0)

        def boom(*a, **k):
            raise RuntimeError("disk full")

        monkeypatch.setattr(f"{CKPT}.save_checkpoint", boom)
        mgr.update(_tiny_state(2.0), 2, 0.4, 0.2, 0.0)  # cadence -> fails
        _wait_done(mgr)
        with pytest.raises(RuntimeError, match="disk full"):
            mgr.update(_tiny_state(3.0), 3, 0.3, 0.8, 0.0)

    def test_rejects_bad_policy(self, tmp_path):
        with pytest.raises(ValueError):
            ck.CheckpointManager(str(tmp_path), best_save="never")


def test_round_trip_of_model_moments_step_and_meta(tmp_path):
    torch.manual_seed(0)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4))
    state = create_train_state(model, 1e-2)
    for _ in range(3):
        state.optimizer.zero_grad()
        model(torch.randn(2, 3, 8, 8)).square().mean().backward()
        state.optimizer.step()
        state.step += 1
    path = str(tmp_path / "last.ckpt")
    ck.save_checkpoint(path, state, epoch=4, loss=0.25, sched_best=np.nan)
    assert sorted(os.listdir(path)) == ["rhss_meta.json", "state.pt"]
    assert not os.path.exists(path + ".tmp")
    torch.manual_seed(1)
    other = create_train_state(
        nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4)), 1e-2)
    got, meta = ck.load_checkpoint(path, other)
    assert got.step == 3 and meta["epoch"] == 4 and meta["loss"] == 0.25
    assert np.isnan(meta["sched_best"])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(got.model.state_dict()[k], v, rtol=0,
                                   atol=0)
    want, have = state.optimizer.state_dict(), got.optimizer.state_dict()
    assert want["param_groups"] == have["param_groups"]
    for i, st in want["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(have["state"][i][k], st[k], rtol=0,
                                       atol=0)
    with open(os.path.join(path, "rhss_meta.json")) as f:
        assert set(json.load(f)) == {"epoch", "loss", "sched_best"}
    # a second save replaces the first through the .tmp directory
    ck.save_checkpoint(path, state, epoch=5)
    assert ck.read_meta(path) == {"epoch": 5.0}


def test_plateau_matches_jax():
    rng = np.random.default_rng(0)
    metrics = list(np.cumsum(rng.normal(0.01, 0.02, 60)))
    metrics += [metrics[-1]] * 10
    for mode in ("max", "min"):
        for patience in (0, 2, 3):
            a = JaxPlateau(0.018, mode, 0.5, patience, min_lr=1e-4)
            b = ReduceLROnPlateau(0.018, mode, 0.5, patience, min_lr=1e-4)
            for m in metrics:
                assert b.step(float(m)) == a.step(float(m))
                assert b.state_dict() == a.state_dict()
            c = ReduceLROnPlateau(1.0)
            c.load_state_dict(b.state_dict())
            assert c.state_dict() == b.state_dict()


def test_metrics_logger_matches_jax(tmp_path):
    for cls, d in ((JaxLogger, "j"), (MetricsLogger, "p")):
        lg = cls(str(tmp_path / d))
        for step in (1, 2, 3):
            lg.log(step, {"loss": 1.0 / step, "dice": np.float32(0.5)},
                   prefix="train")
        lg.truncate_after(2)
    assert (tmp_path / "p" / "metrics.jsonl").read_text() == \
        (tmp_path / "j" / "metrics.jsonl").read_text()

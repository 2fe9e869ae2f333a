"""Checkpointing: best/last with the reference's semantics; counterpart of
the JAX package's ``train/checkpoint.py`` (which writes orbax).

Reference (train.py:666-709): save ``{epoch, model_state_dict,
optimizer_state_dict, loss, test_measure_mean, test_measure_std}`` as
``new_best.pt`` -> delete ``best.pt`` -> rename (two-phase); same for
``last.pt``. Selection metric: val mean Dice excluding background.

Here, the JAX package's layout: a checkpoint is a directory ``<name>.ckpt``
holding ``state.pt`` (``torch.save`` of the model ``state_dict``, the
optimizer ``state_dict`` and the step) and ``rhss_meta.json`` (the scalar
metadata, the same keys as the JAX package's). It is written to
``<name>.ckpt.tmp`` and renamed over ``<name>.ckpt``.

The port's train step updates parameters, buffers and optimizer moments in
place (the analogue of the JAX step's buffer donation), so every snapshot
handed to a later write is a copy: ``.cpu()`` of a CPU tensor is not one.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .state import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager",
           "snapshot"]

_META = "rhss_meta.json"
_STATE = "state.pt"


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def snapshot(state: TrainState, device: Optional[str] = "cpu") -> Dict:
    """``{"model", "optimizer", "step"}`` of ``state``, every tensor a new
    copy: on the host with ``device="cpu"``, else where it lies."""
    if device is None:
        copy = lambda t: t.detach().clone()  # noqa: E731
    else:
        copy = lambda t: t.detach().to(device, copy=True)  # noqa: E731
    return {"model": _map_tensors(state.model.state_dict(), copy),
            "optimizer": _map_tensors(state.optimizer.state_dict(), copy),
            "step": int(state.step)}


def save_checkpoint(path: str, state, **meta) -> None:
    """Two-phase save of a :class:`TrainState` or a :func:`snapshot`: write
    ``path.tmp`` then rename over ``path``."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    snap = snapshot(state) if isinstance(state, TrainState) else state
    torch.save(snap, os.path.join(tmp, _STATE))
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump({k: float(v) for k, v in meta.items()}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def read_meta(path: str) -> Dict[str, Any]:
    meta_path = os.path.join(path, _META)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_state(path: str) -> Dict:
    """The :func:`snapshot` saved in the checkpoint directory ``path``, on
    the host. A directory without ``state.pt`` is refused: under the same
    ``<name>.ckpt`` names the JAX package writes orbax checkpoints, which
    the port does not read."""
    path = os.path.abspath(path)
    state = os.path.join(path, _STATE)
    if os.path.isdir(path) and not os.path.isfile(state):
        raise NotImplementedError(
            f"{path} holds no {_STATE}, so it is not a checkpoint of the "
            "port's trainer: a <name>.ckpt directory without it is the JAX "
            "package's orbax checkpoint, which the port does not read "
            "(orbax needs jax; a converter outside both packages, built on "
            "bridge.py, stays out of the port: ROADMAP.md queue 1, item 7). "
            "Load its variables with jax, convert them with "
            "bridge.state_dict_from_flax and save them with the port's "
            "train/checkpoint.py, or train with the port")
    return torch.load(state, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, state: TrainState
                    ) -> Tuple[TrainState, Dict]:
    """Restore model, optimizer and step into ``state`` (in place, on the
    devices its tensors lie on); returns (state, meta)."""
    snap = load_state(path)
    state.model.load_state_dict(snap["model"], strict=True)
    state.optimizer.load_state_dict(snap["optimizer"])
    state.step = int(snap["step"])
    return state, read_meta(os.path.abspath(path))


class CheckpointManager:
    """best.ckpt / last.ckpt pair with the reference's update policy.

    ``async_save`` (default): ``update`` copies the state to the host
    synchronously and runs the serialization and the two-phase rename in a
    single background worker. Ordering is preserved (one worker, each
    ``update`` waits for the previous save); crash atomicity is unchanged
    (tmp-then-rename). Call ``wait()`` before reading the files."""

    def __init__(self, save_dir: str, async_save: bool = True,
                 ckpt_every: int = 1, final_epoch: Optional[int] = None,
                 best_save: str = "every",
                 defer_snapshot: Optional[Callable[[TrainState], Any]] = None,
                 defer_fetch: Optional[Callable[[Any], Dict]] = None,
                 write: bool = True):
        """``ckpt_every``/``final_epoch``: the last.ckpt cadence — last saves
        on every ``ckpt_every``-th epoch and on the final one (best.ckpt
        saves on every improvement regardless).

        ``best_save``: ``"every"`` (reference durability: best.ckpt hits disk
        on every improvement, train.py:666-686) or ``"end"``: an improvement
        keeps the best state as a device-side copy, and best.ckpt is written
        once in ``finalize()``. A pending deferred best is also flushed to
        disk on every last.ckpt cadence epoch, so a crash loses at most
        ``ckpt_every`` epochs of best-tracking, and ``--auto-resume``
        re-seeds the gate from the flushed best.ckpt meta.

        ``defer_snapshot``/``defer_fetch``: owner-managed storage of the
        deferred best (``best_save="end"``): ``defer_snapshot(state) ->
        handle`` replaces the default copy on the state's device and
        ``defer_fetch(handle) -> snapshot`` gives it back on the host at
        flush or finalize time (the fold-parallel trainer keeps its folds'
        bests this way).

        ``write``: a data-parallel group passes ``write=False`` on every
        rank but its first. A non-writing manager makes the same best/last
        decisions (the trainer gives every rank the first rank's metrics,
        and the first rank's gate: ``prev_best``) and calls the same hooks,
        but touches no file and copies no state to the host."""
        if (defer_snapshot is None) != (defer_fetch is None):
            raise ValueError("defer_snapshot and defer_fetch come together")
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
        if best_save not in ("every", "end"):
            raise ValueError(f"best_save must be 'every'|'end', {best_save!r}")
        self.save_dir = save_dir
        self.write = bool(write)
        if self.write:
            os.makedirs(save_dir, exist_ok=True)
        self._async = async_save and self.write
        self.ckpt_every = int(ckpt_every)
        self.final_epoch = final_epoch
        self.best_save = best_save
        self._deferred_best: Optional[Tuple[Any, Dict]] = None
        self._defer_snapshot = defer_snapshot
        self._defer_fetch = defer_fetch
        self._executor = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
            if self._async else None
        )
        self._pending: Optional[Future] = None
        self.prev_best: Optional[float] = None
        # resume: a prior run's best.ckpt keeps gating best-saves so the
        # resumed trajectory's decisions match an uninterrupted run's
        prior = read_meta(self.best_path)
        if "test_measure_mean" in prior:
            self.prev_best = float(prior["test_measure_mean"])

    @property
    def best_path(self) -> str:
        return os.path.join(self.save_dir, "best.ckpt")

    @property
    def last_path(self) -> str:
        return os.path.join(self.save_dir, "last.ckpt")

    def _surface_failed_save(self) -> None:
        """Raise now if an earlier save already failed: do not train on
        unsaved progress."""
        if self._pending is not None and self._pending.done():
            self.wait()

    def update(self, state: TrainState, epoch: int, loss: float,
               test_measure_mean: float, test_measure_std: float,
               save_last: Optional[bool] = None, **extra_meta) -> bool:
        """Save last (per the ``ckpt_every``/``final_epoch`` cadence, or the
        explicit ``save_last`` override); save best iff the selection metric
        improved (train.py:664: strictly greater). Returns True if best
        updated. ``extra_meta``: additional scalars (e.g. scheduler state for
        exact resume) stored in the meta sidecar.

        Off-cadence non-improving epochs skip the save and the state copy."""
        if save_last is None:
            save_last = (epoch % self.ckpt_every == 0
                         or epoch == self.final_epoch)
        meta = dict(
            epoch=epoch,
            loss=loss,
            test_measure_mean=test_measure_mean,
            test_measure_std=test_measure_std,
            **extra_meta,
        )
        is_best = self.prev_best is None or test_measure_mean > self.prev_best
        if is_best:
            self.prev_best = test_measure_mean
        if not is_best and not save_last:
            self._surface_failed_save()
            return False
        defer_best = is_best and self.best_save == "end"
        if defer_best:
            if self._defer_snapshot is not None:
                self._deferred_best = (self._defer_snapshot(state), meta)
            else:
                # a copy on the state's own device: the next step updates
                # the live tensors in place
                self._deferred_best = (snapshot(state, device=None), meta)
            if not save_last:
                self._surface_failed_save()
                return True
        write_best = is_best and not defer_best
        # cadence epoch with a deferred best pending: flush it to disk along
        # with last.ckpt
        flush: Optional[Tuple[Any, Dict]] = None
        if save_last and self._deferred_best is not None:
            flush, self._deferred_best = self._deferred_best, None
        if not self.write:  # the same decisions, no file and no host copy
            return is_best
        tasks = []
        if self._async:
            self.wait()  # one save in flight; surfaces worker errors
        if flush is not None:
            tasks.append((self.best_path, self._defer_to_host(flush[0]),
                          flush[1]))
        host_state = snapshot(state)
        if write_best:
            tasks.append((self.best_path, host_state, meta))
        if save_last:
            tasks.append((self.last_path, host_state, meta))
        if self._async:
            self._pending = self._executor.submit(self._save_tasks, tasks)
        else:
            self._save_tasks(tasks)
        return is_best

    def _save_tasks(self, tasks) -> None:
        for path, st, meta in tasks:
            save_checkpoint(path, st, **meta)

    def _defer_to_host(self, snap) -> Dict:
        """A deferred best (a device-side snapshot or the owner's handle)
        on the host."""
        if self._defer_fetch is not None:
            return self._defer_fetch(snap)
        return _to_host(snap)

    def wait(self) -> None:
        """Block until the in-flight async save (if any) has finished; raises
        if it failed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def finalize(self) -> None:
        """Drain the async worker and, in ``best_save='end'`` mode, write
        the deferred best state to best.ckpt."""
        self.wait()
        if self._deferred_best is not None:
            snap, meta = self._deferred_best
            self._deferred_best = None
            if self.write:
                save_checkpoint(self.best_path, self._defer_to_host(snap),
                                **meta)


def _to_host(snap: Dict) -> Dict:
    """A private device-side snapshot on the host (nothing else holds it,
    so a CPU tensor need not be copied again)."""
    return _map_tensors(snap, lambda t: t.cpu())

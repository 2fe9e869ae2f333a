"""Fold-parallel cross-validation training: every fold in lockstep;
counterpart of the JAX package's ``train/fold_parallel.py``, with its
names.

The reference trains its cross-validation folds one after another
(train.py:546). The JAX package steps every fold at once as one vmapped
program over a ``(fold, data, space)`` mesh. Here the mesh is of ranks
(``parallel/mesh.py:make_fold_mesh``, sized as JAX sizes it): fold group
``i`` of the mesh owns folds ``[i F / n_fold, (i + 1) F / n_fold)`` and
trains them in lockstep, each fold a :class:`..train.loop.Trainer` of its
own (model, optimizer, loaders, plateau scheduler, ``CheckpointManager``)
that trains over the group's ``(data, space)`` submesh: data-parallel,
and with ``n_space`` above 1 on bands of rows (``parallel/bands.py``).
On one card every fold is
local and the folds take their steps in turn; their compute does not
overlap (streams or batched folds would be a later speed change).

Per-fold semantics are the sequential ``Trainer``'s: one initialization
for every fold (the seed, or a donor ``.pt``/``.pth``), per-fold learning
rates, and each fold's ``metrics.csv``, ``best.ckpt`` and ``last.ckpt`` in
the sequential layout, written by the first rank of its fold group. Logs
add ``concurrent_folds``, because ``sec_per_epoch`` there is the wall time
of the lockstep epoch of all of a group's folds.

Epoch length: folds step in lockstep, so an epoch runs ``min_f(len(loader_f))``
steps; the surplus batches of longer folds are dropped for that epoch
(logged, never silent), and return in later epochs through the per-epoch
shuffle. Resume is all or nothing (``--auto-resume``): every local fold
from its ``last.ckpt`` at one epoch, or all fresh. ``best_save="end"``
keeps each fold's best state through the manager's defer hooks.
"""
from __future__ import annotations

import os
import time
from dataclasses import replace
from typing import List, Optional

import torch
import torch.distributed as dist

from ..config.run import RunConfig
from ..hierarchy.tree import ClassTree
from ..parallel.mesh import make_fold_mesh, world
from ..utils.device import resolve_device
from .checkpoint import _to_host, read_meta, snapshot
from .state import set_learning_rate

__all__ = ["FoldParallelTrainer", "train_folds_parallel"]


class FoldParallelTrainer:
    """The local folds' build + lockstep epoch machinery."""

    def __init__(self, cfg: RunConfig, tree: ClassTree, fold_ids: List[int],
                 device=None):
        self.cfg = cfg
        self.tree = tree
        self.fold_ids = list(fold_ids)
        self.device = resolve_device(device)
        self.trainers = []
        self._best = {}
        try:
            self._build()
        except BaseException:
            # construction failed partway: release the loaders already made
            self.close()
            raise

    def _build(self):
        from .loop import Trainer

        cfg = self.cfg
        if cfg.model_weights and not cfg.model_weights.endswith(
                (".pt", ".pth")):
            raise ValueError(
                "fold-parallel training resumes via --auto-resume True "
                "(per-fold last.ckpt); --model-weights accepts only donor "
                ".pt/.pth files here")
        F = len(self.fold_ids)
        self.mesh = make_fold_mesh(F, cfg.batch_size, cfg.n_space)
        n_fold = self.mesh.shape["fold"]
        pos = self.mesh.position()
        if pos is None:  # an idle rank: no fold of its own
            self.local, self.step_group, self.is_main = [], None, False
            self.start_epoch = cfg.epochs + 1
            return
        per = F // n_fold
        self.local = self.fold_ids[pos[0] * per:(pos[0] + 1) * per]
        self.step_group = self.mesh.step_group()
        self.is_main = self.step_group.is_main
        resume = self._resume_epoch()
        for f, fold in enumerate(self.local):
            loc = os.path.join(cfg.save_path, f"fold_{fold}")
            fold_cfg = (cfg if resume is None else replace(
                cfg, model_weights=os.path.join(loc, "last.ckpt")))
            self.trainers.append(Trainer(
                fold_cfg, self.tree,
                os.path.join(cfg.data_root, f"fold_{fold}", "train"),
                os.path.join(cfg.data_root, f"fold_{fold}", "val"), loc,
                device=self.device, mesh=self.mesh,
                defer=(lambda state, f=f: self._snap_best(f),
                       self._fetch_best)))
        self.start_epoch = self.trainers[0].start_epoch

    # --------------------------------------------------------------- resume
    def _resume_epoch(self) -> Optional[int]:
        """All-or-nothing resume (``_resume_or_init`` of JAX): the epoch every
        local fold's ``last.ckpt`` holds, or None (start fresh; with a
        message when only some folds have one or their epochs differ). The
        step group's first rank decides, for every rank of the group."""
        if not self.cfg.auto_resume:
            return None
        epoch = -1.0
        if self.is_main:
            paths = [os.path.join(self.cfg.save_path, f"fold_{fold}",
                                  "last.ckpt") for fold in self.local]
            have = [os.path.exists(p) for p in paths]
            epochs = {int(read_meta(p).get("epoch", 0))
                      for p, h in zip(paths, have) if h}
            if all(have) and len(epochs) == 1:
                epoch = float(epochs.pop())
                print(f"fold-parallel auto-resume: all {len(paths)} folds at "
                      f"epoch {int(epoch)}, resuming")
            elif any(have):
                print("fold-parallel auto-resume: "
                      + ("folds at different epochs "
                         f"{sorted(epochs)}" if all(have) else
                         "not every fold has a last.ckpt")
                      + " — starting fresh")
        if self.step_group.group is not None:
            t = torch.tensor([epoch], dtype=torch.float64, device=self.device)
            dist.broadcast(t, src=self.step_group.root, group=self.step_group.group)
            epoch = float(t.item())
        return None if epoch < 0 else int(epoch)

    # --------------------------------------------------------------- epochs
    def train_epoch(self, epoch: int) -> List[dict]:
        """One lockstep epoch of every local fold: step ``k`` of each fold,
        then step ``k + 1``; ``min`` of the folds' batch counts."""
        lens = [len(t.train_loader) for t in self.trainers]
        if max(lens) > min(lens) and self.is_main:
            print(f"fold-parallel epoch {epoch}: folds have {lens} batches; "
                  f"running {min(lens)} lockstep steps "
                  f"(longer folds drop their surplus this epoch)")
        masks = [t.level_mask(epoch) for t in self.trainers]
        its = [iter(t.epoch_batches(epoch)) for t in self.trainers]
        device_aux = [[] for _ in self.trainers]
        t0 = time.time()
        n = min(lens)
        # epoch 2 under --profile-dir: one trace of every local fold's
        # steps, by each rank that trains (an idle rank has no trainer)
        with self.trainers[0].profile(epoch):
            for k in range(1, n + 1):
                for f, t in enumerate(self.trainers):
                    x, y = next(its[f])
                    device_aux[f].append(t.step(x, y, masks[f], epoch, k))
        dt = time.time() - t0
        return [t.epoch_result(epoch, aux, dt, n)
                for t, aux in zip(self.trainers, device_aux)]

    def _snap_best(self, f: int) -> int:
        """Deferred-best snapshot hook (``best_save='end'``): fold ``f``'s
        state copied on its device; the fold index is the handle (the newest
        snapshot of each fold, matching the manager's newest meta)."""
        self._best[f] = snapshot(self.trainers[f].state, device=None)
        return f

    def _fetch_best(self, f: int):
        """Deferred-best fetch hook: fold ``f``'s snapshot on the host."""
        return _to_host(self._best.pop(f))

    def run(self) -> List[Optional[float]]:
        cfg = self.cfg
        F = len(self.fold_ids)
        records = [t.open_records() for t in self.trainers]
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            for t in self.trainers:
                if t.scheduler:
                    set_learning_rate(t.state, t.scheduler.lr)
            trs = self.train_epoch(epoch)
            dump = cfg.save_images_batch and (
                epoch % cfg.save_images_batch_num == 0 or epoch == 1
            )
            for fold, t, tr, (csv_path, logger) in zip(
                    self.local, self.trainers, trs, records):
                va = t.evaluate(epoch, dump_images=dump)
                if self.is_main:
                    print(
                        f"Fold {fold} epoch {epoch}: "
                        f"train loss {tr['loss']:.4f} "
                        f"({tr['steps']} steps, {tr['time']:.1f}s all folds) "
                        f"| val dice(no bg) {va['measure_mean']:.4f} "
                        f"iou {va['overall']['iou']:.4f} lr {t.lr():.5f}",
                        flush=True,
                    )
                # sec_per_epoch is the wall time of the lockstep epoch of
                # all folds; concurrent_folds lets tooling normalize it
                t.record(csv_path, logger, epoch, tr, va, concurrent_folds=F)
                t.decide(epoch, tr, va)
        for t in self.trainers:
            t.ckpt.finalize()  # drain async saves; write deferred bests
        return [t.ckpt.prev_best for t in self.trainers]

    def close(self):
        """Release every fold's loaders and deferred-best copies."""
        for t in self.trainers:
            t.close()
        self._best.clear()


def train_folds_parallel(cfg: RunConfig, tree: Optional[ClassTree] = None,
                         fold_ids: Optional[List[int]] = None,
                         device=None) -> List[Optional[float]]:
    """All-folds-at-once entry point (the ``--fold-parallel True`` path of
    ``loop.train``): every fold's best selection metric, in fold order, on
    every rank. Requires the cross-val ``data_root/fold_N/{train,val}``
    layout (train.py:796-803)."""
    if tree is None:
        tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    if fold_ids is None:
        folds = cfg.folds if cfg.inc_cross_val and cfg.folds > 0 else 1
        fold_ids = [cfg.fold] if cfg.fold > 0 else list(range(1, folds + 1))
    rank, size = world()
    if rank == 0:
        print(f"Fold-parallel training: folds {fold_ids} in lockstep")
    trainer = FoldParallelTrainer(cfg, tree, fold_ids, device=device)
    if rank == 0:
        print(f"mesh: {trainer.mesh.shape}")
    try:
        local = trainer.run()
    finally:
        trainer.close()
    best = dict(zip(trainer.local, local)) if trainer.is_main else {}
    if size > 1:  # every fold's writer reports it to every rank
        gathered = [None] * size
        dist.all_gather_object(gathered, best)
        best = {k: v for part in gathered for k, v in part.items()}
    return [best.get(fold) for fold in fold_ids]

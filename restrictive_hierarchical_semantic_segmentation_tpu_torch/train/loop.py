"""The training loop: folds -> build -> epochs -> metrics.csv + best/last;
counterpart of the JAX package's ``train/loop.py``.

Host-side orchestration around the port's train and eval steps, replicating
the reference's ``train``/``train_epoch``/``test`` behaviours
(train.py:161-710) with the JAX package's fixes: every fold trains, the loss
takes the level weights, and the consistency term sees soft probabilities.

The model lives on ``device`` (``cuda`` unless the caller asks for the
CPU) in ``torch.channels_last``, where every BatchNorm runs the port's
kernels. With ``device_data`` the training set lives on that device too
and is augmented there (``data/device_augment.py``); validation keeps the
host chain. ``remat`` makes the backbone's regions recompute in the
backward (``models/remat.py``); ``profile_dir`` traces the steps of epoch 2
and of epoch 2 only, as the JAX trainer does (``utils/profiling.py:trace``;
in a run of several ranks each rank that trains writes its own file).
Options of the JAX trainer that the port does not have raise
(:func:`check_supported`).

Data parallelism (the JAX trainer's ``data`` mesh axis): in a run of
several ranks (``parallel/mesh.py:init_distributed``) a :class:`Trainer`
spans a data group of ranks (every rank by default, or the group the
fold-parallel trainer gives it) and computes what one process computes on
the global batch: each rank loads its rows of every batch
(``data/loader.py:shard_rows``; a device-resident set through its
``set_sharding``), BatchNorm takes the group's statistics,
the step all-reduces the Dice counts, the gradients and its aux
(``train/steps.py``). Parameters start from the group's first rank (a
broadcast) and stay the same bits on every rank. Validation runs on every
rank over the whole validation set (the JAX batch replicated over
``data``), and the host's decisions (the plateau learning rate, the
best-save gate, the NaN probe, the scheduler's state in the checkpoint
meta) come from the first rank's numbers, broadcast; a rank whose learning
rate differs from the first rank's raises. Only the first rank writes
``metrics.csv``, checkpoints, logs and image dumps, and prints progress
(``CheckpointManager(write=False)`` on the others).

Spatial sharding (the JAX trainer's ``space`` axis, ``cfg.n_space``): the
ranks form a ``(data, space)`` mesh (``parallel/mesh.py:make_mesh``), and
each rank of a space group keeps its band of H of its data rows
(``parallel/bands.py``; the loaders cut whole augmented images). The
model runs on the bands (``set_space_group``), BatchNorm and the step's
reductions span the step group (data x space, ``train/steps.py``).
Validation runs as JAX runs it (``P(None, space, None, None)``): every
batch whole on every data rank, H banded over space. The step group's
first rank writes, and the host's decisions come from it.

``train`` runs the folds one after another, or all of them in lockstep
with ``fold_parallel`` (``train/fold_parallel.py``).

``model_weights``: a ``<name>.ckpt`` directory of the port's trainer
resumes (model, optimizer, epoch, scheduler); a ``.pt``/``.pth`` file
replaces the initial parameters and statistics and resumes nothing, read
by the rule of ``train/torch_import.py:load_model_weights`` (the port's
own ``state_dict`` file strictly, any other one as a donor checkpoint, as
the JAX trainer reads every ``.pt``/``.pth``).
"""
from __future__ import annotations

import csv
import glob
import os
import time
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config.run import RunConfig
from ..data.dataset import SegDataset
from ..data.device_augment import DeviceDataset
from ..data.loader import BatchLoader, prefetch_to_device, split_ids
from ..data.png import encode_png_gray8
from ..hierarchy.tree import ClassTree
from ..metrics.segmentation import MetricAccumulator
from ..models.hierarchical import build_model
from ..models.norm import set_bn_group
from ..parallel.bands import band, check_bands, set_space_group
from ..parallel.mesh import RankMesh, make_mesh, single, world
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.profiling import trace
from .checkpoint import CheckpointManager, load_checkpoint
from .plateau import ReduceLROnPlateau
from .state import create_train_state, set_learning_rate
from .steps import make_eval_step, make_train_step
from .torch_import import load_model_weights

__all__ = ["Trainer", "train", "list_pairs", "make_loaders",
           "run_validation", "append_csv", "truncate_csv",
           "check_supported", "CSV_HEADER"]

CSV_HEADER = [
    "Epoch", "Train Loss", "Train Level Loss", "Train Accuracy", "Train IoU",
    "Train Dice", "Train Precision", "Train Recall", "Train Class Metrics",
    "Val Loss", "Val Level Loss", "Val Accuracy", "Val IoU", "Val Dice",
    "Val Precision", "Val Recall", "Val Test Measure Mean",
    "Val Test Measure Std", "Val Class Metrics",
]  # train.py:637


def _fold_ids(cfg: RunConfig) -> List[int]:
    folds = cfg.folds if cfg.inc_cross_val and cfg.folds > 0 else 1
    return [cfg.fold] if cfg.fold > 0 else list(range(1, folds + 1))


def check_supported(cfg: RunConfig) -> None:
    """Raise for the JAX trainer's option that the port does not have:
    grain, which has no counterpart."""
    if cfg.loader == "grain":
        raise NotImplementedError(
            "--loader grain: grain is a JAX input pipeline with no "
            "counterpart in the PyTorch port; use --loader threads or "
            "process")


def list_pairs(root: str) -> Tuple[List[str], List[str]]:
    """root/{images,labels}/* sorted (train.py:420-423)."""
    imgs = sorted(glob.glob(os.path.join(root, "images", "*")))
    labs = sorted(glob.glob(os.path.join(root, "labels", "*")))
    if not imgs or len(imgs) != len(labs):
        raise FileNotFoundError(
            f"bad dataset at {root}: {len(imgs)} images / {len(labs)} labels"
        )
    return imgs, labs


def make_loaders(cfg: RunConfig, tree: ClassTree, train_root: str,
                 val_root: Optional[str], device=None, shard=None,
                 band=None):
    """One fold's (train, val) loaders. With ``cfg.device_data`` the train
    loader is a :class:`DeviceDataset` on ``device`` (``cuda`` unless the
    caller asks for the CPU), which yields tensors already there.
    ``shard``: ``(index, size, grad_accum)`` of this rank in its data group
    (``data/loader.py:shard_rows``); the host train loader yields its rows
    of every batch (a :class:`DeviceDataset` takes them from the caller's
    ``set_sharding``, as the JAX trainer lays out its device set), the
    validation loader every image. ``band``: ``(lo, hi)``, the rows of H
    this rank of a space group keeps, of both loaders' images (a
    :class:`DeviceDataset` takes it from ``set_sharding`` too)."""
    check_supported(cfg)
    hier = cfg.hierarchical
    tr_imgs, tr_labs = list_pairs(train_root)
    if val_root:
        va_imgs, va_labs = list_pairs(val_root)
    else:
        tr_idx, _, va_idx = split_ids(len(tr_imgs), False, False, True)
        va_imgs = [tr_imgs[i] for i in va_idx]
        va_labs = [tr_labs[i] for i in va_idx]
        tr_imgs = [tr_imgs[i] for i in tr_idx]
        tr_labs = [tr_labs[i] for i in tr_idx]
    loader_kw = dict(num_workers=cfg.num_workers)
    if cfg.loader == "process":
        loader_kw["worker_mode"] = "process"
    ds_kw = dict(
        target_dtype=np.int8 if cfg.host_compact else np.float32,
        emit_gray=cfg.host_compact,
    )
    if cfg.device_data:
        # the training set on the device, augmented there: the host's
        # per-epoch work is a permutation
        train_loader = DeviceDataset(
            tr_imgs, tr_labs, tree, cfg.img_size, hier,
            batch_size=cfg.batch_size, seed=cfg.seed, device=device)
    else:
        train_loader = BatchLoader(
            SegDataset(tr_imgs, tr_labs, tree, cfg.img_size, hier,
                       augment=True, **ds_kw),
            cfg.batch_size, shuffle=True, drop_last=True, seed=cfg.seed,
            shard=shard, band=band, **loader_kw,
        )
    val_loader = BatchLoader(
        SegDataset(va_imgs, va_labs, tree, cfg.img_size, hier,
                   augment=False, **ds_kw),
        cfg.val_batch, shuffle=False, drop_last=False, seed=cfg.seed,
        band=band, **loader_kw,
    )
    return train_loader, val_loader


def dump_prediction_images(outputs, save_loc: str, epoch: int):
    """Per-class binary prediction PNGs (train.py:370-385)."""
    save_clss = 0
    for lvl_out in outputs:
        arr = lvl_out[0].float().cpu().numpy()  # first image (H, W, C)
        pred = np.argmax(arr, -1)
        for c in range(arr.shape[-1]):
            d = os.path.join(save_loc, "images", str(save_clss))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"Epoch{epoch}.png"), "wb") as f:
                f.write(encode_png_gray8(((pred == c) * 255).astype(np.uint8)))
            save_clss += 1


def _fetch(results, n_levels: int):
    """One host transfer for a list of step results: (losses, per-level
    losses, per-level stacked confusion matrices) as numpy arrays."""
    if not results:
        return np.zeros(0), np.zeros((0, n_levels)), []
    # float64 on the host, as the JAX trainer's sums of fetched scalars
    loss = torch.stack([r["loss"].float() for r in results]).cpu().numpy(
    ).astype(np.float64)
    per_level = torch.stack([r["per_level"].float() for r in results]
                            ).cpu().numpy().astype(np.float64)
    confmats = [torch.stack([r["confmats"][L] for r in results]).cpu().numpy()
                for L in range(len(results[0]["confmats"]))]
    return loss, per_level, confmats


def run_validation(eval_step, val_loader, device, num_classes_per_level,
                   val_batch: int, dump_fn=None):
    """One validation pass (reference ``test``, train.py:283-393): aggregate
    confusion-matrix metrics, per-level losses, and the ``perf_no_bg``
    selection metric. ``dump_fn(outputs)`` is called once, on the first batch,
    when the eval step returns raw outputs (prediction-PNG dumps)."""
    acc = MetricAccumulator(num_classes_per_level)
    device_res = []
    first = True
    t0 = time.time()
    for x, y in prefetch_to_device(val_loader, 2, device):
        res = eval_step(x, y)
        if dump_fn is not None and first and "outputs" in res:
            dump_fn(res["outputs"])
            first = False
        res.pop("outputs", None)  # don't keep full-res maps per batch
        device_res.append(res)
    t_dispatch = time.time() - t0
    # one host transfer after the last dispatch (see train_epoch)
    losses, level, confmats = _fetch(device_res, len(num_classes_per_level))
    for i in range(len(losses)):
        acc.update([cm[i] for cm in confmats])
    mean, std = acc.selection_metric()
    denom = max(1, len(val_loader) * val_batch)
    return {
        "loss": float(losses[-1]) if len(losses) else 0.0,  # train.py:341
        "level_loss": (level.sum(0) / denom).tolist() if len(losses)
        else [0.0] * len(num_classes_per_level),
        "overall": acc.epoch_overall(),
        "per_class": acc.epoch_per_class(),
        "measure_mean": mean,
        "measure_std": std,
        "sec_dispatch": t_dispatch,
        "sec_total": time.time() - t0,
    }


def default_mesh(cfg: RunConfig) -> Optional[RankMesh]:
    """The ``(data, space)`` mesh of a :class:`Trainer` built without one:
    every rank of the run (the JAX multi-process trainer's mesh spans every
    process), ``cfg.n_space`` of them on the space axis; None for one
    process alone."""
    _, size = world()
    if size == 1 and cfg.n_space == 1:
        return None
    if size > cfg.n_space and size % cfg.n_space:
        raise ValueError(f"--n-space {cfg.n_space} does not divide the "
                         f"{size} ranks of the run")
    return make_mesh(n_data=max(1, size // cfg.n_space),
                     n_space=cfg.n_space)


class Trainer:
    """One fold's build + epoch machinery, on one device or over the ranks
    of a ``(data, space)`` mesh (module docstring).

    ``mesh``: the mesh whose step group trains this fold (this rank's
    position in it; default: :func:`default_mesh`). ``self.data``,
    ``self.space`` and ``self.step_group`` are this rank's data, space
    and step groups. ``defer``: ``(defer_snapshot, defer_fetch)`` for the
    checkpoint manager's deferred best."""

    def __init__(self, cfg: RunConfig, tree: ClassTree,
                 train_root: str, val_root: Optional[str], save_loc: str,
                 device=None, mesh: Optional[RankMesh] = None,
                 defer=None):
        self.cfg = cfg
        self.tree = tree
        self.save_loc = save_loc
        self.device = resolve_device(device)
        if mesh is None:
            mesh = default_mesh(cfg)
        if mesh is None:
            self.data = self.space = self.step_group = single()
        else:
            self.data, self.space, self.step_group = (
                mesh.data_group(), mesh.space_group(), mesh.step_group())
        self.is_main = self.step_group.is_main
        ranks = self.data.size
        if cfg.batch_size % (ranks * cfg.grad_accum):
            raise ValueError(
                f"batch {cfg.batch_size} does not split over a data group "
                f"of {ranks} ranks x {cfg.grad_accum} microbatches")
        if self.is_main:
            os.makedirs(save_loc, exist_ok=True)

        hier = cfg.hierarchical
        self.num_classes_per_level = (
            list(tree.classes_per_level) if hier else [tree.num_leaves]
        )
        self.n_levels = len(self.num_classes_per_level)

        # --- model / state ----------------------------------------------------
        hrnet_cfg = None
        if cfg.hrnet_yaml:
            from ..config.hrnet import resolve_hrnet_config

            hrnet_cfg = resolve_hrnet_config(cfg.hrnet_yaml)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(tree, cfg.model_select, cfg.model_type,
                                hrnet_cfg,
                                concat_prev_probs=cfg.concat_prev_probs,
                                remat=cfg.remat)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).train()
        self.state = create_train_state(self.model, cfg.lr, cfg.weight_decay)
        self._resume_meta = None
        if cfg.model_weights and cfg.model_weights.endswith((".pt", ".pth")):
            # weights only, no resume: the port's own state_dict file, or a
            # donor checkpoint (train/torch_import.py), whose unmatched
            # leaves keep the initialization drawn from cfg.seed
            load_model_weights(self.model, cfg.model_weights,
                               cfg.model_select)
        elif cfg.model_weights:  # one of the port's own .ckpt directories
            self.state, self._resume_meta = load_checkpoint(
                cfg.model_weights, self.state)
            if self.is_main:
                print(f"Resumed from {cfg.model_weights}: "
                      f"{self._resume_meta}")
        group = self.step_group.group
        if group is not None:
            # every rank starts from the first rank's parameters and
            # statistics, and its BatchNorms span the step group's rows
            with torch.no_grad():
                for t in self.model.state_dict().values():
                    dist.broadcast(t, src=self.step_group.root, group=group)
            set_bn_group(self.model, group)
        set_space_group(self.model, self.space)

        lw = cfg.level_weights
        ohem = (cfg.ohem_thres, cfg.ohem_keep) if cfg.use_ohem else None
        self.train_step = make_train_step(
            self.model, tree, hier, lw, cfg.lambda_cons, cfg.lambda_kl,
            ohem=ohem, grad_accum=cfg.grad_accum,
            compute_dtype=cfg.compute_dtype, group=group, space=self.space,
        )
        self.eval_step = make_eval_step(
            self.model, tree, hier, lw, cfg.lambda_cons, cfg.lambda_kl,
            ohem=ohem, return_outputs=cfg.save_images_batch,
            compute_dtype=cfg.compute_dtype, space=self.space,
        )
        self.scheduler = ReduceLROnPlateau(
            cfg.lr, "max", 0.5, 3, min_lr=cfg.lrs_min
        ) if cfg.lrs else None
        snap, fetch = defer if defer is not None else (None, None)
        self.ckpt = CheckpointManager(
            save_loc, ckpt_every=cfg.ckpt_every, final_epoch=cfg.epochs,
            best_save=cfg.best_save, defer_snapshot=snap, defer_fetch=fetch,
            write=self.is_main)
        if group is not None:  # the gate starts where the writer's does
            best = self.agree([np.nan if self.ckpt.prev_best is None
                               else self.ckpt.prev_best])[0]
            self.ckpt.prev_best = None if np.isnan(best) else best

        # --- exact resume: the epoch counter and the plateau scheduler from
        # the checkpoint's meta, so the LR trajectory and best-ckpt
        # decisions continue as if uninterrupted
        self.start_epoch = 1
        meta = self._resume_meta
        if meta and "epoch" in meta:
            self.start_epoch = int(meta["epoch"]) + 1
            if self.scheduler is not None and "sched_lr" in meta:
                best = meta.get("sched_best")
                self.scheduler.load_state_dict({
                    "lr": meta["sched_lr"],
                    "best": None if best is None or best != best else best,
                    "num_bad_epochs": int(meta.get("sched_num_bad_epochs", 0)),
                })

        # --- data, last: its worker pools are released by close() ----------
        shard = ((self.data.index, ranks, cfg.grad_accum) if ranks > 1
                 else None)
        rows = None
        if self.space.size > 1:
            check_bands(cfg.img_size, self.space.size)
            rows = band(cfg.img_size, self.space.size, self.space.index)
        self.train_loader, self.val_loader = make_loaders(
            cfg, tree, train_root, val_root, device=self.device, shard=shard,
            band=rows)
        if hasattr(self.train_loader, "set_sharding"):
            # the device-resident set yields this rank's rows at the source
            self.train_loader.set_sharding(shard, rows)

    def lr(self) -> float:
        return float(self.state.optimizer.param_groups[0]["lr"])

    def agree(self, values: List[float]) -> List[float]:
        """The step group's first rank's ``values`` on every rank of the
        group (a broadcast; the values themselves on one rank): every host
        decision is taken from them."""
        if self.step_group.group is None:
            return [float(v) for v in values]
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=self.step_group.root, group=self.step_group.group)
        return t.tolist()

    def _check_finite(self, loss_val: float, epoch: int, step_idx: int,
                      per_level):
        """Fail fast with context instead of training on garbage."""
        if not np.isfinite(loss_val):
            raise FloatingPointError(
                f"non-finite loss {loss_val} at epoch {epoch} "
                f"step {step_idx} (lr={self.lr():.2e}); per-level "
                f"losses: {np.asarray(per_level).tolist()}"
            )

    # ------------------------------------------------------------- epochs
    def epoch_batches(self, epoch: int):
        """The epoch's (x, y) batches on the device (this rank's rows)."""
        self.train_loader.set_epoch(epoch)
        if self.cfg.device_data:
            return self.train_loader
        return prefetch_to_device(self.train_loader, 2, self.device)

    def level_mask(self, epoch: int) -> torch.Tensor:
        return torch.tensor(
            self.cfg.level_mask_for_epoch(epoch, self.n_levels),
            dtype=torch.float32, device=self.device)

    def step(self, x, y, mask, epoch: int, n: int):
        """The epoch's ``n``-th train step (from 1); its aux stays on the
        device (reading it would synchronize every step), but every
        ``nan_probe_every`` steps one scalar fetch, the first rank's, bounds
        a bad run."""
        self.state, aux = self.train_step(self.state, x, y, mask)
        probe = max(0, int(self.cfg.nan_probe_every))
        if probe and n % probe == 0:
            loss = self.agree([float(aux["loss"])])[0]
            self._check_finite(loss, epoch, n - 1, aux["per_level"].cpu())
        return aux

    def epoch_result(self, epoch: int, device_aux: list, dt: float,
                     batches: int) -> dict:
        """The epoch's numbers from its steps' aux (one host transfer); the
        per-level losses are divided by ``batches`` global batches."""
        losses, level, confmats = _fetch(device_aux, self.n_levels)
        acc = MetricAccumulator(self.num_classes_per_level)
        for step_idx in range(len(losses)):
            self._check_finite(float(losses[step_idx]), epoch, step_idx,
                               level[step_idx])
            acc.update([cm[step_idx] for cm in confmats])
        denom = max(1, batches * self.cfg.batch_size)
        return {
            "loss": float(np.mean(losses)) if len(losses) else 0.0,
            "level_loss": (level.sum(0) / denom).tolist() if len(losses)
            else [0.0] * self.n_levels,
            "overall": acc.epoch_overall(),
            "per_class": acc.epoch_per_class(),
            "time": dt,
            "steps": len(losses),
        }

    def profile(self, epoch: int):
        """The trace around an epoch's steps: epoch 2 (the first steady
        one) under ``profile_dir``, else nothing."""
        return trace(self.cfg.profile_dir if epoch == 2 else None,
                     device=self.device)

    def train_epoch(self, epoch: int):
        mask = self.level_mask(epoch)
        t0 = time.time()
        device_aux = []
        with self.profile(epoch):
            for n, (x, y) in enumerate(self.epoch_batches(epoch), 1):
                device_aux.append(self.step(x, y, mask, epoch, n))
        return self.epoch_result(epoch, device_aux, time.time() - t0,
                                 len(self.train_loader))

    def evaluate(self, epoch: int, dump_images: bool = False):
        dump_fn = (
            (lambda outputs: dump_prediction_images(outputs, self.save_loc,
                                                    epoch))
            if dump_images and self.is_main else None
        )
        return run_validation(
            self.eval_step, self.val_loader, self.device,
            self.num_classes_per_level, self.cfg.val_batch, dump_fn=dump_fn,
        )

    def close(self):
        """Release the loaders' worker pools."""
        for ld in (self.train_loader, self.val_loader):
            ld.close()

    # ------------------------------------------------ records and decisions
    def open_records(self):
        """``(metrics.csv path, logger)``: the csv kept up to the resumed
        epoch (or removed on a fresh run) and the JSONL logger, on the
        writing rank; ``(None, None)`` on the others."""
        if not self.is_main:
            return None, None
        csv_path = os.path.join(self.save_loc, "metrics.csv")
        if os.path.exists(csv_path):
            if self.start_epoch > 1:
                # resume: keep history up to the resumed epoch, drop any rows
                # a crashed run wrote beyond the checkpoint
                truncate_csv(csv_path, self.start_epoch)
            else:
                os.remove(csv_path)  # fresh run (train.py:599-600)
        logger = MetricsLogger(os.path.join(self.save_loc, "logs"),
                               tensorboard=self.cfg.tensorboard)
        logger.truncate_after(self.start_epoch - 1)
        return csv_path, logger

    def record(self, csv_path, logger, epoch: int, tr: dict, va: dict,
               **train_log) -> None:
        """The epoch's metrics.csv row and logs (the writing rank only)."""
        if not self.is_main:
            return
        append_csv(csv_path, epoch, tr, va)
        logger.log(epoch, {
            "loss": tr["loss"], "dice": tr["overall"]["dice"],
            "iou": tr["overall"]["iou"],
            "sec_per_epoch": tr["time"], **train_log, "lr": self.lr(),
        }, prefix="train")
        logger.log(epoch, {
            "loss": va["loss"], "dice_no_bg": va["measure_mean"],
            "iou": va["overall"]["iou"], "dice": va["overall"]["dice"],
        }, prefix="val")

    def decide(self, epoch: int, tr: dict, va: dict) -> None:
        """The plateau step and the checkpoints, from the first rank's
        numbers on every rank."""
        loss, mean, std, lr = self.agree([tr["loss"], va["measure_mean"],
                                          va["measure_std"], self.lr()])
        if lr != self.lr():
            raise RuntimeError(
                f"learning rate {self.lr()} on rank {self.step_group.rank} "
                f"differs from {lr} on rank {self.step_group.root}")
        if self.scheduler:
            self.scheduler.step(mean)
        sched_meta = (
            {f"sched_{k}": (v if v is not None else float("nan"))
             for k, v in self.scheduler.state_dict().items()}
            if self.scheduler else {}
        )
        self.ckpt.update(self.state, epoch, loss, mean, std, **sched_meta)

    def run(self):
        cfg = self.cfg
        csv_path, logger = self.open_records()
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            if self.scheduler:
                set_learning_rate(self.state, self.scheduler.lr)
            tr = self.train_epoch(epoch)
            dump = cfg.save_images_batch and (
                epoch % cfg.save_images_batch_num == 0 or epoch == 1
            )
            va = self.evaluate(epoch, dump_images=dump)
            if self.is_main:
                print(
                    f"Epoch {epoch}: train loss {tr['loss']:.4f} "
                    f"({tr['steps']} steps, {tr['time']:.1f}s) | "
                    f"val dice(no bg) {va['measure_mean']:.4f} "
                    f"iou {va['overall']['iou']:.4f} "
                    f"lr {self.lr():.5f} | "
                    f"val {va.get('sec_total', 0.0):.1f}s "
                    f"(dispatch {va.get('sec_dispatch', 0.0):.1f}s)",
                    flush=True,
                )
            self.record(csv_path, logger, epoch, tr, va)
            self.decide(epoch, tr, va)
        self.ckpt.finalize()  # drain async saves; write a deferred best
        return self.ckpt.prev_best


def truncate_csv(path, start_epoch: int):
    """Resume: keep rows below ``start_epoch`` (drop rows a crashed run wrote
    beyond the checkpoint)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    kept = [r for i, r in enumerate(rows)
            if i == 0 or (r and r[0].isdigit() and int(r[0]) < start_epoch)]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(kept)


def append_csv(path, epoch, tr, va):
    """One reference-layout metrics.csv row (train.py:634-642)."""
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(CSV_HEADER)
        w.writerow([
            epoch, tr["loss"], tr["level_loss"], tr["overall"]["accuracy"],
            tr["overall"]["iou"], tr["overall"]["dice"],
            tr["overall"]["precision"], tr["overall"]["recall"],
            tr["per_class"], va["loss"], va["level_loss"],
            va["overall"]["accuracy"], va["overall"]["iou"],
            va["overall"]["dice"], va["overall"]["precision"],
            va["overall"]["recall"], va["measure_mean"], va["measure_std"],
            va["per_class"],
        ])


def train(cfg: RunConfig, device=None) -> List[Optional[float]]:
    """All folds (train.py:536-710; every fold runs), one fold after
    another on ``device`` (each over every rank of a multi-process run), or
    with ``cfg.fold_parallel`` all of them in lockstep
    (``train/fold_parallel.py``; JAX ``train/loop.py:535-538``).

    Cross-val layout: ``data_root/fold_N/{train,val}`` (train.py:796-803)."""
    check_supported(cfg)
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    fold_ids = _fold_ids(cfg)
    if cfg.fold_parallel and len(fold_ids) > 1:
        from .fold_parallel import train_folds_parallel

        return train_folds_parallel(cfg, tree, fold_ids, device=device)
    main = world()[0] == 0
    results = []
    for fold in fold_ids:
        if cfg.inc_cross_val and cfg.folds > 0:
            train_root = os.path.join(cfg.data_root, f"fold_{fold}", "train")
            val_root = os.path.join(cfg.data_root, f"fold_{fold}", "val")
        else:
            train_root = os.path.join(cfg.data_root, "train")
            val_root = cfg.val_dataset
            if val_root is None:
                cand = os.path.join(cfg.data_root, "val")
                val_root = cand if os.path.exists(cand) else None
        save_loc = os.path.join(cfg.save_path, f"fold_{fold}")
        if main:
            print(f"Fold {fold}: train={train_root} val={val_root} -> "
                  f"{save_loc}")
        fold_cfg = cfg
        if cfg.auto_resume and not cfg.model_weights:
            last = os.path.join(save_loc, "last.ckpt")
            if os.path.exists(last):
                fold_cfg = replace(cfg, model_weights=last)
                if main:
                    print(f"Auto-resuming fold {fold} from {last}")
        trainer = Trainer(fold_cfg, tree, train_root, val_root, save_loc,
                          device=device)
        try:
            results.append(trainer.run())
        finally:
            trainer.close()
    return results

"""The training loop: folds -> build -> epochs -> metrics.csv + best/last;
counterpart of the JAX package's ``train/loop.py``.

Host-side orchestration around the port's train and eval steps, replicating
the reference's ``train``/``train_epoch``/``test`` behaviours
(train.py:161-710) with the JAX package's fixes: every fold trains, the loss
takes the level weights, and the consistency term sees soft probabilities.

One device, no mesh: the model lives on ``device`` (``cuda`` unless the
caller asks for the CPU) in ``torch.channels_last``, where every BatchNorm
runs the port's kernels. Options of the JAX trainer that are not ported
yet raise (:func:`check_supported`).
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

from ..config.run import RunConfig
from ..data.dataset import SegDataset
from ..data.loader import BatchLoader, prefetch_to_device, split_ids
from ..data.png import encode_png_gray8
from ..hierarchy.tree import ClassTree
from ..metrics.segmentation import MetricAccumulator
from ..models.hierarchical import build_model
from ..utils.device import resolve_device
from ..utils.logging import MetricsLogger
from .checkpoint import CheckpointManager, load_checkpoint
from .plateau import ReduceLROnPlateau
from .state import create_train_state, set_learning_rate
from .steps import make_eval_step, make_train_step

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
    """Raise for the JAX trainer's options that the port does not have
    yet, naming the ROADMAP item that brings each."""
    refused = []
    if cfg.loader == "grain":
        refused.append("--loader grain (queue 1, item 6)")
    if cfg.device_data:
        refused.append("--device-data True (queue 1, item 6)")
    if cfg.fold_parallel and len(_fold_ids(cfg)) > 1:
        refused.append("--fold-parallel True over several folds "
                       "(queue 1, item 8)")
    if cfg.n_space > 1:
        refused.append(f"--n-space {cfg.n_space} (queue 1, item 8)")
    if cfg.remat:
        refused.append(f"--remat {cfg.remat} (queue 1, item 8)")
    if cfg.profile_dir:
        refused.append("--profile-dir (queue 1, item 8)")
    if refused:
        raise NotImplementedError(
            "not in the PyTorch port yet (ROADMAP.md): " + "; ".join(refused))


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
                 val_root: Optional[str]):
    """One fold's (train, val) loaders."""
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
    train_loader = BatchLoader(
        SegDataset(tr_imgs, tr_labs, tree, cfg.img_size, hier,
                   augment=True, **ds_kw),
        cfg.batch_size, shuffle=True, drop_last=True, seed=cfg.seed,
        **loader_kw,
    )
    val_loader = BatchLoader(
        SegDataset(va_imgs, va_labs, tree, cfg.img_size, hier,
                   augment=False, **ds_kw),
        cfg.val_batch, shuffle=False, drop_last=False, seed=cfg.seed,
        **loader_kw,
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


class Trainer:
    """One fold's build + epoch machinery on one device."""

    def __init__(self, cfg: RunConfig, tree: ClassTree,
                 train_root: str, val_root: Optional[str], save_loc: str,
                 device=None):
        if cfg.model_weights and cfg.model_weights.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{cfg.model_weights}: donor .pt/.pth weights are not "
                "ported yet (ROADMAP.md queue 1, item 7: "
                "train/torch_import.py); pass a <name>.ckpt directory "
                "written by the port's trainer to resume")
        self.cfg = cfg
        self.tree = tree
        self.save_loc = save_loc
        self.device = resolve_device(device)
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
                                concat_prev_probs=cfg.concat_prev_probs)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).train()
        self.state = create_train_state(self.model, cfg.lr, cfg.weight_decay)
        self._resume_meta = None
        if cfg.model_weights:  # one of the port's own .ckpt directories
            self.state, self._resume_meta = load_checkpoint(
                cfg.model_weights, self.state)
            print(f"Resumed from {cfg.model_weights}: {self._resume_meta}")

        lw = cfg.level_weights
        ohem = (cfg.ohem_thres, cfg.ohem_keep) if cfg.use_ohem else None
        self.train_step = make_train_step(
            self.model, tree, hier, lw, cfg.lambda_cons, cfg.lambda_kl,
            ohem=ohem, grad_accum=cfg.grad_accum,
            compute_dtype=cfg.compute_dtype,
        )
        self.eval_step = make_eval_step(
            self.model, tree, hier, lw, cfg.lambda_cons, cfg.lambda_kl,
            ohem=ohem, return_outputs=cfg.save_images_batch,
            compute_dtype=cfg.compute_dtype,
        )
        self.scheduler = ReduceLROnPlateau(
            cfg.lr, "max", 0.5, 3, min_lr=cfg.lrs_min
        ) if cfg.lrs else None
        self.ckpt = CheckpointManager(
            save_loc, ckpt_every=cfg.ckpt_every, final_epoch=cfg.epochs,
            best_save=cfg.best_save)

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
        self.train_loader, self.val_loader = make_loaders(
            cfg, tree, train_root, val_root
        )

    def lr(self) -> float:
        return float(self.state.optimizer.param_groups[0]["lr"])

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
    def train_epoch(self, epoch: int):
        cfg = self.cfg
        self.train_loader.set_epoch(epoch)
        mask = torch.tensor(cfg.level_mask_for_epoch(epoch, self.n_levels),
                            dtype=torch.float32, device=self.device)
        acc = MetricAccumulator(self.num_classes_per_level)
        t0 = time.time()
        n = 0
        # per-step aux stays on the device during the epoch (reading it
        # would synchronize every step); it is fetched once after the last
        device_aux = []
        probe = max(0, int(cfg.nan_probe_every))
        for x, y in prefetch_to_device(self.train_loader, 2, self.device):
            self.state, aux = self.train_step(self.state, x, y, mask)
            device_aux.append(aux)
            n += 1
            if probe and n % probe == 0:
                # one scalar fetch every `probe` steps bounds a bad run
                self._check_finite(float(aux["loss"]), epoch, n - 1,
                                   aux["per_level"].cpu())
        losses, level, confmats = _fetch(device_aux, self.n_levels)
        dt = time.time() - t0
        for step_idx in range(len(losses)):
            self._check_finite(float(losses[step_idx]), epoch, step_idx,
                               level[step_idx])
            acc.update([cm[step_idx] for cm in confmats])
        denom = max(1, len(self.train_loader) * cfg.batch_size)
        return {
            "loss": float(np.mean(losses)) if len(losses) else 0.0,
            "level_loss": (level.sum(0) / denom).tolist() if len(losses)
            else [0.0] * self.n_levels,
            "overall": acc.epoch_overall(),
            "per_class": acc.epoch_per_class(),
            "time": dt,
            "steps": n,
        }

    def evaluate(self, epoch: int, dump_images: bool = False):
        dump_fn = (
            (lambda outputs: dump_prediction_images(outputs, self.save_loc,
                                                    epoch))
            if dump_images else None
        )
        return run_validation(
            self.eval_step, self.val_loader, self.device,
            self.num_classes_per_level, self.cfg.val_batch, dump_fn=dump_fn,
        )

    def close(self):
        """Release the loaders' worker pools."""
        for ld in (self.train_loader, self.val_loader):
            ld.close()

    def run(self):
        cfg = self.cfg
        csv_path = os.path.join(self.save_loc, "metrics.csv")
        if os.path.exists(csv_path):
            if self.start_epoch > 1:
                # resume: keep history up to the resumed epoch, drop any rows
                # a crashed run wrote beyond the checkpoint
                truncate_csv(csv_path, self.start_epoch)
            else:
                os.remove(csv_path)  # fresh run (train.py:599-600)
        logger = MetricsLogger(os.path.join(self.save_loc, "logs"),
                               tensorboard=cfg.tensorboard)
        logger.truncate_after(self.start_epoch - 1)
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            if self.scheduler:
                set_learning_rate(self.state, self.scheduler.lr)
            tr = self.train_epoch(epoch)
            dump = cfg.save_images_batch and (
                epoch % cfg.save_images_batch_num == 0 or epoch == 1
            )
            va = self.evaluate(epoch, dump_images=dump)
            append_csv(csv_path, epoch, tr, va)
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
            logger.log(epoch, {
                "loss": tr["loss"], "dice": tr["overall"]["dice"],
                "iou": tr["overall"]["iou"],
                "sec_per_epoch": tr["time"], "lr": self.lr(),
            }, prefix="train")
            logger.log(epoch, {
                "loss": va["loss"], "dice_no_bg": va["measure_mean"],
                "iou": va["overall"]["iou"], "dice": va["overall"]["dice"],
            }, prefix="val")
            if self.scheduler:
                self.scheduler.step(va["measure_mean"])
            sched_meta = (
                {f"sched_{k}": (v if v is not None else float("nan"))
                 for k, v in self.scheduler.state_dict().items()}
                if self.scheduler else {}
            )
            self.ckpt.update(
                self.state, epoch, tr["loss"], va["measure_mean"],
                va["measure_std"], **sched_meta,
            )
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
    another on ``device``.

    Cross-val layout: ``data_root/fold_N/{train,val}`` (train.py:796-803)."""
    check_supported(cfg)
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    results = []
    for fold in _fold_ids(cfg):
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
        print(f"Fold {fold}: train={train_root} val={val_root} -> {save_loc}")
        fold_cfg = cfg
        if cfg.auto_resume and not cfg.model_weights:
            last = os.path.join(save_loc, "last.ckpt")
            if os.path.exists(last):
                fold_cfg = replace(cfg, model_weights=last)
                print(f"Auto-resuming fold {fold} from {last}")
        trainer = Trainer(fold_cfg, tree, train_root, val_root, save_loc,
                          device=device)
        try:
            results.append(trainer.run())
        finally:
            trainer.close()
    return results

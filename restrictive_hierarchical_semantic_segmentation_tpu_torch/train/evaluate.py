"""Offline prediction and evaluation, the library core of the predict_eval
CLI; counterpart of the JAX package's ``train/evaluate.py``.

Replicates predictEval.py:265-573: batched inference over one fold's
validation set, per-image per-level metrics, per-class binary mask PNG
dumps and ``metrics.csv``, including the **flat-model hierarchy
reconstruction** (predictEval.py:85-185): parent masks are unions of
descendant leaf predictions, stitched back into per-level tensors, so flat
models are scored on the same per-level class set as hierarchical ones.

The model runs on ``device`` (``cuda`` unless the caller asks for the CPU)
in eval mode and ``torch.channels_last``, so every BatchNorm runs the
port's scale-bias-act kernel. Under ``compute_dtype="float32"`` the card's
convolutions and matmuls compute in float32 for the run: PyTorch lets
cuDNN round float32 convolutions to TF32 by default, which moves the
argmax of near-tie pixels against the CPU and between batch sizes.
``quantize`` runs the forward's convs in int8 (``train/quantize.py``),
with activation scales calibrated on the first ``calib_batches``
validation batches; ``tta`` wraps it in the flip TTA. Weights are read by
the rule of ``train/torch_import.py:load_model_weights``: a ``<name>.ckpt``
directory written by the port's trainer, the port's own ``.pt``/``.pth``
``state_dict`` file, or a donor ``.pt``/``.pth`` checkpoint (imported as
the JAX Evaluator imports it; unmatched leaves keep the initialization
drawn from seed 0). A JAX orbax checkpoint is refused
(``train/checkpoint.py:load_state``).

The data mesh (JAX ``train/evaluate.py:151-164``, ``:225-237``): in a run
of several ranks (an initialized ``torch.distributed`` process group) the
batch is split over a data group of ``n_data`` ranks, the largest divisor
of the batch that is at most the world size (``mesh``, a
:class:`..parallel.mesh.RankMesh` with a ``data`` axis, overrides it). Each
rank of the group loads every padded batch and runs the forward on its
rows; the per-image confusion matrices, and the maps the host needs (PNG
dumps, a flat model's reconstruction), come back to every rank of the group
in image order (an all-reduce of the rows each rank fills, zeros elsewhere:
gloo reduces CUDA tensors but gathers none). The group's first rank scores
them and is the only one to print and write ``metrics.csv`` and PNGs; every
rank of the group returns its result. Ranks outside the group idle: they
build nothing, enter no collective of the group and return None. With one
rank everything is as without a process group.

The space axis (JAX ``train/evaluate.py:160-162``: ``cfg.n_space``): the
ranks form a ``(data, space)`` mesh, ``n_data`` the largest divisor of the
batch that is at most the world size over ``n_space``. Each rank runs the
forward on its band of rows of its data rows (``parallel/bands.py``); the
eval step adds the confusion matrices over the space group and gathers
the maps to the whole height, before the data group's gather. The step
group's first rank writes. ``quantize`` calibrates on the bands (each rank
observes its band of every conv's input; the maxima are all-reduced over
the space group, so every rank holds the whole image's scales) and the
banded convolutions run the int8 forward on their fetched rows, as JAX
wraps the forward over its ``(data, space)`` mesh in ``quantized_apply``.
"""
from __future__ import annotations

import csv
import os
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config.run import RunConfig
from ..data.dataset import SegDataset
from ..data.loader import BatchLoader, to_device
from ..data.png import encode_png_gray8
from ..hierarchy.tree import ClassTree
from ..metrics.segmentation import MetricAccumulator, level_confusion_matrices
from ..models.hierarchical import SegmenterOutput, build_model
from ..parallel.bands import band, check_bands, set_space_group
from ..parallel.mesh import DATA_AXIS, SPACE_AXIS, make_mesh, single, world
from ..utils.device import float32_convs as _float32_convs
from ..utils.device import resolve_device
from .torch_import import load_model_weights
from .loop import list_pairs
from .steps import _compute_dtype, make_eval_step

__all__ = ["reconstruct_levels_from_leaves", "tta_apply", "Evaluator",
           "predict_eval"]


def tta_apply(base_apply):
    """Horizontal-flip test-time augmentation: run the forward on ``x`` and
    ``x`` flipped along W (axis 2 of NHWC), unflip the second view's maps,
    average logits and composed probabilities per level. ``q_per_level``
    keeps the first view's conditionals (only the optional KL stabiliser
    reads them; it is a train-time term).

    Both views go through one forward over the batch of 2B images: eval-mode
    BatchNorm normalizes each image with the running statistics, so the
    images of a batch do not interact, and the BN kernels launch once per
    BatchNorm for both views."""
    def apply(x):
        b = x.shape[0]
        out = base_apply(torch.cat([x, x.flip(2)]))

        def unflip_avg(a):
            return 0.5 * (a[:b] + a[b:].flip(2))

        logits = [unflip_avg(z) for z in out.logits_per_level]
        probs = ([unflip_avg(p) for p in out.probs_per_level]
                 if out.probs_per_level is not None else None)
        qs = ([None if q is None else q[:b] for q in out.q_per_level]
              if out.q_per_level is not None else None)
        return SegmenterOutput(probs_per_level=probs, logits_per_level=logits,
                               q_per_level=qs)

    return apply


def reconstruct_levels_from_leaves(
    leaf_onehot: np.ndarray, tree: ClassTree
) -> List[np.ndarray]:
    """(B, H, W, n_leaves) one-hot leaf maps -> per-level (B, H, W, C_L)
    tensors with parent channels = union of descendant leaves
    (predictEval.py:85-129 ``get_parent_masks`` + :134-185 ``combine_levels``)."""
    parent_union = {
        p: (leaf_onehot[..., list(idxs)].max(-1))
        for p, idxs in zip(tree.parent_names_bfs, tree.descendant_leaves)
    }
    out = []
    for lvl in tree.levels:
        chans = []
        for name in lvl:
            if tree.children[name]:
                chans.append(parent_union[name])
            else:
                chans.append(leaf_onehot[..., tree.leaf_index[name]])
        out.append(np.stack(chans, axis=-1).astype(np.float32))
    return out


class Evaluator:
    """One fold's offline eval: forward -> (reconstruct) -> metrics -> dumps."""

    def __init__(self, cfg: RunConfig, tree: ClassTree, data_root: str,
                 weights_path: str, save_dir: Optional[str] = None,
                 save_images: bool = True, device=None, mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tree = tree
        self.save_dir = save_dir
        self.save_images = save_images and save_dir is not None
        hier = cfg.hierarchical
        # The reference runs offline eval at batch=1 (predictEval.py:222).
        # The forward runs at cfg.val_batch and each image is scored
        # separately (per_image_metrics), so metrics.csv equals the batch=1
        # run's.
        self.batch = max(1, cfg.val_batch)
        self.inflight = max(1, cfg.eval_inflight)
        groups = self._groups(mesh)
        if groups is None:  # idle in the mesh
            self.data = None
            self.is_main = False
            return
        self.data, self.space, self.step_group = groups
        self.is_main = self.step_group.is_main
        n = self.data.size
        per = self.batch // n
        self.rows = slice(self.data.index * per, (self.data.index + 1) * per)
        self.band = slice(None)
        if self.space.size > 1:
            check_bands(cfg.img_size, self.space.size)
            self.band = slice(*band(cfg.img_size, self.space.size,
                                    self.space.index))

        imgs, labs = list_pairs(data_root)
        self.target_paths = labs

        hrnet_cfg = None
        if cfg.hrnet_yaml:
            from ..config.hrnet import resolve_hrnet_config

            hrnet_cfg = resolve_hrnet_config(cfg.hrnet_yaml)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the init a donor leaves unmatched
            model = build_model(tree, cfg.model_select, cfg.model_type,
                                hrnet_cfg,
                                concat_prev_probs=cfg.concat_prev_probs)
        n_params = sum(p.numel() for p in model.parameters())
        if self.is_main:
            print("Number of model parameters: ", n_params)  # :259
        load_model_weights(model, weights_path, cfg.model_select)
        self.model = set_space_group(model.eval().to(
            self.device, memory_format=torch.channels_last), self.space)
        self.num_classes_per_level = list(tree.classes_per_level)

        # the data before the eval step: quantization calibrates on its
        # first batches; run() closes the loader, or a failure here does
        self.loader = BatchLoader(
            SegDataset(imgs, labs, tree, cfg.img_size, hier, augment=False,
                       target_dtype=np.int8 if cfg.host_compact else np.float32,
                       emit_gray=cfg.host_compact),
            batch_size=self.batch, shuffle=False, drop_last=False,
            num_workers=cfg.num_workers,
        )
        apply_fn = None
        if cfg.quantize:
            try:
                apply_fn = self._quantized_apply()
            except BaseException:
                self.loader.close()
                raise
        if cfg.tta:
            # composes with quantize: both views run the int8 convs
            apply_fn = tta_apply(apply_fn or self.model)
        # Flat mode needs full outputs on the host (the hierarchy
        # reconstruction is a host/numpy concern), the hierarchical path
        # only when dumping PNGs.
        self._need_outputs = self.save_images or not hier
        self.eval_step = make_eval_step(
            self.model, tree, hier, return_outputs=self._need_outputs,
            per_image_metrics=True, compute_dtype=cfg.compute_dtype,
            apply_fn=apply_fn, space=self.space,
        )

    def _groups(self, mesh):
        """This rank's (data, space, step) groups (module docstring), or
        None for a rank the mesh leaves idle."""
        n_space = self.cfg.n_space
        if mesh is None:
            _, size = world()
            if size == 1 and n_space == 1:
                return single(), single(), single()
            n_data = max([d for d in range(1, size // n_space + 1)
                          if self.batch % d == 0] or [1])
            # every rank makes its groups
            mesh = make_mesh(n_data=n_data, n_space=n_space)
        n_data = mesh.shape.get(DATA_AXIS, 0)
        if not n_data or self.batch % n_data:
            raise ValueError(
                f"the Evaluator's mesh needs a '{DATA_AXIS}' axis dividing "
                f"the batch {self.batch}; got {mesh.shape}")
        if mesh.position() is None:
            return None
        if mesh.shape.get(SPACE_AXIS, 1) == 1:
            return mesh.data_group(), single(), mesh.data_group()
        return mesh.data_group(), mesh.space_group(), mesh.step_group()

    def _gather(self, res: dict) -> dict:
        """The group's results of a batch, in image order: each rank's rows
        in a zero tensor of the whole batch, all-reduced (exact: every
        element is one rank's value plus zeros)."""
        group = self.data.group
        if group is None:
            return res
        out = {}
        for k in ("confmats", "outputs"):
            if k not in res:
                continue
            whole = []
            for t in res[k]:
                full = t.new_zeros((self.batch,) + tuple(t.shape[1:]))
                full[self.rows] = t
                dist.all_reduce(full, group=group)
                whole.append(full)
            out[k] = whole
        return out

    def _f32_on_card(self) -> bool:
        return (self.device.type == "cuda"
                and self.cfg.compute_dtype == "float32")

    def _quantized_apply(self):
        """Calibrate the activation scales as a running amax over the first
        ``cfg.calib_batches`` validation batches (one image's scales can
        clip the rest of the set), decoded as the eval step decodes them,
        in its compute dtype; a ragged last batch is padded by repeating
        its last image, which leaves the running amax unchanged. On bands
        each rank runs its band of every image, and the maxima are
        all-reduced over the space group."""
        from .quantize import calibrate, quantized_apply

        calib = []
        for xb, _ in self.loader:
            if xb.shape[0] < self.batch:
                pad = self.batch - xb.shape[0]
                xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
            x = torch.from_numpy(xb[:, self.band]).to(self.device)
            if x.shape[-1] == 1:  # train/steps.py:_device_decode
                x = x.expand(*x.shape[:-1], 3).contiguous()
            calib.append(x)
            if len(calib) >= self.cfg.calib_batches:
                break
        dtype = _compute_dtype(self.cfg.compute_dtype)

        def forward(x):
            with torch.autocast(self.device.type, dtype=dtype,
                                enabled=dtype != torch.float32):
                return self.model(x)

        with _float32_convs(self._f32_on_card()):
            self.act_scales = calibrate(self.model, calib, apply_fn=forward,
                                        space=self.space)
        return quantized_apply(self.model, self.act_scales)

    def run(self) -> Optional[dict]:
        """Score every image; returns ``{overall, per_class, measure,
        seconds}``, ``seconds`` holding the run's host-clock time
        (``total``) and the part spent waiting for the loader
        (``loader_wait``), the group's first rank's on every rank of the
        data group; None on an idle rank."""
        if self.data is None:
            return None
        tree = self.tree
        acc = MetricAccumulator(self.num_classes_per_level)
        if self.save_images and self.is_main:
            for c in range(tree.num_classes):
                os.makedirs(os.path.join(self.save_dir, str(c)), exist_ok=True)

        B = self.batch
        # Bounded in-flight window: dispatch ahead of the fetch loop (keeps
        # the device busy) but never hold more than `inflight` batches of
        # results on the device: a flat or save_images result is a few MB
        # per image, and a whole validation set's would not fit.
        pending = deque()
        img_idx = 0
        t0 = time.perf_counter()
        wait = 0.0
        batches = iter(self.loader)
        with _float32_convs(self._f32_on_card()):
            try:
                while True:
                    t_wait = time.perf_counter()
                    batch = next(batches, None)
                    wait += time.perf_counter() - t_wait
                    if batch is None:
                        break
                    x, y = batch
                    n_valid = x.shape[0]
                    if n_valid < B:
                        # pad the ragged last batch to the batch size; padded
                        # images' per-image results are dropped in _consume
                        pad = B - n_valid
                        x = np.concatenate(
                            [x, np.repeat(x[-1:], pad, axis=0)])
                        y = np.concatenate(
                            [y, -np.ones_like(np.repeat(y[-1:], pad, axis=0))])
                    # free a window slot BEFORE dispatching, so at most
                    # `inflight` batches of results are ever on the device
                    if len(pending) >= self.inflight:
                        img_idx = self._consume(*pending.popleft(), acc,
                                                img_idx)
                    res = self._gather(self.eval_step(*to_device(
                        (x[self.rows][:, self.band],
                         y[self.rows][:, self.band]), self.device)))
                    if self.is_main:
                        pending.append((res, n_valid, y))
                while pending:
                    img_idx = self._consume(*pending.popleft(), acc, img_idx)
            finally:
                self.loader.close()
        out = None
        if self.is_main:
            out = self._write_csv(acc)
            out["seconds"] = {"total": time.perf_counter() - t0,
                              "loader_wait": wait}
        if self.step_group.group is not None:  # the writer's, everywhere
            box = [out]
            dist.broadcast_object_list(box, src=self.step_group.root,
                                       group=self.step_group.group)
            out = box[0]
        return out

    def _consume(self, res, n_valid: int, y, acc: MetricAccumulator,
                 img_idx: int) -> int:
        """Fetch one dispatched batch's results and fold them into ``acc``."""
        tree = self.tree
        if self.cfg.hierarchical:
            cms = [c.cpu().numpy() for c in res["confmats"]]
            outputs = ([o.cpu().numpy() for o in res["outputs"]]
                       if self.save_images else None)
            for b in range(n_valid):
                acc.update([cm[b] for cm in cms])
                if self.save_images:
                    scores = [o[b : b + 1] for o in outputs]
                    targets = [
                        np.asarray(t[b : b + 1])
                        for t in tree.split_levels(y, axis=-1)
                    ]
                    self._dump(scores, targets, img_idx + b)
        else:
            # one fetch of the batch's leaf logits
            logits = res["outputs"][0].cpu().numpy()
            for b in range(n_valid):
                leaf_oh = np.eye(tree.num_leaves, dtype=np.float32)[
                    np.argmax(logits[b : b + 1], -1)
                ]
                scores = reconstruct_levels_from_leaves(leaf_oh, tree)
                targets = reconstruct_levels_from_leaves(
                    np.asarray(y[b : b + 1], np.float32), tree
                )
                cms = level_confusion_matrices(
                    [torch.from_numpy(s) for s in scores],
                    [torch.from_numpy(t) for t in targets])
                acc.update([c.numpy() for c in cms])
                if self.save_images:
                    self._dump(scores, targets, img_idx + b)
        return img_idx + n_valid

    def _dump(self, scores, targets, i):
        """Per-class binary PNGs named after the source label file
        (predictEval.py:501-513), 8-bit gray 0/255, through the port's PNG
        encoder (cv2.imwrite in the JAX package; the bytes differ, the
        decoded pixels do not)."""
        base = os.path.basename(self.target_paths[i])
        save_clss = 0
        for lvl_scores, lvl_t in zip(scores, targets):
            arr = np.asarray(lvl_scores[0])
            pred = np.argmax(arr, -1)
            masked = np.asarray(lvl_t[0]) == -1
            for c in range(arr.shape[-1]):
                img = (pred == c) & ~masked[..., c]
                with open(os.path.join(self.save_dir, str(save_clss), base),
                          "wb") as f:
                    f.write(encode_png_gray8(img.astype(np.uint8) * 255))
                save_clss += 1

    def _write_csv(self, acc: MetricAccumulator) -> dict:
        overall = acc.epoch_overall()
        per_class = acc.epoch_per_class()
        print("FINISHED TESTING")
        for k in ("accuracy", "iou", "dice", "precision", "recall"):
            print(f"Validation {k.capitalize() if k != 'iou' else 'IoU'}: ",
                  overall[k])
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, "metrics.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                w.writerow(["Type", "Class", "Accuracy", "IoU", "Dice",
                            "Precision", "Recall"])  # predictEval.py:557
                w.writerow(["Average", "All", overall["accuracy"],
                            overall["iou"], overall["dice"],
                            overall["precision"], overall["recall"]])
                for c, m in enumerate(per_class):
                    w.writerow(["Class", c, m["accuracy"], m["iou"], m["dice"],
                                m["precision"], m["recall"]])
        return {"overall": overall, "per_class": per_class,
                "measure": acc.selection_metric()}


def predict_eval(cfg: RunConfig, weights: List[str], roots: List[str],
                 save_root: str, save_images: bool = True,
                 device=None) -> List[Optional[dict]]:
    """Every fold in turn (predictEval.py:265-299), each over the data mesh
    of the run's ranks (module docstring)."""
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    results = []
    for fold, (w, r) in enumerate(zip(weights, roots), start=1):
        save_dir = os.path.join(save_root, f"fold_{fold}") if save_root else None
        if world()[0] == 0:
            print(f"Fold {fold}: root={r} weights={w}")
        ev = Evaluator(cfg, tree, r, w, save_dir, save_images, device=device)
        results.append(ev.run())
    return results

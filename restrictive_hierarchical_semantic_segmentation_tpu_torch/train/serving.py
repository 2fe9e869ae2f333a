"""Serving path: a predictor around the port's model, with fold ensembles,
test-time augmentation and int8 post-training quantization; counterpart of
the JAX package's ``train/serving.py:Predictor``.

The model runs in eval mode under ``torch.inference_mode()``, in
``torch.autocast`` bf16 when ``compute_dtype="bfloat16"`` (parameters stay
f32; in f32 on the card the convolutions compute in f32, not TF32, with the
flags restored after each call), with activations in
``torch.channels_last`` so every BatchNorm goes through the port's
scale-bias-act kernel. Outputs are the per-level logits
and composed probabilities (NHWC float32) and the first-max argmax class
maps of the logits, as numpy arrays.

The options wrap the model's forward as the JAX Predictor's do: the int8
convs of ``train/quantize.py`` inside, the horizontal-flip TTA of
``train/evaluate.py:tta_apply`` around them, and the fold mean outside. A
fold ensemble (a sequence of weights, see :meth:`Predictor.fold_checkpoints`)
runs each fold's forward in turn on one device and averages the per-level
probabilities in f32 in fold order (a flat model's are the softmax of its
logits); its class maps are the argmax of the mean probabilities and its
``logits`` are None.

``mesh`` (a :class:`..parallel.mesh.RankMesh` with a ``fold`` axis, the
JAX Predictor's ``mesh``) shards a fold ensemble over the ranks of a run:
rank ``i`` of its fold group loads only folds ``[i F / n, (i + 1) F / n)``
of the ``F`` weights (``n`` the fold axis' size), runs their forwards in
turn with TTA and int8 composed inside as above, and takes their f32 mean;
the ranks' means are then averaged over the fold group (an all-reduce of
their sum, divided by ``n``: JAX's ``pmean(p.mean(0))``, a mean of
means, equal to the fold mean up to f32 rounding). Every rank is called
with the same images and returns the same probabilities and class maps. A
mesh without a ``fold`` axis, or folds that do not divide it, raise as in
JAX; a single set of weights ignores the mesh, as JAX's does.

Weights are a ``state_dict`` in memory (``bridge.state_dict_from_flax``
makes one from JAX variables) or a path read by the ``--model-weights``
rule of ``train/torch_import.py:load_model_weights``: a ``.pt``/``.pth``
file whose keys are the model's ``state_dict`` keys is the port's own file
(written with ``torch.save``) and loads strictly; any other ``.pt``/``.pth``
file is a donor checkpoint (the published HRNet or milesial-UNet names),
imported as the JAX Predictor imports it, every leaf it does not match
keeping the model's initialization (drawn from seed 0); anything else is a
``<name>.ckpt`` directory written by the port's trainer (its ``state.pt``;
the counterpart of the JAX Predictor reading its orbax checkpoints). A JAX
orbax checkpoint is refused (``train/checkpoint.py:load_state``).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config.run import RunConfig
from ..hierarchy.tree import ClassTree
from ..models.hierarchical import build_model
from ..utils.device import float32_convs, resolve_device
from .torch_import import load_model_weights

__all__ = ["Predictor"]

_OUTPUTS = ("logits", "probs", "class_maps")


class Predictor:
    """``quantize=True`` runs the conv stack in int8 (``train/quantize.py``):
    per-tensor activation scales calibrated on ``calib_batches``
    (normalized NHWC images, as ``__call__`` takes them; by default one
    uniform batch in (-1, 1), as the JAX Predictor draws it), exposed as
    ``act_scales``, per-output-channel weight scales, the per-level heads
    in float. It does not compose with a fold ensemble (per-fold scales).

    ``weights`` may be a sequence of weights, one per fold: a fold
    ensemble (see the module docstring). A sequence of one is a single
    model. ``tta=True`` adds the horizontal-flip test-time augmentation."""

    @staticmethod
    def fold_checkpoints(run_dir: str, which: str = "best") -> List[str]:
        """``<run_dir>/fold_N/{best|last}.ckpt`` in fold order (the layout
        the trainer writes)."""
        def fold_num(p):
            suffix = p.split("fold_")[-1].split(os.sep)[0]
            return int(suffix) if suffix.isdigit() else None

        paths = sorted(
            (p for p in glob.glob(
                os.path.join(run_dir, "fold_*", f"{which}.ckpt"))
             if fold_num(p) is not None),  # skip e.g. fold_avg/ dirs
            key=fold_num,
        )
        if not paths:
            raise FileNotFoundError(
                f"no fold_<N>/{which}.ckpt under {run_dir}")
        return paths

    def __init__(self, cfg: RunConfig,
                 weights: Union[str, Mapping[str, torch.Tensor], Sequence],
                 tree: Optional[ClassTree] = None,
                 quantize: bool = False,
                 calib_batches: Optional[List[np.ndarray]] = None,
                 outputs: Sequence[str] = _OUTPUTS,
                 class_map_dtype: str = "int32",
                 tta: bool = False,
                 device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tree = tree or ClassTree.from_json(cfg.tree_root, cfg.class_map)
        self.outputs = tuple(outputs)
        bad = set(self.outputs) - set(_OUTPUTS)
        if bad:
            raise ValueError(f"unknown Predictor outputs: {sorted(bad)}")
        if class_map_dtype not in ("int32", "uint8"):
            raise ValueError("class_map_dtype must be 'int32' or 'uint8'")
        if class_map_dtype == "uint8" and any(
                len(l) > 256 for l in self.tree.levels):
            raise ValueError(
                "class_map_dtype='uint8' holds class ids 0..255; a level of "
                "this tree has more classes")
        self.class_map_dtype = (torch.uint8 if class_map_dtype == "uint8"
                                else torch.int32)
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.bf16 = cfg.compute_dtype == "bfloat16"

        folds = (list(weights)
                 if not isinstance(weights, (str, os.PathLike, Mapping))
                 else [weights])
        if not folds:
            raise ValueError("weights is an empty sequence")
        if quantize and len(folds) > 1:
            raise ValueError("quantize=True does not compose with a fold "
                             "ensemble (per-fold activation scales); "
                             "quantize single-fold predictors instead")
        self.ensemble = len(folds) > 1
        self.mesh = mesh if self.ensemble else None
        self.fold_group = None  # the ranks a fold-sharded mean spans
        if self.mesh is not None:
            self.fold_group, folds = self._local_folds(folds)
        hrnet_cfg = None
        if cfg.hrnet_yaml:
            from ..config.hrnet import resolve_hrnet_config

            hrnet_cfg = resolve_hrnet_config(cfg.hrnet_yaml)
        self.models = []
        for w in folds:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)  # the init a donor leaves unmatched
                model = build_model(self.tree, cfg.model_select,
                                    cfg.model_type, hrnet_cfg,
                                    concat_prev_probs=cfg.concat_prev_probs)
            if isinstance(w, Mapping):
                model.load_state_dict(w, strict=True)
            else:
                load_model_weights(model, w, cfg.model_select)
            self.models.append(model.eval().to(
                self.device, memory_format=torch.channels_last))
        self.model = self.models[0]

        applies = list(self.models)
        if quantize:
            from .quantize import calibrate, quantized_apply

            if not calib_batches:
                # no calibration data: one uniform batch in the training
                # normalization range (-1, 1), the JAX Predictor's default
                s = cfg.img_size
                calib_batches = [np.random.default_rng(0).uniform(
                    -1.0, 1.0, (1, s, s, 3)).astype(np.float32)]
            self.act_scales = calibrate(
                self.model, calib_batches,
                apply_fn=lambda x: self._autocast(self.model, x))
            applies = [quantized_apply(self.model, self.act_scales)]
        if tta:
            from .evaluate import tta_apply

            applies = [tta_apply(a) for a in applies]
        self._applies = applies

    def _local_folds(self, folds: list) -> tuple:
        """``(fold group, this rank's share of the fold weights)`` under
        ``mesh`` (JAX ``train/serving.py:256-265`` for the refusals'
        words)."""
        from ..parallel.mesh import FOLD_AXIS

        mesh = self.mesh
        if FOLD_AXIS not in mesh.axis_names:
            raise ValueError(
                f"Predictor mesh needs a '{FOLD_AXIS}' axis; got "
                f"{mesh.axis_names}")
        n_fold = mesh.shape[FOLD_AXIS]
        if len(folds) % n_fold != 0:
            raise ValueError(
                f"{len(folds)} fold checkpoints do not divide the "
                f"mesh '{FOLD_AXIS}' axis of size {n_fold}")
        group = mesh.fold_group()
        per = len(folds) // n_fold
        return group, folds[group.index * per:(group.index + 1) * per]

    def _autocast(self, apply, x):
        # f32 on the card computes its convolutions in f32, not TF32: under
        # cuDNN's default TF32 the class maps moved with the batch size and
        # away from the CPU's
        f32_on_card = not self.bf16 and self.device.type == "cuda"
        with float32_convs(f32_on_card), torch.autocast(
                self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            return apply(x)

    @staticmethod
    def _prep(x: torch.Tensor) -> torch.Tensor:
        """Raw uint8 input: normalize on the device ((x/255 - .5)/.5, the
        training Normalize(.5, .5)) and broadcast gray to 3 channels. The
        input is quantized to 8 bits before normalization (<= 1/255 per
        pixel against the f32 path). Float input passes unchanged."""
        if x.dtype != torch.uint8:
            return x
        if x.dim() == 3:
            x = x[..., None]
        x = (x.float() / 255.0 - 0.5) / 0.5
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        return x.contiguous()

    def forward(self, x: torch.Tensor) -> Dict:
        """Device tensors in, device tensors out (see :meth:`__call__`)."""
        with torch.inference_mode():
            return self.outputs_of(x)

    def outputs_of(self, x: torch.Tensor) -> Dict:
        """The requested outputs of ``x`` with autograd as the caller has
        it: the body of :meth:`forward`, which ``train/export.py`` traces."""
        x = self._prep(x)
        if self.ensemble:
            full = self._fold_mean(x)
        else:
            out = self._autocast(self._applies[0], x)
            full = {
                "logits": list(out.logits_per_level),
                "probs": (list(out.probs_per_level)
                          if out.probs_per_level is not None else None),
                "class_maps": [z.argmax(-1).to(self.class_map_dtype)
                               for z in out.logits_per_level],
            }
        return {k: full[k] for k in self.outputs}

    def _fold_mean(self, x: torch.Tensor) -> Dict:
        """Each fold's forward in turn; the per-level probabilities' f32
        mean over the folds in fold order and its argmax (under ``mesh``:
        this rank's folds' mean, then the mean over the fold group)."""
        fold_probs = []
        for apply in self._applies:
            out = self._autocast(apply, x)
            probs = out.probs_per_level
            if probs is None:  # flat: the ensemble is in prob space
                probs = [torch.softmax(z.float(), -1)
                         for z in out.logits_per_level]
            fold_probs.append([p.float() for p in probs])
        probs = [torch.stack(ps).mean(0) for ps in zip(*fold_probs)]
        group = self.fold_group
        if group is not None and group.group is not None:
            flat = torch.cat([p.reshape(-1) for p in probs])
            dist.all_reduce(flat, group=group.group)
            flat.div_(group.size)
            probs = [v.view(p.shape) for v, p in
                     zip(flat.split([p.numel() for p in probs]), probs)]
        return {"logits": None, "probs": probs,
                "class_maps": [p.argmax(-1).to(self.class_map_dtype)
                               for p in probs]}

    def warmup(self, batch: int = 1, input_dtype: str = "float32"):
        s = self.cfg.img_size
        if input_dtype == "uint8":
            self(np.zeros((batch, s, s), np.uint8))
            self(np.zeros((batch, s, s, 3), np.uint8))
        else:
            self(np.zeros((batch, s, s, 3), np.float32))

    def __call__(self, images: np.ndarray) -> Dict:
        """images: (B, H, W, 3) float32 normalized like training inputs, or
        raw uint8 (B, H, W, 3) / grayscale (B, H, W), normalized on the
        device. Returns numpy arrays: per-level NHWC logits and probs, and
        (B, H, W) class maps."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        out = self.forward(x)
        return {k: None if v is None else [t.cpu().numpy() for t in v]
                for k, v in out.items()}

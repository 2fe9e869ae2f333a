"""Serving path: a predictor around the port's model, with fold ensembles,
test-time augmentation and int8 post-training quantization; counterpart of
the JAX package's ``train/serving.py:Predictor``.

The model runs in eval mode under ``torch.inference_mode()``, in
``torch.autocast`` bf16 when ``compute_dtype="bfloat16"`` (parameters stay
f32), with activations in ``torch.channels_last`` so every BatchNorm goes
through the port's scale-bias-act kernel. Outputs are the per-level logits
and composed probabilities (NHWC float32) and the first-max argmax class
maps of the logits, as numpy arrays.

The options wrap the model's forward as the JAX Predictor's do: the int8
convs of ``train/quantize.py`` inside, the horizontal-flip TTA of
``train/evaluate.py:tta_apply`` around them, and the fold mean outside. A
fold ensemble (a sequence of weights, see :meth:`Predictor.fold_checkpoints`)
runs each fold's forward in turn on one device and averages the per-level
probabilities in f32 in fold order (a flat model's are the softmax of its
logits); its class maps are the argmax of the mean probabilities and its
``logits`` are None. The JAX Predictor's ``mesh``, which shards the folds
over chips, is not ported (ROADMAP.md queue 1, item 8).

Weights are the port's own ``state_dict``: a ``.pt`` file written with
``torch.save``, a ``<name>.ckpt`` directory written by the port's trainer
(its ``state.pt``; the counterpart of the JAX Predictor reading its orbax
checkpoints), or a dict in memory (``bridge.state_dict_from_flax`` makes
one from JAX variables). Loading JAX orbax checkpoints or donor ``.pth``
files is a later slice.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config.run import RunConfig
from ..hierarchy.tree import ClassTree
from ..models.hierarchical import build_model
from ..utils.device import resolve_device

__all__ = ["Predictor"]

_OUTPUTS = ("logits", "probs", "class_maps")


def _state_dict(weights) -> Mapping[str, torch.Tensor]:
    if isinstance(weights, Mapping):
        return weights
    path = str(weights).rstrip("/")
    if os.path.isdir(path) and path.endswith(".ckpt"):
        # a checkpoint of the port's trainer (train/checkpoint.py)
        from .checkpoint import load_state

        return load_state(path)["model"]
    if not path.endswith(".pt"):
        raise NotImplementedError(
            f"{path}: the port loads its own .pt state_dict or a <name>.ckpt "
            "directory written by its trainer; JAX orbax checkpoints and "
            "donor .pth loading are later slices (convert JAX variables "
            "with bridge.state_dict_from_flax and torch.save them)")
    return torch.load(path, map_location="cpu", weights_only=True)


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
                 device=None):
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
        hrnet_cfg = None
        if cfg.hrnet_yaml:
            from ..config.hrnet import resolve_hrnet_config

            hrnet_cfg = resolve_hrnet_config(cfg.hrnet_yaml)
        self.models = []
        for w in folds:
            model = build_model(self.tree, cfg.model_select, cfg.model_type,
                                hrnet_cfg,
                                concat_prev_probs=cfg.concat_prev_probs)
            model.load_state_dict(_state_dict(w), strict=True)
            self.models.append(model.eval().to(
                self.device, memory_format=torch.channels_last))
        self.model = self.models[0]
        self.ensemble = len(self.models) > 1

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

    def _autocast(self, apply, x):
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.bf16):
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
        mean over the folds in fold order and its argmax."""
        fold_probs = []
        for apply in self._applies:
            out = self._autocast(apply, x)
            probs = out.probs_per_level
            if probs is None:  # flat: the ensemble is in prob space
                probs = [torch.softmax(z.float(), -1)
                         for z in out.logits_per_level]
            fold_probs.append([p.float() for p in probs])
        probs = [torch.stack(ps).mean(0) for ps in zip(*fold_probs)]
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

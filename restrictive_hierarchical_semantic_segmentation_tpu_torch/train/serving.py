"""Serving path: a single-fold predictor around the port's model;
counterpart of the JAX package's ``train/serving.py:Predictor``.

The model runs in eval mode under ``torch.inference_mode()``, in
``torch.autocast`` bf16 when ``compute_dtype="bfloat16"`` (parameters stay
f32), with activations in ``torch.channels_last`` so every BatchNorm goes
through the port's scale-bias-act kernel. Outputs are the per-level logits
and composed probabilities (NHWC float32) and the first-max argmax class
maps of the logits, as numpy arrays.

Weights are the port's own ``state_dict``: a ``.pt`` file written with
``torch.save``, a ``<name>.ckpt`` directory written by the port's trainer
(its ``state.pt``; the counterpart of the JAX Predictor reading its orbax
checkpoints), or a dict in memory (``bridge.state_dict_from_flax`` makes
one from JAX variables). Fold ensembles, int8 quantization, TTA, meshes and
loading JAX orbax checkpoints or donor ``.pth`` files are later slices.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence, Union

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
    def __init__(self, cfg: RunConfig,
                 weights: Union[str, Mapping[str, torch.Tensor]],
                 tree: Optional[ClassTree] = None,
                 outputs: Sequence[str] = _OUTPUTS,
                 class_map_dtype: str = "int32",
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

        hrnet_cfg = None
        if cfg.hrnet_yaml:
            from ..config.hrnet import resolve_hrnet_config

            hrnet_cfg = resolve_hrnet_config(cfg.hrnet_yaml)
        model = build_model(self.tree, cfg.model_select, cfg.model_type,
                            hrnet_cfg, concat_prev_probs=cfg.concat_prev_probs)
        model.load_state_dict(_state_dict(weights), strict=True)
        self.model = model.eval().to(self.device,
                                     memory_format=torch.channels_last)

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
        with torch.inference_mode(), torch.autocast(
                self.device.type, dtype=torch.bfloat16, enabled=self.bf16):
            out = self.model(self._prep(x))
        full = {
            "logits": list(out.logits_per_level),
            "probs": (list(out.probs_per_level)
                      if out.probs_per_level is not None else None),
            "class_maps": [z.argmax(-1).to(self.class_map_dtype)
                           for z in out.logits_per_level],
        }
        return {k: full[k] for k in self.outputs}

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

"""Deployment artifact: the ``Predictor``'s forward as a ``torch.export``
program; counterpart of the JAX package's ``train/export.py`` (StableHLO
through ``jax.export``).

:func:`export_predictor` traces the :class:`~.serving.Predictor`'s forward
(:meth:`~.serving.Predictor.outputs_of`: the int8 convs inside, the flip
TTA around them, the fold mean outside, only the requested outputs) with
``torch.export.export`` and writes the program with ``torch.export.save``
(conventionally ``*.pt2``), plus a JSON sidecar at ``<out>.json`` with the
JAX sidecar's keys (``torch_version`` in place of ``jax_version``):

* the artifact holds its weights: ``torch.export`` lifts the parameters
  and buffers of every fold to inputs of the program and stores them in
  the archive, so a fold ensemble is one file too (its sidecar says
  ``"ensemble": {"folds": n, "weights_file": null}``; the JAX package ships
  its stacked fold weights beside the program because of XLA's program
  size limits);
* the batch dimension is symbolic by default (``torch.export.Dim``), so one
  artifact serves any batch; H and W stay static;
* every eval-mode BatchNorm of the program is one node of the operator
  ``torch.ops.rhss.scale_bias_act`` (the port's kernel on a CUDA tensor,
  its plain version on a CPU tensor), and every int8 conv one node of
  ``torch.ops.rhss.int8_conv2d`` (``ops/``);
* ``platforms`` lists the devices the artifact may be loaded on (``cuda``,
  ``cpu``), the exporting device first; :func:`load_exported` moves the
  program to another listed device with
  ``torch.export.passes.move_to_device_pass`` and refuses one the sidecar
  does not list. A bf16 artifact lists its exporting device only: the
  program holds the ``torch.autocast`` region of that device type, which
  does not cast on another one (on an H100 a bf16 UNet exported on the
  card and moved to the CPU failed its own dtype checks), so a
  ``compute_dtype="bfloat16"`` Predictor with another platform is
  refused; export in float32 for both.

Loading needs only ``torch`` and the port's ``ops`` package, which
registers the ``rhss::*`` operators: none of the port's model code runs,
as the JAX docstring says of its own artifact. A fold ensemble sharded over
the ranks of a fold mesh (the ``Predictor``'s ``mesh``) is refused with the
JAX exporter's words: its program would hold one rank's folds and a
collective over the exporting run's process group.
"""
from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

# registers torch.ops.rhss.scale_bias_act and torch.ops.rhss.int8_conv2d,
# which an exported program calls
from ..ops import fused_bn_act as _fused_bn_act  # noqa: F401
from ..ops import int8_conv as _int8_conv  # noqa: F401

__all__ = ["export_predictor", "load_exported", "ExportedPredictor"]

_SIDECAR_SUFFIX = ".json"
_DEVICES = ("cuda", "cpu")


class _Program(torch.nn.Module):
    """The Predictor's forward as a module: its fold models are submodules,
    so their parameters and buffers become the program's."""

    def __init__(self, predictor):
        super().__init__()
        self.folds = torch.nn.ModuleList(predictor.models)
        self._outputs_of = predictor.outputs_of

    def forward(self, x: torch.Tensor) -> Dict:
        return self._outputs_of(x)


def _platforms(device: str, platforms: Optional[Sequence[str]]):
    out = [device] + [p for p in (platforms or ()) if p != device]
    bad = [p for p in out if p not in _DEVICES]
    if bad:
        raise ValueError(f"platforms {bad}: an artifact is loaded on "
                         f"{' or '.join(_DEVICES)}")
    return list(dict.fromkeys(out))


def export_predictor(
    predictor,
    out_path: str,
    batch: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
) -> str:
    """Write ``predictor``'s forward to ``out_path`` as a ``torch.export``
    program.

    Args:
      predictor: a :class:`~.serving.Predictor`, one fold or a fold
        ensemble, with any of its options but a fold ``mesh``.
      out_path: artifact path (conventionally ``*.pt2``); a JSON sidecar is
        written next to it at ``out_path + ".json"``.
      batch: static batch size, or ``None`` (default) for a symbolic batch
        dimension: one artifact, any batch.
      platforms: the devices the artifact may be loaded on (``"cuda"``,
        ``"cpu"``); the exporting device (the Predictor's) is always the
        first. ``None``: the exporting device only. More than one needs
        ``compute_dtype="float32"``.

    Returns the artifact path.
    """
    if predictor.ensemble and predictor.mesh is not None:
        raise ValueError(
            "mesh-sharded fold-ensemble Predictors are not exportable (the "
            "artifact would pin the exporting mesh); export the unsharded "
            "ensemble (mesh=None) or per-fold artifacts instead")
    cfg = predictor.cfg
    plats = _platforms(predictor.device.type, platforms)
    if cfg.compute_dtype != "float32" and len(plats) > 1:
        raise ValueError(
            f"a {cfg.compute_dtype} artifact runs only on the device type it "
            f"was exported on ({plats[0]}): its autocast region does not "
            f"cast on {plats[1:]}; export float32 for several platforms")
    s = cfg.img_size
    # a symbolic batch is traced at 2 (torch.export specializes sizes 0, 1)
    x = torch.zeros((2 if batch is None else int(batch), s, s, 3),
                    device=predictor.device)
    dynamic = ({0: torch.export.Dim("b", min=1)},) if batch is None else None
    with torch.no_grad():
        program = torch.export.export(_Program(predictor), (x,),
                                      dynamic_shapes=dynamic, strict=False)

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, out_path)  # two-phase, like the checkpoint writer

    tree = predictor.tree
    hierarchical = cfg.model_type == 1
    level_classes = ([list(lv) for lv in tree.levels] if hierarchical
                     else [list(tree.leaf_names)])
    shape = ["b" if batch is None else str(int(batch)), str(s), str(s), "3"]
    meta = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "platforms": plats,
        "img_size": s,
        "batch": "symbolic" if batch is None else int(batch),
        "input": {"shape": shape, "dtype": "float32",
                  "layout": "NHWC, training-normalized"},
        "outputs": {
            "keys": sorted(predictor.outputs),
            "level_classes": level_classes,
        },
        "model": {
            "model_select": cfg.model_select,
            "model_type": cfg.model_type,
            "compute_dtype": cfg.compute_dtype,
            "quantized": hasattr(predictor, "act_scales"),
        },
        "ensemble": ({"folds": len(predictor.models), "weights_file": None}
                     if predictor.ensemble else None),
        "artifact_bytes": len(blob),
    }
    with open(out_path + _SIDECAR_SUFFIX, "w") as f:
        json.dump(meta, f, indent=2)
    return out_path


def _program_device(program) -> Optional[torch.device]:
    for t in program.state_dict.values():
        return t.device
    return None


class ExportedPredictor:
    """Callable wrapper over a loaded artifact.

    Mirrors :meth:`~.serving.Predictor.__call__`: takes ``(B, H, W, 3)``
    float32 training-normalized images, returns numpy outputs keyed like
    the exporting Predictor's. ``meta`` is the sidecar dict (``{}`` if the
    sidecar is missing: the artifact alone is still runnable)."""

    def __init__(self, program, meta: Dict, device: torch.device):
        self.meta = meta
        self.program = program
        self.device = device
        self._module = program.module()

    @property
    def platforms(self):
        return tuple(self.meta.get("platforms", ()))

    def forward(self, x: torch.Tensor) -> Dict:
        """Device tensors in, device tensors out."""
        with torch.inference_mode():
            return self._module(x)

    def __call__(self, images: np.ndarray) -> Dict:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        out = self.forward(x.to(self.device))
        return {k: None if v is None else [t.cpu().numpy() for t in v]
                for k, v in out.items()}


def load_exported(path: str, device=None) -> ExportedPredictor:
    """Load an artifact written by :func:`export_predictor`, on ``device``
    (default: where it was exported), which must be one of the sidecar's
    ``platforms``.

    Needs only ``torch`` and the port's ``ops`` package: none of the port's
    model code runs; the graph (weights included) comes from the artifact.
    """
    program = torch.export.load(path)
    meta: Dict = {}
    sidecar = path + _SIDECAR_SUFFIX
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    here = _program_device(program)
    target = torch.device(device) if device is not None else here
    if (target is not None and here is not None and target.index is None
            and target.type == here.type):
        target = here  # "cuda" names the device it was exported on
    if target is not None and target != here:
        allowed = meta.get("platforms", [])
        if target.type not in allowed:
            raise ValueError(f"{path} may be loaded on {allowed} (its "
                             f"sidecar's platforms), not on {target}")
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, target)
    return ExportedPredictor(program, meta, target or torch.device("cpu"))

"""Donor-checkpoint import and the ``--model-weights`` rule of the port;
counterpart of the JAX package's ``train/torch_import.py``.

The JAX package reads every ``.pt``/``.pth`` path as a donor checkpoint:
the published HRNet checkpoints (reference ``init_weights``,
models.py:804-832: ``model.``/``module.``/``net.``/``network.`` prefixes
stripped, exact name then shape-checked suffix match) and the milesial
Pytorch-UNet carvana release (the reference's "in/up/down/out" key merger,
train.py:470-505). This module is a copy of its matcher in numpy: every
flax leaf path of the model is translated to its expected torch name(s)
(:func:`translate_flax_path`), a shape-checked suffix match is the
fallback, conv kernels go OIHW -> HWIO and linear ones (O, I) -> (I, O).
Unmatched leaves keep the model's initialization.

:func:`load_donor_weights` runs it on a port model through the weight
bridge: ``bridge.flax_from_state_dict`` gives the flax-shaped ``params``
and ``batch_stats`` of the model's ``state_dict``, the matcher replaces the
leaves it finds, ``bridge.state_dict_from_flax`` converts back, and the
model loads the result strictly.

:func:`load_model_weights` is the rule every reader of ``--model-weights``
follows (the ``Predictor``, the ``Trainer``, the ``Evaluator``):

* a ``.pt``/``.pth`` file whose keys are exactly the model's
  ``state_dict`` keys is the port's own file and loads strictly;
* any other ``.pt``/``.pth`` file is a donor checkpoint (the JAX rule for
  every ``.pt``/``.pth``);
* anything else is a checkpoint directory of the port's trainer
  (``train/checkpoint.py:load_state``, which refuses a JAX orbax one).

Files are read with ``torch.load(..., weights_only=False)``, as the JAX
importer reads them: only load checkpoints from a source you trust.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..bridge import flax_from_state_dict, state_dict_from_flax

__all__ = ["load_torch_state_dict", "load_donor_weights",
           "load_model_weights", "translate_flax_path"]

_PREFIXES = ("model.", "module.", "net.", "network.")


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _donor_state_dict(ckpt) -> Dict[str, np.ndarray]:
    """A loaded checkpoint -> ``{torch name: numpy array}``: unwrap
    ``state_dict``/``model_state_dict``, strip the wrapper prefixes, drop
    entries that are not tensors."""
    for key in ("state_dict", "model_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        kk = k
        changed = True
        while changed:
            changed = False
            for p in _PREFIXES:
                if kk.startswith(p):
                    kk = kk[len(p):]
                    changed = True
        try:
            out[kk] = v.detach().cpu().numpy()
        except AttributeError:
            continue
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The donor file at ``path`` as ``{torch name: numpy array}``."""
    return _donor_state_dict(_read(path))


def _bn_suffix(leaf: str, collection: str) -> Optional[str]:
    if collection == "params":
        return {"scale": "weight", "bias": "bias"}.get(leaf)
    return {"mean": "running_mean", "var": "running_var"}.get(leaf)


def translate_flax_path(
    path: Tuple[str, ...], collection: str, model_select: int
) -> List[str]:
    """Expected torch key(s) for a flax leaf path (most specific first)."""
    *mods, leaf = path
    name = "/".join(mods)
    name = re.sub(r"^backbone/?", "", name)

    def conv(tname: str) -> List[str]:
        return [f"{tname}.weight" if leaf == "kernel" else f"{tname}.bias"]

    def bn(tname: str) -> List[str]:
        sfx = _bn_suffix(leaf, collection)
        return [f"{tname}.{sfx}"] if sfx else []

    cands: List[str] = []
    if model_select == 0:  # UNet (milesial naming + reference naming)
        m = re.fullmatch(r"(inc|down\d|up\d)/conv/(conv|bn)(\d)", name) or \
            re.fullmatch(r"(inc)/(conv|bn)(\d)", name)
        if m:
            blockname, kind, idx = m.group(1), m.group(2), int(m.group(3))
            seq_idx = 0 if idx == 0 else 3
            if kind == "bn":
                seq_idx += 1
            for stem in _unet_stems(blockname):
                cands += conv(f"{stem}.{seq_idx}") if kind == "conv" else bn(
                    f"{stem}.{seq_idx}"
                )
    else:  # HRNet
        m = re.fullmatch(r"stem_(conv|bn)(\d)", name)
        if m:
            kind, i = m.group(1), int(m.group(2))
            # reference model naming: stem Sequential (models.py:578-585)
            seq = (0 if i == 0 else 3) + (1 if kind == "bn" else 0)
            cands += (conv if kind == "conv" else bn)(f"stem.{seq}")
            # upstream published-checkpoint naming: conv1/bn1/conv2/bn2
            t = f"{kind}{i + 1}"
            cands += conv(t) if kind == "conv" else bn(t)
        m = re.fullmatch(r"layer1/block(\d+)/(\w+)", name)
        if m:
            cands += _hrnet_block(f"layer1.{m.group(1)}", m.group(2), conv, bn)
        m = re.fullmatch(r"transition(\d)/t(\d+)_(conv|bn)(\d*)", name)
        if m:
            t, i, kind, j = m.groups()
            seq = 0 if kind == "conv" else 1
            if j == "":  # simple Sequential(conv, bn, relu)
                cands += (conv if kind == "conv" else bn)(
                    f"transition{t}.{i}.{seq}"
                )
            else:  # nested Sequential for new branches
                cands += (conv if kind == "conv" else bn)(
                    f"transition{t}.{i}.{j}.{seq}"
                )
        m = re.fullmatch(r"stage(\d)_m(\d+)/branch(\d+)/block(\d+)/(\w+)", name)
        if m:
            s, mm, b, k, sub = m.groups()
            cands += _hrnet_block(
                f"stage{s}.{mm}.branches.{b}.{k}", sub, conv, bn
            )
        m = re.fullmatch(r"stage(\d)_m(\d+)/fuse(\d+)_(\d+)/(conv|bn)(\d*)", name)
        if m:
            s, mm, i, j, kind, k = m.groups()
            base = f"stage{s}.{mm}.fuse_layers.{i}.{j}"
            seq = 0 if kind == "conv" else 1
            if k == "":  # upsample path: Sequential(conv, bn)
                cands += (conv if kind == "conv" else bn)(f"{base}.{seq}")
            else:  # downsample chain: .{k}.(0 conv | 1 bn)
                cands += (conv if kind == "conv" else bn)(f"{base}.{k}.{seq}")
        m = re.fullmatch(r"shared_head_(conv|bn)", name)
        if m:
            for stem in ("shared_head", "last_layer"):
                seq = 0 if m.group(1) == "conv" else 1
                cands += (conv if m.group(1) == "conv" else bn)(f"{stem}.{seq}")
    return cands


def _unet_stems(block: str) -> List[str]:
    if block == "inc":
        return ["inc.double_conv", "inc0.conv.conv", "inc.conv.conv"]
    if block.startswith("down"):
        return [f"{block}.maxpool_conv.1.double_conv", f"{block}.mpconv.1.conv"]
    return [f"{block}.conv.double_conv", f"{block}.conv.conv"]


def _hrnet_block(base: str, sub: str, conv, bn) -> List[str]:
    m = re.fullmatch(r"(conv|bn)(\d)", sub)
    if m:
        return (conv if m.group(1) == "conv" else bn)(f"{base}.{sub}")
    if sub == "downsample_conv":
        return conv(f"{base}.downsample.0")
    if sub == "downsample_bn":
        return bn(f"{base}.downsample.1")
    return []


def _convert(torch_arr: np.ndarray, flax_shape: tuple,
             leaf: str) -> Optional[np.ndarray]:
    a = torch_arr
    if leaf == "kernel":
        if a.ndim == 4:  # conv OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2:  # linear (O, I) -> (I, O)
            a = a.T
    if tuple(a.shape) != tuple(flax_shape):
        return None
    return a


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Leaves by path, keys sorted at every level: the order of JAX's
    pytree flattening of the JAX model's variables, so the "Missing" line
    lists the leaves the JAX importer lists."""
    out = {}
    for k, v in sorted(tree.items()):
        p = prefix + (k,)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]):
    root: dict = {}
    for path, v in flat.items():
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return root


def _import_collection(sd, flat, collection, model_select, stats):
    out = {}
    for path, leaf_val in flat.items():
        shape = tuple(np.shape(leaf_val))
        matched = None
        for cand in translate_flax_path(path, collection, model_select):
            if cand in sd:
                conv = _convert(sd[cand], shape, path[-1])
                if conv is not None:
                    matched = conv
                    break
        if matched is None:
            # reference-style suffix fallback (models.py:820-824), shape-checked
            tail = ".".join(path[-2:]).replace("/", ".")
            for k, v in sd.items():
                if k.endswith(tail):
                    conv = _convert(v, shape, path[-1])
                    if conv is not None:
                        matched = conv
                        break
        if matched is not None:
            out[path] = np.asarray(matched, dtype=np.asarray(leaf_val).dtype)
            stats["loaded"] += 1
        else:
            out[path] = leaf_val
            stats["missing"].append("/".join(path))
    return _unflatten(out)


def _load_donor(sd: Dict[str, np.ndarray], model: torch.nn.Module,
                model_select: int) -> None:
    params, batch_stats = flax_from_state_dict(model.state_dict())
    stats = {"loaded": 0, "missing": []}
    new_params = _import_collection(sd, _flatten(params), "params",
                                    model_select, stats)
    new_bs = _import_collection(sd, _flatten(batch_stats), "batch_stats",
                                model_select, stats)
    total = stats["loaded"] + len(stats["missing"])
    print(f"Loaded {stats['loaded']} / {total} layers.")
    if stats["missing"]:
        print(f"Missing {len(stats['missing'])} layers (first 10): "
              f"{stats['missing'][:10]}")
    model.load_state_dict(state_dict_from_flax(new_params, new_bs),
                          strict=True)


def load_donor_weights(path: str, model: torch.nn.Module,
                       model_select: int = 1) -> torch.nn.Module:
    """Import the donor ``.pth`` at ``path`` onto ``model`` (in place) and
    return it; prints the reference-style coverage line (models.py:827)."""
    _load_donor(load_torch_state_dict(path), model, model_select)
    return model


def load_model_weights(model: torch.nn.Module, path: str,
                       model_select: int) -> None:
    """Load ``--model-weights`` ``path`` into ``model`` by the rule of the
    module docstring: the port's own ``.pt``/``.pth`` strictly, any other
    ``.pt``/``.pth`` as a donor, anything else as a checkpoint directory of
    the port's trainer."""
    path = str(path).rstrip("/")
    if not path.endswith((".pt", ".pth")):
        from .checkpoint import load_state

        model.load_state_dict(load_state(path)["model"], strict=True)
        return
    ckpt = _read(path)
    if isinstance(ckpt, dict) and set(ckpt) == set(model.state_dict()):
        model.load_state_dict(ckpt, strict=True)
        return
    _load_donor(_donor_state_dict(ckpt), model, model_select)

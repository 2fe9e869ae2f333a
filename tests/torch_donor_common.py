"""Shared helper of the donor-import tests: a synthetic donor checkpoint
under the reference's torch names, written from flax variables (numpy).

Every leaf goes under its first ``translate_flax_path`` candidate (the JAX
package's map to the reference's and the published checkpoints' names);
a leaf with no candidate (the per-level heads, FiLM) goes under its dotted
flax path, which the importer's shape-checked suffix fallback matches.
Conv kernels are written OIHW and linear ones (O, I), as torch stores
them."""
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.train.torch_import import (
    translate_flax_path,
)


def leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def donor_state_dict(params, stats, model_select: int,
                     keep: Optional[Callable] = None) -> dict:
    """``{torch name: tensor}`` of the flax ``params`` and ``stats``; only
    the leaves whose path ``keep`` accepts (default: all)."""
    out = {}
    for coll, tree in (("params", params), ("batch_stats", stats)):
        for path, arr in leaves(tree):
            if keep is not None and not keep(path):
                continue
            cands = translate_flax_path(path, coll, model_select)
            name = cands[0] if cands else ".".join(path)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            assert name not in out, name
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out

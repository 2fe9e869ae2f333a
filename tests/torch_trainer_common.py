"""Shared helpers of the trainer tests (``test_torch_trainer*.py``): the
hierarchical UNet at base width 8 patched into each package's trainer (as
``tests/test_resume.py`` does for the JAX one), and metrics.csv cells as
numbers."""
import ast

import numpy as np

PORT = "restrictive_hierarchical_semantic_segmentation_tpu_torch"
JAX_PKG = "restrictive_hierarchical_semantic_segmentation_tpu"


def small_model(monkeypatch):
    """The trainer's model is a hierarchical UNet of base width 8 (with the
    run's ``remat``)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (
        UNetBackbone,
    )

    def small(tree, model_select, model_type, *args, remat=False, **kwargs):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8),
                                       hierarchical=model_type == 1,
                                       remat=remat)

    monkeypatch.setattr(f"{PORT}.train.loop.build_model", small)
    monkeypatch.setattr(f"{PORT}.train.serving.build_model", small)


def jax_small_model(monkeypatch):
    from restrictive_hierarchical_semantic_segmentation_tpu.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.unet import (
        UNetBackbone,
    )

    def small(tree, model_select, model_type, *args, **kwargs):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8),
                                       hierarchical=model_type == 1)

    monkeypatch.setattr(f"{JAX_PKG}.train.loop.build_model", small)


def numbers(cell):
    """A metrics.csv cell as a flat float array (scalars, lists of
    per-level losses, lists of per-class metric dicts)."""
    def flat(v):
        if isinstance(v, dict):
            return [x for k in sorted(v) for x in flat(v[k])]
        if isinstance(v, (list, tuple)):
            return [x for e in v for x in flat(e)]
        return [float(v)]
    return np.asarray(flat(ast.literal_eval(cell)), float)

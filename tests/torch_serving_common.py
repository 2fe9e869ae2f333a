"""Shared helpers of the serving-option tests (``test_torch_quantize.py``,
``test_torch_serving_options.py``): each package's ``Predictor`` on the
same seeded variables, with the model built by the test (the hierarchical
or flat UNet at base width 8, or the tiny HRNet), at 32 px, in f32.

The JAX Predictor is given its variables without ``model.init`` or an
orbax checkpoint: ``create_train_state`` and ``load_checkpoint`` are
patched to hand it the variables stored under each weights path (a name
of the test's choosing). The port's Predictor gets the same variables
through ``bridge.state_dict_from_flax``."""
from types import SimpleNamespace

import numpy as np

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    checkpoint as jckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    serving as jserving,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    build_model as port_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    serving as pserving,
)
from torch_eval_common import IMG, jax_small, port_small
from torch_port_common import ASSETS, jax_variables, tiny_configs, trees

TREE = {"tree_root": str(ASSETS / "class_tree_tl.json"),
        "class_map": str(ASSETS / "class_map.csv")}


def models(name: str, model_type: int = 1):
    """(JAX model, a maker of fresh port models) of ``name``: "unet" (base
    width 8) or "hrnet" (tests/test_models.py:tiny_hrnet)."""
    jtree, ptree = trees("default")
    if name == "unet":
        return (jax_small(jtree, model_type),
                lambda: port_small(ptree, model_type))
    jcfg, pcfg = tiny_configs()
    return (jax_build_model(jtree, 1, model_type, jcfg),
            lambda: port_build_model(ptree, 1, model_type, pcfg))


def variables(jmodel, seed: int):
    """Seeded numpy (params, batch_stats) of ``jmodel`` at 32 px."""
    return jax_variables(jmodel, np.zeros((1, IMG, IMG, 3), np.float32),
                         seed=seed, train=False)


def jax_predictor(monkeypatch, jmodel, by_path: dict, weights, **kw):
    """The JAX Predictor over ``weights`` (a name of ``by_path`` or a list
    of them), each name's ``(params, batch_stats)`` from ``by_path``."""
    monkeypatch.setattr(jserving, "build_model", lambda *a, **k: jmodel)
    monkeypatch.setattr(jserving, "create_train_state",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda path, state: (
        SimpleNamespace(params=by_path[path][0],
                        batch_stats=by_path[path][1]), {}))
    cfg = JaxRunConfig(img_size=IMG, model_type=jmodel.hierarchical * 1,
                       **TREE)
    return jserving.Predictor(cfg, weights, tree=trees("default")[0], **kw)


def port_predictor(monkeypatch, make_model, weights, **kw):
    """The port's Predictor on the CPU; ``weights`` are (params,
    batch_stats) pairs, one or a list of them."""
    monkeypatch.setattr(pserving, "build_model",
                        lambda *a, **k: make_model())
    model_type = int(make_model().hierarchical)
    cfg = RunConfig(img_size=IMG, model_type=model_type, **TREE)
    sds = ([state_dict_from_flax(*w) for w in weights]
           if isinstance(weights, list) else state_dict_from_flax(*weights))
    return pserving.Predictor(cfg, sds, tree=trees("default")[1],
                              device="cpu", **kw)


def images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(n, IMG, IMG, 3)).astype(np.float32)

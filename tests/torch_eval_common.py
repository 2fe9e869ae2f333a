"""Shared helpers of the offline-eval tests (``test_torch_evaluate.py``,
``test_torch_predict_eval.py``): the hierarchical or flat UNet at base
width 8 patched into each package's Evaluator (as ``tests/test_e2e.py``
does for the JAX one), and one set of seeded weights written twice: as a
JAX orbax checkpoint with the JAX package's ``save_checkpoint`` (which the
JAX Evaluator reads) and, through ``bridge.state_dict_from_flax``, as a
port ``<name>.ckpt`` with the port's ``train/checkpoint.py`` (which the
port's Evaluator reads)."""
import csv
import os

import jax.numpy as jnp
import numpy as np

from restrictive_hierarchical_semantic_segmentation_tpu.models import (
    hierarchical as JH,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.unet import (
    UNetBackbone as JaxUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    checkpoint as jckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    state as jstate,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    hierarchical as PH,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (
    UNetBackbone as PortUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    checkpoint as pckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    state as pstate,
)
from torch_port_common import jax_variables

PORT = "restrictive_hierarchical_semantic_segmentation_tpu_torch"
JAX_PKG = "restrictive_hierarchical_semantic_segmentation_tpu"
IMG = 32
BASE_CH = 8


def jax_small(tree, model_type: int):
    return JH.HierarchicalSegmenter(tree=tree, backbone=JaxUNet(base_ch=BASE_CH),
                                    hierarchical=model_type == 1)


def port_small(tree, model_type: int):
    return PH.HierarchicalSegmenter(tree=tree,
                                    backbone=PortUNet(base_ch=BASE_CH),
                                    hierarchical=model_type == 1)


def small_models(monkeypatch, jax_side: bool = True):
    """Each package's Evaluator builds the UNet at base width 8."""
    monkeypatch.setattr(f"{PORT}.train.evaluate.build_model",
                        lambda tree, ms, mt, *a, **k: port_small(tree, mt))
    if jax_side:
        monkeypatch.setattr(f"{JAX_PKG}.train.evaluate.build_model",
                            lambda tree, ms, mt, *a, **k: jax_small(tree, mt))


def seeded_variables(jtree, model_type: int, seed: int = 0):
    """Seeded numpy (params, batch_stats) of the small JAX model."""
    x = np.zeros((1, IMG, IMG, 3), np.float32)
    return jax_variables(jax_small(jtree, model_type), x, seed=seed,
                         train=False)


def write_weights(directory: str, jtree, ptree, model_type: int,
                  seed: int = 0):
    """The same seeded weights as ``<directory>/jax/best.ckpt`` (orbax) and
    ``<directory>/port/best.ckpt``; returns the two paths."""
    params, stats = seeded_variables(jtree, model_type, seed)
    # the TrainState that create_train_state makes, without its eager
    # model.init (tens of seconds on the CPU)
    state = jstate.TrainState(
        params=params, batch_stats=stats,
        opt_state=jstate.make_optimizer(0.0).init(params),
        step=jnp.zeros((), jnp.int32))
    meta = dict(epoch=1, loss=0.0, test_measure_mean=0.5,
                test_measure_std=0.0)
    jpath = os.path.join(directory, "jax", "best.ckpt")
    os.makedirs(os.path.dirname(jpath), exist_ok=True)
    jckpt.save_checkpoint(jpath, state, **meta)

    pmodel = port_small(ptree, model_type)
    pmodel.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    ppath = os.path.join(directory, "port", "best.ckpt")
    os.makedirs(os.path.dirname(ppath), exist_ok=True)
    pckpt.save_checkpoint(ppath, pstate.create_train_state(pmodel, 0.0),
                          **meta)
    return jpath, ppath


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def csv_numbers(rows) -> np.ndarray:
    """The metric columns of a metrics.csv (rows after the header)."""
    return np.asarray([[float(v) for v in r[2:]] for r in rows[1:]])

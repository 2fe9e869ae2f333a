"""The port's train step against the JAX package's default train path
(``LeanBatchNorm``), and the port's eval step against ``make_eval_step``,
on the CPU, in fp32. The setting and the tolerances, with their reasons,
are in ``torch_train_common.py``; the eval step's outputs are held to
1e-4 (the forward's f32 conv order) and its confusion matrices must be
equal."""
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.steps import (
    make_eval_step as jax_make_eval_step,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
    build_model as port_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
    make_eval_step,
)
from torch_port_common import jax_variables, tiny_configs, trees
from torch_train_common import LEVEL_WEIGHTS, Pair, batch, check_losses


def test_train_steps_match_jax_default_bn():
    Pair(oracle="default").two_steps()


@pytest.mark.parametrize("per_image", [False, True])
def test_eval_step_matches_jax(per_image):
    jtree, ptree = trees("default")
    jcfg, pcfg = tiny_configs()
    x, y = batch(ptree, seed=2)
    jm = jax_build_model(jtree, 1, 1, jcfg)
    params, stats = jax_variables(jm, x[:1], train=False)
    want = jax_make_eval_step(jm, jtree, True, LEVEL_WEIGHTS,
                              return_outputs=True,
                              per_image_metrics=per_image)(
        params, stats, x, y)
    pm = port_build_model(ptree, 1, 1, pcfg)
    pm.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    pm.train()
    got = make_eval_step(pm, ptree, True, LEVEL_WEIGHTS, return_outputs=True,
                         per_image_metrics=per_image)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert pm.training  # the eval step restores the module's mode
    check_losses(want, got)
    for a, b in zip(got["outputs"], want["outputs"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    for a, b in zip(got["confmats"], want["confmats"]):
        assert a.shape == np.asarray(b).shape
        assert (a.dim() == 3) == per_image
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_step_after_eval_step():
    """An eval step (under inference_mode) and then a train step on the
    same model: tensors the eval step caches (the resize tables, the folded
    BN vectors) must not be inference tensors, which autograd refuses to
    save for a backward."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        create_train_state,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )

    _, ptree = trees("default")
    _, pcfg = tiny_configs()
    x, y = (torch.from_numpy(a) for a in batch(ptree, seed=3, n=2, size=40))
    pm = port_build_model(ptree, 1, 1, pcfg).to(
        memory_format=torch.channels_last)
    make_eval_step(pm, ptree, True, LEVEL_WEIGHTS)(x, y)
    state = create_train_state(pm, 1e-3)
    _, aux = make_train_step(pm, ptree, True, LEVEL_WEIGHTS)(
        state, x, y, torch.ones(2))
    assert np.isfinite(aux["loss"].item())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in pm.parameters())
    # and eval mode with autograd on after that (the folded BN vectors)
    pm.eval()
    out = pm(x.requires_grad_())
    out.logits_per_level[0].sum().backward()
    assert torch.isfinite(x.grad).all()

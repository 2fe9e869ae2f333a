"""Shared helpers of the train-step parity tests
(``test_torch_train_step.py``, ``test_torch_train_step_default_bn.py``):
one tiny-HRNet train step on the JAX side and on the port's, from the same
variables and batch, and the checks between them.

Setting: the tiny HRNet (``torch_port_common.tiny_hrnet``), or with
``donor="unet"`` a UNet of base width 8, on the default tree, 64 px, batch
4, fp32, AdamW at lr 0.018 with ``bench.py``'s level weights. Images and int8 ternary targets come from the port's numpy
synthetic generator and target factory; the same arrays go to both sides.

Each comparison is made after each of two steps. The second step starts
from the JAX parameters, copied into the port (the optimizer state carries
on): AdamW's first update is ``lr * g / (|g| + eps)``, about
``lr * sign(g)``, so an element whose gradient is at the noise level moves
by up to 2 lr more in one framework than in the other, and the second step
would compare two different models.

Tolerances, and why:
* loss and per-level losses: 1e-5 relative (f32 sums in another order);
* gradients: ``GRAD_RTOL[oracle]`` of each tensor's largest |g|, plus 1e-7
  (a conv bias ahead of a train-mode BatchNorm has a gradient of 0 in exact
  arithmetic and ~1e-9 of noise). Against the JAX Pallas BatchNorm path,
  whose backward uses the same InPlace-ABN identities as the port's, 1e-4
  (measured: <= 4.1e-5). The JAX default ``LeanBatchNorm`` differentiates
  through ``var = E[x²] - E[x]²`` in f32 and loses digits where a
  gradient nearly cancels (the bias of a BatchNorm whose output feeds
  another BatchNorm): there it sits up to 1.5e-2 of a tensor's largest
  gradient from the port, while the port stays within ~1e-5 of a float64
  run (``test_torch_bn_train.py:test_step_gradients_against_float64``);
  so 5e-2. The UNet's convs have biases, and each sits ahead of a
  train-mode BatchNorm, so its gradient is 0 in exact arithmetic and f32
  noise on either side (measured: <= 1.8e-6 apart, the step's largest
  gradient being 0.10): those tensors are held to 5e-5 of the step's
  largest gradient instead;
* running statistics: ``STATS_RTOL[oracle]`` of the tensor's largest
  value (1e-5; 1e-4 for the default path, whose batch variance carries the
  same cancellation);
* parameters after AdamW: AdamW moves an element by about lr in the
  direction of its first moment m (m = 0.1 g after one step). Elements
  whose |m| is at least ten times the gradient tolerance
  (``|m| >= 10 * GRAD_RTOL * max|m|``) and above the noise of a gradient
  that is 0 in exact arithmetic (``|m| >= 1e-7``) are held to 1e-2 lr (in
  the second step the direction carries the first step's gradient error;
  measured: <= 5.3e-5 = 2.9e-3 lr); the rest within ``2 * lr`` (the sign
  argument above);
* confusion matrices: equal, except where two logits of a pixel tie within
  the forward's error: at most 2 pixels per matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.models.backbones.unet import (
    UNetBackbone as JaxUNet,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    HierarchicalSegmenter as JaxSegmenter,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.state import (
    TrainState as JaxTrainState,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    synth_sample,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.target_factory import (
    node_masks,
    ternary_encode,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    HierarchicalSegmenter,
    UNetBackbone,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
    build_model as port_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
    make_train_step,
)
from torch_port_common import jax_variables, tiny_configs, trees

LR = 0.018
# bench.py's level weights for the default tree (the reference recipe)
LEVEL_WEIGHTS = [[0.0297, 1.577, 0.9619, 0.1770],
                 [1.5432, 0.2638, 1.0413, 3.9722]]
S, B = 64, 4
GRAD_RTOL = {"pallas": 1e-4, "default": 5e-2}
ZERO_GRAD_TOL = 5e-5
STATS_RTOL = {"pallas": 1e-5, "default": 1e-4}


def batch(tree, seed=0, n=B, size=S):
    """Seeded images (B, S, S, 3) f32 and int8 ternary targets, from the
    port's numpy data modules."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(n):
        img, mask = synth_sample(rng, size)
        xs.append((np.stack((img,) * 3, -1).astype(np.float32) / 255.0
                   - 0.5) / 0.5)
        ys.append(ternary_encode(node_masks(mask, tree), tree)
                  .astype(np.int8))
    return np.stack(xs), np.stack(ys)


def adamw_keeping_grads(lr):
    """optax AdamW (the JAX package's ``make_optimizer`` settings) whose
    state also holds the last gradients it was given."""
    inner = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)

    def init(params):
        return inner.init(params), jax.tree_util.tree_map(jnp.zeros_like,
                                                          params)

    def update(g, state, params=None):
        u, s = inner.update(g, state[0], params)
        return u, (s, g)

    return optax.GradientTransformation(init, update)


def flat(params, stats=None):
    """JAX variables as the port's state_dict entries (numpy)."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.device_get(params), jax.device_get(stats or {})).items()}


UNET_BASE = 8


def unet_models(jtree, ptree, model_type=1, share=True, base_ch=UNET_BASE):
    """The hierarchical (or flat) segmenter on a UNet of width ``base_ch``,
    as the JAX ``build_model(model_select=0)`` builds it (a 1x1 head,
    ``align_corners=True``) at full width: (JAX module, port module)."""
    jm = JaxSegmenter(tree=jtree, backbone=JaxUNet(base_ch=base_ch),
                      hierarchical=model_type == 1, final_conv_kernel=1,
                      align_corners=True, share_backbone=share)
    pm = HierarchicalSegmenter(ptree, UNetBackbone(base_ch=base_ch),
                               hierarchical=model_type == 1,
                               final_conv_kernel=1, align_corners=True,
                               share_backbone=share)
    return jm, pm


class Pair:
    """The JAX step and the port's, from the same variables. ``donor``:
    "hrnet" (the tiny HRNet) or "unet" (``unet_models``). ``oracle``:
    "pallas" (the JAX model with ``use_pallas_bn=True``, its kernels in
    interpret mode) or "default" (``LeanBatchNorm``; the JAX UNet has no
    other BatchNorm)."""

    def __init__(self, share=True, grad_accum=1, oracle="pallas", seed=0,
                 donor="hrnet"):
        if donor == "unet" and oracle != "default":
            raise ValueError("the JAX UNet has LeanBatchNorm only: use "
                             "oracle='default'")
        self.oracle = oracle
        self.donor = donor
        self.jtree, self.ptree = trees("default")
        jcfg, pcfg = tiny_configs()
        self.x, self.y = batch(self.ptree)
        if donor == "unet":
            jm, pm = unet_models(self.jtree, self.ptree, share=share)
        else:
            jm = jax_build_model(self.jtree, 1, 1, jcfg, share_backbone=share,
                                 use_pallas_bn=oracle == "pallas")
            pm = port_build_model(self.ptree, 1, 1, pcfg,
                                  share_backbone=share)
        params, stats = jax_variables(jm, self.x[:1], seed=seed, train=False)
        tx = adamw_keeping_grads(LR)
        self.jstate = JaxTrainState(params=params, batch_stats=stats,
                                    opt_state=tx.init(params),
                                    step=jnp.zeros((), jnp.int32))
        self.jstep = jax_make_train_step(
            jm, tx, self.jtree, True, level_weights=LEVEL_WEIGHTS,
            donate=False, grad_accum=grad_accum)
        self.jm = jm
        pm.load_state_dict(state_dict_from_flax(params, stats), strict=True)
        self.pm = pm.to(memory_format=torch.channels_last)
        self.pstate = create_train_state(self.pm, LR)
        self.pstep = make_train_step(self.pm, self.ptree, True,
                                     level_weights=LEVEL_WEIGHTS,
                                     grad_accum=grad_accum)

    def step(self, mask=(1.0, 1.0), x=None, y=None):
        """One step on both sides; returns (jax aux, port aux, jax grads)."""
        x = self.x if x is None else x
        y = self.y if y is None else y
        self.jstate, jaux = self.jstep(self.jstate, x, y,
                                       jnp.asarray(mask, jnp.float32))
        self.pstate, paux = self.pstep(self.pstate, torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       torch.tensor(mask))
        return jaux, paux, self.jstate.opt_state[1]

    def sync(self):
        """Copy the JAX parameters and running statistics into the port's
        model in place (its optimizer state stays)."""
        sd = state_dict_from_flax(jax.device_get(self.jstate.params),
                                  jax.device_get(self.jstate.batch_stats))
        with torch.no_grad():
            for k, v in self.pm.state_dict().items():
                v.copy_(sd[k])

    # ------------------------------------------------------------- checks
    def check_grads(self, jgrads):
        want = flat(jgrads)
        got = {n: p.grad.numpy() for n, p in self.pm.named_parameters()}
        assert set(got) == set(want)
        rtol = GRAD_RTOL[self.oracle]
        top = max(np.abs(g).max() for g in want.values())
        for n, g in got.items():
            scale = np.abs(want[n]).max()
            err = np.abs(g - want[n]).max()
            if n in self.zero_grads():
                assert err <= ZERO_GRAD_TOL * top, (n, err, top)
            else:
                assert err <= rtol * scale + 1e-7, (n, err, scale)

    def zero_grads(self):
        """Parameters whose gradient is 0 in exact arithmetic: the bias of
        a conv whose output goes straight into a train-mode BatchNorm (the
        UNet's; HRNet's convs have no bias)."""
        if self.donor != "unet":
            return set()
        return {n for n, _ in self.pm.named_parameters()
                if n.startswith("backbone.")
                and n.endswith((".conv0.bias", ".conv1.bias"))}

    def check_state(self):
        want = flat(self.jstate.params, self.jstate.batch_stats)
        params = dict(self.pm.named_parameters())
        sd = {k: v.detach().numpy() for k, v in self.pm.state_dict().items()}
        assert set(sd) == set(want)
        for k, v in sd.items():
            if k.endswith(("running_mean", "running_var")):
                err = np.abs(v - want[k]).max()
                assert err <= STATS_RTOL[self.oracle] * np.abs(
                    want[k]).max(), (k, err)
                continue
            m = np.abs(self.pstate.optimizer.state[params[k]]["exp_avg"]
                       .numpy())
            big = m >= max(10 * GRAD_RTOL[self.oracle] * m.max(), 1e-7)
            np.testing.assert_allclose(v[big], want[k][big], rtol=0,
                                       atol=1e-2 * LR, err_msg=k)
            assert np.abs(v - want[k]).max() <= 2 * LR + 1e-5, k

    def two_steps(self):
        """Two steps on two batches, each compared; the second with
        ``level_mask`` [1, 0] (level-0 pretraining: the level-1 loss is
        reported, not trained). Returns the last port aux."""
        x2, y2 = batch(self.ptree, seed=1)
        for x, y, mask in ((None, None, (1.0, 1.0)),
                           (x2, y2, (1.0, 0.0))):
            if x is not None:
                self.sync()
            jaux, paux, jgrads = self.step(mask=mask, x=x, y=y)
            check_losses(jaux, paux)
            self.check_grads(jgrads)
            self.check_state()
            check_confmats(jaux, paux)
        assert self.pstate.step == int(self.jstate.step) == 2
        return paux


def check_losses(jaux, paux):
    np.testing.assert_allclose(paux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(paux["per_level"].numpy(),
                               np.asarray(jaux["per_level"]), rtol=1e-5)


def check_confmats(jaux, paux, near_ties=2):
    assert len(paux["confmats"]) == len(jaux["confmats"])
    for got, want in zip(paux["confmats"], jaux["confmats"]):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.sum() == want.sum()
        assert np.abs(got - want).sum() <= 2 * near_ties, (got, want)

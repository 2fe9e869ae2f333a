"""``--remat`` in the port (``models/remat.py``) on the CPU: the UNet's
backbone pass as one recomputed region, each ``HighResolutionModule`` of
HRNet as one, in the modes "module" (everything recomputed) and "conv"
(convolution outputs kept, the rest recomputed).

Held, for the UNet of base width 8 and the tiny HRNet
(``tests/test_models.py:tiny_hrnet``), 32 px, batch 4, f32, from one set
of weights:
- each mode against ``remat=False``, one train step of the port
  (``train/steps.py``: bench.py's level weights, AdamW at lr 0.018): loss,
  per-level losses, every gradient, the parameters after AdamW and the
  running buffers **bit for bit** (the recompute runs the same ops on the
  same inputs; the JAX package holds its own modes to each other within
  loss rtol 1e-6, params rtol 1e-4 / atol 1e-6,
  ``tests/test_shared_backbone.py:169-245``, and the CPU gives more);
- each mode against the JAX step with the same mode (the UNet, whose JAX
  BatchNorm is ``LeanBatchNorm``), two steps at the tolerances of
  ``tests/torch_train_common.py`` (``Pair.two_steps``), as
  ``test_torch_train_step_default_bn.py`` holds ``remat=False``;
- the running buffers move once a step: the recompute re-runs every
  BatchNorm of its regions and updates no buffer;
- "conv" recomputes no convolution in the backward, "module" every
  convolution of its regions;
- two ``gloo`` ranks with ``remat="conv"`` against one process with it, at
  ``test_torch_distributed.py``'s tolerances, and the recompute's extra
  all-reduces (one per BatchNorm of the regions: its forward's statistics
  again).
"""
import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
    norm,
    remat,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.hrnet import (
    HighResolutionModule,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    fused_bn_act as fba,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
    make_train_step,
)
from torch_dist_common import build_small, rank_threads, run_ranks, step_job
from torch_port_common import trees
from torch_train_common import LEVEL_WEIGHTS, LR, Pair, batch

MODES = ["module", "conv"]
N_BN = {"unet": 18}
STEADY_THREADS = 4


@pytest.fixture(autouse=True)
def steady_threads():
    """A fixed intra-op thread count and deterministic algorithms for each
    test, the settings restored after. Until ``torch.set_num_threads`` is
    called, MKL runs with its dynamic threading on (PyTorch turns it off
    only in ``set_num_threads``) and may pick fewer threads under load, so
    two steps of one process could add their sums in other orders; the
    bit-for-bit comparisons need the same threads in both steps."""
    saved = (torch.get_num_threads(),
             torch.are_deterministic_algorithms_enabled())
    torch.set_num_threads(min(STEADY_THREADS, saved[0]))
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.set_num_threads(saved[0])
        torch.use_deterministic_algorithms(saved[1])


def _step(donor, mode, sd, x, y):
    """One port train step from ``sd``: (model, aux)."""
    _, tree = trees("default")
    model = build_small(donor, mode)
    model.load_state_dict(sd, strict=True)
    model = model.to(memory_format=torch.channels_last)
    state = create_train_state(model, LR)
    step = make_train_step(model, tree, True, level_weights=LEVEL_WEIGHTS)
    _, aux = step(state, torch.from_numpy(x), torch.from_numpy(y),
                  torch.ones(2))
    # AdamW leaves the step's gradients in .grad
    return model, aux, {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def inputs():
    _, tree = trees("default")
    x, y = batch(tree, seed=3, n=4, size=32)
    sds = {}
    for donor in ("unet", "hrnet"):
        torch.manual_seed(5)
        sds[donor] = copy.deepcopy(build_small(donor).state_dict())
    return x, y, sds


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("donor", ["unet", "hrnet"])
def test_remat_step_equals_no_remat_bit_for_bit(donor, mode, inputs):
    x, y, sds = inputs
    want_model, want, want_grads = _step(donor, False, sds[donor], x, y)
    got_model, got, got_grads = _step(donor, mode, sds[donor], x, y)
    assert float(got["loss"]) == float(want["loss"])
    assert torch.equal(got["per_level"], want["per_level"])
    for a, b in zip(got["confmats"], want["confmats"]):
        assert torch.equal(a, b)
    assert set(got_grads) == set(want_grads) and got_grads
    for n, g in want_grads.items():
        assert torch.equal(got_grads[n], g), n
    want_sd = want_model.state_dict()
    for k, v in got_model.state_dict().items():  # params after AdamW, buffers
        assert torch.equal(v, want_sd[k]), k


@pytest.mark.parametrize("mode", MODES)
def test_remat_step_matches_jax_with_the_same_mode(mode):
    Pair(oracle="default", donor="unet", remat=mode).two_steps()


def _regions_bns(donor, model):
    """BatchNorms inside the model's recomputed regions."""
    if donor == "unet":
        mods = [model.backbone]
    else:
        mods = [m for m in model.modules()
                if isinstance(m, HighResolutionModule)]
    return sum(isinstance(b, norm.BatchNormAct) for m in mods
               for b in m.modules())


@pytest.mark.parametrize("mode", [False] + MODES)
@pytest.mark.parametrize("donor", ["unet", "hrnet"])
def test_running_buffers_move_once_per_step(donor, mode, inputs,
                                            monkeypatch):
    """Each buffer is written twice a step (the forward's update, then the
    closed-form D-update correction, ``train/steps.py``), whatever the
    mode, while the recompute re-runs every BatchNorm of its regions (its
    statistics and its kernel-2 forward: ``batch_norm_act``)."""
    x, y, sds = inputs
    calls = {True: 0, False: 0}
    real = norm.batch_norm_act

    def counted(*a, **k):
        calls[remat.recomputing()] += 1
        return real(*a, **k)

    monkeypatch.setattr(norm, "batch_norm_act", counted)
    model = build_small(donor, mode)
    model.load_state_dict(sds[donor], strict=True)
    model = model.to(memory_format=torch.channels_last)
    bns = [m for m in model.modules() if isinstance(m, norm.BatchNormAct)]
    before = [m.running_mean._version for m in bns]
    _, tree = trees("default")
    step = make_train_step(model, tree, True, level_weights=LEVEL_WEIGHTS)
    step(create_train_state(model, LR), torch.from_numpy(x),
         torch.from_numpy(y), torch.ones(2))
    assert [m.running_mean._version - v for m, v in zip(bns, before)] \
        == [2] * len(bns)
    assert calls[False] == len(bns)
    assert calls[True] == (_regions_bns(donor, model) if mode else 0)
    assert not remat.recomputing()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("donor", ["unet", "hrnet"])
def test_recompute_hands_the_train_entry_no_buffers(donor, mode, inputs,
                                                    monkeypatch):
    """The running update lives in kernel 2's train entry
    (``bn_act_forward``): a step's forward hands it every BatchNorm's
    buffers once, the recompute of its regions none."""
    x, y, sds = inputs
    calls = {(False, True): 0, (False, False): 0, (True, True): 0,
             (True, False): 0}
    real = fba.bn_act_forward

    def counted(*a, **k):
        calls[(remat.recomputing(), k.get("running") is not None)] += 1
        return real(*a, **k)

    monkeypatch.setattr(fba, "bn_act_forward", counted)
    model = build_small(donor, mode)
    model.load_state_dict(sds[donor], strict=True)
    model = model.to(memory_format=torch.channels_last)
    n_bn = sum(isinstance(m, norm.BatchNormAct) for m in model.modules())
    _, tree = trees("default")
    step = make_train_step(model, tree, True, level_weights=LEVEL_WEIGHTS)
    step(create_train_state(model, LR), torch.from_numpy(x),
         torch.from_numpy(y), torch.ones(2))
    assert calls == {(False, True): n_bn, (False, False): 0,
                     (True, True): 0,
                     (True, False): _regions_bns(donor, model)}


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", [False] + MODES)
@pytest.mark.parametrize("donor", ["unet", "hrnet"])
def test_conv_mode_recomputes_no_convolution(donor, mode, inputs):
    """Forward convolutions computed inside the backward: 0 without remat
    and in "conv" mode, every convolution of the regions in "module"."""
    x, _, sds = inputs
    model = build_small(donor, mode)
    model.load_state_dict(sds[donor], strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    out = model(torch.from_numpy(x))
    loss = sum(z.sum() for z in out.logits_per_level)
    with _CountConvs() as counted:
        loss.backward()
    regions = ([model.backbone] if donor == "unet" else
               [m for m in model.modules()
                if isinstance(m, HighResolutionModule)])
    convs = sum(isinstance(c, torch.nn.Conv2d) for m in regions
                for c in m.modules())
    assert counted.n == (convs if mode == "module" else 0)
    assert convs >= 18


def test_remat_modes_and_refusal():
    assert [remat.remat_mode(v) for v in (False, None, True, "module",
                                          "conv")] == \
        [None, None, "module", "module", "conv"]
    with pytest.raises(ValueError, match="remat 'full'"):
        remat.remat_mode("full")


def test_eval_forward_runs_no_region(inputs):
    """Without autograd the regions run plainly: no recompute context."""
    x, _, sds = inputs
    model = build_small("unet", "conv")
    model.load_state_dict(sds["unet"], strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    plain = build_small("unet")
    plain.load_state_dict(sds["unet"], strict=True)
    plain = plain.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        for a, b in zip(model(torch.from_numpy(x)).logits_per_level,
                        plain(torch.from_numpy(x)).logits_per_level):
            assert torch.equal(a, b)


def test_remat_over_two_ranks_equals_one_process(tmp_path):
    """``remat="conv"`` with global-batch BatchNorm over two gloo ranks
    against one process with it; the recompute adds one all-reduce per
    BatchNorm of the region (18 for the UNet)."""
    _, ptree = trees("default")
    torch.manual_seed(0)
    sd_path = str(tmp_path / "unet.pt")
    torch.save(build_small("unet").state_dict(), sd_path)
    x, y = batch(ptree, seed=0, n=4, size=32)
    args = (sd_path, x, y, 1, 1, LR, LEVEL_WEIGHTS)
    ranks = run_ranks(step_job, 2, tmp_path, *args, False, "conv")
    with rank_threads():
        one = step_job(0, 1, *args, False, "conv")
    (loss, per_level, cms), = one["aux"]
    for r in ranks:
        (rl, rpl, rcm), = r["aux"]
        np.testing.assert_allclose(rl, loss, rtol=1e-5)
        np.testing.assert_allclose(rpl.numpy(), per_level.numpy(), rtol=1e-5)
        for a, b in zip(rcm, cms):
            assert int(a.sum()) == int(b.sum())
            assert int((a - b).abs().sum()) <= 4  # near-tied pixels
    init = torch.load(sd_path)
    n_sig = n_bad = 0
    for k, v in one["state"].items():
        got = [r["state"][k] for r in ranks]
        assert torch.equal(got[0], got[1]), k
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[0].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        elif k in ranks[0]["params"]:
            up = (got[0] - init[k]).double()
            us = (v - init[k]).double()
            sig = us.abs() > 0.5 * LR
            n_sig += int(sig.sum())
            n_bad += int(((up[sig] - us[sig]).abs()
                          > 0.1 * LR + 0.1 * us[sig].abs()).sum())
    assert n_sig > 1000 and n_bad / n_sig < 0.01, (n_sig, n_bad)
    # 2 per BN call, the Dice count, the gradient bucket(s), the aux, and
    # the recompute's 18 forward all-reduces
    plain = run_ranks(step_job, 2, tmp_path / "plain", *args)
    assert [r["all_reduces"] for r in ranks] == \
        [[p["all_reduces"][0] + N_BN["unet"]] for p in plain]
    for k, v in plain[0]["state"].items():  # the mode changes no bit
        assert torch.equal(ranks[0]["state"][k], v), k

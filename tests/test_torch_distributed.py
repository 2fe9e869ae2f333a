"""The port's data axis on the CPU: ranks over ``torch.distributed`` with
``gloo``, two processes started with ``spawn`` (``torch_dist_common.py``),
held to one process on the concatenated batch and to the JAX package.

* the rank mesh (``parallel/mesh.py``): ``make_fold_mesh`` sizes its axes as
  the JAX function does for the same inputs over 8, 4 and 1 ranks and
  prints the same idle line (its space axis: ``test_torch_space.py``);
* BatchNorm over a group of two ranks (``models/norm.py:set_bn_group``:
  the split kernels' plain versions and the all-reduces between them)
  against one process on the concatenated input: outputs, input gradients,
  the ranks' summed dgamma and dbeta, running statistics; then a whole
  tiny HRNet and a base-width-8 UNet forward and backward the same way;
* one train step of two ranks against one process at the same global batch
  (with and without gradient accumulation): loss within rtol 1e-5, BN
  running statistics within rtol 1e-5 / atol 1e-6, parameters on the
  significant-update criterion of JAX ``tests/test_fold_parallel.py:
  160-178``, and the two ranks' parameters and buffers bit-equal;
* the Dice count: a batch whose shards have different numbers of items
  with a non-zero union; the loss of two ranks equals one process's, and
  the ranks' losses with their own counts (no all-reduce) do not;
* one epoch of the ``Trainer`` on two ranks against one process (its
  metrics.csv), the files written by the first rank only; and the train
  CLI with ``--dist-coordinator`` on two ranks;
* a step of two ranks against the JAX ``Trainer`` on the 8-device CPU mesh
  (its data axis, global-batch ``LeanBatchNorm``), from the JAX trainer's
  initial weights through ``bridge.py``;
* host decisions: a rank whose learning rate differs from the first
  rank's raises; the checkpoint manager's ``write=False`` makes the
  writer's decisions without a file, and its defer hooks hold the
  deferred best.

Tolerances: float32 on both sides, sums in another order (the group's
statistics are formed in float64 from the ranks' sums). Gradients of the
ranks' summed loss against one process: 1e-4 of each tensor's largest
|g| plus 1e-6 (measured: a few 1e-6). Against JAX, the tolerances of
``tests/torch_train_common.py`` (its default-BatchNorm oracle).
"""
import csv
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.parallel.mesh import (
    make_fold_mesh as jax_make_fold_mesh,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    loop as jloop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    train as pcli,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.loader import (
    BatchLoader,
    shard_rows,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
    BatchNormAct,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    SPACE_AXIS,
    init_distributed,
    make_fold_mesh,
    make_mesh,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    loop as ploop,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.checkpoint import (
    CheckpointManager,
    snapshot,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
    create_train_state,
)
from torch_dist_common import (
    bn_job,
    build_small,
    cli_job,
    free_port,
    lr_divergence_job,
    model_job,
    run_ranks,
    step_job,
    train_job,
)
from torch_port_common import trees
from torch_train_common import LEVEL_WEIGHTS, LR, batch
from torch_trainer_common import jax_small_model, numbers, small_model

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"
LOSS_RTOL = 1e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
OUT_ATOL = 1e-5
ZERO_GRAD_TOL = 5e-5  # of the largest gradient (torch_train_common.py)
# metrics.csv of an epoch: after the first step the two sides' parameters
# differ where AdamW's sign-like first update amplified f32 noise, and on a
# 4-step-old model near-tied argmaxes flip boundary pixels; the criterion
# of JAX tests/test_fold_parallel.py:test_matches_sequential for the same
# comparison: the train loss within rtol 2e-3, and 95 % of the row's
# numbers within rtol 0.1 / atol 5e-2 (measured: the train loss 3.6e-5
# apart, train accuracy 1.4e-3)
EPOCH_LOSS_RTOL = 2e-3
EPOCH_CELLS = dict(rtol=0.1, atol=5e-2)
EPOCH_SHARE = 0.95


def significant_update_ok(new, ref, old, lr, tol=0.01):
    """JAX ``tests/test_fold_parallel.py:160-178``: AdamW's first update is
    about lr * sign(g), so elements whose gradient is noise may flip by a
    whole lr; the updates above lr / 2 must agree to 10 % on at least
    (1 - tol) of them, and there must be many."""
    n_sig = n_bad = 0
    for k in ref:
        up = np.asarray(new[k]) - np.asarray(old[k])
        us = np.asarray(ref[k]) - np.asarray(old[k])
        sig = np.abs(us) > 0.5 * lr
        n_sig += int(sig.sum())
        n_bad += int((~np.isclose(up[sig], us[sig], rtol=0.1,
                                  atol=0.1 * lr)).sum())
    return n_sig, n_bad / max(1, n_sig)


# ------------------------------------------------------------------ the mesh
MESH_CASES = [(5, 4), (4, 4), (6, 8), (2, 4), (3, 16), (1, 16), (5, 2)]


@pytest.mark.parametrize("n_ranks", [8, 4, 1])
@pytest.mark.parametrize("folds,batch_size", MESH_CASES)
def test_fold_mesh_sizes_its_axes_as_jax(n_ranks, folds, batch_size, capsys):
    """Mirrors JAX ``TestFoldMesh`` on 8, 4 and 1 ranks: the same axis
    sizes, the same rank (device) order, the same idle line."""
    jm = jax_make_fold_mesh(folds, batch_size,
                            devices=jax.devices()[:n_ranks])
    want_out = capsys.readouterr().out
    pm = make_fold_mesh(folds, batch_size, ranks=range(n_ranks))
    assert capsys.readouterr().out == want_out
    assert pm.shape == dict(jm.shape)
    assert list(pm.shape) == [FOLD_AXIS, DATA_AXIS, SPACE_AXIS]
    assert pm.devices.ravel().tolist() == [d.id for d in jm.devices.flat]


def test_fold_mesh_cases_of_the_jax_tests():
    ranks = range(8)
    assert make_fold_mesh(5, 4, ranks=ranks).shape == {
        FOLD_AXIS: 5, DATA_AXIS: 1, SPACE_AXIS: 1}
    assert make_fold_mesh(4, 4, ranks=ranks).shape[DATA_AXIS] == 2
    m = make_fold_mesh(6, 8, ranks=ranks)
    assert 6 % m.shape[FOLD_AXIS] == 0
    assert m.shape[FOLD_AXIS] * m.shape[DATA_AXIS] <= 8


def test_mesh_positions_and_groups_without_a_process_group():
    m = make_mesh(ranks=[0])
    assert m.shape == {DATA_AXIS: 1, SPACE_AXIS: 1}
    g = m.data_group(0)
    assert g.group is None and g.is_main and g.size == 1
    m = make_fold_mesh(4, 4, ranks=range(8))
    assert m.position(5) == (2, 1, 0)
    with pytest.raises(RuntimeError, match="init_distributed"):
        m.data_group(5)  # two ranks share fold 2: a group is needed
    assert make_fold_mesh(5, 4, ranks=range(8)).position(6) is None  # idle


def test_init_distributed_without_a_coordinator_does_nothing():
    init_distributed(None)
    init_distributed("")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process_id"):
        init_distributed("localhost:1", num_processes=2, process_id=2,
                         device="cpu")


@pytest.mark.parametrize("device,procs,cards,local,want", [
    ("cuda", 2, 1, None, "gloo"),  # two ranks share one card
    ("cuda", 2, 2, None, "nccl"),
    ("cuda", 4, 2, "2", "nccl"),  # two nodes of two cards
    ("cuda", 4, 2, None, "gloo"),  # one node: four ranks, two cards
    ("cpu", 2, 8, None, "gloo"),
])
def test_init_distributed_picks_the_backend(monkeypatch, device, procs,
                                            cards, local, want):
    """NCCL where this node has a card for each of its ranks, gloo where
    they share cards (NCCL refuses two ranks on one device) or on the
    CPU; a backend given is kept."""
    got = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    init_distributed("localhost:1", num_processes=procs, process_id=1,
                     device=device)
    init_distributed("localhost:1", num_processes=procs, process_id=1,
                     backend="mpi", device=device)
    assert [b for b, _ in got] == [want, "mpi"]
    assert got[0][1] == {"init_method": "tcp://localhost:1",
                         "world_size": procs, "rank": 1}


def test_rank_device_keeps_an_explicit_device():
    assert pcli.rank_device("cpu", 3) == "cpu"
    assert pcli.rank_device("cuda:1", 0) == "cuda:1"
    if not torch.cuda.is_available():
        assert pcli.rank_device("cuda", 1) == "cuda"  # resolve_device raises


@pytest.mark.parametrize("micro", [1, 2])
def test_rank_rows_cover_the_batch_in_microbatch_order(micro):
    b = 8
    rows = [shard_rows(b, (r, 2, micro)) for r in range(2)]
    # microbatch a of rank 0, then of rank 1, is microbatch a of the batch
    flat = [i for a in range(micro) for r in range(2)
            for i in range(*rows[r][a])]
    assert flat == list(range(b))
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(6, (0, 4, 1))


def test_sharded_loader_loads_its_rows_of_each_batch(tmp_path):
    """A rank's BatchLoader yields its rows of the single-process batch,
    bit for bit (per-sample seeds depend on (seed, epoch, index) alone)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.dataset import (
        SegDataset,
    )

    write_synth_dataset(str(tmp_path), 8, size=48, seed=2, folds=1)
    _, ptree = trees("default")
    root = tmp_path / "fold_1" / "train"
    ims = sorted(str(p) for p in (root / "images").iterdir())
    labs = sorted(str(p) for p in (root / "labels").iterdir())

    def loader(shard):
        ds = SegDataset(ims, labs, ptree, 32, True, augment=True)
        return BatchLoader(ds, 4, shuffle=True, drop_last=True, seed=3,
                           num_workers=2, shard=shard)

    full, parts = loader(None), [loader((r, 2, 1)) for r in range(2)]
    try:
        for ld in (full, *parts):
            ld.set_epoch(2)
        for (x, y), *halves in zip(full, *parts):
            np.testing.assert_array_equal(
                x, np.concatenate([h[0] for h in halves]))
            np.testing.assert_array_equal(
                y, np.concatenate([h[1] for h in halves]))
    finally:
        for ld in (full, *parts):
            ld.close()


# ------------------------------------------------------- BatchNorm over ranks
BN_SHAPES = [((4, 6, 5, 16), "relu"), ((2, 9, 7, 24), "none"),
             ((6, 4, 4, 8), "relu"), ((4, 3, 11, 40), "none")]


def _bn_cases():
    rng = np.random.default_rng(11)
    cases = []
    for shape, act in BN_SHAPES:
        c = shape[-1]
        x = (rng.standard_normal(shape) * 1.5 + 0.4).astype(np.float32)
        cases.append((x, rng.uniform(0.5, 1.5, c).astype(np.float32),
                      (rng.standard_normal(c) * 0.3).astype(np.float32),
                      rng.standard_normal(shape).astype(np.float32), act))
    return cases


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    cases = _bn_cases()
    return cases, run_ranks(bn_job, 2, tmp_path_factory.mktemp("bn"), cases)


@pytest.mark.parametrize("case", range(len(BN_SHAPES)))
def test_bn_over_two_ranks_equals_one_process(bn_runs, case):
    cases, ranks = bn_runs
    x, gamma, beta, cot, act = cases[case]
    bn = BatchNormAct(x.shape[-1], act).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    got = [r[0][case] for r in ranks]
    np.testing.assert_allclose(torch.cat([g[0] for g in got]).numpy(),
                               y.detach().permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=OUT_ATOL)
    dx = xt.grad.permute(0, 2, 3, 1)
    np.testing.assert_allclose(torch.cat([g[1] for g in got]).numpy(),
                               dx.numpy(), rtol=0,
                               atol=GRAD_RTOL * float(dx.abs().max())
                               + GRAD_ATOL)
    for i, want in ((2, bn.weight.grad), (3, bn.bias.grad)):
        np.testing.assert_allclose(sum(g[i] for g in got).numpy(),
                                   want.numpy(), rtol=0,
                                   atol=GRAD_RTOL * float(want.abs().max())
                                   + GRAD_ATOL)
    for i, want in ((4, bn.running_mean), (5, bn.running_var)):
        np.testing.assert_allclose(got[0][i].numpy(), want.numpy(),
                                   rtol=STATS_RTOL, atol=STATS_ATOL)
        assert torch.equal(got[0][i], got[1][i])  # the same bits


def _zero_grad(donor, name):
    """A conv bias whose output goes straight into a train-mode BatchNorm:
    its gradient is 0 in exact arithmetic, f32 noise on either side
    (``tests/torch_train_common.py:Pair.zero_grads``)."""
    if donor == "unet":
        return name.startswith("backbone.") and name.endswith(
            (".conv0.bias", ".conv1.bias"))
    return name == "backbone.shared_head_conv.bias"


def _model_case(donor, tmp_path):
    torch.manual_seed(5)
    model = build_small(donor)
    sd_path = str(tmp_path / f"{donor}.pt")
    torch.save(model.state_dict(), sd_path)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        shapes = [z.shape for z in model.eval()(torch.from_numpy(x[:1]))
                  .logits_per_level]
    cot = [rng.standard_normal((4,) + tuple(s[1:])).astype(np.float32)
           for s in shapes]
    return sd_path, x, cot


@pytest.mark.parametrize("donor", ["hrnet", "unet"])
def test_model_forward_backward_over_two_ranks(donor, tmp_path):
    """Every BatchNorm of the tiny HRNet (widths 4-32) or the UNet over the
    group: the logits and input gradients of the two ranks, concatenated,
    the sum of their parameter gradients and their running statistics
    equal one process's."""
    sd_path, x, cot = _model_case(donor, tmp_path)
    ranks = run_ranks(model_job, 2, tmp_path, donor, sd_path, x, cot)
    one = model_job(0, 1, donor, sd_path, x, cot)
    for L, want in enumerate(one["logits"]):
        got = torch.cat([r["logits"][L] for r in ranks])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    dx = torch.cat([r["dx"] for r in ranks])
    np.testing.assert_allclose(dx.numpy(), one["dx"].numpy(), rtol=0,
                               atol=GRAD_RTOL * float(one["dx"].abs().max())
                               + GRAD_ATOL)
    assert set(ranks[0]["grads"]) == set(one["grads"])
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for n, want in one["grads"].items():
        got = ranks[0]["grads"][n] + ranks[1]["grads"][n]
        atol = (ZERO_GRAD_TOL * top if _zero_grad(donor, n)
                else GRAD_RTOL * float(want.abs().max()) + GRAD_ATOL)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=n)
    for k, want in one["buffers"].items():
        np.testing.assert_allclose(ranks[0]["buffers"][k].numpy(),
                                   want.numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)
        assert torch.equal(ranks[0]["buffers"][k], ranks[1]["buffers"][k])


# ------------------------------------------------------------- the train step
def _step_setup(tmp_path, seed=0, n=4):
    _, ptree = trees("default")
    torch.manual_seed(seed)
    sd_path = str(tmp_path / "unet.pt")
    torch.save(build_small("unet").state_dict(), sd_path)
    x, y = batch(ptree, seed=seed, n=n, size=32)
    return sd_path, x, y


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_over_two_ranks_equals_one_process(grad_accum, tmp_path):
    sd_path, x, y = _step_setup(tmp_path)
    args = (sd_path, x, y, 1, grad_accum, LR, LEVEL_WEIGHTS)
    ranks = run_ranks(step_job, 2, tmp_path, *args)
    one = step_job(0, 1, *args)
    init = torch.load(sd_path)
    (loss, per_level, cms), = one["aux"]
    for r in ranks:
        (rl, rpl, rcm), = r["aux"]
        np.testing.assert_allclose(rl, loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(rpl.numpy(), per_level.numpy(),
                                   rtol=LOSS_RTOL)
        for a, b in zip(rcm, cms):  # counts: all-reduced sums
            assert a.dtype == b.dtype and int(a.sum()) == int(b.sum())
            assert int((a - b).abs().sum()) <= 4  # near-tied pixels
    for k, v in one["state"].items():
        got = [r["state"][k] for r in ranks]
        assert torch.equal(got[0], got[1]), k  # the ranks' bits agree
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[0].numpy(), v.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=k)
    n_sig, bad = significant_update_ok(ranks[0]["params"], one["params"],
                                       init, LR)
    assert n_sig > 1000 and bad < 0.01, (n_sig, bad)


def test_dice_count_is_the_groups(tmp_path):
    """Rank 1's images hold no valid pixel of level 1 (targets -1), so its
    shard keeps no item of that level's Dice while rank 0's keeps both:
    divided by the group's count the two ranks give one process's loss;
    each with its own count they do not."""
    sd_path, x, y = _step_setup(tmp_path, seed=3)
    _, ptree = trees("default")
    lvl1 = slice(*np.cumsum([0] + list(ptree.classes_per_level))[1:3])
    y = y.copy()
    y[2:, ..., lvl1] = -1
    args = (sd_path, x, y, 1, 1, LR, LEVEL_WEIGHTS, True)
    ranks = run_ranks(step_job, 2, tmp_path, *args)
    one = step_job(0, 1, *args)
    want = one["aux"][0][0]
    assert one["local_loss"][0] == pytest.approx(want, rel=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["aux"][0][0], want, rtol=LOSS_RTOL)
    own_counts = np.mean([r["local_loss"][0] for r in ranks])
    assert abs(own_counts - want) > 100 * LOSS_RTOL * abs(want), \
        (own_counts, want)


# ---------------------------------------------------------- epochs and the CLI
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_data")
    write_synth_dataset(str(root), 8, size=96, seed=5, folds=1)
    return str(root)


def _cfg_kw(data, save, **kw):
    base = dict(save_path=str(save), data_root=data,
                tree_root=str(ASSETS / "class_tree_tl.json"),
                class_map=str(ASSETS / "class_map.csv"), model_select=0, model_type=1, img_size=32, epochs=1,
                batch_size=2, val_batch=1, lr=1e-3, num_workers=2, folds=1,
                seed=0)
    base.update(kw)
    return base


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _assert_rows_close(got, want):
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want]
    for rg, rw in zip(got[1:], want[1:]):
        np.testing.assert_allclose(float(rg[1]), float(rw[1]),
                                   rtol=EPOCH_LOSS_RTOL)
        a = np.concatenate([numbers(c) for c in rw[1:]])
        b = np.concatenate([numbers(c) for c in rg[1:]])
        close = np.isclose(b, a, **EPOCH_CELLS)
        assert close.mean() > EPOCH_SHARE, \
            f"epoch {rw[0]}: {int((~close).sum())}/{close.size} off"


def test_trainer_epoch_over_two_ranks_equals_one_process(tmp_path, data,
                                                         monkeypatch):
    small_model(monkeypatch)
    one = tmp_path / "one"
    ploop.train(RunConfig(**_cfg_kw(data, one)), device="cpu")
    two = tmp_path / "two"
    res = run_ranks(train_job, 2, tmp_path, _cfg_kw(data, two))
    assert res[0] == res[1]  # every rank gets the writer's best metric
    _assert_rows_close(_rows(two / "fold_1" / "metrics.csv"),
                       _rows(one / "fold_1" / "metrics.csv"))
    # one writer: the same files as one process wrote
    for d in (one, two):
        assert sorted(os.listdir(d / "fold_1")) == [
            "best.ckpt", "last.ckpt", "logs", "metrics.csv"]


def test_cli_dist_coordinator_trains_on_two_ranks(tmp_path, data,
                                                  assets_dir, monkeypatch):
    small_model(monkeypatch)
    flags = ["--data-root", data,
             "--tree-root", str(assets_dir / "class_tree_tl.json"),
             "--class-map", str(assets_dir / "class_map.csv"),
             "--model-type", "1", "--img-size", "32", "--batch-size", "2",
             "--learning-rate", "[1e-3]", "--num-workers", "2",
             "--folds", "1", "--epochs", "1", "--device", "cpu"]
    pcli.main(["--save-path", str(tmp_path / "one")] + flags)
    run_ranks(cli_job, 2, tmp_path,
              ["--save-path", str(tmp_path / "two"), *flags,
               "--dist-coordinator", f"127.0.0.1:{free_port()}"],
              rendezvous=False)
    _assert_rows_close(_rows(tmp_path / "two" / "fold_1" / "metrics.csv"),
                       _rows(tmp_path / "one" / "fold_1" / "metrics.csv"))


# ------------------------------------------------------------ against the JAX
def test_step_over_two_ranks_tracks_the_jax_trainer(tmp_path, data,
                                                    assets_dir, monkeypatch):
    """The JAX Trainer at batch 4 puts its batch on a data axis of 4 of the
    8 CPU devices (global-batch LeanBatchNorm); two port ranks take 2 rows
    each, from the same initial weights."""
    jax_small_model(monkeypatch)
    jtree, ptree = trees("default")
    kw = _cfg_kw(data, tmp_path / "j", batch_size=4)
    fold = os.path.join(data, "fold_1")
    jt = jloop.Trainer(JaxRunConfig(**kw), jtree, os.path.join(fold, "train"),
                       os.path.join(fold, "val"), str(tmp_path / "j"))
    try:
        assert jt.mesh.shape["data"] == 4
        params, stats = jax.device_get((jt.state.params,
                                        jt.state.batch_stats))
        sd = state_dict_from_flax(params, stats)
        sd_path = str(tmp_path / "init.pt")
        torch.save(sd, sd_path)
        x, y = batch(ptree, seed=7, n=4, size=32)
        state, jaux = jt.train_step(jt.state, x, y,
                                    jnp.ones((2,), jnp.float32))
        jsd = state_dict_from_flax(*jax.device_get((state.params,
                                                    state.batch_stats)))
    finally:
        jt.close()
    ranks = run_ranks(step_job, 2, tmp_path, sd_path, x, y, 1, 1, 1e-3,
                      None)
    for r in ranks:
        np.testing.assert_allclose(r["aux"][0][0], float(jaux["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["aux"][0][1].numpy(),
                                   np.asarray(jaux["per_level"]),
                                   rtol=LOSS_RTOL)
    for k, v in jsd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ranks[0]["state"][k].numpy(),
                                       v.numpy(), rtol=0,
                                       atol=1e-4 * float(v.abs().max()),
                                       err_msg=k)
    n_sig, bad = significant_update_ok(
        ranks[0]["params"], {k: v for k, v in jsd.items()
                             if k in ranks[0]["params"]}, sd, 1e-3)
    assert n_sig > 1000 and bad < 0.01, (n_sig, bad)


def test_learning_rates_that_differ_raise(tmp_path, data):
    """The host's decisions come from the first rank: a rank whose
    learning rate differs from it is a fault, and raises."""
    ranks = run_ranks(lr_divergence_job, 2, tmp_path,
                      _cfg_kw(data, tmp_path / "lr"))
    assert ranks[0] is None
    assert "differs from" in ranks[1]


# ------------------------------------------------- the checkpoint manager
MEASURES = [0.3, 0.2, 0.5, 0.5, 0.4]  # best at epochs 1 and 3


def _states(n=len(MEASURES)):
    torch.manual_seed(0)
    state = create_train_state(torch.nn.Linear(3, 2), 1e-3)
    for _ in range(n):  # a different state each epoch
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        state.step += 1
        yield state


@pytest.mark.parametrize("best_save", ["every", "end"])
def test_non_writing_manager_makes_the_same_decisions(tmp_path, best_save):
    """``write=False`` (every rank of a data group but the first): the same
    best/last decisions and gate, no file and no directory."""
    kw = dict(ckpt_every=2, final_epoch=len(MEASURES), best_save=best_save)
    writer = CheckpointManager(str(tmp_path / "w"), **kw)
    quiet = CheckpointManager(str(tmp_path / "q"), write=False, **kw)
    for epoch, (state, m) in enumerate(zip(_states(), MEASURES), 1):
        got = [mgr.update(state, epoch, 1.0, m, 0.1)
               for mgr in (writer, quiet)]
        assert got[0] == got[1] == (epoch in (1, 3)), epoch
        assert writer.prev_best == quiet.prev_best
    for mgr in (writer, quiet):
        mgr.finalize()
    assert not (tmp_path / "q").exists()
    meta = json.loads((tmp_path / "w" / "best.ckpt" /
                       "rhss_meta.json").read_text())
    assert meta["epoch"] == 3


def test_defer_hooks_keep_the_deferred_best(tmp_path):
    """``best_save="end"`` with an owner's ``defer_snapshot``/``defer_fetch``:
    the owner's handle is taken at each improvement, fetched once at
    finalize, and best.ckpt holds the best epoch's state."""
    store, fetched = {}, []

    def snap(state):
        store["best"] = snapshot(state, device=None)
        return "best"

    def fetch(handle):
        fetched.append(handle)
        return store.pop(handle)

    mgr = CheckpointManager(str(tmp_path / "d"), best_save="end",
                            ckpt_every=100, final_epoch=100,
                            defer_snapshot=snap, defer_fetch=fetch)
    want = None
    for epoch, (state, m) in enumerate(zip(_states(), MEASURES), 1):
        if mgr.update(state, epoch, 1.0, m, 0.1):
            want = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert not (tmp_path / "d" / "best.ckpt").exists()  # deferred
    mgr.finalize()
    assert fetched == ["best"]
    saved = torch.load(tmp_path / "d" / "best.ckpt" / "state.pt")
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v)
    with pytest.raises(ValueError, match="together"):
        CheckpointManager(str(tmp_path / "x"), defer_snapshot=snap)

"""Shared helpers of the distributed tests (``test_torch_distributed.py``,
``test_torch_fold_parallel.py``, ``test_torch_remat.py``,
``test_torch_mesh_inference.py``): a function run on N ranks over ``gloo``
on the CPU, each rank a process started with ``spawn``, and the jobs those
ranks run.

:func:`run_ranks` gives every run its own ``file://`` rendezvous under the
test's ``tmp_path`` (no port, so concurrent test workers never collide),
joins the ranks with a time limit, kills what is left, and returns what
each rank's job returned (through ``torch.save`` files, no queue). The
jobs import torch and the port only: never jax.
"""
import os
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 240
_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "assets")
ASSETS_TREE = os.path.join(_ASSETS, "class_tree_tl.json")
ASSETS_MAP = os.path.join(_ASSETS, "class_map.csv")


def _entry(job, rank, world, init, out_dir, args):
    import torch.distributed as dist

    torch.set_num_threads(2)
    if init is not None:
        dist.init_process_group("gloo", init_method=init, world_size=world,
                                rank=rank)
    try:
        out = job(rank, world, *args)
    finally:
        if init is not None:
            dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(job, world, tmp_path, *args, rendezvous=True,
              timeout=RANK_TIMEOUT_S):
    """``job(rank, world, *args)`` on ``world`` spawned ranks (in a gloo
    process group unless ``rendezvous`` is False: the job then makes its
    own); returns the ranks' results in rank order."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(str(tmp_path), f"ranks_{job.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    init = (f"file://{os.path.join(out_dir, 'rendezvous')}" if rendezvous
            else None)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(job, r, world, init, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} of {world} ranks still running after " \
                     f"{timeout} s: killed"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def free_port() -> int:
    """A TCP port free on localhost now (for the CLI's tcp rendezvous)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def small_model_here():
    """The base-width-8 hierarchical UNet in the trainer of this process
    (``torch_trainer_common.small_model`` without pytest's monkeypatch)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (
        UNetBackbone,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        loop,
    )

    def small(tree, model_select, model_type, *args, **kwargs):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8),
                                       hierarchical=model_type == 1)

    loop.build_model = small


def rank_rows(batch: int, rank: int, world: int, micro: int = 1):
    """This rank's rows of a global batch (``data/loader.py:shard_rows``)
    as an index array."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.loader import (
        shard_rows,
    )

    return np.concatenate([np.arange(a, b) for a, b in
                           shard_rows(batch, (rank, world, micro))])


# ----------------------------------------------------------------- the jobs
def bn_job(rank, world, cases, device="cpu"):
    """Each case ``(x, gamma, beta, cot, act)`` (x NHWC numpy, the global
    batch): a train-mode ``BatchNormAct`` on ``device`` over the WORLD
    group on this rank's rows; returns per case (y, dx, dgamma, dbeta,
    running_mean, running_var) of this rank, on the CPU, and the launches
    its counters saw."""
    import torch.distributed as dist

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
        BatchNormAct,
        set_bn_group,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        fused_bn_act as fba,
    )

    out = []
    for x, gamma, beta, cot, act in cases:
        rows = rank_rows(x.shape[0], rank, world)
        bn = BatchNormAct(x.shape[-1], act).to(device)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(gamma))
            bn.bias.copy_(torch.from_numpy(beta))
        set_bn_group(bn.train(), dist.group.WORLD)
        xr = torch.from_numpy(x[rows]).to(device).permute(0, 3, 1, 2)
        xr = xr.contiguous(memory_format=torch.channels_last)
        xr.requires_grad_()
        y = bn(xr)
        ct = torch.from_numpy(cot[rows]).to(device).permute(0, 3, 1, 2)
        (y * ct).sum().backward()
        out.append(tuple(t.detach().cpu().clone() for t in (
            y.permute(0, 2, 3, 1), xr.grad.permute(0, 2, 3, 1),
            bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var)))
    return out, dict(fba.TRAIN_LAUNCHES)


def model_job(rank, world, donor, sd_path, x, cot):
    """One train-mode forward and backward of a hierarchical segmenter
    (``donor``: "unet", width 8, or "hrnet", the tiny HRNet of
    ``tests/test_models.py``) from the state_dict at ``sd_path`` over the
    WORLD group, on this rank's rows of x; the loss is the sum of every
    level's logits times ``cot``. Returns this rank's logits, input
    gradient, parameter gradients and running buffers."""
    import torch.distributed as dist

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
        set_bn_group,
    )

    model = build_small(donor)
    model.load_state_dict(torch.load(sd_path), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    set_bn_group(model, dist.group.WORLD if world > 1 else None)
    rows = rank_rows(x.shape[0], rank, world)
    xr = torch.from_numpy(x[rows]).requires_grad_()
    out = model(xr)
    loss = sum((z * torch.from_numpy(c[rows])).sum()
               for z, c in zip(out.logits_per_level, cot))
    loss.backward()
    return {"logits": [z.detach().clone() for z in out.logits_per_level],
            "dx": xr.grad.clone(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "buffers": {k: v.clone() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}}


def build_small(donor: str, remat=False):
    """The hierarchical segmenter on the default tree with a small backbone:
    "unet" (base width 8) or "hrnet" (the tiny HRNet, widths 4-32), with
    ``remat`` (``models/remat.py``)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.hrnet import (
        HRNetConfig,
        HRNetStage,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        HierarchicalSegmenter,
        UNetBackbone,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.hierarchical import (
        build_model,
    )

    tree = ClassTree.from_json(ASSETS_TREE, ASSETS_MAP)
    if donor == "unet":
        return HierarchicalSegmenter(tree=tree,
                                     backbone=UNetBackbone(base_ch=8),
                                     hierarchical=True, remat=remat)
    tiny = HRNetConfig(
        stage1=HRNetStage(1, 1, "BOTTLENECK", (1,), (4,)),
        stage2=HRNetStage(1, 2, "BASIC", (1, 1), (4, 8)),
        stage3=HRNetStage(1, 3, "BASIC", (1, 1, 1), (4, 8, 16)),
        stage4=HRNetStage(1, 4, "BASIC", (1, 1, 1, 1), (4, 8, 16, 32)),
    )
    return build_model(tree, 1, 1, tiny, remat=remat)


def step_job(rank, world, sd_path, x, y, steps, grad_accum, lr, level_weights,
             local_loss=False, remat=False):
    """``steps`` train steps of the base-width-8 UNet (with ``remat``) from
    the state_dict at ``sd_path`` over the WORLD group, on this rank's rows
    of the global batch (x, y); returns each step's (loss, per_level,
    confmats) and all-reduces, the final parameters and buffers, and
    (``local_loss``) each step's loss computed again with this rank's Dice
    count alone."""
    import torch.distributed as dist

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.losses.hierarchical import (
        hierarchical_loss,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
        set_bn_group,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        create_train_state,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step,
        split_targets,
    )

    tree = ClassTree.from_json(ASSETS_TREE, ASSETS_MAP)
    model = build_small("unet", remat)
    model.load_state_dict(torch.load(sd_path), strict=True)
    model = model.to(memory_format=torch.channels_last)
    group = dist.group.WORLD if world > 1 else None
    reduces = [0]
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(*a, **k):
        reduces[0] += 1
        return real_all_reduce(*a, **k)
    set_bn_group(model, group)
    state = create_train_state(model, lr)
    step = make_train_step(model, tree, True, level_weights=level_weights,
                           grad_accum=grad_accum, group=group)
    rows = rank_rows(x.shape[0], rank, world, grad_accum)
    xr, yr = torch.from_numpy(x[rows]), torch.from_numpy(y[rows])
    mask = torch.ones(2)
    auxes, local, all_reduces = [], [], []
    for _ in range(steps):
        if local_loss:
            with torch.no_grad():
                out = model(xr)
                total, _ = hierarchical_loss(
                    out.logits_per_level, split_targets(tree, yr.float(), True),
                    level_weights, probs_per_level=out.probs_per_level,
                    tree=tree)
            local.append(float(total))
        reduces[0] = 0
        dist.all_reduce = counted_all_reduce
        try:
            state, aux = step(state, xr, yr, mask)
        finally:
            dist.all_reduce = real_all_reduce
        all_reduces.append(reduces[0])
        auxes.append((float(aux["loss"]), aux["per_level"].clone(),
                      [c.clone() for c in aux["confmats"]]))
    return {"aux": auxes, "local_loss": local, "all_reduces": all_reduces,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}


def train_job(rank, world, cfg_kw, device="cpu"):
    """``train/loop.py:train`` of the base-width-8 UNet on this rank of the
    run; returns what it returned."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        loop,
    )

    small_model_here()
    return loop.train(RunConfig(**cfg_kw), device=device)


def cli_job(rank, world, argv):
    """The train CLI as rank ``rank`` of ``world`` (its own tcp rendezvous
    through ``--dist-coordinator``), with the base-width-8 UNet."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
        train as pcli,
    )

    small_model_here()
    return pcli.main(list(argv) + ["--dist-procs", str(world),
                                   "--dist-proc-id", str(rank)])


def lr_divergence_job(rank, world, cfg_kw):
    """A ``Trainer`` of the base-width-8 UNet over the WORLD group whose
    last rank's learning rate is changed behind the scheduler's back;
    returns what ``decide`` raised on this rank (None if nothing)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        loop,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        set_learning_rate,
    )

    small_model_here()
    cfg = RunConfig(**cfg_kw)
    fold = os.path.join(cfg.data_root, "fold_1")
    t = loop.Trainer(cfg, ClassTree.from_json(ASSETS_TREE, ASSETS_MAP),
                     os.path.join(fold, "train"), os.path.join(fold, "val"),
                     os.path.join(cfg.save_path, "fold_1"), device="cpu")
    try:
        if rank == world - 1:
            set_learning_rate(t.state, 2 * t.lr())
        tr = {"loss": 1.0}
        va = {"measure_mean": 0.5, "measure_std": 0.1}
        try:
            t.decide(1, tr, va)
        except RuntimeError as e:
            return str(e)
        return None
    finally:
        t.close()


def mesh_inference_job(rank, world, sd_paths, x, eval_kw, weights, data_root,
                       save_base, device="cpu"):
    """The inference paths over the ranks: the fold-mesh ``Predictor`` of
    the base-width-8 UNet over the fold weights at ``sd_paths`` (a
    ``fold`` mesh of every rank; with and without TTA) on the replicated
    images ``x`` (the TTA forward under ``utils/profiling.py:trace`` into
    ``save_base/traces``), what ``export_predictor`` raises for it, and
    ``predict_eval`` over the data mesh at ``eval_kw``'s batch and at
    batch 3 (one rank idle) into ``save_base/rank{rank}``, on ``device``
    ("cuda": the ranks share ``cuda:0``). Returns the Predictors' outputs
    and local fold counts, their kernel-2 launches, the export error and
    the eval results."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        fused_bn_act as fba,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.mesh import (
        FOLD_AXIS,
        RankMesh,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate,
        serving,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.export import (
        export_predictor,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils.profiling import (
        annotate,
        trace,
    )

    if device == "cuda":
        torch.cuda.set_device(0)
    serving.build_model = lambda *a, **k: build_small("unet")
    evaluate.build_model = lambda *a, **k: build_small("unet")
    cfg = RunConfig(img_size=x.shape[1], model_type=1,
                    tree_root=ASSETS_TREE, class_map=ASSETS_MAP)
    mesh = RankMesh(np.arange(world), (FOLD_AXIS,))
    sds = [torch.load(p) for p in sd_paths]
    out = {}
    for tta in (False, True):
        pred = serving.Predictor(cfg, sds, device=device, mesh=mesh, tta=tta)
        before = fba.LAUNCHES
        with trace(os.path.join(save_base, "traces") if tta else None,
                   device=device), annotate(f"fold_mesh_rank{rank}"):
            res = pred(x)
        out[f"tta={tta}"] = {"local_folds": len(pred.models),
                             "launches": fba.LAUNCHES - before, **res}
    try:
        export_predictor(pred, os.path.join(save_base, f"r{rank}.pt2"))
        out["export"] = None
    except ValueError as e:
        out["export"] = str(e)
    ecfg = RunConfig(tree_root=ASSETS_TREE, class_map=ASSETS_MAP, **eval_kw)
    out["eval"] = evaluate.predict_eval(
        ecfg, [weights], [data_root], os.path.join(save_base, f"rank{rank}"),
        device=device)
    odd = RunConfig(tree_root=ASSETS_TREE, class_map=ASSETS_MAP,
                    **dict(eval_kw, val_batch=3))
    out["eval_batch3"] = evaluate.predict_eval(
        odd, [weights], [data_root], None, device=device)
    return out

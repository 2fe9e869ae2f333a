"""The jobs of the spatial-sharding tests (``test_torch_space.py``): each
runs on the ranks of ``torch_dist_common.run_ranks`` (gloo, the CPU) over
a ``(data, space)`` mesh of the port (``parallel/mesh.py``), with this
rank's band of rows (``parallel/bands.py``). They import torch and the
port only: never jax.
"""
import numpy as np
import torch

from torch_dist_common import ASSETS_MAP, ASSETS_TREE, build_small


def mesh_groups(n_data, n_space):
    """(mesh, data group, space group, step group) of this rank."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    mesh = make_mesh(n_data=n_data, n_space=n_space)
    return mesh, mesh.data_group(), mesh.space_group(), mesh.step_group()


def my_rows(h, space):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.bands import (
        band,
    )

    return slice(*band(h, space.size, space.index))


def banded_model(donor, sd, space, step, train, device="cpu", remat=False):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
        set_bn_group,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.bands import (
        set_space_group,
    )

    model = build_small(donor, remat)
    model.load_state_dict(sd, strict=True)
    model = model.to(device, memory_format=torch.channels_last).train(train)
    set_space_group(model, space)
    set_bn_group(model, step.group)
    return model


def ops_job(rank, world, cases):
    """Each banded op of ``parallel/bands.py`` on this rank's band, with
    its gradient: ``cases`` is a list of ``(name, x, params, cot)`` (x
    NCHW, cot the output's cotangent for the whole output; for "fetch"
    each rank's requested rows' cotangent); returns per case (output band,
    input band's gradient, parameter gradients)."""
    import torch.nn.functional as F

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.film import (
        FiLM,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel import (
        bands,
    )

    _, _, space, _ = mesh_groups(1, world)
    out = []
    for name, x, params, cot in cases:
        h = x.shape[2]
        xr = torch.from_numpy(x[:, :, my_rows(h, space)]).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        mods = []
        if name == "fetch":  # cot: this rank's rows' cotangent
            y = bands.fetch_rows(xr, h, params["lo"], params["hi"], space)
            (y * torch.from_numpy(cot[rank])).sum().backward()
            out.append((y.detach(), xr.grad, []))
            continue
        if name == "conv":
            k, s, p = params["k"], params["s"], params["p"]
            conv = torch.nn.Conv2d(x.shape[1], 3, k, s, p)
            conv.load_state_dict(params["sd"])
            mods = [conv]
            y = bands.conv2d(conv, xr, h, space)
            ho = bands.conv_height(conv, h)
        elif name == "pool":
            y = bands.max_pool2(xr, h, space)
            ho = h // 2
        elif name == "resize":
            ho = params["size"][0]
            y = bands.resize(xr, h, params["size"], params["ac"], space)
        elif name == "pad":
            top, bottom = params["pad"]
            y = F.pad(bands.pad_rows(xr, h, top, bottom, space), (1, 0))
            ho = h + top + bottom
        elif name == "film":
            film = FiLM(x.shape[1], 5)
            film.load_state_dict(params["sd"])
            film.space = space
            mods = [film]
            feats = torch.from_numpy(params["feats"][:, :, my_rows(h, space)])
            y = film(feats, xr, h)
            ho = h
        c = torch.from_numpy(cot[:, :, my_rows(ho, space)])
        (y * c).sum().backward()
        out.append((y.detach(), xr.grad,
                    [p.grad for m in mods for p in m.parameters()]))
    return out


def forward_job(rank, world, donor, sd, x, device="cpu"):
    """The small donor's forward on this rank's band of ``x`` (NHWC) over
    a space group of every rank, on ``device`` ("cuda:0": the ranks share
    the card, its f32 convolutions without TF32), in eval mode and then in
    train mode; returns per mode the logits and probabilities of every
    level (bands) and the running buffers after, on the CPU, and the
    launches of the kernel entries."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        fused_bn_act as fba,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils.device import (
        float32_convs,
    )

    _, _, space, step = mesh_groups(1, world)
    xr = torch.from_numpy(np.ascontiguousarray(
        x[:, my_rows(x.shape[1], space)])).to(device)
    out = {}
    with float32_convs(xr.is_cuda):
        for train in (False, True):
            model = banded_model(donor, sd, space, step, train, device)
            with torch.no_grad():
                o = model(xr)
            out[train] = ([z.cpu() for z in o.logits_per_level],
                          [p.cpu() for p in o.probs_per_level],
                          {k: v.cpu() for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))})
    out["launches"] = dict(fba.TRAIN_LAUNCHES, scale_bias_act=fba.LAUNCHES)
    return out


def step_job(rank, world, donor, sd, x, y, n_data, n_space, lr,
             level_weights=None, loss_kw=None, remat=False):
    """One port train step over a ``(n_data, n_space)`` mesh of every
    rank (or alone: ``world`` 1): this rank's rows of the batch
    (``shard_rows``) and band of H, ``loss_kw`` for ``make_train_step``,
    the model with ``remat`` (``models/remat.py``);
    returns the step's loss, per-level losses, confusion matrices, every
    gradient (the step's, all-reduced) and the state after."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (
        create_train_state,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step,
    )
    from torch_dist_common import rank_rows

    tree = ClassTree.from_json(ASSETS_TREE, ASSETS_MAP)
    _, data, space, step_group = mesh_groups(n_data, n_space)
    model = banded_model(donor, sd, space, step_group, True, remat=remat)
    state = create_train_state(model, lr)
    step = make_train_step(model, tree, True, level_weights=level_weights,
                           group=step_group.group, space=space,
                           **(loss_kw or {}))
    rows = rank_rows(x.shape[0], data.index, data.size)
    band = my_rows(x.shape[1], space)
    xr = torch.from_numpy(np.ascontiguousarray(x[rows][:, band]))
    yr = torch.from_numpy(np.ascontiguousarray(y[rows][:, band]))
    state, aux = step(state, xr, yr, torch.ones(2))
    return {"loss": float(aux["loss"]), "per_level": aux["per_level"],
            "confmats": aux["confmats"],
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def steps_job(rank, world, runs):
    """:func:`step_job` for each of ``runs`` (tuples of its arguments after
    ``world``) in one process group."""
    return [step_job(rank, world, *run) for run in runs]


def space_runs_job(rank, world, cli_argv, fold_kw, eval_kw, weights,
                   eval_root, eval_save):
    """On the ranks of one process group, at ``--n-space`` = ``world``
    (a ``(data 1, space world)`` mesh), with the base-width-8 UNet: the
    train CLI (``cli_argv``, without ``--dist-*`` flags: the group is
    there), the fold-parallel trainer (``fold_kw``, a ``RunConfig``), and
    ``predict_eval`` of ``weights`` over ``eval_root`` into
    ``eval_save/rank{rank}``; returns what each returned."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
        train as pcli,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate,
        loop,
    )
    from torch_dist_common import small_model_here

    small_model_here()
    evaluate.build_model = lambda *a, **k: build_small("unet")
    out = {"cli": pcli.main(list(cli_argv) + ["--n-space", str(world)]),
           "fold_parallel": loop.train(RunConfig(**fold_kw,
                                                 n_space=world),
                                       device="cpu")}
    cfg = RunConfig(tree_root=ASSETS_TREE, class_map=ASSETS_MAP,
                    n_space=world, **eval_kw)
    import os

    out["eval"] = evaluate.predict_eval(
        cfg, [weights], [eval_root], os.path.join(eval_save, f"rank{rank}"),
        device="cpu")
    return out


# the Evaluator with quantize on bands (tests/test_torch_space_quantize.py):
# the base-width-8 UNet at 48 px and the tiny HRNet at 72 px (their lowest
# levels have 3 rows, so 3 ranks each hold one), with and without tta
QUANT_SIZES = {"unet": 48, "hrnet": 72}
QUANT_CASES = [(donor, tta) for donor in ("unet", "hrnet")
               for tta in (False, True)]


def quant_cfg_kw(donor, tta):
    return dict(tree_root=ASSETS_TREE, class_map=ASSETS_MAP, model_type=1,
                model_select=0 if donor == "unet" else 1,
                img_size=QUANT_SIZES[donor], val_batch=2, num_workers=1,
                quantize=True, calib_batches=2, tta=tta)


def quant_evaluate(cfg, donor, root, weights, save, device="cpu"):
    """The port's int8 Evaluator of ``donor``'s small model (patched into
    ``train/evaluate.py``): (its result, its scales)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate,
    )

    evaluate.build_model = lambda *a, **k: build_small(donor)
    tree = evaluate.ClassTree.from_json(cfg.tree_root, cfg.class_map)
    ev = evaluate.Evaluator(cfg, tree, root, weights, save, device=device)
    return ev.run(), ev.act_scales


def quantized_eval_job(rank, world, roots, weights, save):
    """On ``world`` ranks at ``n_space = world``: every case's int8
    Evaluator over ``roots[donor]`` with the port weights
    ``weights[donor]``, its files into ``save/<donor>_<tta>_rank<rank>``;
    (result, scales) per case."""
    import os

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
        RunConfig,
    )

    out = {}
    for donor, tta in QUANT_CASES:
        cfg = RunConfig(n_space=world, **quant_cfg_kw(donor, tta))
        out[(donor, tta)] = quant_evaluate(
            cfg, donor, roots[donor], weights[donor],
            os.path.join(save, f"{donor}_{tta}_rank{rank}"))
    return out

"""Train CLI — counterpart of the JAX package's ``cli/train.py``: the same
51 flags with the same names, defaults and choices (drop-in parity with the
reference ``train.py:714-750``), plus ``--device`` (``cuda`` by default;
``cpu`` to train on the host).

Example (reference README.md:71-91, adapted):

    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.cli.train \\
        --save-path runs/hier_unet --data-root data/tlpano \\
        --tree-root assets/class_tree_tl.json --class-map assets/class_map.csv \\
        --epochs 80 --batch-size 16 --img-size 352 --model-type 1 \\
        --model-select 0 --learning-rate "[0.018]" --folds 5 \\
        --inc-cross-val True --compute-dtype bfloat16 \\
        --level-weights "[[0.0297,1.577,0.9619,0.1770],[1.5432,0.2638,1.0413,3.9722]]"

``--model-weights``: a ``<name>.ckpt`` directory of the port's trainer
resumes; a ``.pt``/``.pth`` file seeds the model's weights (the port's own
state_dict, or a donor checkpoint under the published HRNet or
milesial-UNet names, as the JAX CLI reads it; ``train/torch_import.py``).

``--device-data True`` keeps the training set on ``--device`` and augments
it there (``data/device_augment.py``). ``--loader grain`` raises: grain is a
JAX input pipeline with no counterpart here. The JAX trainer's scale-out
options raise and name ROADMAP queue 1, item 8: ``--fold-parallel True``
over several folds, ``--n-space`` above 1, ``--dist-coordinator``,
``--remat`` other than False and ``--profile-dir``.
"""
from __future__ import annotations

import argparse
import ast


from .common import parse_bool as _bool


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train restrictive hierarchical segmentation (PyTorch port)"
    )
    p.add_argument("--save-path", type=str, required=True)
    p.add_argument("--model-weights", type=str, default="None")
    p.add_argument("--no-ph-weights", type=str, default="True")  # vestigial parity
    p.add_argument("--data-root", type=str, required=True, dest="root")
    p.add_argument("--tree-root", type=str, required=True)
    p.add_argument("--class-map", type=str, required=True)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--val-dataset", type=str, default="None")
    p.add_argument("--img-size", type=int, default=352)
    p.add_argument("--learning-rate", type=str, default="[1e-4]", dest="lr")
    p.add_argument("--test-remove", type=str, default="True")
    p.add_argument("--model-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--model-select", type=int, default=0, choices=[0, 1])
    p.add_argument("--val-batch", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=-1)
    p.add_argument("--loader", type=str, default="threads",
                   choices=["threads", "process", "grain"])
    p.add_argument("--learning-rate-scheduler", type=str, default="true",
                   dest="lrs")
    p.add_argument("--learning-rate-scheduler-minimum", type=float,
                   default=1e-6, dest="lrs_min")
    p.add_argument("--multi-gpu", type=str, default="false", dest="mgpu")
    p.add_argument("--save-images-batch", type=str, default="False")
    p.add_argument("--save-images-batch-num", type=int, default=10)
    p.add_argument("--inc-cross-val", type=str, default="True")
    p.add_argument("--folds", type=int, default=0)
    p.add_argument("--fold", type=int, default=0,
                   help=">0: run only this fold (launch folds in parallel "
                        "across hosts/slices — each fold is self-contained)")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--level-weights", type=str, default=None)
    p.add_argument("--level0-pretrain-epochs", type=int, default=None)
    # TPU-framework extensions
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--n-space", type=int, default=1,
                   help="spatial-sharding mesh axis size")
    p.add_argument("--fold-parallel", type=str, default="False",
                   help="train all cross-val folds simultaneously (not "
                        "in the PyTorch port yet: over several folds it "
                        "raises; the reference trains folds sequentially)")
    p.add_argument("--concat-prev-probs", type=str, default="False",
                   help="README-abstract image(+)probs conditioning variant")
    p.add_argument("--remat", type=str, default="False",
                   # "false" | "true"/"module" (full per-module recompute) |
                   # "conv" (save conv outputs only — lighter memory knob)
                   help="rematerialize backbone re-runs (memory for FLOPs)")
    p.add_argument("--best-save", type=str, default="every",
                   choices=("every", "end"),
                   help="best.ckpt policy: 'every' improvement hits disk "
                        "(reference durability) or 'end' keeps the best "
                        "state on device and writes once per fold — avoids "
                        "a ~30s full-state fetch per improving epoch on "
                        "slow host links")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="last.ckpt cadence in epochs (best always saves on "
                        "improvement; final epoch always saves)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help=">1: accumulate gradients over N microbatches per "
                        "optimizer step (peak memory of one microbatch; "
                        "cheaper large-batch knob than --remat)")
    p.add_argument("--lambda-cons", type=float, default=1.0)
    p.add_argument("--lambda-kl", type=float, default=0.0)
    p.add_argument("--use-ohem", type=str, default="False")
    p.add_argument("--ohem-thres", type=float, default=0.9)
    p.add_argument("--ohem-keep", type=int, default=100000)
    p.add_argument("--nan-probe-every", type=int, default=50,
                   help="fetch the loss every N steps and fail fast on "
                        "non-finite values (0 disables the mid-epoch probe)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile-dir", type=str, default=None)
    p.add_argument("--auto-resume", type=str, default="False",
                   help="resume each fold from its last.ckpt when present "
                        "(crash/preemption-safe restarts)")
    p.add_argument("--tensorboard", type=str, default="False",
                   help="also write tf.summary events under <fold>/logs/tb")
    p.add_argument("--host-compact", type=str, default="True",
                   help="int8 ternary targets + 1ch gray images decoded on "
                        "device (smaller host->device transfers)")
    p.add_argument("--device-data", type=str, default="False",
                   help="device-resident train set + on-device augmentation "
                        "(zero host work per epoch; distributionally "
                        "equivalent to the host pipeline)")
    p.add_argument("--dist-coordinator", type=str, default="",
                   help="multi-process training (jax.distributed over "
                        "DCN/gloo): coordinator address host:port; every "
                        "process runs this CLI with the same flags, process "
                        "0 writes all artifacts")
    p.add_argument("--dist-procs", type=int, default=0,
                   help="total process count for --dist-coordinator")
    p.add_argument("--dist-proc-id", type=int, default=-1,
                   help="this process's id in [0, --dist-procs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def config_from_args(args):
    from ..config.run import RunConfig

    lr = ast.literal_eval(args.lr)
    if isinstance(lr, (list, tuple)):
        lr = float(lr[0])
    lw = ast.literal_eval(args.level_weights) if args.level_weights else None
    return RunConfig(
        save_path=args.save_path,
        data_root=args.root,
        val_dataset=None if args.val_dataset == "None" else args.val_dataset,
        tree_root=args.tree_root,
        class_map=args.class_map,
        model_weights=None if args.model_weights in ("None", "") else
        args.model_weights,
        model_select=args.model_select,
        model_type=args.model_type,
        img_size=args.img_size,
        hrnet_yaml=args.config or None,
        concat_prev_probs=_bool(args.concat_prev_probs),
        remat=(args.remat.lower() if args.remat.lower() in ("module", "conv")
               else _bool(args.remat)),
        compute_dtype=args.compute_dtype,
        epochs=args.epochs,
        batch_size=args.batch_size,
        val_batch=args.val_batch,
        lr=float(lr),
        lrs=_bool(args.lrs),
        lrs_min=args.lrs_min,
        level_weights=lw,
        level0_pretrain_epochs=args.level0_pretrain_epochs,
        ckpt_every=args.ckpt_every,
        best_save=args.best_save,
        grad_accum=args.grad_accum,
        lambda_cons=args.lambda_cons,
        lambda_kl=args.lambda_kl,
        use_ohem=_bool(args.use_ohem),
        ohem_thres=args.ohem_thres,
        ohem_keep=args.ohem_keep,
        loader=args.loader,
        num_workers=8 if args.num_workers == -1 else args.num_workers,
        inc_cross_val=_bool(args.inc_cross_val),
        folds=args.folds,
        fold=args.fold,
        test_remove=_bool(args.test_remove),
        seed=args.seed,
        nan_probe_every=args.nan_probe_every,
        save_images_batch=_bool(args.save_images_batch),
        save_images_batch_num=args.save_images_batch_num,
        profile_dir=args.profile_dir,
        n_space=args.n_space,
        fold_parallel=_bool(args.fold_parallel),
        host_compact=_bool(args.host_compact),
        device_data=_bool(args.device_data),
        tensorboard=_bool(args.tensorboard),
        auto_resume=_bool(args.auto_resume),
    )


def main(argv=None):
    args = get_args(argv)
    if _bool(args.mgpu):
        # reference --multi-gpu wraps nn.DataParallel (train.py:509-510);
        # here data parallelism is automatic over the device mesh, so the
        # flag is accepted for drop-in parity but changes nothing
        print("--multi-gpu is ignored: data parallelism is automatic over "
              "the device mesh (see --n-space / --fold-parallel; "
              "MIGRATION.md 'Parallelism').")
    import os

    if os.environ.get("RHSS_FAULTHANDLER"):
        # debugging hook: `kill -USR2 <pid>` dumps all thread stacks to
        # stderr without killing the process
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR2, all_threads=True)
    if args.dist_coordinator:
        raise NotImplementedError(
            "--dist-coordinator: multi-process training is not in the "
            "PyTorch port yet (ROADMAP.md queue 1, item 8)")
    cfg = config_from_args(args)
    from ..train.loop import train

    results = train(cfg, device=args.device)
    print("Finished Training", results)
    return results


if __name__ == "__main__":
    main()

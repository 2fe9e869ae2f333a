"""Predict/Eval CLI — counterpart of the JAX package's
``cli/predict_eval.py``: the same flags with the same names, defaults and
choices (flag parity with the reference ``predictEval.py:577-601``), plus
``--device`` (``cuda`` by default; ``cpu`` to evaluate on the host).
Cross-val mode expands ``--full-ds`` and ``--model-weights`` into per-fold
``root/fold_N/val`` and ``weights/fold_N/best.ckpt`` paths
(predictEval.py:675-707 semantics); the output goes under
``./Predictions/<save-loc>/fold_N/``.

    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.cli.predict_eval \\
        --save-loc hier_unet --full-ds data/tlpano --model-weights runs/hier_unet \\
        --tree-root assets/class_tree_tl.json --class-map assets/class_map.csv \\
        --model-type 1 --folds 5 --val-batch 4

Weights are read by the rule of ``train/torch_import.py:load_model_weights``:
the port trainer's ``<name>.ckpt`` directories, the port's own
``.pt``/``.pth`` state_dict files, or donor ``.pt``/``.pth`` checkpoints (the
published HRNet and milesial-UNet names, as the JAX CLI reads them). A JAX
orbax checkpoint is refused. ``--quantize True`` runs the forward's convs in
int8 (calibrated on the first ``--calib-batches`` validation batches), also
under ``--tta True``.
"""
from __future__ import annotations

import argparse
import os


from .common import parse_bool as _bool


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Make predictions on a dataset")
    p.add_argument("--save-loc", type=str, required=True)
    p.add_argument("--full-ds", type=str, default="False", dest="root")
    p.add_argument("--tree-root", type=str, required=True)
    p.add_argument("--class-map", type=str, required=True)
    p.add_argument("--model-weights", type=str, required=True)
    p.add_argument("--img-size", type=int, default=352)
    p.add_argument("--num-workers", type=int, default=-1)
    p.add_argument("--save-images", type=str, default="True")
    p.add_argument("--include-background", type=str, default="False")  # vestigial
    p.add_argument("--include-std-div", type=str, default="False")     # vestigial
    p.add_argument("--model-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--model-select", type=int, default=0, choices=[0, 1])
    p.add_argument("--inc-cross-val", type=str, default="True")
    p.add_argument("--folds", type=int, default=0)
    p.add_argument("--config", type=str, default="")
    p.add_argument("--compute-dtype", type=str, default="float32")
    p.add_argument("--val-batch", type=int, default=1,
                   help="eval forward batch size; scores stay per-image so "
                        "metrics are identical to the reference's batch=1 "
                        "(reference caps at 1, predictEval.py:222)")
    p.add_argument("--tta", type=str, default="False",
                   help="horizontal-flip test-time augmentation (averaged "
                        "logits/probs)")
    p.add_argument("--quantize", type=str, default="False",
                   help="int8 post-training quantization of the eval forward "
                        "(train/quantize.py)")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="val batches used for --quantize activation-scale "
                        "calibration (running amax)")
    p.add_argument("--eval-inflight", type=int, default=4,
                   help="max dispatched batches whose results are held on "
                        "device before the oldest is fetched (bounds device "
                        "memory for large validation sets)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from ..config.run import RunConfig
    from ..train.evaluate import predict_eval

    cfg = RunConfig(
        tree_root=args.tree_root,
        class_map=args.class_map,
        model_select=args.model_select,
        model_type=args.model_type,
        img_size=args.img_size,
        hrnet_yaml=args.config or None,
        compute_dtype=args.compute_dtype,
        num_workers=8 if args.num_workers == -1 else args.num_workers,
        val_batch=args.val_batch,
        quantize=_bool(args.quantize),
        calib_batches=args.calib_batches,
        eval_inflight=args.eval_inflight,
        tta=_bool(args.tta),
    )
    if _bool(args.inc_cross_val) and args.folds > 0:
        roots, weights = [], []
        for i in range(1, args.folds + 1):
            roots.append(os.path.join(args.root, f"fold_{i}", "val"))
            w = os.path.join(args.model_weights, f"fold_{i}", "best.ckpt")
            if not os.path.exists(w):
                w = os.path.join(args.model_weights, f"fold_{i}", "best.pt")
            weights.append(w)
    else:
        roots, weights = [args.root], [args.model_weights]
    save_root = os.path.join("./Predictions", args.save_loc)
    return predict_eval(cfg, weights, roots, save_root,
                        _bool(args.save_images), device=args.device)


if __name__ == "__main__":
    main()

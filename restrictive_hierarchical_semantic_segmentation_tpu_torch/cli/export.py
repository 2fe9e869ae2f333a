"""Export CLI — counterpart of the JAX package's ``cli/export.py``: write a
checkpoint's serving forward as a self-contained ``torch.export`` artifact
(see ``train/export.py``). The same flags with the same names, defaults
and help as the JAX CLI, plus ``--device`` (``cuda`` by default; ``cpu`` to
export on the host). ``--platforms`` lists the devices the artifact may be
loaded on (``cuda``, ``cpu``); the exporting device comes first.

``--model-weights`` is read by the rule of
``train/torch_import.py:load_model_weights``: a ``<name>.ckpt`` directory of
the port's trainer, the port's own ``.pt``/``.pth`` state_dict, or a donor
``.pt``/``.pth`` checkpoint.

Example::

    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.cli.export \\
        --model-weights runs/fold_1/best.ckpt --out runs/fold_1/model.pt2 \\
        --tree-root assets/class_tree_tl.json --class-map assets/class_map.csv \\
        --model-select 1 --model-type 1 --img-size 620 \\
        --compute-dtype bfloat16 --platforms cuda
"""
from __future__ import annotations

import argparse


from .common import parse_bool as _bool


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Export a checkpoint to a torch.export serving artifact")
    p.add_argument("--model-weights", type=str, required=True,
                   help="checkpoint (.ckpt) or donor torch state dict "
                        "(.pt/.pth) to bake into the artifact")
    p.add_argument("--out", type=str, required=True,
                   help="artifact path (writes <out> + <out>.json sidecar)")
    p.add_argument("--tree-root", type=str, required=True)
    p.add_argument("--class-map", type=str, required=True)
    p.add_argument("--model-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--model-select", type=int, default=0, choices=[0, 1])
    p.add_argument("--img-size", type=int, default=352)
    p.add_argument("--config", type=str, default="")
    p.add_argument("--compute-dtype", type=str, default="float32")
    p.add_argument("--batch", type=str, default="poly",
                   help="'poly' (default: symbolic batch dim — one artifact, "
                        "any batch) or a static int")
    p.add_argument("--platforms", type=str, default="",
                   help="comma list of the devices the artifact may be "
                        "loaded on ('cuda', 'cpu'); the exporting device "
                        "comes first; empty = the exporting device only")
    p.add_argument("--outputs", type=str, default="probs,class_maps",
                   help="comma subset of logits,probs,class_maps baked into "
                        "the artifact (unrequested outputs are not in the "
                        "program)")
    p.add_argument("--quantize", type=str, default="False",
                   help="int8 PTQ the conv stack before export (uniform "
                        "fallback calibration unless real batches are wired "
                        "through the Predictor API)")
    p.add_argument("--ensemble", type=str, default="",
                   help="'best' or 'last': treat --model-weights as a train "
                        "run dir and export the fold-ensemble forward; the "
                        "fold weights are in the artifact")
    p.add_argument("--tta", type=str, default="False",
                   help="bake hflip test-time augmentation into the "
                        "exported forward (train/evaluate.py tta_apply)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to export on: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from ..config.run import RunConfig
    from ..train.export import export_predictor
    from ..train.serving import Predictor

    cfg = RunConfig(
        tree_root=args.tree_root,
        class_map=args.class_map,
        model_select=args.model_select,
        model_type=args.model_type,
        img_size=args.img_size,
        hrnet_yaml=args.config or None,
        compute_dtype=args.compute_dtype,
    )
    outputs = tuple(s for s in args.outputs.split(",") if s)
    weights = (Predictor.fold_checkpoints(args.model_weights, args.ensemble)
               if args.ensemble else args.model_weights)
    if args.ensemble and "logits" in outputs:
        # ensembles emit fold-mean probabilities; logits are None there
        outputs = tuple(k for k in outputs if k != "logits")
        if not outputs:
            outputs = ("probs",)
            print("note: --ensemble cannot export 'logits' (fold-mean "
                  "probabilities have no single logit tensor); exporting "
                  "'probs' instead")
    pred = Predictor(cfg, weights, quantize=_bool(args.quantize),
                     outputs=outputs, tta=_bool(args.tta),
                     device=args.device)
    batch = None if args.batch == "poly" else int(args.batch)
    platforms = (tuple(s for s in args.platforms.split(",") if s) or None)
    path = export_predictor(pred, args.out, batch=batch, platforms=platforms)
    import json

    with open(path + ".json") as f:
        meta = json.load(f)
    print(f"exported {path} ({meta['artifact_bytes']/1e6:.1f} MB, "
          f"platforms={meta['platforms']}, batch={meta['batch']})")
    return path


if __name__ == "__main__":
    main()

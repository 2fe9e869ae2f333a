"""The port's counterpart of ``tests/test_extended_eval_recall.py``: the
depth-4 eval-mode recall floor.

The same recipe through the port on the CPU: a short hierarchical training
run on synthetic data under the EXTENDED depth-4 tree (base-width-8 UNet,
48 px, 10 epochs), then offline eval through the port's ``predict_eval``
(running-statistics BN, the mode users deploy). Both level-0 recalls must
stay above the JAX test's floor of 0.5, and the mean recall over every
class above its 0.2: a train/eval forward divergence (BN running-statistics
drift at depth 4, eval-mode composition, starvation of the binary level-0
head) lands at about 0 there.
"""
import numpy as np

from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)

PORT = "restrictive_hierarchical_semantic_segmentation_tpu_torch"


def test_depth4_eval_mode_l0_recall_floor(tmp_path, assets_dir, monkeypatch):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (
        UNetBackbone,
    )

    def small(tree, model_select, model_type, *args, **kwargs):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8),
                                       hierarchical=model_type == 1)

    for mod in ("loop", "evaluate"):
        monkeypatch.setattr(f"{PORT}.train.{mod}.build_model", small)
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.evaluate import (
        predict_eval,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.loop import (
        train,
    )

    root = str(tmp_path / "data")
    write_synth_dataset(root, 8, size=96, seed=3, folds=1)
    cfg = RunConfig(
        save_path=str(tmp_path / "run"),
        data_root=root,
        tree_root=str(assets_dir / "class_tree_tl_extended.json"),
        class_map=str(assets_dir / "class_map_extended.csv"),
        model_select=0, model_type=1, img_size=48, epochs=10, batch_size=2,
        val_batch=2, lr=3e-3, num_workers=2, inc_cross_val=True, folds=1,
        level0_pretrain_epochs=None,
    )
    results = train(cfg, device="cpu")
    assert results[0] is not None

    res = predict_eval(cfg, weights=[str(tmp_path / "run" / "fold_1" /
                                         "best.ckpt")],
                       roots=[f"{root}/fold_1/val"],
                       save_root=str(tmp_path / "pred"), device="cpu")
    per_class = res[0]["per_class"]
    assert len(per_class) == 11  # 2 + 2 + 4 + 3 extended classes
    # level 0 = [Background, Tooth+alveolar]: the gate for the whole tree
    l0_recalls = [per_class[0]["recall"], per_class[1]["recall"]]
    assert min(l0_recalls) > 0.5, (
        f"eval-mode level-0 recall collapsed: {l0_recalls} "
        "(train/eval forward divergence or metric-path regression)")
    # the deeper levels were trained and scored, not masked away
    assert np.mean([m["recall"] for m in per_class]) > 0.2

"""The port's offline eval (``train/evaluate.py``) against the JAX
package's on the CPU: the flat-model hierarchy reconstruction, the
horizontal-flip TTA, and ``predict_eval`` / ``Evaluator`` end to end on the
same weights and the same synthetic files, hierarchical and flat.

Tolerances:
- ``reconstruct_levels_from_leaves``: exact (numpy on both sides).
- ``tta_apply``: logits and probabilities within the port tests' f32
  tolerance (rtol = atol = 1e-4, ``torch_port_common.RTOL``: XLA and
  oneDNN sum the convolutions in other orders); against the mean of the two
  views computed by hand within rtol 1e-5, atol 1e-6 (the JAX test's).
- ``metrics.csv``: every value within 1e-6 absolute. The values are means
  over images of ratios of pixel counts, so equal class maps give them to
  float64 rounding.
- the per-class PNG dumps: the same directories and file names, and the
  decoded pixels equal on at least 99.9 % of all dumped pixels (a pixel
  whose two largest logits the two frameworks order differently is the
  only allowed cause of a difference; these seeds give none).
"""
import os

import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    evaluate as jev,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    decode_png,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    evaluate as pev,
)
from torch_eval_common import (
    IMG,
    csv_numbers,
    jax_small,
    port_small,
    read_csv,
    seeded_variables,
    small_models,
    write_weights,
)
from torch_port_common import ASSETS, ATOL, RTOL, TREE_FILES, load_port, trees

CSV_ATOL = 1e-6
PIXEL_SHARE = 0.999
N_IMAGES = 5


@pytest.mark.parametrize("name", ["default", "extended"])
def test_reconstruct_levels_from_leaves_equals_jax(name):
    jtree, ptree = trees(name)
    rng = np.random.default_rng(1)
    leaf_oh = np.eye(jtree.num_leaves, dtype=np.float32)[
        rng.integers(0, jtree.num_leaves, (3, 9, 7))]
    want = jev.reconstruct_levels_from_leaves(leaf_oh, jtree)
    got = pev.reconstruct_levels_from_leaves(leaf_oh, ptree)
    assert len(got) == len(want) == jtree.num_levels
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("model_type", [1, 0])
def test_tta_apply_against_jax(model_type):
    jtree, ptree = trees("default")
    params, stats = seeded_variables(jtree, model_type, seed=4)
    jmodel = jax_small(jtree, model_type)
    pmodel = load_port(port_small(ptree, model_type), params, stats)
    x = np.random.default_rng(5).normal(size=(2, IMG, IMG, 3)).astype(
        np.float32)
    variables = {"params": params, "batch_stats": stats}
    want = jev.tta_apply(jmodel.apply)(variables, x, train=False)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = pev.tta_apply(pmodel)(xt)
        one, two = pmodel(xt), pmodel(xt.flip(2))
    keys = ["logits_per_level"] + (["probs_per_level"] if model_type else [])
    assert (got.probs_per_level is None) == (model_type == 0)
    for key in keys:
        for L, (g, w) in enumerate(zip(getattr(got, key), getattr(want, key))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key} {L}")
            by_hand = 0.5 * (getattr(one, key)[L] + getattr(two, key)[L]
                             .flip(2))
            np.testing.assert_allclose(g.numpy(), by_hand.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{key} {L}")
    if model_type:
        # the first view's conditionals
        assert got.q_per_level[0] is None
        for g, w in zip(got.q_per_level[1:], one.q_per_level[1:]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_data"))
    write_synth_dataset(root, N_IMAGES, size=IMG, seed=3)
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jtree, ptree = trees("default")
    return {mt: write_weights(str(tmp_path_factory.mktemp(f"w{mt}")), jtree,
                              ptree, mt, seed=2)
            for mt in (1, 0)}


def _configs(**kw):
    tree, cmap = (str(ASSETS / f) for f in TREE_FILES["default"])
    kw = dict(tree_root=tree, class_map=cmap, model_select=0, img_size=IMG,
              num_workers=2, **kw)
    return JaxRunConfig(**kw), RunConfig(**kw)


def _param_count(out: str) -> int:
    line = next(ln for ln in out.splitlines()
                if ln.startswith("Number of model parameters: "))
    return int(line.split(":")[1])


def _pixels(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


@pytest.mark.parametrize("model_type", [1, 0])
def test_predict_eval_against_jax(model_type, data_root, weights, tmp_path,
                                  monkeypatch, capsys):
    """The port's predict_eval and the JAX one on the same weights and
    files, at val_batch 2 (a padded ragged tail): metrics.csv, the printed
    parameter count, and the per-class PNG dumps."""
    small_models(monkeypatch)
    jcfg, pcfg = _configs(model_type=model_type, val_batch=2)
    jw, pw = weights[model_type]
    jres = jev.predict_eval(jcfg, [jw], [data_root], str(tmp_path / "jax"))
    jcount = _param_count(capsys.readouterr().out)
    pres = pev.predict_eval(pcfg, [pw], [data_root], str(tmp_path / "port"),
                            device="cpu")
    pcount = _param_count(capsys.readouterr().out)
    assert pcount == jcount > 0

    jdir, pdir = tmp_path / "jax" / "fold_1", tmp_path / "port" / "fold_1"
    jrows, prows = read_csv(jdir / "metrics.csv"), read_csv(pdir / "metrics.csv")
    assert prows[0] == jrows[0] == ["Type", "Class", "Accuracy", "IoU", "Dice",
                                    "Precision", "Recall"]
    assert [r[:2] for r in prows] == [r[:2] for r in jrows]
    assert len(prows) == 1 + 1 + 8  # scored on all 8 classes in both modes
    np.testing.assert_allclose(csv_numbers(prows), csv_numbers(jrows),
                               rtol=0, atol=CSV_ATOL)
    np.testing.assert_allclose(pres[0]["measure"], jres[0]["measure"],
                               rtol=0, atol=CSV_ATOL)

    files = sorted(os.path.relpath(os.path.join(d, f), jdir)
                   for d, _, fs in os.walk(jdir) for f in fs
                   if f.endswith(".png"))
    assert files == sorted(os.path.relpath(os.path.join(d, f), pdir)
                           for d, _, fs in os.walk(pdir) for f in fs
                           if f.endswith(".png"))
    assert len(files) == 8 * N_IMAGES
    same = total = 0
    for f in files:
        a, b = _pixels(jdir / f), _pixels(pdir / f)
        assert a.shape == b.shape == (IMG, IMG) and b.dtype == np.uint8
        assert set(np.unique(b)) <= {0, 255}
        same += int((a == b).sum())
        total += a.size
    assert same >= PIXEL_SHARE * total, (same, total)
    assert any(_pixels(pdir / f).any() for f in files)


def test_tta_evaluator_against_jax(data_root, weights, monkeypatch):
    """--tta True through both Evaluators (hierarchical, val_batch 3)."""
    small_models(monkeypatch)
    jcfg, pcfg = _configs(model_type=1, val_batch=3, tta=True)
    jw, pw = weights[1]
    jres = jev.Evaluator(jcfg, jev.ClassTree.from_json(jcfg.tree_root,
                                                       jcfg.class_map),
                         data_root, jw, save_dir=None,
                         save_images=False).run()
    ptree = pev.ClassTree.from_json(pcfg.tree_root, pcfg.class_map)
    pres = pev.Evaluator(pcfg, ptree, data_root, pw, save_dir=None,
                         save_images=False, device="cpu").run()
    for k in jres["overall"]:
        np.testing.assert_allclose(pres["overall"][k], jres["overall"][k],
                                   rtol=0, atol=CSV_ATOL, err_msg=k)
    for pm, jm in zip(pres["per_class"], jres["per_class"]):
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], rtol=0, atol=CSV_ATOL,
                                       err_msg=k)
    # TTA changes the scores: the identity-view run differs somewhere
    _, plain_cfg = _configs(model_type=1, val_batch=3)
    plain = pev.Evaluator(plain_cfg, ptree, data_root, pw, save_dir=None,
                          save_images=False, device="cpu").run()
    assert plain["per_class"] != pres["per_class"]

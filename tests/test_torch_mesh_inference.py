"""The inference paths over ranks on the CPU: the ``Predictor``'s fold mesh
(JAX ``train/serving.py``'s ``mesh``) and the ``Evaluator``'s data mesh
(JAX ``train/evaluate.py:151-164``), two ``gloo`` ranks in one spawned run
(``torch_dist_common.mesh_inference_job``), the hierarchical UNet of base
width 8 at 32 px, f32.

Held:
- the fold-mesh ensemble of 4 seeded folds (2 a rank) against the
  single-process ensemble, with and without TTA: probabilities within
  rtol 1e-5, atol 1e-6 and class maps equal (the JAX test's tolerances,
  ``tests/test_round3_safety.py:321``); the two ranks' outputs the same
  bits; against the JAX ensemble on the same weights at the port tests'
  tolerance (``torch_port_common.RTOL``), class maps equal off near-ties
  (as ``test_torch_serving_options.py`` holds the unsharded ensemble);
- each rank writes its own trace file (``utils/profiling.py:trace``);
- the refusals with JAX's words: a mesh without a ``fold`` axis, folds
  that do not divide it, and ``export_predictor`` of a mesh-sharded
  ensemble (``mesh-sharded``, ``tests/test_export.py:185``);
- ``predict_eval`` on two ranks at batch 4 (a ragged tail: rank 1 holds
  only padding in the last batch): ``metrics.csv`` byte-equal to one
  process's at batch 4, the PNG dumps byte-equal, only rank 0 wrote
  files, both ranks return rank 0's result; against the JAX Evaluator
  within ``test_torch_evaluate.py``'s tolerance; at batch 3 the data group
  is one rank and the other idles (returns None).
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
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    RankMesh,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    evaluate as pev,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.export import (
    export_predictor,
)
from torch_dist_common import (
    ASSETS_MAP,
    ASSETS_TREE,
    mesh_inference_job,
    run_ranks,
)
from torch_eval_common import (
    csv_numbers,
    read_csv,
    small_models,
    write_weights,
)
from torch_port_common import ATOL, RTOL, trees
from torch_serving_common import (
    images,
    jax_predictor,
    models,
    port_predictor,
    variables,
)

N_FOLDS = 4
N_IMAGES = 5
EVAL_KW = dict(model_select=0, model_type=1, img_size=32, num_workers=2,
               val_batch=4)
CSV_ATOL = 1e-6
TIE = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Fold variables, images, a data root, eval weights, and the two
    ranks' results."""
    base = tmp_path_factory.mktemp("mesh_inference")
    jm, _ = models("unet")
    folds = [variables(jm, 40 + f) for f in range(N_FOLDS)]
    sd_paths = []
    for f, (params, stats) in enumerate(folds):
        sd_paths.append(str(base / f"fold{f}.pt"))
        torch.save(state_dict_from_flax(params, stats), sd_paths[-1])
    x = images(2, 41)
    data_root = str(base / "data")
    write_synth_dataset(data_root, N_IMAGES, size=32, seed=3)
    jtree, ptree = trees("default")
    jw, pw = write_weights(str(base / "weights"), jtree, ptree, 1, seed=2)
    save = str(base / "ranks")
    os.makedirs(save)
    ranks = run_ranks(mesh_inference_job, 2, base, sd_paths, x, EVAL_KW, pw,
                      data_root, save)
    return {"folds": folds, "x": x, "data_root": data_root, "jw": jw,
            "pw": pw, "save": save, "ranks": ranks}


# --------------------------------------------------------------- fold mesh
@pytest.mark.parametrize("tta", [False, True])
def test_fold_mesh_matches_the_single_process_ensemble(setup, tta,
                                                       monkeypatch):
    _, make = models("unet")
    one = port_predictor(monkeypatch, make, setup["folds"], tta=tta)(
        setup["x"])
    got = [r[f"tta={tta}"] for r in setup["ranks"]]
    assert [g["local_folds"] for g in got] == [N_FOLDS // 2] * 2
    for L in range(2):
        for k in ("probs", "class_maps"):  # every rank returns the same
            assert np.array_equal(got[0][k][L], got[1][k][L]), k
        np.testing.assert_allclose(got[0]["probs"][L], one["probs"][L],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[0]["class_maps"][L],
                                      one["class_maps"][L])
    assert got[0]["logits"] is None


@pytest.mark.parametrize("tta", [False, True])
def test_fold_mesh_matches_the_jax_ensemble(setup, tta, monkeypatch):
    jm, _ = models("unet")
    by_path = {f"fold_{f}": v for f, v in enumerate(setup["folds"])}
    want = jax_predictor(monkeypatch, jm, by_path, sorted(by_path),
                         tta=tta)(setup["x"])
    got = setup["ranks"][0][f"tta={tta}"]
    for L in range(2):
        w = np.asarray(want["probs"][L])
        np.testing.assert_allclose(got["probs"][L], w, rtol=RTOL, atol=ATOL)
        top2 = np.sort(w, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > TIE
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(
            got["class_maps"][L][clear],
            np.asarray(want["class_maps"][L])[clear])


def test_each_rank_writes_its_own_trace(setup):
    import json

    traces = sorted(os.listdir(os.path.join(setup["save"], "traces")))
    assert [t.split(".")[0] for t in traces] == ["rank0", "rank1"]
    for r, t in enumerate(traces):
        with open(os.path.join(setup["save"], "traces", t)) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert f"fold_mesh_rank{r}" in names
        assert f"fold_mesh_rank{1 - r}" not in names


def test_mesh_without_a_fold_axis_raises(monkeypatch):
    _, make = models("unet")
    jm, _ = models("unet")
    folds = [variables(jm, 50), variables(jm, 51)]
    mesh = RankMesh(np.array([0]), (DATA_AXIS,))
    with pytest.raises(ValueError, match="Predictor mesh needs a 'fold' "
                                         "axis"):
        port_predictor(monkeypatch, make, folds, mesh=mesh)


def test_folds_that_do_not_divide_the_fold_axis_raise(monkeypatch):
    _, make = models("unet")
    jm, _ = models("unet")
    folds = [variables(jm, 50 + f) for f in range(3)]
    mesh = RankMesh(np.arange(2), (FOLD_AXIS,))
    with pytest.raises(ValueError, match="3 fold checkpoints do not divide "
                                         "the mesh 'fold' axis of size 2"):
        port_predictor(monkeypatch, make, folds, mesh=mesh)


def test_export_refuses_a_mesh_sharded_ensemble(setup, tmp_path,
                                                monkeypatch):
    """In this process (a fold axis of one rank) and on the two ranks."""
    _, make = models("unet")
    pred = port_predictor(monkeypatch, make, setup["folds"][:2],
                          mesh=RankMesh(np.array([0]), (FOLD_AXIS,)))
    with pytest.raises(ValueError, match="mesh-sharded"):
        export_predictor(pred, str(tmp_path / "ens.pt2"))
    assert not (tmp_path / "ens.pt2").exists()
    for r in setup["ranks"]:
        assert "mesh-sharded fold-ensemble Predictors are not exportable" \
            in r["export"]


def test_a_single_fold_ignores_the_mesh(setup, monkeypatch):
    """As JAX's: the mesh shards an ensemble only."""
    _, make = models("unet")
    mesh = RankMesh(np.array([0]), (DATA_AXIS,))
    pred = port_predictor(monkeypatch, make, setup["folds"][0], mesh=mesh)
    plain = port_predictor(monkeypatch, make, setup["folds"][0])
    assert pred.mesh is None and not pred.ensemble
    for a, b in zip(pred(setup["x"])["probs"], plain(setup["x"])["probs"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- data mesh
def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_evaluator_on_two_ranks_writes_what_one_process_writes(
        setup, tmp_path, monkeypatch):
    small_models(monkeypatch, jax_side=False)
    cfg = RunConfig(tree_root=ASSETS_TREE, class_map=ASSETS_MAP, **EVAL_KW)
    one = pev.predict_eval(cfg, [setup["pw"]], [setup["data_root"]],
                           str(tmp_path / "one"), device="cpu")
    rank0 = os.path.join(setup["save"], "rank0", "fold_1")
    assert not os.path.exists(os.path.join(setup["save"], "rank1"))
    files = _files(rank0)
    assert "metrics.csv" in files and len(files) == 1 + 8 * N_IMAGES
    assert files == _files(tmp_path / "one" / "fold_1")
    for f in files:  # metrics.csv and every PNG, byte for byte
        with open(os.path.join(rank0, f), "rb") as a, \
                open(tmp_path / "one" / "fold_1" / f, "rb") as b:
            assert a.read() == b.read(), f
    r0, r1 = (r["eval"][0] for r in setup["ranks"])
    assert r0["overall"] == r1["overall"] == one[0]["overall"]
    assert r0["per_class"] == r1["per_class"]


def test_evaluator_on_two_ranks_matches_jax(setup, tmp_path, monkeypatch):
    small_models(monkeypatch)
    kw = dict(EVAL_KW, tree_root=ASSETS_TREE, class_map=ASSETS_MAP)
    jev.predict_eval(JaxRunConfig(**kw), [setup["jw"]], [setup["data_root"]],
                     str(tmp_path / "jax"))
    want = read_csv(tmp_path / "jax" / "fold_1" / "metrics.csv")
    got = read_csv(os.path.join(setup["save"], "rank0", "fold_1",
                                "metrics.csv"))
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose(csv_numbers(got), csv_numbers(want), rtol=0,
                               atol=CSV_ATOL)


def test_a_rank_outside_the_data_group_idles(setup):
    """Batch 3 over two ranks: a data group of one rank (3 has no divisor
    2); the other rank builds nothing and returns None."""
    r0, r1 = (r["eval_batch3"] for r in setup["ranks"])
    assert r1 == [None]
    assert r0[0]["overall"] == setup["ranks"][0]["eval"][0]["overall"]

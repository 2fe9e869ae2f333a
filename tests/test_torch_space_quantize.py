"""The ``Evaluator`` with ``quantize`` over the space axis (a ``(data 1,
space N)`` mesh: each rank runs the int8 convolutions on its band of rows
of every image), on 2 and 3 ``gloo`` ranks of the CPU, for the base-width-8
UNet (48 px: its lowest level has 3 rows) and the tiny HRNet (72 px: its
lowest branch has 3 rows), with and without ``tta``, on the same seeded
weights, against:

* the one-process int8 ``Evaluator``: the calibrated scales within 1e-5
  relative (each rank observes its band and the group takes the maximum;
  the banded convolutions add in another order, ``tests/test_torch_space.py``),
  the class maps (the per-class PNG dumps) agreeing on at least ``AGREE``
  of the pixels and every metric of ``metrics.csv`` within ``PROB_MAX``
  (``tests/test_torch_quantize.py``'s bounds: float noise upstream of a
  ``round()`` can move an int8 value by one step); observed on the CPU:
  the same class maps and metrics at every case here, the scales within
  1.9e-7 relative;
* the JAX int8 ``Evaluator`` over its own ``(data 1, space 2)`` mesh of the
  CPU's devices (``n_space = 2``), for the UNet without ``tta`` and the
  tiny HRNet with it: every metric within ``JAX_ATOL``, the bound
  ``tests/test_torch_predict_eval.py`` holds the two quantized CLIs to,
  and the class maps on at least ``AGREE`` of the pixels; observed: the
  same maps and metrics for the UNet, 99.80 % of the pixels and metrics
  within 0.0214 for the tiny HRNet.

The ranks' jobs import torch and the port only.
"""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.config.run import (
    RunConfig as JaxRunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    checkpoint as jckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    evaluate as jev,
)
from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    state as jstate,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    state_dict_from_flax,
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
    checkpoint as pckpt,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    evaluate as pev,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    state as pstate,
)
from test_torch_quantize import AGREE, PROB_MAX
from torch_dist_common import build_small, rank_threads, run_ranks
from torch_port_common import jax_variables
from torch_serving_common import models
from torch_space_common import (
    QUANT_CASES as CASES,
    QUANT_SIZES as SIZES,
    quant_cfg_kw as _cfg_kw,
    quant_evaluate as _evaluate,
    quantized_eval_job,
)

N_IMAGES = 2
SCALE_RTOL = 1e-5
JAX_ATOL = 0.05


def _write_weights(directory, donor):
    """One seeded set of ``donor``'s variables as a JAX orbax checkpoint
    and a port ``.ckpt``: (jax path, port path, the JAX model)."""
    jmodel, _ = models(donor)
    size = SIZES[donor]
    params, stats = jax_variables(jmodel, np.zeros((1, size, size, 3),
                                                   np.float32),
                                  seed=7, train=False)
    state = jstate.TrainState(
        params=params, batch_stats=stats,
        opt_state=jstate.make_optimizer(0.0).init(params),
        step=jnp.zeros((), jnp.int32))
    meta = dict(epoch=1, loss=0.0, test_measure_mean=0.5,
                test_measure_std=0.0)
    jpath = os.path.join(directory, "jax", "best.ckpt")
    os.makedirs(os.path.dirname(jpath), exist_ok=True)
    jckpt.save_checkpoint(jpath, state, **meta)
    pmodel = build_small(donor)
    pmodel.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    ppath = os.path.join(directory, "port", "best.ckpt")
    os.makedirs(os.path.dirname(ppath), exist_ok=True)
    pckpt.save_checkpoint(ppath, pstate.create_train_state(pmodel, 0.0),
                          **meta)
    return jpath, ppath, jmodel


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one process and on 2 and 3 ranks (a spawn each)."""
    tmp = tmp_path_factory.mktemp("space_quantize")
    roots, weights = {}, {}
    for donor in SIZES:
        roots[donor] = str(tmp / f"data_{donor}")
        write_synth_dataset(roots[donor], N_IMAGES, size=96, seed=3)
        weights[donor] = _write_weights(str(tmp / f"w_{donor}"), donor)
    mp = pytest.MonkeyPatch()
    one = {}
    try:
        mp.setattr(pev, "build_model", pev.build_model)
        with rank_threads():
            for donor, tta in CASES:
                one[(donor, tta)] = _evaluate(
                    RunConfig(**_cfg_kw(donor, tta)), donor, roots[donor],
                    weights[donor][1], str(tmp / "one" / f"{donor}_{tta}"))
    finally:
        mp.undo()
    ranks = {}

    def spawn(world):  # both worlds at once: their start-up overlaps
        ranks[world] = run_ranks(
            quantized_eval_job, world, tmp / f"world{world}", roots,
            {d: w[1] for d, w in weights.items()}, str(tmp / f"ranks{world}"))

    threads = [threading.Thread(target=spawn, args=(w,)) for w in (2, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(ranks) == [2, 3]
    return tmp, roots, weights, one, ranks


def _pngs(root):
    return {os.path.relpath(os.path.join(d, f), root):
            decode_png(open(os.path.join(d, f), "rb").read())
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}


def _agreement(got_root, want_root):
    got, want = _pngs(got_root), _pngs(want_root)
    assert sorted(got) == sorted(want) and want
    same = sum(int((got[k] == want[k]).sum()) for k in want)
    return same / sum(v.size for v in want.values())


def _metrics_close(got, want, atol):
    for k in want["overall"]:
        np.testing.assert_allclose(got["overall"][k], want["overall"][k],
                                   rtol=0, atol=atol, err_msg=k)
    for g, w in zip(got["per_class"], want["per_class"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("donor,tta", CASES)
def test_quantized_evaluator_on_bands_equals_one_process(runs, world, donor,
                                                         tta):
    tmp, _, _, one, ranks = runs
    want, want_scales = one[(donor, tta)]
    results = [r[(donor, tta)] for r in ranks[world]]
    for res, scales in results:
        assert res == results[0][0]  # every rank returns the writer's
        assert sorted(scales) == sorted(want_scales)
        for path, s in want_scales.items():
            assert s > 0.0
            np.testing.assert_allclose(scales[path], s, rtol=SCALE_RTOL,
                                       err_msg=path)
    _metrics_close(results[0][0], want, PROB_MAX)
    save = tmp / f"ranks{world}"
    assert not (save / f"{donor}_{tta}_rank1").exists()  # one writer
    assert _agreement(save / f"{donor}_{tta}_rank0",
                      tmp / "one" / f"{donor}_{tta}") >= AGREE


# each donor once, and tta once (the JAX Evaluator compiles its mesh
# program for each case: 8-25 s apiece on the CPU)
@pytest.mark.parametrize("donor,tta", [("unet", False), ("hrnet", True)])
def test_quantized_evaluator_on_bands_against_jax(runs, monkeypatch, donor,
                                                  tta):
    """The two ranks' run against the JAX int8 Evaluator over its (data 1,
    space 2) mesh on the same weights and files."""
    tmp, roots, weights, _, ranks = runs
    jpath, _, jmodel = weights[donor]
    monkeypatch.setattr(jev, "build_model", lambda *a, **k: jmodel)
    jcfg = JaxRunConfig(n_space=2, **_cfg_kw(donor, tta))
    save = tmp / "jax" / f"{donor}_{tta}"
    want = jev.Evaluator(jcfg, jev.ClassTree.from_json(jcfg.tree_root,
                                                       jcfg.class_map),
                         roots[donor], jpath, save_dir=str(save)).run()
    got = ranks[2][0][(donor, tta)][0]
    _metrics_close(got, want, JAX_ATOL)
    assert _agreement(tmp / "ranks2" / f"{donor}_{tta}_rank0", save) >= AGREE

"""The port's ``space`` mesh axis on the CPU (``parallel/bands.py``,
``parallel/mesh.py``): each rank of a space group holds a band of rows of
every activation, held to one process on the whole image.

* the band rule (XLA's split of an uneven dimension: ``ceil(H / n)`` rows,
  the last band short), at the heights of HRNet-W48 at 620 px and the UNet
  at 352 px, and the refusal of a band of no rows;
* the mesh: ``(data, space)`` and ``(fold, data, space)`` sized as JAX
  sizes them, its space and step groups, and "needs N ranks, have M";
* ``fetch_rows`` on three ranks over an uneven height, forward and
  backward, against slicing the zero-padded whole tensor (exact);
* each banded operation (3x3 convolutions of stride 1 and 2, a 1x1 one,
  the max-pool at an odd band start, the resize with ``align_corners``
  True and False up and down, the UNet's pad, FiLM's mean) on three ranks,
  with its gradients, against the whole-image operation;
* both donors (the base-width-8 UNet, the tiny HRNet) at 2 and 3 space
  ranks, uneven bands included, in eval and train mode (BatchNorm over the
  group), against one process.

Tolerances: operations that only move values are exact; a sum in
another order (the convolution of a band, FiLM's pooled mean, the f64 BN
statistics of the ranks' sums) is held at 1e-5 of the map's largest
value, gradients at 1e-5 of each tensor's largest value (measured: a few
1e-7 to 6e-6).
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.film import (
    FiLM,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops.resize import (
    resize_nchw,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.bands import (
    band,
    bands,
    check_bands,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    SPACE_AXIS,
    fold_mesh_shape,
    make_fold_mesh,
    make_mesh,
)
from torch_dist_common import build_small, rank_threads, run_ranks
from torch_space_common import forward_job, ops_job

REL = 1e-5


def _close(got, want, rel=REL):
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * scale + 1e-7, (err, scale)


# --------------------------------------------------------------- the rule
@pytest.mark.parametrize("size,n,want", [
    (620, 2, [(0, 310), (310, 620)]),
    (155, 2, [(0, 78), (78, 155)]),
    (78, 2, [(0, 39), (39, 78)]),
    (39, 2, [(0, 20), (20, 39)]),
    (20, 2, [(0, 10), (10, 20)]),
    (352, 2, [(0, 176), (176, 352)]),
    (11, 2, [(0, 6), (6, 11)]),
    (10, 3, [(0, 4), (4, 8), (8, 10)]),
    (25, 3, [(0, 9), (9, 18), (18, 25)]),
    (7, 1, [(0, 7)]),
])
def test_band_rule(size, n, want):
    assert bands(size, n) == want
    assert [band(size, n, i) for i in range(n)] == want
    check_bands(size, n)


def test_unet_at_352_splits_evenly_at_every_level():
    h = 352
    for _ in range(5):
        lo_hi = bands(h, 2)
        assert lo_hi[0][1] - lo_hi[0][0] == lo_hi[1][1] - lo_hi[1][0]
        h //= 2


@pytest.mark.parametrize("size,n", [(4, 3), (2, 3), (1, 2)])
def test_a_band_of_no_rows_is_refused(size, n):
    with pytest.raises(ValueError, match="band of no rows"):
        check_bands(size, n)


# --------------------------------------------------------------- the mesh
def test_space_axis_meshes_size_as_jax():
    """n_space above 1 builds the mesh (the refusal of the earlier port is
    gone); the JAX sizing of ``make_fold_mesh`` with a space axis."""
    m = make_mesh(n_data=2, n_space=2, ranks=range(4))
    assert m.shape == {DATA_AXIS: 2, SPACE_AXIS: 2}
    assert m._space_lines == {(0,): (0, 1), (1,): (2, 3)}
    assert m._lines == {(0,): (0, 2), (1,): (1, 3)}
    assert m._step_lines == {(): (0, 1, 2, 3)}
    f = make_fold_mesh(2, 4, n_space=2, ranks=range(8))
    assert f.shape == {FOLD_AXIS: 2, DATA_AXIS: 2, SPACE_AXIS: 2}
    assert f._step_lines == {(0,): (0, 1, 2, 3), (1,): (4, 5, 6, 7)}
    assert f._space_lines[(1, 0)] == (4, 5)
    assert fold_mesh_shape(5, 16, 8, n_space=2) == (1, 4, 2)
    assert fold_mesh_shape(4, 16, 8, n_space=2) == (4, 1, 2)


@pytest.mark.parametrize("call", [
    lambda: make_mesh(1, n_space=2, ranks=[0]),
    lambda: make_mesh(2, n_space=2, ranks=range(3)),
])
def test_a_mesh_larger_than_its_ranks_raises(call):
    with pytest.raises(ValueError, match="needs 4 ranks, have 3|needs 2 "
                                         "ranks, have 1"):
        call()


def test_fold_mesh_space_larger_than_the_ranks_raises():
    with pytest.raises(ValueError, match="n_space=2 with 1 ranks"):
        make_fold_mesh(2, 4, n_space=2, ranks=[0])


def test_groups_without_a_process_group():
    m = make_mesh(n_data=1, n_space=1, ranks=[0])
    for g in (m.data_group(0), m.space_group(0), m.step_group(0)):
        assert g.group is None and g.size == 1 and g.is_main
    m = make_mesh(n_data=2, n_space=2, ranks=range(4))
    with pytest.raises(RuntimeError, match="init_distributed"):
        m.space_group(3)


# ------------------------------------------------------- the banded ops
def _cases(rng):
    """(name, x, params, cot) of ``ops_job`` and the whole-image reference
    of each: (output, input gradient, parameter gradients)."""
    cases, refs = [], []

    def add(name, x, params, fn, mods=()):
        xt = torch.from_numpy(x).requires_grad_()
        y = fn(xt)
        cot = rng.standard_normal(tuple(y.shape)).astype(np.float32)
        (y * torch.from_numpy(cot)).sum().backward()
        refs.append((y.detach(), xt.grad,
                     [p.grad for m in mods for p in m.parameters()]))
        cases.append((name, x, params, cot))

    def img(h, w=7, c=4):
        return rng.standard_normal((2, c, h, w)).astype(np.float32)

    for k, s, p, h in ((3, 1, 1, 10), (3, 2, 1, 11), (3, 2, 1, 10),
                       (1, 1, 0, 11)):
        torch.manual_seed(k * 10 + s + h)
        conv = torch.nn.Conv2d(4, 3, k, s, p)
        params = {"k": k, "s": s, "p": p,
                  "sd": copy.deepcopy(conv.state_dict())}
        add("conv", img(h), params, conv, [conv])
    for h in (11, 13):  # odd: a band starts on an odd row
        add("pool", img(h), {}, lambda t: F.max_pool2d(t, 2))
    for h, size, ac in ((10, (21, 9), True), (11, (5, 4), True),
                        (10, (23, 7), False), (13, (6, 7), False),
                        (9, (9, 12), True)):
        add("resize", img(h), {"size": size, "ac": ac},
            lambda t, size=size, ac=ac: resize_nchw(t, size, ac))
    for h, pad in ((10, (1, 2)), (11, (0, 1))):
        add("pad", img(h), {"pad": pad},
            lambda t, pad=pad: F.pad(t, (1, 0, *pad)))
    torch.manual_seed(3)
    film = FiLM(4, 5)
    feats = rng.standard_normal((2, 5, 11, 7)).astype(np.float32)
    add("film", np.abs(img(11)),
        {"sd": copy.deepcopy(film.state_dict()), "feats": feats},
        lambda t: film(torch.from_numpy(feats), t), [film])
    return cases, refs


def _fetch_cases(rng):
    """Requests over a height of 10 on three ranks (bands 4, 4, 2): a halo
    of one row, rows past both ends (zeros), a shift, and another rank's
    rows only."""
    x = rng.standard_normal((2, 3, 10, 5)).astype(np.float32)
    pad = np.pad(x, ((0, 0), (0, 0), (3, 3), (0, 0)))
    cases, refs = [], []
    for lo, hi in (([-1, 3, 7], [5, 9, 11]), ([-3, 2, 9], [1, 9, 13]),
                   ([1, 5, 9], [5, 9, 11]), ([8, 0, 4], [10, 4, 8])):
        cot = [rng.standard_normal((2, 3, b - a, 5)).astype(np.float32)
               for a, b in zip(lo, hi)]
        grad = np.zeros_like(pad)
        for a, b, c in zip(lo, hi, cot):
            grad[:, :, a + 3:b + 3] += c
        refs.append(([torch.from_numpy(pad[:, :, a + 3:b + 3])
                      for a, b in zip(lo, hi)],
                     torch.from_numpy(grad[:, :, 3:13])))
        cases.append(("fetch", x, {"lo": lo, "hi": hi}, cot))
    return cases, refs


@pytest.fixture(scope="module")
def ops_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    fcases, frefs = _fetch_cases(rng)
    cases, refs = _cases(rng)
    ranks = run_ranks(ops_job, 3, tmp_path_factory.mktemp("space_ops"),
                      fcases + cases)
    return ranks, frefs, cases, refs


@pytest.mark.parametrize("case", range(4))
def test_fetch_rows_forward_and_backward(ops_runs, case):
    ranks, frefs, _, _ = ops_runs
    outs, grad = frefs[case]
    for rank, want in zip(ranks, outs):
        assert torch.equal(rank[case][0], want)
    got = torch.cat([r[case][1] for r in ranks], dim=2)
    np.testing.assert_allclose(got.numpy(), grad.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("case", range(14))
def test_banded_op_equals_the_whole_image_op(ops_runs, case):
    ranks, frefs, cases, refs = ops_runs
    i = len(frefs) + case
    y, gx, gps = refs[case]
    name = cases[case][0]
    got_y = torch.cat([r[i][0] for r in ranks], dim=2)
    got_gx = torch.cat([r[i][1] for r in ranks], dim=2)
    assert got_y.shape == y.shape, name
    if name in ("pool", "pad"):  # moves values: exact
        assert torch.equal(got_y, y) and torch.equal(got_gx, gx), name
    else:
        _close(got_y, y)
        _close(got_gx, gx)
    for j, g in enumerate(gps):  # each rank's share of a parameter gradient
        _close(sum(r[i][2][j] for r in ranks), g)


# ------------------------------------------------------------ the donors
@pytest.fixture(scope="module")
def donor_weights():
    sds = {}
    for donor in ("unet", "hrnet"):
        torch.manual_seed(5)
        sds[donor] = copy.deepcopy(build_small(donor).state_dict())
    return sds


# (donor, image height, space ranks): the UNet at 36 px over 2 ranks has
# bands of 18, 9 (5 / 4), 4, 2 and pads 8 -> 9; at 50 over 3, bands of 17 /
# 17 / 16, 25 (9 / 9 / 7) and a pad; the tiny HRNet's branches at 36 px
# are 9, 5, 3, 2 rows (over 2: 5 / 4, 3 / 2, 2 / 1); over 3 ranks its
# lowest branch needs 3 rows, so 72 px (18, 9, 5, 3 rows; 5 as 2 / 2 / 1)
DONOR_CASES = [("unet", 36, 2), ("unet", 50, 3), ("hrnet", 36, 2),
               ("hrnet", 72, 3)]


@pytest.mark.parametrize("donor,size,n", DONOR_CASES)
def test_donor_forward_on_bands_equals_one_process(donor, size, n,
                                                   donor_weights, tmp_path):
    sd = donor_weights[donor]
    x = np.random.default_rng(size).standard_normal(
        (2, size, size - 4, 3)).astype(np.float32)
    ranks = run_ranks(forward_job, n, tmp_path, donor, sd, x)
    for train in (False, True):
        model = build_small(donor)
        model.load_state_dict(sd, strict=True)
        model = model.to(memory_format=torch.channels_last).train(train)
        with torch.no_grad(), rank_threads():
            want = model(torch.from_numpy(x))
        for L, (z, p) in enumerate(zip(want.logits_per_level,
                                       want.probs_per_level)):
            got_z = torch.cat([r[train][0][L] for r in ranks], dim=1)
            got_p = torch.cat([r[train][1][L] for r in ranks], dim=1)
            assert got_z.shape == z.shape
            _close(got_z, z)
            _close(got_p, p)
        if train:  # the group's statistics, on every rank
            wsd = model.state_dict()
            for r in ranks:
                for k, v in r[True][2].items():
                    np.testing.assert_allclose(v.numpy(), wsd[k].numpy(),
                                               rtol=1e-5, atol=1e-6,
                                               err_msg=k)

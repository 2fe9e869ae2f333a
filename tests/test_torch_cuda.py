"""The port's CUDA kernels on the card: each against its plain version,
the BatchNorm module on the card against itself on the CPU, the fused
1x1 conv + BN + ReLU kernel and its tool, the train data path's device
prefetch and checkpoint snapshots, the offline Evaluator (card against
CPU, kernel launches per forward), the int8 conv's card path (cuBLASLt's
int8 GEMM through ``torch._int_mm``) against its plain version at the
shapes its rules make it pad, fold ensembles and the quantized Predictor,
a ``torch.export`` artifact launching kernel 2 (the operator's fake
implementation against the kernel's output), the device-resident
training set (augmentation on the card against the CPU), and the split
entries of kernels 1 and 3 for a data-parallel group (bit for bit to the
fused launches, each against its plain version, the same bits launch after
launch and in a replayed CUDA graph; two gloo ranks sharing the card),
kernel 2's train entry (bit for bit to its plain version, one launch a
call, in a replayed CUDA graph), ``--remat`` on the card (bit for bit to remat False, the
recompute's launches, no forward convolution recomputed in "conv"
mode), the fold-mesh Predictor and data-mesh Evaluator over two gloo
ranks sharing the card against one process, and the space axis: kernels
1-3 at band shapes, and a banded forward over two gloo ranks sharing the
card against one process. Marked
``cuda``; every test skips where torch sees no CUDA device. Imports no jax,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import threading

import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.norm import (
    BatchNormAct,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    conv_bn_relu as k4,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    fused_bn_act as fba,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.tools import (
    conv_bn_experiment as tool,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 310, 310, 64), (2, 20, 20, 384),
                                   (1001, 48), (3, 7, 720),
                                   # views wider than one block's 512 units:
                                   # 2 and 4 column groups, and 4 with a tail
                                   (3, 5000), (2, 16384), (5, 2047)])
def test_scale_bias_act_kernel_equals_plain(cuda, shape, dtype, act):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    scale = torch.rand(c, generator=g, device=cuda) + 0.5
    shift = torch.randn(c, generator=g, device=cuda)
    before = fba.LAUNCHES
    y = fba.fused_scale_bias_act(x, scale, shift, act)
    torch.cuda.synchronize()
    assert fba.LAUNCHES == before + 1
    # the kernel rounds x * scale + shift like the plain version: bit-equal
    assert torch.equal(y, fba._scale_bias_act_ref(x, scale, shift, act))


def test_scale_bias_act_kernel_rejects_what_it_does_not_take(cuda):
    one = torch.ones(12, device=cuda)
    # C = 12, no multiple of 8: taken (the view of 24-wide rows and a tail)
    x12 = torch.randn(5, 12, device=cuda)
    assert torch.equal(fba.fused_scale_bias_act(x12, one, one, "relu"),
                       fba._scale_bias_act_ref(x12, one, one, "relu"))
    wide = torch.ones(2049, device=cuda)  # lcm(2049, 8) > 16384
    with pytest.raises(ValueError, match="C <= 2048"):
        fba.fused_scale_bias_act(torch.ones(4, 2049, device=cuda), wide,
                                 wide, "relu")
    with pytest.raises(TypeError):
        fba.fused_scale_bias_act(torch.ones(4, 16, device=cuda,
                                            dtype=torch.float16),
                                 torch.ones(16, device=cuda),
                                 torch.ones(16, device=cuda), "relu")
    with pytest.raises(ValueError, match="contiguous"):
        fba.fused_scale_bias_act(torch.ones(16, 4, device=cuda).t(),
                                 torch.ones(16, device=cuda),
                                 torch.ones(16, device=cuda), "relu")


def test_batchnorm_module_on_card_equals_cpu(cuda):
    torch.manual_seed(0)
    bn = BatchNormAct(96, "relu").eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.1)
        bn.running_mean.normal_(0, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
    x = torch.randn(2, 96, 13, 17).contiguous(
        memory_format=torch.channels_last)
    want = bn(x)
    got = bn.to(cuda)(x.to(cuda)).cpu()
    # the folded scale takes rsqrt, which CUDA computes within 2 ulp of the
    # CPU's value; a few f32 ulp of |x * scale| (|x| < 6, scale < 2) remain
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------- train kernels
# Tolerances: the kernels add in another order than torch's sums (strips of
# rows in f32, the strips in double), so statistics and per-channel sums
# agree to 1e-5 relative (the variance relative to E[x^2] = var + mean^2,
# the size of the two terms it subtracts); dx agrees to 1e-5 of its largest
# value in f32, and in bf16 to one bf16 ulp of the value besides (a value
# near a rounding boundary may round either way).
TRAIN_SHAPES = [(16, 310, 310, 64), (16, 155, 155, 256), (16, 39, 39, 192),
                (2, 20, 20, 384), (1001, 48), (3, 7, 720), (1, 8)]
# the BN backward's single pass beyond TRAIN_SHAPES: W48 shapes whose x + g
# exceed L2 (the re-read comes from device memory), the 720-channel head at
# batch 2, C = 8 over many rows, one row of 720 channels (fewer rows than
# the grid has blocks: one strip)
BACKWARD_SHAPES = TRAIN_SHAPES + [(16, 155, 155, 48), (2, 155, 155, 720),
                                  (4099, 8), (1, 720)]
# the statistics kernel's geometry beyond TRAIN_SHAPES: both stems (UNet
# 1,982,464 rows; W48's (16, 310, 310, 64) is in TRAIN_SHAPES), the 720-channel
# head at batch 2 (3 column groups), C = 8 over many rows, ragged strips
# (97,343 and 1,001 rows), fewer rows than a block's row lanes (5 rows of 48
# channels: 32 lanes), one row (one strip), the smallest W48 call
STATS_SHAPES = TRAIN_SHAPES + [(16, 352, 352, 64), (2, 155, 155, 720),
                               (200003, 8), (4099, 8), (97343, 96), (5, 48),
                               (1, 720), (16, 20, 20, 48)]
# the cluster geometry's edges (csrc/bn_stats.cu) at C = 48 (32 row lanes:
# a round is 256 rows of bf16, 128 of f32): one strip of one round; one
# cluster of 8 strips at 4 rounds a thread (4096 rows of f32, 8192 of
# bf16, the most one cluster takes); one row more (the clusters' sums go
# through the workspace and a ticket); the most strips a group (the W48
# stem); a view wider than C with a tail in one column group over many
# clusters (W18's 18 channels at batch 16), over 5 column groups (its
# 270-channel head) and over the most (lcm(2047, 8) = 16376 columns, 64
# groups, 2 view rows and a tail); the widest view at C % 8 == 0
STATS_EDGE_SHAPES = [(256, 48), (4096, 48), (4097, 48), (8192, 48),
                     (8193, 48), (16, 310, 310, 64), (16, 155, 155, 18),
                     (1, 155, 155, 270), (17, 2047), (3, 16384)]


def _stats_ok(got, want):
    (m, v), (mr, vr) = got, want
    assert m.dtype == v.dtype == torch.float32
    assert bool(((m - mr).abs() <= 1e-5 * (mr.abs() + vr.sqrt())
                 + 1e-12).all())
    assert bool(((v - vr).abs() <= 1e-5 * (vr + mr * mr) + 1e-12).all())


def _train_inputs(shape, dtype, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * 1.5 + 0.7).to(dtype)
    grad = torch.randn(shape, generator=g, device=cuda).to(dtype)
    mean, var = fba._bn_stats_ref(x)
    rstd = torch.rsqrt(var + 1e-5)
    gamma = torch.rand(c, generator=g, device=cuda) + 0.5
    beta = torch.randn(c, generator=g, device=cuda) * 0.5
    scale = gamma * rstd
    shift = beta - mean * scale
    return x, grad, scale, shift, mean, rstd


def _counters_zero(device):
    """Every ticket counter of the statistics kernel is back at 0."""
    torch.cuda.synchronize()
    assert not bool(fba._COUNTERS[device.index or 0].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STATS_SHAPES + STATS_EDGE_SHAPES[:5]
                         + STATS_EDGE_SHAPES[6:])
def test_bn_stats_kernel_equals_plain(cuda, shape, dtype):
    x = _train_inputs(shape, dtype, cuda)[0]
    before = fba.TRAIN_LAUNCHES["bn_stats"]
    got = fba.bn_stats(x)
    torch.cuda.synchronize()
    assert fba.TRAIN_LAUNCHES["bn_stats"] == before + 1
    _stats_ok(got, fba._bn_stats_ref(x))
    _counters_zero(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 155, 155, 48), (2, 155, 155, 720),
                                   (16, 352, 352, 64), (1001, 48),
                                   (8193, 48), (1, 155, 155, 270),
                                   (17, 2047)])
def test_bn_stats_kernel_is_deterministic(cuda, shape, dtype):
    """The combine adds in a fixed order whichever block does it, and
    there are no float atomics: two calls give the same bits, of either
    entry."""
    x = _train_inputs(shape, dtype, cuda, seed=5)[0]
    first = fba.bn_stats(x)
    second = fba.bn_stats(x)
    sums = [fba.bn_stats_sums(x) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(sums[0], sums[1])


# (shape, dtype, levels, blocks a cluster where the call is one cluster a
# column group): csrc/bn_stats.cu's geometry at its edges
GEOMETRY_EDGES = [((1, 48), torch.bfloat16, 1, 1),
                  ((256, 48), torch.bfloat16, 1, 1),
                  ((257, 48), torch.bfloat16, 1, 2),
                  ((2048, 48), torch.bfloat16, 1, 8),
                  ((4096, 48), torch.float32, 1, 8),
                  ((4097, 48), torch.float32, 2, None),
                  ((8192, 48), torch.bfloat16, 1, 8),
                  ((8193, 48), torch.bfloat16, 2, None),
                  ((16, 10, 20, 48), torch.bfloat16, 1, 8),
                  ((16, 10, 20, 384), torch.bfloat16, 2, None),
                  ((16, 310, 310, 64), torch.bfloat16, 2, None),
                  ((3, 18), torch.float32, 1, 1),
                  ((16, 155, 155, 18), torch.bfloat16, 2, None),
                  ((1, 155, 155, 270), torch.bfloat16, 2, None),
                  ((17, 2047), torch.float32, 2, None),
                  ((3, 16384), torch.float32, 1, 1)]


@pytest.mark.parametrize("shape,dtype,levels,cluster", GEOMETRY_EDGES)
def test_bn_stats_geometry_at_its_edges(cuda, shape, dtype, levels,
                                        cluster):
    """The launch both entries make: one cluster a column group (of as
    many strips as the call has rounds, up to 8, a power of 2) while each
    thread takes at most 4 rounds, else strips of about a round in
    clusters of 8 blocks, as many as the card holds at once over the
    column groups (at most 64 a group); two levels also where a view wider
    than C spans several column groups."""
    x = _train_inputs(shape, dtype, cuda)[0]
    g = fba.stats_geometry(x)
    assert g["levels"] == levels, g
    assert g["strips"] == g["cluster"] * g["clusters"], g
    assert g["cluster"] in (1, 2, 4, 8), g
    assert g["card_clusters"] >= 1, g  # the portable size fits
    if cluster is not None:
        assert g["cluster"] == cluster and g["clusters"] == 1, g
    else:
        assert 1 <= g["clusters"] <= min(
            64, max(1, g["card_clusters"] // g["column_groups"])), g
        if g["clusters"] > 1:  # else a fold over several column groups
            assert g["cluster"] == 8, g
        if g["column_groups"] == 1:
            assert g["clusters"] > 1, g
    _stats_ok(fba.bn_stats(x), fba._bn_stats_ref(x))
    _counters_zero(cuda)


def test_bn_stats_kernel_in_a_cuda_graph(cuda):
    """Calls of both entries captured in a CUDA graph and replayed twice
    give the eager calls' bits: every launch leaves its counters at 0 (one
    cluster a group, clusters through a ticket, a fold over one and over
    five column groups)."""
    xs = [_train_inputs(shape, torch.bfloat16, cuda, seed=i)[0] for i, shape
          in enumerate([(16, 78, 78, 48), (2, 155, 155, 720), (1001, 48),
                        (16, 10, 20, 384), (16, 155, 155, 18),
                        (1, 155, 155, 270)])]
    eager = [fba.bn_stats(x) for x in xs]
    eager_sums = [fba.bn_stats_sums(x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [fba.bn_stats(x) for x in xs]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = [fba.bn_stats(x) for x in xs]
        captured_sums = [fba.bn_stats_sums(x) for x in xs]
    for _ in range(2):
        for (m, v), s in zip(captured, captured_sums):
            m.zero_()
            v.zero_()
            s.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (m, v), (em, ev) in zip(captured, eager):
            assert torch.equal(m, em) and torch.equal(v, ev)
        for s, es in zip(captured_sums, eager_sums):
            assert torch.equal(s, es)
    _counters_zero(cuda)


def test_bn_stats_kernel_on_two_streams(cuda):
    """Calls of both entries on two streams at once, from two threads,
    take separate counters and each gives the eager bits."""
    xs = [_train_inputs((16, 155, 155, 64), torch.bfloat16, cuda, seed=i)[0]
          for i in range(2)]
    eager = [fba.bn_stats(x) for x in xs]
    eager_sums = [fba.bn_stats_sums(x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    got = [[], []]
    got_sums = [[], []]
    torch.cuda.synchronize()

    def calls(i):
        with torch.cuda.stream(streams[i]):
            for _ in range(8):
                got[i].append(fba.bn_stats(xs[i]))
                got_sums[i].append(fba.bn_stats_sums(xs[i]))

    threads = [threading.Thread(target=calls, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    torch.cuda.synchronize()
    for outs, (em, ev) in zip(got, eager):
        assert len(outs) == 8
        for m, v in outs:
            assert torch.equal(m, em) and torch.equal(v, ev)
    for outs, es in zip(got_sums, eager_sums):
        assert len(outs) == 8 and all(torch.equal(s, es) for s in outs)
    slots = {fba._SLOTS[(cuda.index or 0, st.cuda_stream)] for st in streams}
    assert len(slots) == 2
    _counters_zero(cuda)


@pytest.mark.parametrize("entry", ["bn_stats", "bn_stats_sums"])
def test_refused_stats_launch_raises(cuda, monkeypatch, entry):
    """A launch the card refuses (here its C entry returns a CUDA error,
    as cudaLaunchKernelEx does for a cluster the card cannot place) raises
    with the error and counts no launch: nothing falls back to the plain
    version or another launch."""
    x = _train_inputs((1001, 48), torch.bfloat16, cuda)[0]
    key = ("bn_stats", "rhss_" + entry)
    fba._fn(*key)
    calls = []

    def refused(*args):
        calls.append(args)
        return 912

    monkeypatch.setitem(fba._FNS, key, refused)
    plain = fba._bn_stats_ref if entry == "bn_stats" else \
        fba._bn_stats_sums_ref
    monkeypatch.setattr(fba, plain.__name__, lambda *a: pytest.fail(
        "a refused launch ran the plain version"))
    before = dict(fba.TRAIN_LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 912"):
        getattr(fba, entry)(x)
    assert len(calls) == 1 and fba.TRAIN_LAUNCHES == before
    _counters_zero(cuda)


def test_bn_stats_kernel_refuses_before_launching(cuda):
    """A call that raises launches nothing and leaves the counters at 0."""
    fba.bn_stats(torch.ones(4, 16, device=cuda))
    before = fba.TRAIN_LAUNCHES["bn_stats"]
    with pytest.raises(ValueError, match="C <= 16384"):
        fba.bn_stats(torch.ones(2, 16392, device=cuda))
    with pytest.raises(ValueError, match="at least one row"):
        fba.bn_stats(torch.ones(0, 16, device=cuda))
    assert fba.TRAIN_LAUNCHES["bn_stats"] == before
    _counters_zero(cuda)
    x = _train_inputs((3, 7, 720), torch.float32, cuda)[0]
    _stats_ok(fba.bn_stats(x), fba._bn_stats_ref(x))


def _dx_ok(dx, ref):
    assert dx.dtype == ref.dtype and dx.shape == ref.shape
    err = (dx.float() - ref.float()).abs()
    tol = 1e-5 * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + ref.float().abs() * 2.0 ** -7
    assert bool((err <= tol).all()), float(err.max())


def _sums_ok(got, ref):
    assert got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_bn_backward_kernel_equals_plain(cuda, shape, dtype, act):
    x, grad, *vecs = _train_inputs(shape, dtype, cuda)
    c = shape[-1]
    before = fba.TRAIN_LAUNCHES["bn_backward"]
    dx, dgamma, dbeta = fba.bn_act_backward(x, grad, *vecs, act)
    torch.cuda.synchronize()
    assert fba.TRAIN_LAUNCHES["bn_backward"] == before + 1  # one launch
    rdx, rdg, rdb = fba._bn_backward_ref(x.reshape(-1, c), grad.reshape(-1, c),
                                         *vecs, act)
    _dx_ok(dx, rdx.reshape(shape))
    _sums_ok(dgamma, rdg)
    _sums_ok(dbeta, rdb)
    # without dx the same launch stops after the sums
    none, dg2, db2 = fba.bn_act_backward(x, grad, *vecs, act, need_dx=False)
    assert none is None
    assert fba.TRAIN_LAUNCHES["bn_backward"] == before + 2
    assert torch.equal(dg2, dgamma) and torch.equal(db2, dbeta)


# ------------------------------------------- the split entries of a group
# Global-batch BatchNorm over ranks splits kernels 1 and 3 at their
# reductions (the sums entry, the reduce and dx entries). On one rank the
# split gives the fused launches' bits; each entry is held to its plain
# version with the tolerances above (f64 sums of f32 strips against f64
# sums: 1e-5 of the sums of |x| and x^2).
SPLIT_SHAPES = [(16, 352, 352, 64), (16, 155, 155, 48), (2, 155, 155, 720),
                (16, 22, 22, 512), (1001, 48), (3, 7, 720), (1, 8),
                # the entries' geometry at small row counts: one row, fewer
                # rows than the reduce's row lanes (85, 42, 21, 21, 17 at C
                # = 48, 96, 192, 384, 720), rows whose units do not fill the
                # dx entry's last round, and C = 8 (one vector a row)
                (1, 48), (1, 720), (50, 48), (7, 96), (13, 192), (3, 384),
                (77, 720), (203, 384), (1003, 96), (61, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES + STATS_EDGE_SHAPES)
def test_split_stats_equal_the_fused_kernel(cuda, shape, dtype):
    _split_stats_ok(cuda, shape, dtype)


def _split_stats_ok(cuda, shape, dtype):
    x = _train_inputs(shape, dtype, cuda, seed=4)[0]
    c = shape[-1]
    mean, var = fba.bn_stats(x)
    before = dict(fba.TRAIN_LAUNCHES)
    sums = fba.bn_stats_sums(x)
    torch.cuda.synchronize()
    assert fba.TRAIN_LAUNCHES["bn_stats_sums"] == before["bn_stats_sums"] + 1
    assert fba.TRAIN_LAUNCHES["bn_stats"] == before["bn_stats"]
    assert sums.dtype == torch.float64 and sums.shape == (2 * c + 1,)
    m2, v2 = fba.stats_from_sums(sums)
    assert torch.equal(m2, mean) and torch.equal(v2, var)
    ref = fba._bn_stats_sums_ref(x)
    assert float(sums[-1]) == float(ref[-1]) == x.numel() // c
    xd = x.reshape(-1, c).double()
    for got, want, size in ((sums[:c], ref[:c], xd.abs().sum(0)),
                            (sums[c:2 * c], ref[c:2 * c], (xd * xd).sum(0))):
        assert bool(((got - want).abs() <= 1e-5 * size + 1e-12).all())
    _counters_zero(cuda)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_backward_equals_the_fused_kernel(cuda, shape, dtype, act):
    _split_backward_ok(cuda, shape, dtype, act)


def _split_backward_ok(cuda, shape, dtype, act):
    x, grad, *vecs = _train_inputs(shape, dtype, cuda, seed=6)
    c = shape[-1]
    dx, dgamma, dbeta = fba.bn_act_backward(x, grad, *vecs, act)
    before = dict(fba.TRAIN_LAUNCHES)
    dg2, db2, sums = fba.bn_backward_reduce(x, grad, *vecs, act)
    dx2 = fba.bn_backward_dx(x, grad, *vecs, sums, act)
    torch.cuda.synchronize()
    for name in ("bn_backward_reduce", "bn_backward_dx"):
        assert fba.TRAIN_LAUNCHES[name] == before[name] + 1
    assert fba.TRAIN_LAUNCHES["bn_backward"] == before["bn_backward"]
    assert torch.equal(dx2, dx)
    assert torch.equal(dg2, dgamma) and torch.equal(db2, dbeta)
    assert float(sums[-1]) == x.numel() // c
    rdg, rdb, rsums = fba._bn_backward_reduce_ref(
        x.reshape(-1, c), grad.reshape(-1, c), *vecs, act)
    _sums_ok(dg2, rdg)
    _sums_ok(db2, rdb)
    assert float((sums - rsums).abs().max()) <= 1e-5 * float(
        rsums[:2 * c].abs().max())
    rdx = fba._bn_backward_dx_ref(x.reshape(-1, c), grad.reshape(-1, c),
                                  *vecs, sums, act)
    _dx_ok(dx2, rdx.reshape(shape))


# a rank's rows of the space axis (``parallel/bands.py``) over two space
# ranks: W48 at 620 px (the stem's 310 rows as 155, 155 as 78 / 77, the
# branches' 78, 39 as 20 / 19 and 20; the head's 720 channels) and the UNet
# at 352 px (176 rows, and 22 as 11)
BAND_SHAPES = [((16, 10, 20, 48), torch.bfloat16),
               ((16, 10, 20, 192), torch.bfloat16),
               ((16, 155, 310, 64), torch.bfloat16),
               ((16, 77, 155, 64), torch.bfloat16),
               ((16, 39, 78, 96), torch.bfloat16),
               ((16, 19, 39, 192), torch.bfloat16),
               ((16, 10, 20, 384), torch.bfloat16),
               ((16, 78, 155, 720), torch.bfloat16),
               ((16, 176, 352, 64), torch.float32),
               ((16, 11, 22, 512), torch.float32),
               # W18's (18 channels: a fold over many clusters; its head's
               # 270 over five column groups)
               ((16, 78, 155, 18), torch.bfloat16),
               ((16, 77, 155, 270), torch.bfloat16)]


@pytest.mark.parametrize("shape,dtype", BAND_SHAPES)
def test_kernels_at_band_shapes(cuda, shape, dtype):
    """Kernels 1-3 at the band shapes of the space axis: the split entries
    bit for bit to the fused launches and each against its plain version,
    kernel 2 bit for bit to its plain version."""
    _split_stats_ok(cuda, shape, dtype)
    for act in ("none", "relu"):
        _split_backward_ok(cuda, shape, dtype, act)
    x = _train_inputs(shape, dtype, cuda, seed=9)[0]
    scale = torch.rand(shape[-1], device=cuda) + 0.5
    shift = torch.randn(shape[-1], device=cuda)
    y = fba.fused_scale_bias_act(x, scale, shift, "relu")
    assert torch.equal(y, fba._scale_bias_act_ref(x, scale, shift, "relu"))


# C that is no multiple of 8 (HRNet-W18's 18, 36 and its 270-channel head;
# 4, 6, 12): W18's batch-1 high-resolution branch (24,025 rows), which
# leaves a tail of one image row after the view's rows of lcm(C, 8)
# columns at every C here; fewer rows than one row of the view (3 of 18: 4
# to a view's row; 2 of 270); a tail of 3 rows (7 of 6); a W18 band
ODD_C_SHAPES = ([(1, 155, 155, c) for c in (4, 6, 12, 18, 36, 270)]
                + [(3, 18), (2, 270), (7, 6), (16, 19, 39, 36),
                   (16, 155, 155, 18)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ODD_C_SHAPES)
def test_kernels_at_any_c(cuda, shape, dtype):
    """Kernels 1-3 at a C that is no multiple of 8: each fused launch
    against its plain version, the split entries bit for bit to the fused
    launches and against their plain versions, kernel 2 bit for bit to its
    plain version."""
    x, grad, *vecs = _train_inputs(shape, dtype, cuda, seed=11)
    c = shape[-1]
    _stats_ok(fba.bn_stats(x), fba._bn_stats_ref(x))
    _split_stats_ok(cuda, shape, dtype)
    for act in ("none", "relu"):
        dx, dgamma, dbeta = fba.bn_act_backward(x, grad, *vecs, act)
        rdx, rdg, rdb = fba._bn_backward_ref(
            x.reshape(-1, c), grad.reshape(-1, c), *vecs, act)
        _dx_ok(dx, rdx.reshape(shape))
        _sums_ok(dgamma, rdg)
        _sums_ok(dbeta, rdb)
        _split_backward_ok(cuda, shape, dtype, act)
    scale, shift = vecs[0], vecs[1]
    for act in ("none", "relu", "leaky_relu"):
        y = fba.fused_scale_bias_act(x, scale, shift, act)
        assert torch.equal(y, fba._scale_bias_act_ref(x, scale, shift, act))
    _counters_zero(cuda)


def test_space_ranks_on_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card at ``n_space`` 2: the base-width-8
    UNet's forward on bands (rows exchanged through host memory) in eval
    and train mode against one process on the card, f32 without TF32;
    each rank launched the split entries, never the fused kernels 1 and
    3."""
    import copy

    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils.device import (
        float32_convs,
    )
    from torch_dist_common import build_small, run_ranks
    from torch_space_common import forward_job

    torch.manual_seed(5)
    model = build_small("unet")
    sd = copy.deepcopy(model.state_dict())
    x = np.random.default_rng(0).standard_normal(
        (2, 36, 32, 3)).astype(np.float32)
    ranks = run_ranks(forward_job, 2, tmp_path, "unet", sd, x, "cuda:0")
    model = model.to(cuda, memory_format=torch.channels_last)
    for train in (False, True):
        with torch.no_grad(), float32_convs(True):
            want = model.train(train)(torch.from_numpy(x).to(cuda))
        for L, z in enumerate(want.logits_per_level):
            got = torch.cat([r[train][0][L] for r in ranks], dim=1)
            torch.testing.assert_close(got, z.cpu(), rtol=0,
                                       atol=1e-5 * float(z.abs().max()))
    for r in ranks:  # train: the sums entry and kernel 2's train entry
        n = r["launches"]
        assert n["bn_stats_sums"] == n["bn_act_forward"] == 18, n
        assert n["scale_bias_act"] == 18, n  # eval: kernel 2's eval entry
        assert n["bn_stats"] == n["bn_backward"] == 0, n


def test_bn_over_two_ranks_on_one_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (gloo's all-reduce and broadcast
    take CUDA tensors; NCCL refuses two ranks on one device): each
    BatchNorm's output and input gradient, concatenated over the ranks,
    against one process on the whole batch."""
    from torch_dist_common import bn_job, run_ranks

    g = torch.Generator().manual_seed(8)
    cases = []
    for shape, act in (((4, 24, 24, 64), "relu"), ((2, 9, 7, 48), "none")):
        x = torch.randn(shape, generator=g) * 1.5 + 0.4
        cases.append((x.numpy(), (torch.rand(shape[-1], generator=g) + 0.5)
                      .numpy(), torch.randn(shape[-1], generator=g).numpy(),
                      torch.randn(shape, generator=g).numpy(), act))
    ranks = run_ranks(bn_job, 2, tmp_path, cases, "cuda:0")
    for k, (x, gamma, beta, cot, act) in enumerate(cases):
        bn = BatchNormAct(x.shape[-1], act).to(cuda).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(gamma))
            bn.bias.copy_(torch.from_numpy(beta))
        xt = torch.from_numpy(x).to(cuda).permute(0, 3, 1, 2)
        xt = xt.contiguous(memory_format=torch.channels_last)
        xt.requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(cot).to(cuda).permute(0, 3, 1, 2)).sum(
        ).backward()
        y2 = torch.cat([r[0][k][0] for r in ranks])
        dx2 = torch.cat([r[0][k][1] for r in ranks])
        torch.testing.assert_close(y2, y.detach().permute(0, 2, 3, 1).cpu(),
                                   rtol=0, atol=1e-5)
        dx = xt.grad.permute(0, 2, 3, 1).cpu()
        torch.testing.assert_close(dx2, dx, rtol=0,
                                   atol=1e-4 * float(dx.abs().max()))
        torch.testing.assert_close(ranks[0][0][k][5], bn.running_var.cpu(),
                                   rtol=1e-5, atol=1e-6)
    for r in ranks:  # the split entries ran, the fused ones did not
        launched = r[1]
        assert launched["bn_stats_sums"] == launched["bn_backward_reduce"] \
            == launched["bn_backward_dx"] == len(cases)
        assert launched["bn_stats"] == launched["bn_backward"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 155, 155, 48), (2, 155, 155, 720),
                                   (1001, 48)])
def test_bn_backward_kernel_is_deterministic(cuda, shape, dtype):
    """No float atomics and sums in a fixed order: two calls on the same
    inputs give the same bits in dx, dgamma and dbeta."""
    x, grad, *vecs = _train_inputs(shape, dtype, cuda, seed=3)
    first = fba.bn_act_backward(x, grad, *vecs, "relu")
    second = fba.bn_act_backward(x, grad, *vecs, "relu")
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 10, 20, 384), (16, 78, 155, 48),
                                   (77, 720), (61, 8), (8193, 48),
                                   (16, 78, 155, 18)])
def test_split_entries_are_deterministic(cuda, shape, dtype):
    """Two launches of each split entry on the same inputs give the same
    bits: no float atomics, the strips added in a fixed order whichever
    block draws the last ticket, and the ticket counters back at 0."""
    x, grad, *vecs = _train_inputs(shape, dtype, cuda, seed=12)
    sums = [fba.bn_stats_sums(x) for _ in range(2)]
    assert torch.equal(sums[0], sums[1])
    first = fba.bn_backward_reduce(x, grad, *vecs, "relu")
    second = fba.bn_backward_reduce(x, grad, *vecs, "relu")
    dx1 = fba.bn_backward_dx(x, grad, *vecs, first[2], "relu")
    dx2 = fba.bn_backward_dx(x, grad, *vecs, first[2], "relu")
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(dx1, dx2)
    _counters_zero(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 19, 39, 192), (3, 720)])
def test_split_backward_replays_in_a_cuda_graph(cuda, shape, dtype):
    """The reduce entry, then the dx entry, captured in a CUDA graph and
    replayed three times: each replay gives the eager calls' bits. The
    reduce entry's ticket counters are back at 0 after every launch, so
    each replay draws its tickets anew."""
    x, grad, *vecs = _train_inputs(shape, dtype, cuda, seed=13)
    want_dg, want_db, want_sums = fba.bn_backward_reduce(x, grad, *vecs,
                                                         "relu")
    want_dx = fba.bn_backward_dx(x, grad, *vecs, want_sums, "relu")
    side = torch.cuda.Stream()  # a warm-up on a side stream before capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fba.bn_backward_reduce(x, grad, *vecs, "relu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dg, db, sums = fba.bn_backward_reduce(x, grad, *vecs, "relu")
        dx = fba.bn_backward_dx(x, grad, *vecs, sums, "relu")
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(dx, want_dx)
        assert torch.equal(dg, want_dg) and torch.equal(db, want_db)
        assert torch.equal(sums, want_sums)
    _counters_zero(cuda)


def test_bn_backward_copies_a_gradient_in_another_layout(cuda):
    shape = (2, 20, 20, 384)
    x, grad, *vecs = _train_inputs(shape, torch.bfloat16, cuda)
    # the same values laid out NCHW-contiguous, seen as NHWC
    strided = grad.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    copies = fba.GRAD_COPIES
    got = fba.bn_act_backward(x, strided, *vecs, "relu")
    want = fba.bn_act_backward(x, grad, *vecs, "relu")
    assert fba.GRAD_COPIES == copies + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_train_kernels_reject_what_they_do_not_take(cuda):
    # C = 12, no multiple of 8: taken, against the plain versions
    x12, g12, *v12 = _train_inputs((5, 12), torch.float32, cuda)
    _stats_ok(fba.bn_stats(x12), fba._bn_stats_ref(x12))
    dx, dg, db = fba.bn_act_backward(x12, g12, *v12, "relu")
    rdx, rdg, rdb = fba._bn_backward_ref(x12, g12, *v12, "relu")
    _dx_ok(dx, rdx)
    _sums_ok(dg, rdg)
    _sums_ok(db, rdb)
    with pytest.raises(TypeError):
        fba.bn_stats(torch.ones(4, 16, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fba.bn_stats(torch.ones(16, 4, device=cuda).t())
    x, grad, *vecs = _train_inputs((4, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="leaky_relu"):
        fba.bn_act_backward(x, grad, *vecs, "leaky_relu")
    with pytest.raises(ValueError, match="g like x"):
        fba.bn_act_backward(x, grad.bfloat16(), *vecs, "relu")
    with pytest.raises(ValueError, match="C <= 2048"):
        fba.bn_stats(torch.ones(4, 2049, device=cuda))
    bn = BatchNormAct(16, "leaky_relu").to(cuda).train()
    with pytest.raises(ValueError, match="leaky_relu"):
        bn(torch.ones(2, 16, 3, 3, device=cuda))
    wide = torch.ones(2, 4104, device=cuda)  # one block's threads: C <= 4096
    with pytest.raises(ValueError, match="C <= 4096"):
        fba.bn_backward_dx(wide, wide, *[torch.ones(4104, device=cuda)] * 4,
                           torch.ones(8209, dtype=torch.float64,
                                      device=cuda), "relu")


@pytest.mark.parametrize("act", ["none", "relu"])
def test_train_mode_batchnorm_on_card_equals_cpu(cuda, act):
    """Forward, running statistics and gradients of a train-mode
    BatchNormAct, f32, on the card through its three kernels against the
    same module on the CPU through the plain versions."""
    torch.manual_seed(1)
    cpu = BatchNormAct(96, act).train()
    with torch.no_grad():
        cpu.weight.uniform_(0.5, 1.5)
        cpu.bias.normal_(0, 0.1)
        cpu.running_mean.normal_(0, 0.1)
        cpu.running_var.uniform_(0.5, 1.5)
    card = BatchNormAct(96, act).to(cuda).train()
    card.load_state_dict(cpu.state_dict())
    x = (torch.randn(4, 96, 33, 29) * 2 + 0.5).contiguous(
        memory_format=torch.channels_last)
    ct = torch.randn(x.shape)
    xs = [x.clone().requires_grad_(), x.to(cuda).requires_grad_()]
    before = dict(fba.TRAIN_LAUNCHES)
    outs = []
    for bn, xx in zip((cpu, card), xs):
        y = bn(xx)
        (y * ct.to(xx.device)).sum().backward()
        outs.append(y)
    torch.cuda.synchronize()
    # no group: kernel 1, kernel 2's train entry and kernel 3, fused
    fused = ("bn_stats", "bn_act_forward", "bn_backward")
    assert all(fba.TRAIN_LAUNCHES[k] == before[k] + (k in fused)
               for k in before)
    torch.testing.assert_close(outs[1].cpu(), outs[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs[1].grad.cpu(), xs[0].grad, rtol=1e-4,
                               atol=1e-5)
    for name in ("weight", "bias"):
        got = getattr(card, name).grad.cpu()
        want = getattr(cpu, name).grad
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(card, name).cpu(),
                                   getattr(cpu, name), rtol=1e-5, atol=1e-6)


def test_fused_bn_act_under_bf16_autocast_keeps_vectors_f32(cuda):
    x = torch.randn(2, 64, 9, 10, device=cuda).contiguous(
        memory_format=torch.channels_last).bfloat16().requires_grad_()
    bn = BatchNormAct(64, "relu").to(cuda).train()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = bn(x)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert bn.weight.grad.dtype == bn.bias.grad.dtype == torch.float32
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


# ------------------------------------------------- kernel 2's train entry
# HRNet-W18's widths (views of 72 and 1,080 columns with a tail), W48's 48
# and 720, one row, fewer rows than a view's row, and views wider than one
# block's 512 units (5,000 channels: 2 column groups; 16,384: 4)
TRAIN_ENTRY_SHAPES = [(16, 155, 155, 18), (4, 78, 78, 36), (2, 39, 39, 270),
                      (16, 78, 78, 48), (2, 20, 20, 720), (1, 18), (3, 270),
                      (3, 5000), (2, 16384)]


def _train_entry_inputs(shape, dtype, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda) * 1.5 + 0.7).to(dtype)
    gamma = torch.rand(c, generator=g, device=cuda) + 0.5
    beta = torch.randn(c, generator=g, device=cuda) * 0.5
    rm = torch.randn(c, generator=g, device=cuda) * 0.1
    rv = torch.rand(c, generator=g, device=cuda) + 0.5
    return x, gamma, beta, rm, rv


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TRAIN_ENTRY_SHAPES)
def test_train_entry_equals_plain(cuda, shape, dtype, act):
    """Kernel 2's train entry bit for bit to its plain version run on the
    card (the PyTorch composition it replaces): y, mean, var, rstd, scale,
    shift and the moved running buffers, from kernel 1's statistics and
    from the sums entry's sums (whose mean and var are then kernel 1's
    bits, at one rank); one launch counted per call."""
    x, gamma, beta, rm, rv = _train_entry_inputs(shape, dtype, cuda)
    mean, var = fba.bn_stats(x)
    sums = fba.bn_stats_sums(x)
    for kw in (dict(mean=mean, var=var), dict(sums=sums)):
        got_r, want_r = (rm.clone(), rv.clone(), 0.9), (rm.clone(),
                                                        rv.clone(), 0.9)
        before = dict(fba.TRAIN_LAUNCHES)
        got = fba.bn_act_forward(x, gamma, beta, 1e-5, act, running=got_r,
                                 **kw)
        assert fba.TRAIN_LAUNCHES == dict(
            before, bn_act_forward=before["bn_act_forward"] + 1)
        want = fba._bn_act_forward_ref(x, gamma, beta, 1e-5, act,
                                       running=want_r, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("y", "mean", "var", "rstd", "scale", "shift"),
                              got, want):
            assert torch.equal(a, b), (name, shape, kw.keys())
        assert torch.equal(got_r[0], want_r[0])
        assert torch.equal(got_r[1], want_r[1])
        assert torch.equal(got[1], mean) and torch.equal(got[2], var)
    _counters_zero(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 39, 39, 270), (16, 19, 39, 192)])
def test_train_entry_replays_in_a_cuda_graph(cuda, shape, dtype):
    """Kernel 1, then kernel 2's train entry with the running update,
    captured in a CUDA graph and replayed three times: each replay gives
    the eager calls' y and vectors and moves the buffers as the next eager
    call does; so does the group route (the sums entry, then the entry)."""
    x, gamma, beta, rm, rv = _train_entry_inputs(shape, dtype, cuda, seed=3)

    def forward(running, group):
        if group:
            return fba.bn_act_forward(x, gamma, beta, 1e-5, "relu",
                                      sums=fba.bn_stats_sums(x),
                                      running=running)
        mean, var = fba.bn_stats(x)
        return fba.bn_act_forward(x, gamma, beta, 1e-5, "relu", mean, var,
                                  running=running)

    for group in (False, True):
        eager_r = (rm.clone(), rv.clone(), 0.9)
        want = []
        for _ in range(3):
            out = forward(eager_r, group)
            want.append(([t.clone() for t in out], eager_r[0].clone(),
                         eager_r[1].clone()))
        side = torch.cuda.Stream()  # a warm-up on a side stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            forward(None, group)
        torch.cuda.current_stream().wait_stream(side)
        graph_r = (rm.clone(), rv.clone(), 0.9)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = forward(graph_r, group)
        for outs, m, v in want:
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, outs))
            assert torch.equal(graph_r[0], m) and torch.equal(graph_r[1], v)
    _counters_zero(cuda)


def test_train_entry_rejects_what_it_does_not_take(cuda):
    x, gamma, beta, rm, rv = _train_entry_inputs((5, 12), torch.float32,
                                                 cuda)
    mean, var = fba.bn_stats(x)
    before = dict(fba.TRAIN_LAUNCHES)
    with pytest.raises(ValueError, match="leaky_relu"):
        fba.bn_act_forward(x, gamma, beta, 1e-5, "leaky_relu", mean, var)
    with pytest.raises(ValueError, match="mean and var, or sums"):
        fba.bn_act_forward(x, gamma, beta, 1e-5, "relu", mean)
    with pytest.raises(ValueError, match="sums"):
        fba.bn_act_forward(x, gamma, beta, 1e-5, "relu",
                           sums=torch.ones(25, device=cuda))
    with pytest.raises(ValueError, match="in place"):
        fba.bn_act_forward(x, gamma, beta, 1e-5, "relu", mean, var,
                           running=(rm.bfloat16(), rv, 0.9))
    with pytest.raises(ValueError, match="on cpu, x on"):
        fba.bn_act_forward(x, gamma.cpu(), beta, 1e-5, "relu", mean, var)
    with pytest.raises(ValueError, match="C <= 2048"):
        wide = torch.ones(2049, device=cuda)
        fba.bn_act_forward(torch.ones(4, 2049, device=cuda), wide, wide,
                           1e-5, "relu", wide, wide)
    assert fba.TRAIN_LAUNCHES == before


# ------------------------------------------------ 1x1 conv + BN + ReLU (GEMM)
# Tolerance (tools/conv_bn_experiment.py:tolerance): one bf16 ulp of the
# plain version's value, plus K * 2^-24 * |a| * (|x| @ |w|), the worst-case
# error of an f32 sum of K products in another order (the plain version is
# an f32 matmul with TF32 off). Shapes: the tool's, its rows unpadded
# (ragged against the 128-row tile), fewer rows than one tile, and a narrow
# K and N inside one tile.
CONV_BN_SHAPES = [(96256, 720, 720), (96100, 720, 720), (77, 720, 720),
                  (1000, 48, 64)]
# the wgmma kernel's edges: ragged M (one row, one short of and one past the
# 128-row tile), the K tails of its 64-wide K step (16, 48, 720 = 11 x 64 +
# 16, 736 = 11 x 64 + 32), and N against its 240-wide tile (8, 144, 240,
# 720, and 248, one past)
CONV_BN_EDGES = [(1, 720, 720), (127, 720, 720), (129, 720, 720),
                 (1000, 16, 64), (1000, 736, 720), (300, 720, 8),
                 (300, 720, 144), (300, 720, 240), (300, 64, 248)]


def _conv_bn_inputs(shape, cuda, seed=0):
    n, c_in, c_out = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, c_in, generator=g, device=cuda).bfloat16()
    w = (torch.randn(c_in, c_out, generator=g, device=cuda) * 0.05).bfloat16()
    a = torch.rand(c_out, generator=g, device=cuda) + 0.5
    b = torch.randn(c_out, generator=g, device=cuda)
    return x, w, a, b


@pytest.mark.parametrize("shape", CONV_BN_SHAPES + CONV_BN_EDGES)
def test_conv_bn_relu_kernel_equals_plain(cuda, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, a, b = _conv_bn_inputs(shape, cuda)
    before = k4.LAUNCHES
    y = k4.conv1x1_bn_relu(x, w, a, b)
    torch.cuda.synchronize()
    assert k4.LAUNCHES == before + 1
    ref = k4._conv1x1_bn_relu_ref(x, w, a, b)
    assert y.dtype == torch.bfloat16 and y.shape == ref.shape
    err = (y.float() - ref.float()).abs()
    assert bool((err <= tool.tolerance(x, w, a, ref)).all()), \
        float(err.max())


def test_conv_bn_relu_kernel_reads_w_as_it_is_now(cuda):
    """w changed in place between two calls: the second call must use the
    new values (the K-major copy of w is made anew on every call)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, a, b = _conv_bn_inputs((500, 720, 720), cuda, seed=1)
    first = k4.conv1x1_bn_relu(x, w, a, b)
    w.mul_(-1.5)
    second = k4.conv1x1_bn_relu(x, w, a, b)
    torch.cuda.synchronize()
    ref = k4._conv1x1_bn_relu_ref(x, w, a, b)
    err = (second.float() - ref.float()).abs()
    assert bool((err <= tool.tolerance(x, w, a, ref)).all())
    assert not torch.equal(first, second)


def test_conv_bn_relu_kernel_rejects_what_it_does_not_take(cuda):
    x, w, a, b = _conv_bn_inputs((64, 32, 16), cuda)
    before = k4.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        k4.conv1x1_bn_relu(x.t().contiguous().t(), w, a, b)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        k4.conv1x1_bn_relu(flat[1:].view(64, 32), w, a, b)
    with pytest.raises(ValueError, match="C_in % 16"):
        k4.conv1x1_bn_relu(x[:, :24].contiguous(), w[:24], a, b)
    with pytest.raises(ValueError, match="C_out % 8"):
        k4.conv1x1_bn_relu(x, w[:, :12].contiguous(), a[:12], b[:12])
    with pytest.raises(TypeError):
        k4.conv1x1_bn_relu(x.half(), w, a, b)
    with pytest.raises(ValueError, match="one device"):
        k4.conv1x1_bn_relu(x, w.cpu(), a, b)
    assert k4.LAUNCHES == before


def test_conv_bn_tool_on_card(cuda):
    before = k4.LAUNCHES
    row = tool.run(b=1, h=20, w=20, c=64, tile_n=128, steps=2)
    assert k4.LAUNCHES >= before + 1
    assert row["within_tolerance"] and row["device"] == "cuda"
    assert row["kernel_ms"] > 0 and row["library_ms"] > 0 and row["card"]


# ------------------------------------------------------------ train data path
def test_prefetch_to_device_copies_pinned_batches_to_the_card(cuda):
    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.loader import (  # noqa: E501
        prefetch_to_device,
    )

    rng = np.random.default_rng(0)
    batches = [(rng.random((4, 64, 64, 1), dtype=np.float32),
                rng.integers(-1, 2, (4, 64, 64, 8)).astype(np.int8))
               for _ in range(6)]
    got = list(prefetch_to_device(iter(batches), 2, cuda))
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for (x, y), (tx, ty) in zip(batches, got):
        assert tx.is_cuda and ty.is_cuda and ty.dtype == torch.int8
        assert torch.equal(tx.cpu(), torch.from_numpy(x))
        assert torch.equal(ty.cpu(), torch.from_numpy(y))


@pytest.mark.parametrize("best_save", ["every", "end"])
def test_checkpoint_of_a_card_state_is_unaffected_by_a_later_step(
        cuda, tmp_path, best_save):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        checkpoint as ck,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (  # noqa: E501
        create_train_state,
    )

    torch.manual_seed(0)
    model = torch.nn.Linear(64, 64).to(cuda)
    state = create_train_state(model, 1e-2)

    def step():
        state.optimizer.zero_grad()
        model(torch.randn(8, 64, device=cuda)).square().mean().backward()
        state.optimizer.step()
        state.step += 1

    step()
    want = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    moments = state.optimizer.state_dict()["state"][0]["exp_avg"].cpu()
    mgr = ck.CheckpointManager(str(tmp_path), best_save=best_save,
                               ckpt_every=100)
    mgr.update(state, 1, 0.0, 0.5, 0.0)
    for _ in range(3):  # in-place updates of the live card tensors
        step()
    mgr.finalize()
    snap = ck.load_state(mgr.best_path)
    assert snap["step"] == 1
    for k, v in want.items():
        assert torch.equal(snap["model"][k], v), k
    assert torch.equal(snap["optimizer"]["state"][0]["exp_avg"], moments)
    assert not torch.equal(model.weight.detach().cpu(), want["weight"])


# ------------------------------------------------------------ offline eval
EVAL_IMAGES = 5
EVAL_IMG = 48


def _tiny_eval(tmp_path, monkeypatch, model_type):
    """5 synthetic files at 48 px and a port checkpoint of a seeded UNet of
    base width 8 (18 BatchNorms, as at full width), patched into the
    Evaluator; returns (data root, checkpoint, config kwargs)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (  # noqa: E501
        write_synth_dataset,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (  # noqa: E501
        UNetBackbone,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        checkpoint as ck,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate as ev,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (  # noqa: E501
        create_train_state,
    )

    def small(tree, model_select, mt, *a, **k):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8),
                                       hierarchical=mt == 1)

    monkeypatch.setattr(ev, "build_model", small)
    files = dict(tree_root="assets/class_tree_tl.json",
                 class_map="assets/class_map.csv")
    tree = ClassTree.from_json(files["tree_root"], files["class_map"])
    data = str(tmp_path / "data")
    write_synth_dataset(data, EVAL_IMAGES, size=EVAL_IMG, seed=0)
    torch.manual_seed(0)
    model = small(tree, 0, model_type)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormAct):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    ckpt = str(tmp_path / "best.ckpt")
    ck.save_checkpoint(ckpt, create_train_state(model, 0.0), epoch=1)
    return data, ckpt, dict(files, model_select=0, model_type=model_type,
                            img_size=EVAL_IMG, num_workers=2)


@pytest.mark.parametrize("model_type", [1, 0])
def test_evaluator_on_card_equals_cpu(cuda, tmp_path, monkeypatch,
                                      model_type):
    """The tiny Evaluator in f32 on the card and on the CPU, with TF32
    allowed as PyTorch allows it by default (the Evaluator computes its f32
    convolutions in f32 and restores the flags): metrics.csv within 1e-6
    and the PNG dumps' pixels equal on at least 99.9 % (argmax near-ties
    may move)."""
    import csv
    import os

    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (  # noqa: E501
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (  # noqa: E501
        decode_png,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate as ev,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    data, ckpt, kw = _tiny_eval(tmp_path, monkeypatch, model_type)
    cfg = RunConfig(val_batch=2, **kw)
    out = {}
    for dev in ("cuda", "cpu"):
        ev.predict_eval(cfg, [ckpt], [data], str(tmp_path / dev), device=dev)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with open(tmp_path / dev / "fold_1" / "metrics.csv") as f:
            out[dev] = np.asarray([[float(v) for v in r[2:]]
                                   for r in list(csv.reader(f))[1:]])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-6)
    same = total = 0
    for c in range(8):
        d = tmp_path / "cpu" / "fold_1" / str(c)
        for n in os.listdir(d):
            with open(d / n, "rb") as a, open(
                    tmp_path / "cuda" / "fold_1" / str(c) / n, "rb") as b:
                pa, pb = decode_png(a.read()), decode_png(b.read())
            same += int((pa == pb).sum())
            total += pa.size
    assert total == 8 * EVAL_IMAGES * EVAL_IMG ** 2
    assert same >= 0.999 * total


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("val_batch", [1, 2])
def test_evaluator_launches_kernel_2_per_forward(cuda, tmp_path, monkeypatch,
                                                 tta, val_batch):
    """18 scale_bias_act launches per forward (one per BatchNorm), with TTA
    too (both views ride one forward of 2B images); no BN kernel of the
    train step and no plain version runs."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (  # noqa: E501
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate as ev,
    )

    plain = []
    for name in ("_bn_stats_ref", "_bn_backward_ref", "_scale_bias_act_ref"):
        def counted(*a, _n=name, _f=getattr(fba, name), **k):
            plain.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(fba, name, counted)
    data, ckpt, kw = _tiny_eval(tmp_path, monkeypatch, 1)
    cfg = RunConfig(val_batch=val_batch, tta=tta, **kw)
    before = fba.LAUNCHES
    train_before = dict(fba.TRAIN_LAUNCHES)
    res = ev.predict_eval(cfg, [ckpt], [data], str(tmp_path / "out"),
                          device="cuda")
    torch.cuda.synchronize()
    forwards = -(-EVAL_IMAGES // val_batch)
    assert fba.LAUNCHES - before == 18 * forwards
    assert fba.TRAIN_LAUNCHES == train_before
    assert plain == []
    assert 0.0 <= res[0]["overall"]["dice"] <= 1.0


# (batch, H, W, C_in, kernel, C_out, stride, padding): the padded cases of
# torch._int_mm's rules, and the largest UNet and W48 shapes' geometry
INT8_SHAPES = [
    (1, 352, 352, 3, 3, 64, 1, 1),    # the UNet's first conv: K = 27
    (1, 620, 620, 3, 3, 64, 2, 1),    # the W48 stem: K = 27, stride 2
    (2, 64, 64, 7, 3, 64, 1, 1),      # concat_prev_probs: K = 63
    (1, 40, 40, 12, 3, 32, 1, 1),     # K = 108: C not a multiple of 8
    (1, 3, 3, 16, 3, 32, 2, 1),       # 4 rows: padded to 17
    (1, 155, 155, 256, 1, 64, 1, 0),  # a 1x1: the input as it is
    (1, 78, 78, 48, 1, 96, 2, 0),     # a strided 1x1
    (1, 44, 44, 1024, 3, 256, 1, 1),  # the UNet's widest conv
    # C_out no multiple of 8 (HRNet-W18: branches of 18 and 36 channels,
    # its 270-channel head; 4): zero output channels padded, sliced off
    (1, 155, 155, 18, 3, 18, 1, 1),
    (1, 39, 39, 36, 3, 36, 1, 1),
    (1, 155, 155, 270, 1, 270, 1, 0),
    (1, 20, 20, 144, 3, 4, 1, 1),
]


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_conv_card_equals_plain(cuda, shape):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        int8_conv,
    )

    b, h, w, c, k, o, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    xq = torch.randint(-127, 128, (b, h, w, c), generator=g, device=cuda,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, (k, k, c, o), generator=g, device=cuda,
                       dtype=torch.int8)
    before = int8_conv.CALLS
    acc = int8_conv.int8_conv2d(xq, kq, (s, s), (p, p))
    torch.cuda.synchronize()
    assert int8_conv.CALLS == before + 1
    assert acc.dtype == torch.int32 and acc.is_cuda
    # the plain version on the card and on the CPU: exact in float64
    assert torch.equal(acc, int8_conv._int8_conv_ref(xq, kq, (s, s), (p, p)))
    assert torch.equal(acc.cpu(), int8_conv.int8_conv2d(xq.cpu(), kq.cpu(),
                                                        (s, s), (p, p)))


def test_int8_conv_card_refuses_what_it_does_not_take(cuda):
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        int8_conv,
    )

    xq = torch.randint(-127, 128, (1, 8, 8, 16), dtype=torch.int8,
                       device=cuda)
    # C_out = 12, no multiple of 8: taken (zero output channels padded)
    kq = torch.randint(-127, 128, (1, 1, 16, 12), dtype=torch.int8,
                       device=cuda)
    assert torch.equal(int8_conv.int8_conv2d(xq, kq),
                       int8_conv._int8_conv_ref(xq, kq, (1, 1), (0, 0)))
    with pytest.raises(ValueError, match="is on"):
        int8_conv.int8_conv2d(xq, torch.zeros((1, 1, 16, 8),
                                              dtype=torch.int8))




def _tiny_unets(monkeypatch, folds: int):
    """Seeded state_dicts of the hierarchical UNet at base width 8, one per
    fold, with that model patched into the Predictor; returns (serving
    module, a 48 px f32 config, state_dicts)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (  # noqa: E501
        RunConfig,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models import (
        hierarchical as H,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.models.backbones.unet import (  # noqa: E501
        UNetBackbone,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        serving,
    )

    def small(tree, *a, **k):
        return H.HierarchicalSegmenter(tree=tree,
                                       backbone=UNetBackbone(base_ch=8))

    monkeypatch.setattr(serving, "build_model", small)
    cfg = RunConfig(tree_root="assets/class_tree_tl.json",
                    class_map="assets/class_map.csv", model_type=1,
                    img_size=EVAL_IMG)
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    sds = []
    for f in range(folds):
        torch.manual_seed(f)
        model = small(tree)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, BatchNormAct):
                    m.running_mean.normal_(0, 0.1)
                    m.running_var.uniform_(0.5, 1.5)
        sds.append(model.state_dict())
    return serving, cfg, sds


def test_one_fold_ensemble_is_the_single_predictor_on_card(cuda,
                                                           monkeypatch):
    """A list of one fold's weights serves as the single Predictor, bit for
    bit; two folds give the f32 mean of the two Predictors' probabilities
    (within 1e-6) and its argmax, with 18 scale_bias_act launches per fold
    and forward."""
    import numpy as np

    serving, cfg, sds = _tiny_unets(monkeypatch, 2)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, EVAL_IMG, EVAL_IMG, 3)).astype(np.float32)
    single = [serving.Predictor(cfg, sd, device="cuda") for sd in sds]
    one = serving.Predictor(cfg, sds[:1], device="cuda")
    got, want = one(x), single[0](x)
    for k in ("logits", "probs", "class_maps"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    ens = serving.Predictor(cfg, sds, device="cuda")
    before = fba.LAUNCHES
    out = ens(x)
    assert fba.LAUNCHES - before == 2 * 18
    assert out["logits"] is None
    outs = [p(x) for p in single]
    for L, p in enumerate(out["probs"]):
        mean = np.stack([o["probs"][L] for o in outs]).mean(0)
        np.testing.assert_allclose(p, mean, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["class_maps"][L], mean.argmax(-1))


def test_quantized_predictor_on_card_against_cpu(cuda, monkeypatch):
    """The quantized forward with the same weights and scales on the card
    (the int8 GEMM) and the CPU (its plain version): class maps equal on at
    least 99.5 % of pixels (an f32 difference upstream of a round() may
    move an int8 value by one step)."""
    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
        int8_conv,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        quantize as q,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    serving, cfg, sds = _tiny_unets(monkeypatch, 1)
    pred = serving.Predictor(cfg, sds[0], quantize=True, device="cuda")
    assert pred.act_scales and min(pred.act_scales.values()) > 0
    x = np.random.default_rng(1).uniform(
        -1, 1, (4, EVAL_IMG, EVAL_IMG, 3)).astype(np.float32)
    before = int8_conv.CALLS
    card = pred(x)
    assert int8_conv.CALLS - before == 18  # the heads stay float
    model = serving.build_model(pred.tree)
    model.load_state_dict(sds[0])
    model = model.eval().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        out = q.quantized_apply(model, pred.act_scales)(torch.from_numpy(x))
    for L, z in enumerate(out.logits_per_level):
        agree = (card["class_maps"][L] == z.argmax(-1).numpy()).mean()
        assert agree >= 0.995, (L, agree)


@pytest.mark.parametrize("tta", [False, True])
def test_exported_program_launches_kernel_2(cuda, tmp_path, monkeypatch, tta):
    """A symbolic-batch artifact exported and loaded on the card: 18
    scale_bias_act launches per forward at batch 1 and 3 (TTA's two views
    are one forward), no plain call, outputs bit-equal to the eager
    Predictor's (the same kernels in the same order); loaded on the CPU
    (``platforms`` cuda, cpu) its f32 probabilities are within 1e-4."""
    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        export,
    )

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    serving, cfg, sds = _tiny_unets(monkeypatch, 1)
    pred = serving.Predictor(cfg, sds[0], tta=tta, device="cuda")
    path = str(tmp_path / "u.pt2")
    export.export_predictor(pred, path, platforms=("cuda", "cpu"))
    loaded = export.load_exported(path)
    plain = []
    monkeypatch.setattr(fba, "_scale_bias_act_ref",
                        lambda *a: plain.append(1))
    x = np.random.default_rng(2).uniform(
        -1, 1, (3, EVAL_IMG, EVAL_IMG, 3)).astype(np.float32)
    for b in (1, 3):
        before = fba.LAUNCHES
        got = loaded(x[:b])
        torch.cuda.synchronize()
        assert fba.LAUNCHES - before == 18 and not plain
        want = pred(x[:b])
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)
    monkeypatch.undo()
    cpu = export.load_exported(path, device="cpu")(x)
    for g, w in zip(cpu["probs"], loaded(x)["probs"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,dtype", [((2, 39, 39, 192), torch.bfloat16),
                                         ((77, 48), torch.float32)])
def test_scale_bias_act_fake_matches_kernel(cuda, shape, dtype):
    """The operator's fake implementation (what torch.export traces with)
    gives the kernel's output shape, dtype, strides and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    c = shape[-1]
    x = torch.randn(shape, device=cuda).to(dtype)
    a, b = torch.rand(c, device=cuda), torch.rand(c, device=cuda)
    y = torch.ops.rhss.scale_bias_act(x, a, b, "relu")
    with FakeTensorMode() as mode:
        fx, fa, fb = (mode.from_tensor(t) for t in (x, a, b))
        fy = torch.ops.rhss.scale_bias_act(fx, fa, fb, "relu")
    assert (fy.shape, fy.dtype, fy.stride(), fy.device) == \
        (y.shape, y.dtype, y.stride(), y.device)
    assert torch.equal(y, fba._scale_bias_act_ref(x, a, b, "relu"))



def test_augment_sample_on_card_equals_cpu(cuda):
    """``data/device_augment.py:augment_sample`` on the card against the
    same call on the CPU at one seeded draw per sample, under PyTorch's
    default TF32 flags (the blur is multiply-adds, not a conv): the image
    within 1e-5 on at least 99.5 % of pixels and the targets on at least
    99.5 %, the bounds the port is held to against JAX."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
        device_augment as da,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )

    tree = ClassTree.from_json("assets/class_tree_tl.json",
                               "assets/class_map.csv")
    g = torch.Generator().manual_seed(0)
    img = torch.rand((4, 96, 96, 1), generator=g)
    y = (torch.rand((4, 96, 96, tree.num_classes), generator=g) > 0.6).float()
    y[..., 0] = 1.0
    p = da.sample_params(torch.Generator().manual_seed(1), 4)
    xc, yc = da.augment_sample(img, y, p, tree, True)
    xd, yd = da.augment_sample(img.to(cuda), y.to(cuda),
                               da.AugmentParams(*(t.to(cuda) for t in p)),
                               tree, True)
    assert xd.device.type == yd.device.type == "cuda"
    assert ((xd.cpu() - xc).abs() <= 1e-5).float().mean() >= 0.995
    assert (yd.cpu() == yc).float().mean() >= 0.995


def test_device_dataset_on_card(cuda, tmp_path):
    """The device-resident set uploads once and yields card tensors; the
    same (seed, epoch) draws the same batches on the card."""
    import glob

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
        device_augment as da,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (  # noqa: E501
        write_synth_dataset,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )

    tree = ClassTree.from_json("assets/class_tree_tl.json",
                               "assets/class_map.csv")
    write_synth_dataset(str(tmp_path), 5, size=64, seed=1)
    imgs = sorted(glob.glob(str(tmp_path / "images" / "*")))
    labs = sorted(glob.glob(str(tmp_path / "labels" / "*")))
    ds = da.DeviceDataset(imgs, labs, tree, 48, True, batch_size=2,
                          device="cuda")
    ds.set_epoch(4)
    first = [(x.clone(), y.clone()) for x, y in ds]
    assert len(first) == 2
    assert all(x.device.type == "cuda" and x.shape == (2, 48, 48, 1)
               for x, _ in first)
    for (xa, ya), (xb, yb) in zip(first, ds):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)


def test_f32_predictor_on_card_computes_convs_in_f32(cuda, monkeypatch):
    """Under PyTorch's default TF32 flags the f32 Predictor on the card
    runs its convolutions with TF32 off and restores the flags: batch 4
    equals four batches of 1 and the CPU within 1e-5 (the serve CLI's f32
    class maps had moved on 233 and 464 of 991,232 pixels under TF32)."""
    import numpy as np

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    serving, cfg, sds = _tiny_unets(monkeypatch, 1)
    seen = []
    pred = serving.Predictor(cfg, sds[0], device="cuda")
    conv = next(m for m in pred.model.modules()
                if isinstance(m, torch.nn.Conv2d))
    conv.register_forward_pre_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32)))
    x = np.random.default_rng(0).uniform(
        -1, 1, (4, EVAL_IMG, EVAL_IMG, 3)).astype(np.float32)
    b4 = pred(x)
    b1 = [pred(x[i:i + 1]) for i in range(4)]
    assert seen and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
    cpu = serving.Predictor(cfg, sds[0], device="cpu")(x)
    for L, p in enumerate(b4["probs"]):
        one = np.concatenate([o["probs"][L] for o in b1])
        np.testing.assert_allclose(p, one, rtol=0, atol=1e-5)
        np.testing.assert_allclose(p, cpu["probs"][L], rtol=0, atol=1e-5)


# ------------------------------------------------ remat and the mesh paths
@pytest.fixture
def deterministic():
    """Deterministic cuDNN and PyTorch algorithms for the test (the
    resize's index_add_ and cuDNN's atomics otherwise move bits between
    two runs of one step)."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.backends.cudnn.deterministic = saved[0]
    torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def _remat_step(mode, sd, x, y, dtype):
    """One bf16 or f32 train step of the base-width-8 UNet on the card with
    ``remat``: (model, aux, grads, launches of kernels 1 / 2 / 3)."""
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (  # noqa: E501
        create_train_state,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.steps import (  # noqa: E501
        make_train_step,
    )
    from torch_dist_common import build_small

    tree = ClassTree.from_json("assets/class_tree_tl.json",
                               "assets/class_map.csv")
    model = build_small("unet", mode)
    model.load_state_dict(sd, strict=True)
    model = model.to("cuda", memory_format=torch.channels_last)
    step = make_train_step(model, tree, True, compute_dtype=dtype)
    before = (fba.TRAIN_LAUNCHES["bn_stats"],
              fba.TRAIN_LAUNCHES["bn_act_forward"],
              fba.TRAIN_LAUNCHES["bn_backward"])
    _, aux = step(create_train_state(model, 0.018), x, y,
                  torch.ones(2, device="cuda"))
    torch.cuda.synchronize()
    after = (fba.TRAIN_LAUNCHES["bn_stats"],
             fba.TRAIN_LAUNCHES["bn_act_forward"],
             fba.TRAIN_LAUNCHES["bn_backward"])
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return model, aux, grads, [a - b for a, b in zip(after, before)]


def _remat_inputs():
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.hierarchy.tree import (  # noqa: E501
        ClassTree,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (  # noqa: E501
        synth_sample,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.target_factory import (  # noqa: E501
        node_masks,
        ternary_encode,
    )
    import numpy as np

    from torch_dist_common import build_small

    tree = ClassTree.from_json("assets/class_tree_tl.json",
                               "assets/class_map.csv")
    torch.manual_seed(3)
    sd = build_small("unet").state_dict()
    rng = np.random.default_rng(2)
    xs, ys = [], []
    for _ in range(4):
        img, mask = synth_sample(rng, 64)
        xs.append((np.stack((img,) * 3, -1).astype(np.float32) / 255.0
                   - 0.5) / 0.5)
        ys.append(ternary_encode(node_masks(mask, tree), tree)
                  .astype(np.int8))
    return (sd, torch.from_numpy(np.stack(xs)).cuda(),
            torch.from_numpy(np.stack(ys)).cuda())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["module", "conv"])
def test_remat_step_on_card_equals_no_remat(cuda, deterministic, mode,
                                            dtype):
    """Loss, gradients, parameters after AdamW and running buffers bit for
    bit to remat False under deterministic algorithms; kernels 1 / 2 / 3
    launch 36 / 36 / 18 times (the 18 BatchNorms again in the recompute)."""
    sd, x, y = _remat_inputs()
    want_m, want, want_g, want_n = _remat_step(False, sd, x, y, dtype)
    got_m, got, got_g, got_n = _remat_step(mode, sd, x, y, dtype)
    assert want_n == [18, 18, 18] and got_n == [36, 36, 18]
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["per_level"], want["per_level"])
    for n, g in want_g.items():
        assert torch.equal(got_g[n], g), n
    want_sd = want_m.state_dict()
    for k, v in got_m.state_dict().items():
        assert torch.equal(v, want_sd[k]), k


@pytest.mark.parametrize("mode", [False, "module", "conv"])
def test_remat_conv_recomputes_no_convolution_on_card(cuda, mode):
    """cuDNN forward convolutions inside the backward (``torch.profiler``'s
    ``aten::cudnn_convolution`` events): 0 for remat False and "conv",
    the backbone's 18 for "module"."""
    from torch.profiler import ProfilerActivity, profile

    from torch_dist_common import build_small

    sd, x, _ = _remat_inputs()
    model = build_small("unet", mode)
    model.load_state_dict(sd, strict=True)
    model = model.to("cuda", memory_format=torch.channels_last).train()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(x)
    loss = sum(z.sum() for z in out.logits_per_level)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key == "aten::cudnn_convolution")
    assert n == (18 if mode == "module" else 0)


def test_mesh_inference_on_card_two_ranks(cuda, tmp_path, monkeypatch):
    """Two gloo ranks sharing ``cuda:0``: the fold-mesh Predictor (4 folds
    of the base-width-8 UNet, 2 a rank, with and without TTA) against the
    single-process ensemble on the card (probs within rtol 1e-5, atol 1e-6,
    class maps equal; 18 kernel-2 launches per fold forward), and
    ``predict_eval`` over the data mesh at batch 4 (f32): metrics.csv
    byte-equal to one process's, only rank 0 wrote files."""
    import os

    import numpy as np

    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (  # noqa: E501
        write_synth_dataset,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        checkpoint as pckpt,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
        evaluate,
    )
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.state import (  # noqa: E501
        create_train_state,
    )
    from torch_dist_common import (
        build_small,
        mesh_inference_job,
        run_ranks,
    )

    serving, cfg, sds = _tiny_unets(monkeypatch, 4)
    sd_paths = []
    for f, sd in enumerate(sds):
        sd_paths.append(str(tmp_path / f"fold{f}.pt"))
        torch.save(sd, sd_paths[-1])
    x = np.random.default_rng(7).uniform(
        -1, 1, (2, EVAL_IMG, EVAL_IMG, 3)).astype(np.float32)
    data = str(tmp_path / "data")
    write_synth_dataset(data, EVAL_IMAGES, size=EVAL_IMG, seed=3)
    torch.manual_seed(9)
    model = build_small("unet")
    weights = str(tmp_path / "w" / "best.ckpt")
    pckpt.save_checkpoint(weights, create_train_state(model, 0.0), epoch=1,
                          loss=0.0, test_measure_mean=0.5,
                          test_measure_std=0.0)
    kw = dict(model_select=0, model_type=1, img_size=EVAL_IMG,
              num_workers=2, val_batch=4)
    save = str(tmp_path / "ranks")
    os.makedirs(save)
    ranks = run_ranks(mesh_inference_job, 2, tmp_path, sd_paths, x, kw,
                      weights, data, save, "cuda")
    for tta in (False, True):
        one = serving.Predictor(cfg, sds, device="cuda", tta=tta)(x)
        got = [r[f"tta={tta}"] for r in ranks]
        assert [g["launches"] for g in got] == [2 * 18] * 2
        for L in range(2):
            np.testing.assert_allclose(got[0]["probs"][L], one["probs"][L],
                                       rtol=1e-5, atol=1e-6)
            for g in got:
                np.testing.assert_array_equal(g["class_maps"][L],
                                              one["class_maps"][L])
        assert all("mesh-sharded" in r["export"] for r in ranks)
    monkeypatch.setattr(evaluate, "build_model",
                        lambda *a, **k: build_small("unet"))
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (  # noqa: E501
        RunConfig,
    )

    evaluate.predict_eval(
        RunConfig(tree_root="assets/class_tree_tl.json",
                  class_map="assets/class_map.csv", **kw),
        [weights], [data], str(tmp_path / "one"), device="cuda")
    with open(tmp_path / "one" / "fold_1" / "metrics.csv", "rb") as f:
        want = f.read()
    with open(os.path.join(save, "rank0", "fold_1", "metrics.csv"),
              "rb") as f:
        assert f.read() == want
    assert not os.path.exists(os.path.join(save, "rank1"))
    assert ranks[1]["eval_batch3"] == [None]

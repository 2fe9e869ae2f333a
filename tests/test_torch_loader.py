"""The port's ``data/loader.py`` against the JAX package's: the sklearn-free
splits equal ``split_ids`` (sklearn's ``train_test_split``) for every n
from 5 to 200 and raise where it raises; two epochs of ``BatchLoader``
batches equal the JAX loader's (targets exactly, images within 1e-6, as
``test_torch_dataset.py`` states); process mode equals thread mode bit for
bit; ``prefetch_to_device`` on the CPU hands the batches over unchanged.
"""
import glob

import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    dataset as jds,
)
from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    loader as jld,
)
from restrictive_hierarchical_semantic_segmentation_tpu.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    dataset as pds,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    loader as pld,
)
from torch_port_common import trees

IMAGE_ATOL = 1e-6


@pytest.mark.parametrize("test_remove", [True, False])
def test_split_ids_match_sklearn(test_remove):
    raised = 0
    for n in range(5, 201):
        try:
            want = jld.split_ids(n, False, False, test_remove)
        except ValueError:  # round(0.1 n) == 0
            raised += 1
            with pytest.raises(ValueError):
                pld.split_ids(n, False, False, test_remove)
            continue
        got = pld.split_ids(n, False, False, test_remove)
        for a, b in zip(want, got):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(b, a)
    assert raised == 1  # n = 5: round(0.5) == 0
    tr, te, va = pld.split_ids(7, True, False, True)
    np.testing.assert_array_equal(tr, np.arange(7))
    assert te is None and va is None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_split_ids_raise_where_sklearn_raises(n):
    # round(0.1 n) == 0: no validation image
    with pytest.raises(ValueError):
        jld.split_ids(n, False, False, True)
    with pytest.raises(ValueError):
        pld.split_ids(n, False, False, True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ld")
    write_synth_dataset(str(root), 7, size=64, seed=5)
    return (sorted(glob.glob(str(root / "images" / "*"))),
            sorted(glob.glob(str(root / "labels" / "*"))))


def _batches(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += [(x.copy(), y.copy()) for x, y in loader]
    return out


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 3),
                                                     (False, False, 2)])
def test_batch_loader_matches_jax(files, shuffle, drop_last, batch):
    jtree, ptree = trees("default")
    kw = dict(target_dtype=np.int8, emit_gray=True)
    jl = jld.BatchLoader(
        jds.SegDataset(*files, jtree, 32, True, True, use_native=False, **kw),
        batch, shuffle=shuffle, drop_last=drop_last, seed=3, num_workers=2)
    pl = pld.BatchLoader(pds.SegDataset(*files, ptree, 32, True, True,
                                        use_native=False, **kw),
                         batch, shuffle=shuffle, drop_last=drop_last, seed=3,
                         num_workers=2)
    try:
        assert len(pl) == len(jl)
        want, got = _batches(jl), _batches(pl)
    finally:
        jl.close()
        pl.close()
    assert len(got) == len(want) == 2 * len(pl)
    for (xa, ya), (xb, yb) in zip(want, got):
        assert xb.shape == xa.shape and yb.dtype == ya.dtype
        np.testing.assert_allclose(xb, xa, rtol=0, atol=IMAGE_ATOL)
        np.testing.assert_array_equal(yb, ya)


def test_process_mode_equals_thread_mode(files):
    _, ptree = trees("default")
    loaders = [pld.BatchLoader(pds.SegDataset(*files, ptree, 32, True, True),
                               2, shuffle=True, drop_last=True, seed=1,
                               num_workers=2, worker_mode=mode)
               for mode in ("thread", "process")]
    try:
        a, b = (_batches(ld) for ld in loaders)
    finally:
        for ld in loaders:
            ld.close()
    assert len(a) == len(b) == 6
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xb, xa)
        np.testing.assert_array_equal(yb, ya)


def test_process_mode_splits_the_cache_budget(files):
    _, ptree = trees("default")
    ds = pds.SegDataset(*files, ptree, 32, True, True, cache_bytes=1000)
    split = pld._split_cache_budget(ds, 4)
    assert split is not ds and split._cache.cap_bytes == 250
    assert ds._cache.cap_bytes == 1000
    with pytest.raises(ValueError, match="worker_mode"):
        pld.BatchLoader(ds, 2, True, True, worker_mode="fork")


def test_prefetch_to_device_on_cpu():
    rng = np.random.default_rng(0)
    batches = [(rng.random((2, 4, 4, 1), dtype=np.float32),
                rng.integers(-1, 2, (2, 4, 4, 3)).astype(np.int8))
               for _ in range(5)]
    for size in (1, 2, 8):
        got = list(pld.prefetch_to_device(iter(batches), size,
                                          torch.device("cpu")))
        assert len(got) == len(batches)
        for (x, y), (tx, ty) in zip(batches, got):
            assert tx.device.type == "cpu" and ty.dtype == torch.int8
            np.testing.assert_array_equal(tx.numpy(), x)
            np.testing.assert_array_equal(ty.numpy(), y)
    assert list(pld.prefetch_to_device(iter([]), 2)) == []

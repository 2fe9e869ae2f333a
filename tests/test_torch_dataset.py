"""The port's ``data/dataset.py`` (decode, cache, ``SegDataset``) against the
JAX package's numpy target path (``SegDataset(use_native=False)``, which
calls cv2) on the same synthetic files and seeds.

Tolerances: images within 1e-6 (the blur, jitter and resize differences
of ``test_torch_transforms.py``, doubled by normalize) outside the pixels
where the nearest affine took another source pixel than cv2; targets equal
except there.
"""
import glob
import pickle
import sys
import threading

import cv2
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    dataset as jds,
)
from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    transforms as JT,
)
from restrictive_hierarchical_semantic_segmentation_tpu.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    dataset as pds,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    transforms as PT,
)
from torch_port_common import trees

IMAGE_ATOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    write_synth_dataset(str(root), 4, size=96, seed=2)
    return (sorted(glob.glob(str(root / "images" / "*"))),
            sorted(glob.glob(str(root / "labels" / "*"))))


def _moved(jd, index, rng_seed, s):
    """Pixels where the JAX and port nearest affines pick different source
    pixels for this sample (none, or the disagreement the transforms test
    bounds)."""
    rng = np.random.default_rng(rng_seed)
    if not jd.augment:
        return np.zeros((s, s), bool)
    rng.uniform(0.001, 2.0)
    rng.uniform()
    prm = JT.sample_affine(rng)
    probe = np.arange(s * s, dtype=np.float32).reshape(s, s)
    return JT.affine_nearest(probe, prm, -1.0) != \
        PT.affine_nearest(probe, prm, -1.0)


@pytest.mark.parametrize("size", [32, 64, 96])
@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("hier", [True, False])
def test_segdataset_matches_jax(files, hier, augment, size):
    imgs, labs = files
    jtree, ptree = trees("default")
    for compact in (True, False):
        kw = dict(emit_gray=compact,
                  target_dtype=np.int8 if compact else np.float32)
        jd = jds.SegDataset(imgs, labs, jtree, size, hier, augment,
                            use_native=False, **kw)
        pd = pds.SegDataset(imgs, labs, ptree, size, hier, augment, **kw)
        assert pd.num_target_channels == jd.num_target_channels
        for i in range(len(imgs)):
            for _ in range(2):  # the second read comes from the caches
                xa, ya = jd.__getitem__(i, np.random.default_rng(i))
                xb, yb = pd.__getitem__(i, np.random.default_rng(i))
                assert xb.shape == xa.shape and xb.dtype == xa.dtype
                assert yb.shape == ya.shape and yb.dtype == ya.dtype
                keep = ~_moved(jd, i, i, size)
                np.testing.assert_allclose(xb[keep], xa[keep], rtol=0,
                                           atol=IMAGE_ATOL)
                np.testing.assert_array_equal(yb[keep], ya[keep])


def test_native_targets_are_a_later_slice(files):
    _, ptree = trees("default")
    with pytest.raises(NotImplementedError, match="item 6"):
        pds.SegDataset(*files, ptree, 32, True, True, use_native=True)


def test_decode_image_and_mask_match_cv2(files, tmp_path):
    imgs, labs = files
    for path in imgs[:2]:
        np.testing.assert_array_equal(pds.decode_image(path),
                                      jds.decode_image(path))
        np.testing.assert_array_equal(pds.decode_image_compact(path),
                                      jds.decode_image_compact(path))
    for path in labs[:2]:
        np.testing.assert_array_equal(pds.decode_mask(path),
                                      jds.decode_mask(path))
    # cv2-written files: Paeth/Sub rows, 16-bit gray, colour
    rng = np.random.default_rng(0)
    g16 = str(tmp_path / "g16.png")
    cv2.imwrite(g16, rng.integers(0, 65536, (23, 31), dtype=np.uint16))
    np.testing.assert_array_equal(pds.decode_mask(g16), jds.decode_mask(g16))
    rgb = str(tmp_path / "rgb.png")
    cv2.imwrite(rgb, rng.integers(0, 256, (23, 31, 3), dtype=np.uint8))
    np.testing.assert_array_equal(pds.decode_image(rgb), jds.decode_image(rgb))
    with pytest.raises(ValueError, match="colour mask"):
        pds.decode_mask(rgb)
    with pytest.raises(FileNotFoundError):
        pds.decode_mask(str(tmp_path / "missing.png"))


def test_byte_capped_cache():
    c = pds.ByteCappedCache(100)
    c["a"] = np.zeros(10, np.float32)  # 40 bytes
    c["b"] = np.zeros(10, np.float32)  # 80
    c["c"] = np.zeros(10, np.float32)  # would be 120: not cached
    c["a"] = np.ones(20, np.float32)  # present keys are not replaced
    assert len(c) == 2 and "c" not in c and c.nbytes == 80
    assert c.get("a").sum() == 0 and c.get("c", 7) == 7


def test_byte_capped_cache_under_concurrent_inserts():
    # more threads than cores, a short switch interval: a lost update of
    # the byte count would break the invariant
    c = pds.ByteCappedCache(64 * 40)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda t=t: [
            c.__setitem__((t, i), np.zeros(10, np.float32))
            for i in range(50)]) for t in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(c) == 64 and c.nbytes == 64 * 40
    # a process worker's pickled copy works and has its own lock
    d = pickle.loads(pickle.dumps(c))
    d[("new", 0)] = np.zeros(1, np.float32)
    assert len(d) == 64 and d.nbytes == c.nbytes

"""The port's native C++ sample factory (``data/native.py`` on
``csrc/sample_factory.cpp``) against the port's numpy target path, as
``tests/test_native_runtime.py`` holds the JAX one, and against the JAX
package's native bridge; its build (g++ into ``build/native/``, a content
digest in the name, concurrent builds, a failing compiler raises).

Tolerance: none on these inputs. The JAX test allows 0.5 % (1 % with the
affine) of pixels to differ, because cv2's fixed-point bilinear resize and
the library's float one may fall on either side of 0.5; the port's numpy
path resizes in float (``F.interpolate``) and takes the same side on every
pixel here. The two affine gathers round a source coordinate at a
half-pixel tie differently (the library in float64 half away from zero,
the numpy path cv2's float32 half to even), which moves 2 of 5,947,392
target values on 48 augmented 352 px samples and none here.
"""
import glob
import threading

import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    native as jnative,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    native,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    transforms as T,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.dataset import (
    SegDataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    synth_sample,
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.target_factory import (
    leaf_masks,
    node_masks,
    ternary_encode,
)
from torch_port_common import trees


def numpy_reference(mask, tree, size, hier, hflip=False, aff=None):
    y = (node_masks(mask, tree) if hier else leaf_masks(mask, tree)).astype(
        np.float32)
    y = T.resize_bilinear_np(y, (size, size))
    if hflip:
        y = T.hflip(y)
    if aff is not None:
        fills = np.full(y.shape[-1], -1.0, np.float32)
        fills[0] = y[..., 0].max()
        y = T.affine_nearest(y, aff, fills)
    y = (y >= 0.5).astype(np.float32)
    return ternary_encode(y, tree) if hier else y


@pytest.mark.parametrize("hier", [True, False])
@pytest.mark.parametrize("hflip", [False, True])
def test_native_matches_numpy_no_affine(hier, hflip):
    _, tree = trees("default")
    _, mask = synth_sample(np.random.default_rng(0), 96)
    tables = native.ChannelTables(tree, hier)
    got = native.make_target_native(mask, tables, 64, hflip=hflip)
    np.testing.assert_array_equal(
        got, numpy_reference(mask, tree, 64, hier, hflip=hflip))


@pytest.mark.parametrize("hflip", [False, True])
def test_native_matches_numpy_with_affine(hflip):
    _, tree = trees("default")
    _, mask = synth_sample(np.random.default_rng(1), 96)
    aff = T.sample_affine(np.random.default_rng(7))
    m = T.affine_forward_matrix(aff, 64, 64)
    tables = native.ChannelTables(tree, True)
    got = native.make_target_native(mask, tables, 64, hflip=hflip,
                                    affine_matrix=m)
    np.testing.assert_array_equal(
        got, numpy_reference(mask, tree, 64, True, hflip=hflip, aff=aff))
    assert set(np.unique(got)) <= {-1.0, 0.0, 1.0}
    i8 = native.make_target_native(mask, tables, 64, hflip=hflip,
                                   affine_matrix=m, dtype=np.int8)
    assert i8.dtype == np.int8
    np.testing.assert_array_equal(i8.astype(np.float32), got)


def test_native_extended_tree():
    _, tree = trees("extended")
    _, mask = synth_sample(np.random.default_rng(2), 96)
    tables = native.ChannelTables(tree, True)
    got = native.make_target_native(mask, tables, 48)
    np.testing.assert_array_equal(got,
                                  numpy_reference(mask, tree, 48, True))


def test_bits_and_targets_equal_the_jax_bridge():
    jtree, ptree = trees("default")
    _, mask = synth_sample(np.random.default_rng(4), 96)
    aff = T.sample_affine(np.random.default_rng(9))
    m = T.affine_forward_matrix(aff, 64, 64)
    for hier in (True, False):
        jt = jnative.ChannelTables(jtree, hier)
        pt = native.ChannelTables(ptree, hier)
        for name in ("nvals", "vals", "parent"):
            np.testing.assert_array_equal(getattr(pt, name),
                                          getattr(jt, name))
        bits = native.mask_bits(mask, pt, 64)
        np.testing.assert_array_equal(bits, jnative.mask_bits(mask, jt, 64))
        for dtype in (np.float32, np.int8):
            np.testing.assert_array_equal(
                native.expand_bits(bits, pt, True, m, dtype=dtype),
                jnative.expand_bits(bits, jt, True, m, dtype=dtype))


def test_refusals():
    _, tree = trees("default")
    tables = native.ChannelTables(tree, True)
    bits = native.mask_bits(np.zeros((8, 8), np.uint8), tables, 8)
    with pytest.raises(ValueError, match="float32 or int8"):
        native.expand_bits(bits, tables, dtype=np.float16)
    with pytest.raises(ValueError, match="expected \\(h, w\\)"):
        native.mask_bits(np.zeros((8, 8, 1), np.uint8), tables, 8)


def test_dataset_uses_native_consistently(tmp_path):
    """Seed for seed, the native and numpy datasets give the same images
    and targets, with and without a vertical flip (where the native
    dataset takes the numpy path)."""
    _, tree = trees("default")
    write_synth_dataset(str(tmp_path), 2, size=96, seed=3)
    imgs = sorted(glob.glob(str(tmp_path / "images" / "*")))
    labs = sorted(glob.glob(str(tmp_path / "labels" / "*")))
    for vflip in (False, True):
        ds_n = SegDataset(imgs, labs, tree, 64, True, augment=True,
                          vflip=vflip)
        ds_p = SegDataset(imgs, labs, tree, 64, True, augment=True,
                          vflip=vflip, use_native=False)
        for seed in range(4):
            for i in range(len(imgs)):
                xn, yn = ds_n.__getitem__(i, np.random.default_rng(seed))
                xp, yp = ds_p.__getitem__(i, np.random.default_rng(seed))
                np.testing.assert_array_equal(xn, xp)
                np.testing.assert_array_equal(yn, yp)


def test_build_names_digest_and_survives_concurrent_builds(tmp_path,
                                                           monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libsample_factory-") and path.suffix == ".so"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    target = tmp_path / "native" / path.name
    errors = []

    def build():
        try:
            native._build(target)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert [p.name for p in (tmp_path / "native").iterdir()] == [path.name]


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native._build(tmp_path / "native" / "libx.so")

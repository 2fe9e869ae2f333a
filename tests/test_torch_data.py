"""The port's numpy data modules against the JAX package's: the target
factory (leaf and node masks, ternary encoding) must be equal; the
synthetic generator draws the same random numbers in the same order, but
rasterizes its ellipses by an inequality and blurs with a separable 5-tap
Gaussian where the JAX module calls OpenCV, so its masks agree with the
JAX module's on >= 98.5 % of pixels at 96 px (ellipse edges differ; the
share grows with the size), its images by < 2 grey levels on average, its
pixel codes are the class map's, and the samples after it stay in step."""
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    synthetic as jsyn,
    target_factory as jtf,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    synthetic as tsyn,
    target_factory as ttf,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    decode_png,
)
from torch_port_common import trees

CODES = {0, 212, 255, 127, 170, 85, 42}


@pytest.mark.parametrize("name", ["default", "extended"])
def test_target_factory_equals_jax(name):
    jt, pt = trees(name)
    rng = np.random.default_rng(0)
    codes = np.array([v for v in pt.pixel_value.values() if v is not None],
                     np.uint8)
    mask = rng.choice(codes, size=(23, 31))
    mask[0, :5] = 3  # a pixel value outside the class map: no class
    np.testing.assert_array_equal(ttf.leaf_masks(mask, pt),
                                  jtf.leaf_masks(mask, jt))
    nodes = ttf.node_masks(mask, pt)
    np.testing.assert_array_equal(nodes, jtf.node_masks(mask, jt))
    np.testing.assert_array_equal(ttf.ternary_encode(nodes, pt),
                                  jtf.ternary_encode(nodes, jt))


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_sample_tracks_the_jax_generator(hard):
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        jimg, jmask = jsyn.synth_sample(jrng, 96, hard=hard)
        timg, tmask = tsyn.synth_sample(trng, 96, hard=hard)
        assert timg.dtype == tmask.dtype == np.uint8
        assert timg.shape == tmask.shape == (96, 96)
        assert set(np.unique(tmask)) <= CODES
        assert (tmask == jmask).mean() >= 0.985
        assert np.abs(timg.astype(int) - jimg.astype(int)).mean() < 2
    # the same draws in the same order: the generators end in step
    assert trng.uniform() == jrng.uniform()


def test_fill_ellipse_and_blur():
    img = np.zeros((21, 21), np.float32)
    tsyn.fill_ellipse(img, (10, 10), (6, 3), 0, 1.0)
    assert img[10, 4] == img[10, 16] == img[7, 10] == 1.0
    assert img[10, 3] == img[6, 10] == 0.0
    rotated = np.zeros_like(img)
    tsyn.fill_ellipse(rotated, (10, 10), (6, 3), 90, 1.0)
    np.testing.assert_array_equal(rotated, img.T)
    blurred = tsyn.gaussian_blur5(img)
    assert blurred.shape == img.shape
    np.testing.assert_allclose(blurred.sum(), img.sum(), rtol=0.05)
    const = np.full((9, 7), 3.0, np.float32)
    np.testing.assert_allclose(tsyn.gaussian_blur5(const), const, rtol=1e-6)


def test_write_synth_dataset_round_trips(tmp_path):
    tsyn.write_synth_dataset(str(tmp_path), 2, size=40, seed=3, folds=1)
    rng = np.random.default_rng(3)
    for i in range(2):
        img, mask = tsyn.synth_sample(rng, 40)
        d = tmp_path / "fold_1" / "train"
        for sub, want in (("images", img), ("labels", mask)):
            got = decode_png((d / sub / f"{i:04d}.png").read_bytes())
            np.testing.assert_array_equal(got, want)
    assert len(list((tmp_path / "fold_1" / "val" / "images").iterdir())) == 2

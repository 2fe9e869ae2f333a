"""The port's cv2-free train transforms (``data/transforms.py``) against the
JAX package's, which call cv2, on the same seeded numpy inputs.

Tolerances: the random draws are equal and leave the generators in step;
flip and normalize are bit-equal; the bilinear resize is bit-equal at the
sizes the trainer meets in these tests (the same size, reductions by 3)
and within 5e-5 elsewhere (``F.interpolate`` against cv2's float32
coordinates and its area path for halving);
blur and jitter within 1e-6; the nearest affine takes another source pixel
than cv2 on at most 1e-4 of the pixels, and never at the fill border.
"""
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    transforms as J,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    transforms as P,
)

BLUR_JITTER_ATOL = 1e-6
AFFINE_SHARE = 1e-4
RESIZE_ATOL = 5e-5


def _img(rng, s, c):
    return rng.random((s, s, c), dtype=np.float32)


@pytest.mark.parametrize("seed", range(5))
def test_draws_are_the_same_and_leave_the_generators_in_step(seed):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    a, b = J.sample_affine(rj), P.sample_affine(rp)
    assert (a.angle, a.translate, a.scale, a.shear) == \
        (b.angle, b.translate, b.scale, b.shear)
    np.testing.assert_array_equal(J.affine_forward_matrix(a, 40, 30),
                                  P.affine_forward_matrix(b, 40, 30))
    x = _img(np.random.default_rng(100 + seed), 16, 3)
    J.color_jitter(x, rj)
    P.color_jitter(x, rp)
    assert rj.uniform() == rp.uniform()


@pytest.mark.parametrize("shape,size", [
    ((96, 96, 1), 32), ((96, 96, 8), 32), ((99, 66, 9), 33),
    ((352, 352, 1), 352), ((40, 40, 3), 40)])
def test_resize_is_bit_equal_at_the_trainers_sizes(shape, size):
    x = _img(np.random.default_rng(1), shape[0], shape[2])
    want = J.resize_bilinear_np(x, (size, size))
    got = P.resize_bilinear_np(x, (size, size))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("shape,size", [((64, 64, 3), 48),
                                        ((620, 620, 1), 352),
                                        ((64, 64, 9), 32),
                                        ((40, 40, 1), 64)])
def test_resize_at_other_ratios_within_tolerance(shape, size):
    x = _img(np.random.default_rng(2), shape[0], shape[2])
    want = J.resize_bilinear_np(x, (size, size))
    got = P.resize_bilinear_np(x, (size, size))
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=RESIZE_ATOL)


def test_flip_and_normalize_are_bit_equal():
    x = _img(np.random.default_rng(3), 33, 3)
    np.testing.assert_array_equal(P.hflip(x), J.hflip(x))
    np.testing.assert_array_equal(P.normalize(x), J.normalize(x))
    assert P.hflip(x).flags.c_contiguous


@pytest.mark.parametrize("size", [5, 12, 13, 32, 96, 352])
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur_matches_cv2(size, channels):
    rng = np.random.default_rng(size * 10 + channels)
    for _ in range(3):
        x = _img(rng, size, channels)
        sigma = rng.uniform(0.001, 2.0)
        want = J.gaussian_blur(x, sigma)
        got = P.gaussian_blur(x, sigma)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_JITTER_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_color_jitter_matches_cv2(channels):
    rng = np.random.default_rng(channels)
    for i in range(60):
        x = _img(rng, 24, channels)
        if channels == 3 and i % 4 == 0:
            x[..., 1] = x[..., 0]  # ties between channels: hue sectors
        want = J.color_jitter(x, np.random.default_rng(i))
        got = P.color_jitter(x, np.random.default_rng(i))
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=BLUR_JITTER_ATOL)


def test_hue_and_gray_helpers_match_cv2():
    x = _img(np.random.default_rng(4), 48, 3)
    np.testing.assert_allclose(P._grayscale(x), J._grayscale(x), rtol=0,
                               atol=BLUR_JITTER_ATOL)
    for f in (-0.01, 0.0031, 0.01):
        np.testing.assert_allclose(P._adjust_hue(x, f), J._adjust_hue(x, f),
                                   rtol=0, atol=BLUR_JITTER_ATOL)


def test_affine_nearest_matches_cv2():
    rng = np.random.default_rng(5)
    total = differ = 0
    for i in range(40):
        s = int(rng.choice([32, 64, 96, 352]))
        c = int(rng.choice([1, 3]))
        x = _img(rng, s, c)
        prm = J.sample_affine(np.random.default_rng(i))
        want = J.affine_nearest(x, prm, -1.0)
        got = P.affine_nearest(x, prm, -1.0)
        assert got.shape == want.shape and got.dtype == want.dtype
        want = want.reshape(s, s, -1)
        got = got.reshape(s, s, -1)
        # the fill border: pixels filled on one side are filled on the other
        np.testing.assert_array_equal((got == -1).all(-1),
                                      (want == -1).all(-1))
        total += s * s
        differ += int((got != want).any(-1).sum())
    assert differ <= AFFINE_SHARE * total, (differ, total)


def test_affine_nearest_shapes_and_fills():
    x = _img(np.random.default_rng(6), 40, 3)
    prm = J.sample_affine(np.random.default_rng(7))
    two = P.affine_nearest(x[..., 0], prm, 2.0)
    assert two.shape == (40, 40)
    np.testing.assert_array_equal(two, J.affine_nearest(x[..., 0], prm, 2.0))
    # one fill per channel equals one call per channel (the dataset's use)
    fills = [5.0, -1.0, 0.25]
    per = P.affine_nearest(x, prm, fills)
    for ch, f in enumerate(fills):
        np.testing.assert_array_equal(
            per[..., ch], P.affine_nearest(np.ascontiguousarray(x[..., ch]),
                                           prm, f))

"""The port's ``data/device_augment.py`` (the device-resident training set
of ``--device-data True``) on the CPU, against the JAX package's
``data/device_augment.py`` and the port's own host chain.

Tolerances:
* against JAX ``augment_sample`` on the same ``AugmentParams`` (fixed, and
  20 random draws): the image within 1e-5 on at least 99.5 % of pixels,
  the targets equal on at least 99.5 % (the inverse matrix is a closed
  form where JAX calls ``jnp.linalg.inv``, so a pixel at a half-pixel tie
  may take another source); at the identity affine the targets exactly and
  the image within 1e-5 everywhere;
* against the port's host chain (``data/transforms.py``) with the JAX
  test's bounds (``tests/test_device_augment.py``): images within 2e-2 on
  more than 97 % of pixels and targets on more than 97 % at the fixed
  draw, more than 95 % over 20 random draws, and at the identity affine
  the targets exactly and the image within 1e-3.
"""
import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.data import (
    device_augment as JD,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    device_augment as PD,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data import (
    transforms as PT,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.synthetic import (
    write_synth_dataset,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.target_factory import (
    ternary_encode as np_ternary_encode,
)
from torch_port_common import trees

S = 64
JAX_IMAGE_ATOL, JAX_SHARE = 1e-5, 0.995
HOST_IMAGE_ATOL = 2e-2

FIXED = dict(sigma=1.3, brightness=1.2, contrast=0.8, bc_order=False,
             do_hflip=True, angle=17.0, tx=5.0, ty=-8.0, scale=1.05,
             shear=-3.0)
IDENTITY = dict(FIXED, angle=0.0, tx=0.0, ty=0.0, scale=1.0, shear=0.0)


def _random_draws(n=20, seed=11):
    rng = np.random.default_rng(seed)
    return [dict(sigma=float(rng.uniform(0.001, 2.0)),
                 brightness=float(rng.uniform(0.6, 1.4)),
                 contrast=float(rng.uniform(0.5, 1.5)),
                 bc_order=bool(rng.uniform() > 0.5),
                 do_hflip=bool(rng.uniform() > 0.5),
                 angle=float(rng.uniform(-50, 50)),
                 tx=float(rng.uniform(-20, 20)),
                 ty=float(rng.uniform(-20, 20)),
                 scale=float(rng.uniform(0.85, 1.15)),
                 shear=float(rng.uniform(-5, 5))) for _ in range(n)]


@pytest.fixture(scope="module")
def sample():
    jtree, _ = trees("default")
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (S, S, 1)).astype(np.float32)
    y = (rng.uniform(0, 1, (S, S, jtree.num_classes)) > 0.6).astype(
        np.float32)
    y[..., 0] = 1  # background present
    return img, y


def _port(img, y, draw, tree):
    p = PD.AugmentParams(**{k: torch.tensor([v]) for k, v in draw.items()})
    x, t = PD.augment_sample(torch.from_numpy(img)[None],
                             torch.from_numpy(y)[None], p, tree, True)
    assert x.shape == (1,) + img.shape and t.dtype == torch.float32
    return x[0].numpy(), t[0].numpy()


def _jax(img, y, draw, tree):
    p = JD.AugmentParams(**{k: jnp.asarray(v) for k, v in draw.items()})
    x, t = JD.augment_sample(img, y, p, tree, True)
    return np.asarray(x), np.asarray(t)


@pytest.mark.parametrize("which", ["fixed", "random"])
def test_augment_sample_matches_jax(sample, which):
    img, y = sample
    jtree, ptree = trees("default")
    draws = [FIXED] if which == "fixed" else _random_draws()
    for draw in draws:
        xp, yp = _port(img, y, draw, ptree)
        xj, yj = _jax(img, y, draw, jtree)
        share = (np.abs(xp - xj) <= JAX_IMAGE_ATOL).mean()
        assert share >= JAX_SHARE, (draw, share)
        assert (yp == yj).mean() >= JAX_SHARE, draw


def test_identity_affine_matches_jax_exactly(sample):
    img, y = sample
    jtree, ptree = trees("default")
    xp, yp = _port(img, y, IDENTITY, ptree)
    xj, yj = _jax(img, y, IDENTITY, jtree)
    np.testing.assert_allclose(xp, xj, rtol=0, atol=JAX_IMAGE_ATOL)
    np.testing.assert_array_equal(yp, yj)


def _host_chain(img01, y01, p, tree):
    """The port's host chain with the same explicit parameters."""
    x = PT.gaussian_blur(img01, p["sigma"])
    ops = [lambda v: np.clip(v * p["brightness"], 0, 1),
           lambda v: np.clip(v.mean() + (v - v.mean()) * p["contrast"], 0, 1)]
    if p["bc_order"]:
        ops = ops[::-1]
    for op in ops:
        x = op(x).astype(np.float32)
    x = PT.normalize(x)
    y = y01.astype(np.float32)
    if p["do_hflip"]:
        x, y = PT.hflip(x), PT.hflip(y)
    ap = PT.AffineParams(p["angle"], (p["tx"], p["ty"]), p["scale"],
                         p["shear"])
    x = PT.affine_nearest(x, ap, fill=-1.0)
    fills = np.full(y.shape[-1], -1.0, np.float32)
    fills[0] = y[..., 0].max()
    y = PT.affine_nearest(y, ap, fills)
    return x, np_ternary_encode((y >= 0.5).astype(np.float32), tree)


@pytest.mark.parametrize("which,bound", [("fixed", 0.97), ("random", 0.95)])
def test_device_chain_matches_host_chain(sample, which, bound):
    img, y = sample
    _, ptree = trees("default")
    draws = [FIXED] if which == "fixed" else _random_draws()
    for draw in draws:
        xd, yd = _port(img, y, draw, ptree)
        xh, yh = _host_chain(img, y, draw, ptree)
        assert xd.shape == xh.shape and yd.shape == yh.shape
        assert np.isclose(xd, xh, atol=HOST_IMAGE_ATOL).mean() > bound, draw
        assert (yd == yh).mean() > bound, draw


def test_identity_affine_matches_host_chain_exactly(sample):
    img, y = sample
    _, ptree = trees("default")
    xd, yd = _port(img, y, IDENTITY, ptree)
    xh, yh = _host_chain(img, y, IDENTITY, ptree)
    np.testing.assert_allclose(xd, xh, atol=1e-3)
    np.testing.assert_array_equal(yd, yh)


@pytest.mark.parametrize("name", ["default", "extended"])
def test_ternary_encode_matches_numpy(name):
    _, ptree = trees(name)  # depth 2 and depth 4
    rng = np.random.default_rng(0)
    y = (rng.uniform(0, 1, (3, 16, 16, ptree.num_classes)) > 0.5).astype(
        np.float32)
    np.testing.assert_array_equal(
        PD.ternary_encode(torch.from_numpy(y), ptree).numpy(),
        np_ternary_encode(y, ptree))


def test_sample_params_ranges():
    p = PD.sample_params(torch.Generator().manual_seed(0), 500)
    for name, lo, hi in (("sigma", 0.001, 2.0), ("brightness", 0.6, 1.4),
                         ("contrast", 0.5, 1.5), ("angle", -50, 50),
                         ("tx", -20, 20), ("ty", -20, 20),
                         ("scale", 0.85, 1.15), ("shear", -5, 5)):
        v = getattr(p, name)
        assert v.shape == (500,) and v.dtype == torch.float32, name
        assert lo <= float(v.min()) and float(v.max()) <= hi, name
    for name in ("bc_order", "do_hflip"):
        v = getattr(p, name)
        assert v.dtype == torch.bool and 0 < int(v.sum()) < 500, name
    again = PD.sample_params(torch.Generator().manual_seed(0), 500)
    assert all(torch.equal(a, b) for a, b in zip(p, again))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("dd")
    write_synth_dataset(str(root), 7, size=48, seed=2, folds=1)
    base = root / "fold_1" / "train"
    return (sorted(glob.glob(str(base / "images" / "*"))),
            sorted(glob.glob(str(base / "labels" / "*"))))


def test_device_dataset_reshuffles_and_repeats(files):
    imgs, labs = files
    _, ptree = trees("default")
    ds = PD.DeviceDataset(imgs, labs, ptree, 32, True, batch_size=2, seed=0,
                          device="cpu")
    assert ds.nbytes == len(imgs) * 32 * 32 * (4 + ptree.num_classes)

    def epoch(e):
        ds.set_epoch(e)
        return [(x.clone(), y.clone()) for x, y in ds]

    b1 = epoch(1)
    assert len(b1) == len(ds) == len(imgs) // 2  # the partial batch dropped
    x, y = b1[0]
    assert x.shape == (2, 32, 32, 1) and x.dtype == torch.float32
    assert y.shape == (2, 32, 32, ptree.num_classes)
    assert set(torch.unique(y).tolist()) <= {-1.0, 0.0, 1.0}
    assert -1.0 - 1e-6 <= float(x.min()) and float(x.max()) <= 1.0 + 1e-6
    b2 = epoch(2)
    assert not torch.allclose(b1[0][0], b2[0][0])
    for (xa, ya), (xb, yb) in zip(b1, epoch(1)):  # same (seed, epoch)
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
    # the host's permutation is the JAX dataset's
    ds.set_epoch(3)
    perm = np.random.default_rng(0 + 3).permutation(len(imgs))
    assert PD.batch_seed(0, 3, 1) != PD.batch_seed(0, 3, 0)
    gen = torch.Generator().manual_seed(PD.batch_seed(0, 3, 1))
    want = PD.make_augment_fn(ptree, True)(
        gen, ds._images[perm[2:4]], ds._masks[perm[2:4]].float())
    got = list(ds)[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_device_dataset_refuses_colour_and_defaults_to_cuda(files, tmp_path):
    imgs, labs = files
    _, ptree = trees("default")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PD.DeviceDataset(imgs, labs, ptree, 32, True, batch_size=2)
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
        _chunk, PNG_SIGNATURE,
    )
    import struct
    import zlib

    rgb = np.zeros((8, 8 * 3 + 1), np.uint8)
    png = (PNG_SIGNATURE
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rgb.tobytes()))
           + _chunk(b"IEND", b""))
    colour = tmp_path / "colour.png"
    colour.write_bytes(png)
    with pytest.raises(ValueError, match="grayscale sources only"):
        PD.load_base_arrays([str(colour)], labs[:1], ptree, 32, True)


def test_load_base_arrays_matches_jax(files):
    imgs, labs = files
    jtree, ptree = trees("default")
    for hier in (True, False):
        xj, yj = JD.load_base_arrays(imgs, labs, jtree, 32, hier)
        xp, yp = PD.load_base_arrays(imgs, labs, ptree, 32, hier)
        assert xp.shape == xj.shape and yp.shape == yj.shape
        assert xp.dtype == np.float32 and yp.dtype == np.uint8
        # the cv2-free resize: within 5e-5 of cv2's (test_torch_transforms);
        # no mask pixel of these files lands on the other side of 0.5
        np.testing.assert_allclose(xp, xj, rtol=0, atol=5e-5)
        np.testing.assert_array_equal(yp, yj)

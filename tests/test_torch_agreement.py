"""The port's agreement CLI (``cli/agreement.py``) against the JAX
package's, on the same synthetic masks: the report dicts to 1e-12 and the
printed text equal, over the fixture of ``tests/test_agreement_oracle.py``
(casefold slot order, the Td/Rd split, per-patient filtering, the 'ofr'
exclusion, equal-shape, downscale and upscale ground truths, the
fn == fp == 0 quirk), with ``--ap-only``, ``--conf-intervals`` and
``--reproducibility``; its numpy resize and interval against the JAX
module's scipy ones; its mask reader against ``cv2.imread(...,
IMREAD_GRAYSCALE)``, exactly."""
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    agreement as jag,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    agreement as pag,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    PNG_SIGNATURE,
    _chunk,
)

ATOL = 1e-12
PRED_MODS = ["AP12A", "AP12P", "AP40A", "AP40P", "AP100A", "AP100P",
             "AP200A", "AP200P", "ISO100", "ISO200", "ISO300", "ISO400",
             "OFC40", "TSCAN100A", "TSCAN100B", "OFR200"]


def _blob(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(4, h // 3), rng.integers(4, w // 3)
        yy, xx = np.ogrid[:h, :w]
        m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = 255
    return m


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """tests/test_agreement_oracle.py's layout: patient 3 equal shapes,
    5 a downscaled ground truth, 7 an upscaled one, and one prediction
    identical to its ground truth."""
    root = tmp_path_factory.mktemp("agreement")
    pred_dir, gt_dir = root / "preds", root / "gt"
    pred_dir.mkdir(), gt_dir.mkdir()
    rng = np.random.default_rng(42)
    for pat, gt_shape in (("3", (64, 64)), ("5", (96, 80)), ("7", (48, 40))):
        for series in ("Td", "Rd"):
            gt = _blob(rng, *gt_shape)
            cv2.imwrite(str(gt_dir / f"z{pat}{series}-OFR200.png"), gt)
            for mod in PRED_MODS:
                pm = (gt.copy() if (pat, series, mod) == ("3", "Td", "AP12A")
                      else _blob(rng, 64, 64))
                cv2.imwrite(str(pred_dir / f"z{pat}{series}-{mod}.png"), pm)
    return str(pred_dir), str(gt_dir)


def _assert_reports_equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_reports_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=0, atol=ATOL)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=0, atol=ATOL)


def _both(capsys, fn_name, *args, **kw):
    want = getattr(jag, fn_name)(*args, **kw)
    want_out = capsys.readouterr().out
    got = getattr(pag, fn_name)(*args, **kw)
    got_out = capsys.readouterr().out
    return got, want, got_out, want_out


@pytest.mark.parametrize("ap_only", [False, True])
@pytest.mark.parametrize("conf_intervals", [False, True])
def test_run_agreement_matches_jax(fixture, capsys, ap_only, conf_intervals):
    pred_dir, gt_dir = fixture
    got, want, got_out, want_out = _both(
        capsys, "run_agreement", pred_dir, gt_dir, ["OFR200"],
        ap_only=ap_only, conf_intervals=conf_intervals)
    _assert_reports_equal(got, want)
    n_mods = 4 if ap_only else 10
    assert all(len(got["OFR200"][k]) == n_mods
               for k in ("agreement", "fn", "fp"))
    assert got_out == want_out
    # the fn == fp == 0 quirk reached the table: AP12's mean is pulled
    # below the other slots' by one 0.0
    assert 0.0 < got["OFR200"]["agreement"]["AP12"][0] < 1.0


def test_run_reproducibility_matches_jax(fixture, capsys):
    pred_dir, _ = fixture
    got, want, got_out, want_out = _both(capsys, "run_reproducibility",
                                         pred_dir)
    _assert_reports_equal(got, want)
    assert len(got) == 11 and got_out == want_out


def test_main_argv_matches_jax(fixture, capsys):
    pred_dir, gt_dir = fixture
    argv = ["--mask-root", pred_dir, "--ofr-gt-masks", gt_dir,
            "--list-of-ofr", "['OFR200']", "--ap-only", "False",
            "--conf-intervals", "True", "--reproducibility", "True"]
    got, want, got_out, want_out = _both(capsys, "main", argv)
    _assert_reports_equal(got, want)
    assert got_out == want_out and "REPRODUCIBILITY" in got_out


def test_agreement_cli_e2e_masks(tmp_path):
    """tests/test_e2e.py's synthetic pair: 0.75, and the quirk's 0."""
    a = np.zeros((32, 32), np.uint8)
    a[8:24, 8:24] = 255
    b = np.zeros((32, 32), np.uint8)
    b[8:24, 12:28] = 255
    agr, fn, fp = pag.agreement_from_masks(a, b)
    np.testing.assert_allclose((agr, fn, fp), (0.75, 0.25, 0.25))
    assert pag.agreement_from_masks(a, a)[0] == 0.0
    pred_dir, gt_dir = tmp_path / "preds", tmp_path / "gt"
    pred_dir.mkdir(), gt_dir.mkdir()
    for series in ("Td", "Rd"):
        for n in PRED_MODS[:8]:
            cv2.imwrite(str(pred_dir / f"z1{series}-{n}.png"), a)
        cv2.imwrite(str(gt_dir / f"z1{series}-OFR200.png"), b)
    rep = pag.run_agreement(str(pred_dir), str(gt_dir), ["OFR200"],
                            ap_only=True)
    np.testing.assert_allclose(rep["OFR200"]["agreement"]["AP12"][0], 0.75)


@pytest.mark.parametrize("src,dst", [((96, 80), (64, 64)),
                                     ((48, 40), (64, 64)),
                                     ((7, 1), (5, 3)), ((1, 1), (4, 4))])
def test_resize_matches_scipy(src, dst):
    img = np.random.default_rng(0).uniform(0, 1, src)
    np.testing.assert_allclose(pag._resize_bilinear_skimage(img, dst),
                               jag._resize_bilinear_skimage(img, dst),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_mean_confidence_interval_matches_scipy(n):
    data = np.random.default_rng(n).uniform(0, 1, n)
    with np.errstate(invalid="ignore", divide="ignore"):
        got = pag.mean_confidence_interval(data)
        want = jag.mean_confidence_interval(data)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)  # nan at n=1


def _png(path, body_rows, width, height, depth, color, extra=b""):
    raw = np.concatenate([np.zeros((height, 1), np.uint8), body_rows], 1)
    path.write_bytes(
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                      color, 0, 0, 0))
        + extra + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
        + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb8", "rgba8",
                                  "rgb16", "rgba16"])
def test_imread_gray_matches_cv2(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    deep = kind.endswith("16")
    ch = {"gray": 1, "rgb": 3, "rgba": 4}[kind[:-1] if not deep
                                            else kind[:-2]]
    hi = 65536 if deep else 256
    img = rng.integers(0, hi, (37, 29, ch)).astype(
        np.uint16 if deep else np.uint8)
    img[:5, :5, :] = img[:5, :5, :1]  # some gray pixels in colour files
    path = tmp_path / f"{kind}.png"
    # cv2 writes BGR(A)
    cv2.imwrite(str(path), img[..., [2, 1, 0, 3][:ch]] if ch > 1
                else img[..., 0])
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    got = pag.imread_gray(str(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_imread_gray_none_and_refusals(tmp_path):
    missing = str(tmp_path / "missing.png")
    assert pag.imread_gray(missing) is None
    assert cv2.imread(missing, cv2.IMREAD_GRAYSCALE) is None
    junk = tmp_path / "junk.png"
    junk.write_bytes(PNG_SIGNATURE + b"xxxxgarbage")
    assert pag.imread_gray(str(junk)) is None
    assert cv2.imread(str(junk), cv2.IMREAD_GRAYSCALE) is None
    text = tmp_path / "notes.png"
    text.write_bytes(b"not an image at all")
    assert pag.imread_gray(str(text)) is None
    assert cv2.imread(str(text), cv2.IMREAD_GRAYSCALE) is None
    # kinds cv2 decodes and the reader does not: it raises, naming the file
    jpeg = tmp_path / "mask.jpg"
    cv2.imwrite(str(jpeg), np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="mask.jpg: a JPEG file"):
        pag.imread_gray(str(jpeg))
    palette = tmp_path / "palette.png"
    _png(palette, np.zeros((4, 4), np.uint8), 4, 4, 8, 3,
         extra=_chunk(b"PLTE", bytes(3 * 256)))
    with pytest.raises(ValueError, match="palette.png: a PNG kind"):
        pag.imread_gray(str(palette))
    gamma = tmp_path / "gamma.png"
    _png(gamma, np.full((4, 12), 9, np.uint8), 4, 4, 8, 2,
         extra=_chunk(b"gAMA", struct.pack(">I", 45455)))
    with pytest.raises(ValueError, match="gamma.png: a colour PNG with "
                                         "gamma"):
        pag.imread_gray(str(gamma))
    # a gray PNG with gamma information reads as cv2 reads it
    gray = tmp_path / "gray_gamma.png"
    _png(gray, np.arange(16, dtype=np.uint8).reshape(4, 4), 4, 4, 8, 0,
         extra=_chunk(b"gAMA", struct.pack(">I", 45455)))
    np.testing.assert_array_equal(pag.imread_gray(str(gray)),
                                  cv2.imread(str(gray), cv2.IMREAD_GRAYSCALE))


def test_cli_flags_match_jax():
    import argparse
    from unittest import mock

    def actions(get_args):
        seen = {}

        def capture(self, *a, **k):
            seen["parser"] = self
            return argparse.Namespace()

        with mock.patch.object(argparse.ArgumentParser, "parse_args",
                               capture):
            get_args([])
        return {a.dest: (a.option_strings, a.default, a.type, a.required,
                         a.help) for a in seen["parser"]._actions}

    assert actions(pag.get_args) == actions(jag.get_args)
    assert os.path.basename(pag.__file__) == "agreement.py"

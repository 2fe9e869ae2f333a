"""Agreement CLI — standalone mask-agreement tool; counterpart of the JAX
package's ``cli/agreement.py`` with the same flags, report dict and printed
text, without cv2 (the card's machine has none) and with scipy only for the
Student t quantile. It is the capability equivalent of the reference
``AgreementModule.py``.

Semantics (AgreementModule.py:18-100, 103-472):

* ``agreement(pred, gt) = 1 - (FN% + FP%) / 2`` computed from pixelwise
  AND/XOR areas between two binarized masks (gt resized to pred's shape,
  nearest semantics via anti_aliasing=False);
* per-modality grouping (AP12/40/100/200, ISO100-400, OFC, TSCAN100) of the
  prediction files against OFR ground-truth masks, per patient, test ("Td")
  and retest ("Rd") series;
* 95% confidence intervals via the Student t distribution.

Masks are read by :func:`imread_gray`, which returns what
``cv2.imread(path, IMREAD_GRAYSCALE)`` returns for the PNGs masks come in
(``data/png.py:decode_png``, then libpng's gray conversion as cv2 asks for
it), None where cv2 gives None, and raises for a file it cannot read as
cv2 would. The JAX module's ``scipy.ndimage.map_coordinates`` and
``scipy.stats.sem`` are numpy here (:func:`_resize_bilinear_skimage`).

The reference's sixteen copy-pasted ``agreement(...)`` blocks and per-modality
print blocks (AgreementModule.py:251-467) are replaced by one data-driven
modality table with identical pairings and output values.
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.png import PNG_SIGNATURE, _chunks, decode_png

__all__ = ["agreement_from_masks", "imread_gray", "mean_confidence_interval",
           "run_agreement", "run_reproducibility"]

# libpng's rgb_to_gray weights in 1/32768, as cv2 sets them (0.299, 0.587)
# for IMREAD_GRAYSCALE: 8-bit sums are truncated, 16-bit ones rounded, and
# 16-bit gray then keeps its high byte (png_set_strip_16)
_GRAY_WEIGHTS = (9797, 19234, 3737)
# with these chunks libpng converts colour to gray in linear light
_GAMMA_CHUNKS = (b"gAMA", b"sRGB", b"iCCP")
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"RIFF", "WebP"))


def imread_gray(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` without cv2: an (H, W)
    uint8 mask, or None for a missing or undecodable file. 8- and 16-bit
    gray, RGB and RGBA PNGs read as cv2 reads them (alpha ignored). A file
    cv2 would decode and this reader cannot (another image format, a
    palette, gray-with-alpha, sub-8-bit or interlaced PNG, a colour PNG with
    gamma information) raises and names the file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data[:8] != PNG_SIGNATURE:
        for sig, kind in _OTHER_FORMATS:
            if data.startswith(sig):
                raise ValueError(f"{path}: a {kind} file; the masks are "
                                 "read as PNG only")
        return None
    try:
        img = decode_png(data)
    except ValueError:
        return None
    if img is None:
        raise ValueError(f"{path}: a PNG kind this reader does not take "
                         "(palette, gray with alpha, below 8 bits or "
                         "interlaced)")
    deep = img.dtype == np.uint16
    if img.ndim == 3:
        if any(tag in _GAMMA_CHUNKS for tag, _ in _chunks(data)):
            raise ValueError(f"{path}: a colour PNG with gamma information, "
                             "which cv2 turns to gray in linear light; not "
                             "reproduced here")
        r, g, b = (img[..., c].astype(np.int64) for c in range(3))
        rc, gc, bc = _GRAY_WEIGHTS
        img = (rc * r + gc * g + bc * b + (16384 if deep else 0)) >> 15
    if deep:
        img = img >> 8
    return img.astype(np.uint8)


def mean_confidence_interval(data, confidence: float = 0.95):
    """[mean, lo, hi, std] — AgreementModule.py:18-24."""
    from scipy.stats import t  # the port's only use of scipy

    a = 1.0 * np.array(data)
    n = len(a)
    # scipy.stats.sem: the ddof=1 deviation over sqrt(n)
    m, se = np.mean(a), np.std(a, ddof=1) / np.sqrt(n)
    h = se * t.ppf((1 + confidence) / 2.0, n - 1)
    return [m, m - h, m + h, np.std(a)]


def _mirror(c: np.ndarray, n: int) -> np.ndarray:
    """Coordinates outside ``[0, n - 1]`` reflected without repeating the
    edge, as ``scipy.ndimage`` maps them in mode 'mirror'."""
    if n <= 1:
        return np.zeros_like(c)
    sz2 = 2 * n - 2
    low = sz2 * np.trunc(-c / sz2) + c
    low = np.where(low <= 1 - n, low + sz2, -low)
    high = c - sz2 * np.trunc(c / sz2)
    high = np.where(high >= n, sz2 - high, high)
    return np.where(c < 0, low, np.where(c > n - 1, high, c))


def _linear_taps(c: np.ndarray, n: int):
    """Order-1 spline taps of coordinates ``c`` on an axis of ``n``
    samples: (index, index + 1 mirrored, their weights). As in scipy, a
    coordinate in ``(n - 1, n)`` stays there and its second tap is the
    mirrored sample ``n - 2``."""
    c = _mirror(c, n)
    i0 = np.floor(c).astype(np.int64)
    t = c - i0
    i1 = np.where(i0 + 1 > n - 1, 2 * (n - 1) - (i0 + 1), i0 + 1)
    return i0, np.maximum(i1, 0), 1.0 - t, t


def _resize_bilinear_skimage(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """skimage.transform.resize(img, shape, anti_aliasing=False) for 2-D
    floats: center-aligned bilinear with np.pad-'reflect' border semantics
    (edge NOT repeated == scipy ndimage mode='mirror').

    skimage resolves resize to ``ndi.map_coordinates(order=1, mode='mirror')``
    over coords ``(i+0.5)*in/out - 0.5``; this is that in numpy. The border
    mode only matters on UPSCALE (coords within half a pixel outside the
    first/last sample center), where cv2.INTER_LINEAR's border clamp
    diverges from skimage within the border band.
    """
    oh, ow = int(shape[0]), int(shape[1])
    ih, iw = img.shape[:2]
    ys = (np.arange(oh) + 0.5) * (ih / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (iw / ow) - 0.5
    y0, y1, wy0, wy1 = _linear_taps(ys, ih)
    x0, x1, wx0, wx1 = _linear_taps(xs, iw)
    a = img.astype(np.float64)
    top, bottom = a[y0], a[y1]
    return (wy0[:, None] * (top[:, x0] * wx0 + top[:, x1] * wx1)
            + wy1[:, None] * (bottom[:, x0] * wx0 + bottom[:, x1] * wx1))


def agreement_from_masks(pred: np.ndarray, gt: np.ndarray) -> Tuple[float, float, float]:
    """(agreement, fn, fp) from two masks — AgreementModule.py:28-69.

    ``pred`` binarized as exactly-255 pixels; ``gt`` resized to pred's shape
    and binarized as >0 (matching the reference's asymmetric conventions).

    The reference resizes gt with ``skimage.transform.resize(...,
    anti_aliasing=False)`` — center-aligned BILINEAR on [0,1] floats with
    'reflect' (np.pad sense: edge not repeated) borders — then thresholds >0
    (AgreementModule.py:33-37), so boundary pixels whose bilinear support
    touches any nonzero gt pixel count as foreground. Reproduced exactly for
    BOTH down- and up-scale by ``_resize_bilinear_skimage`` (cv2.INTER_LINEAR
    clamps at borders, which diverges from skimage on upscale); held to
    the JAX package's scipy version, on an upscale fixture too, in
    tests/test_torch_agreement.py.
    """
    if gt.shape != pred.shape:
        gt = _resize_bilinear_skimage(gt.astype(np.float64) / 255.0,
                                      pred.shape) * 255.0
    a = (pred == 255).ravel()
    b = (gt.astype(np.float64).ravel() / 255.0) > 0.0
    both = np.logical_and(a, b)
    only_a = np.logical_xor(both, a)
    only_b = np.logical_xor(both, b)
    total = int(only_a.sum() + only_b.sum() + both.sum())
    ref_area = int(only_a.sum() + both.sum())
    test_area = int(only_b.sum() + both.sum())
    fn = (total - test_area) / ref_area if ref_area else 0.0
    fp = (total - ref_area) / test_area if test_area else 0.0
    agr = 1.0 - (fn + fp) / 2.0
    if fp == 0 and fn == 0:
        agr = 0.0  # AgreementModule.py:67-68
    return agr, fn, fp


# modality -> (prediction file slots, reported name). The slot layout follows
# the reference's fixed per-patient file ordering (AgreementModule.py:251-281).
_MODALITIES: List[Tuple[str, List[int], bool]] = [
    ("AP12", [0, 1], False),
    ("AP40", [2, 3], False),
    ("AP100", [4, 5], False),
    ("AP200", [6, 7], False),
    ("IOS100", [8], True),
    ("IOS200", [9], True),
    ("IOS300", [10], True),
    ("IOS400", [11], True),
    ("OFC", [12], True),
    ("TSCAN100", [13, 14], True),
]


def _split_series(files: List[str]) -> Tuple[List[str], List[str]]:
    """test ("Td"/other) vs retest ("Rd") — AgreementModule.py:196-208."""
    test, retest = [], []
    for f in files:
        (retest if "Rd" in os.path.basename(f) else test).append(f)
    return test, retest


def _patient_of(path: str) -> str:
    return (os.path.basename(path).lower().split(".")[0].split("-")[0]
            .split("rd")[0].split("td")[0].split("tf")[0])


def _modality_of(path: str) -> str:
    parts = os.path.basename(path).split(".")[0].split("-")
    return parts[1] if len(parts) > 1 else ""


# Reproducibility slot layout (the reference's commented-out test/retest
# block, AgreementModule.py:121-187: 16 per-patient prediction slots incl.
# the OFR image the validity table excludes).
_REPRO_MODALITIES: List[Tuple[str, List[int]]] = [
    ("AP12", [0, 1]), ("AP40", [2, 3]), ("AP100", [4, 5]), ("AP200", [6, 7]),
    ("ISO100", [8]), ("ISO200", [9]), ("ISO300", [10]), ("ISO400", [11]),
    ("OFC", [12]), ("OFR", [13]), ("TSCAN100", [14, 15]),
]


def run_reproducibility(mask_root: str) -> Dict[str, float]:
    """Test/retest reproducibility: agreement between each patient's "Td" and
    "Rd" prediction series, per modality slot.

    Implements the INTENT of the reference's fully-commented-out block
    (AgreementModule.py:121-187 — dead code there, working here; opt-in via
    ``--reproducibility`` so the default output matches the reference's).
    Returns {modality: mean agreement} and prints the report.
    """
    pred_files = sorted(glob.glob(os.path.join(mask_root, "*")),
                        key=str.casefold)
    pred_test, pred_retest = _split_series(pred_files)
    patients = sorted({_patient_of(f) for f in pred_test})
    accum: Dict[str, List[float]] = {name: [] for name, _ in _REPRO_MODALITIES}
    for pat in patients:
        t = [f for f in pred_test if pat == _patient_of(f)]
        r = [f for f in pred_retest if pat == _patient_of(f)]
        if not t or not r:
            continue
        for name, slots in _REPRO_MODALITIES:
            for s in slots:
                if s >= len(t) or s >= len(r):
                    continue
                a = imread_gray(t[s])
                b = imread_gray(r[s])
                if a is None or b is None:
                    continue
                agr, _, _ = agreement_from_masks(a, b)
                accum[name].append(agr)
    print("################################# REPRODUCIBILITY "
          "#################################")
    report = {}
    for name, _ in _REPRO_MODALITIES:
        if accum[name]:
            report[name] = float(np.mean(accum[name]))
            print(f"{name}: ", report[name])
    return report


def run_agreement(mask_root: str, ofr_gt_masks: str, list_of_ofr: List[str],
                  ap_only: bool = False, conf_intervals: bool = False) -> Dict:
    """Prediction-vs-OFR-ground-truth agreement tables
    (AgreementModule.py:189-472). Returns {ofr_sensitivity: {modality:
    {agreement/fn/fp: [mean, lo, hi, std]}}} and prints the report."""
    pred_files = sorted(glob.glob(os.path.join(mask_root, "*")), key=str.casefold)
    ofr_files = sorted(glob.glob(os.path.join(ofr_gt_masks, "*")), key=str.casefold)
    pred_test, pred_retest = _split_series(pred_files)
    ofr_test, ofr_retest = _split_series(ofr_files)

    print("################################# VALIDITY "
          "#################################")
    report: Dict = {}
    for sens in list_of_ofr:
        o_test = [f for f in ofr_test if sens in _modality_of(f)]
        o_retest = [f for f in ofr_retest if sens in _modality_of(f)]
        patients = [
            os.path.basename(f).lower().split(".")[0].split("-")[0]
            .split("rd")[0].split("z")[-1]
            for f in o_retest
        ]
        accum = {name: {"agreement": [], "fn": [], "fp": []}
                 for name, _, _ in _MODALITIES}
        for pat in patients:
            cot = [f for f in o_test if pat in _patient_of(f)]
            cor = [f for f in o_retest if pat in _patient_of(f)]
            cpt = [f for f in pred_test if pat in _patient_of(f)
                   and "ofr" not in _modality_of(f).lower()]
            cpr = [f for f in pred_retest if pat in _patient_of(f)
                   and "ofr" not in _modality_of(f).lower()]
            if not cot or not cor:
                continue
            gt_t = imread_gray(cot[0])
            gt_r = imread_gray(cor[0])
            for name, slots, skippable in _MODALITIES:
                if ap_only and skippable:
                    continue
                for s in slots:
                    for series, gt in ((cpt, gt_t), (cpr, gt_r)):
                        if s >= len(series):
                            continue
                        pred = imread_gray(series[s])
                        agr, fn, fp = agreement_from_masks(pred, gt)
                        accum[name]["agreement"].append(agr)
                        accum[name]["fn"].append(fn)
                        accum[name]["fp"].append(fp)

        print(f"############ OFR:  {sens}  ############")
        report[sens] = {}
        # NB: the reference prints FN under the "FP %" header and vice versa
        # with the comment "FP and FN are swapped to keep the metrics correct"
        # (AgreementModule.py:355) — we report under the corrected labels.
        for header, key in (("Agreement", "agreement"), ("FP %", "fn"),
                            ("FN %", "fp")):
            print(f"###### {header} ######")
            report[sens][key] = {}
            for name, _, skippable in _MODALITIES:
                if ap_only and skippable:
                    continue
                vals = accum[name][key]
                if not vals:
                    continue
                m = mean_confidence_interval(vals)
                report[sens][key][name] = m
                if conf_intervals:
                    print(f"{name}: ", m[0], f"({m[1]}-{m[2]})")
                else:
                    print(f"{name}: ", m[0], f"($\\pm {m[3]}$)")
        print("\n")
    return report


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Mask agreement evaluation")
    p.add_argument("--mask-root", type=str, required=True)
    p.add_argument("--invert-mask", type=str, default="False")  # vestigial parity
    p.add_argument("--img-size", type=str, default=352)
    p.add_argument("--ofr-gt-masks", type=str, required=True)
    p.add_argument("--list-of-ofr", type=str, required=True)
    p.add_argument("--ap-only", type=str, default="False")
    p.add_argument("--conf-intervals", type=str, default="False")
    p.add_argument("--reproducibility", type=str, default="False",
                   help="also print the test/retest reproducibility table "
                        "(the reference's commented-out block, made real)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    if str(args.reproducibility).lower() == "true":
        run_reproducibility(args.mask_root)
    return run_agreement(
        args.mask_root,
        args.ofr_gt_masks,
        ast.literal_eval(args.list_of_ofr),
        ap_only=str(args.ap_only).lower() == "true",
        conf_intervals=str(args.conf_intervals).lower() == "true",
    )


if __name__ == "__main__":
    main()

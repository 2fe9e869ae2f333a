"""Synthetic TL-pano-like samples in numpy alone; counterpart of the JAX
package's ``data/synthetic.py``.

A grayscale "radiograph" with jaw bands (upper, lower) and elliptical
"teeth" whose interiors hold pulp, dentin and enamel (and sometimes
composite), encoded with the class map's pixel values, so the whole target
factory path runs on it. The JAX module draws with OpenCV
(``cv2.ellipse``, ``cv2.GaussianBlur``); the machines the port runs on may
have no OpenCV, so here filled ellipses are an inequality on the pixel grid
(>= 99 % of mask pixels agree with OpenCV's at 96 px and above) and the
blur is a separable 5-tap Gaussian (sigma 1.2, border reflected
without repeating the edge pixel, OpenCV's default). The pixel coding, the
random draws and their order are the JAX module's; the pixels are not
identical to OpenCV's rasterization, and parity tests feed the same numpy
arrays to both packages rather than calling both generators.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .png import encode_png_gray8

__all__ = ["synth_sample", "write_synth_dataset", "fill_ellipse",
           "gaussian_blur5"]


def fill_ellipse(img: np.ndarray, center, axes, angle: float,
                 value) -> None:
    """Fill the ellipse with integer ``center`` (x, y), half-axes ``axes``
    (a along x, b along y before rotation) and ``angle`` in degrees, in
    place: the pixels whose centres satisfy the ellipse inequality with
    each half-axis half a pixel longer (OpenCV's filled ellipse covers the
    pixels its outline passes through; this matches its area)."""
    cx, cy = center
    a, b = float(axes[0]) + 0.5, float(axes[1]) + 0.5
    r = int(np.ceil(max(a, b)))
    h, w = img.shape[:2]
    y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
    x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dx, dy = xx - cx, yy - cy
    t = np.deg2rad(angle)
    u = dx * np.cos(t) + dy * np.sin(t)
    v = -dx * np.sin(t) + dy * np.cos(t)
    inside = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    img[y0:y1, x0:x1][inside] = value


def gaussian_blur5(img: np.ndarray, sigma: float = 1.2) -> np.ndarray:
    """5x5 Gaussian blur as two 1-D passes, reflect-101 borders."""
    k = np.exp(-((np.arange(5) - 2.0) ** 2) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    p = np.pad(img, 2, mode="reflect")
    rows = sum(k[i] * p[i:i + img.shape[0], :] for i in range(5))
    return sum(k[i] * rows[:, i:i + img.shape[1]] for i in range(5))


def synth_sample(rng: np.random.Generator, size: int = 128,
                 hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image uint8 (S, S), mask uint8 (S, S)) with the class map's
    pixel codes: background 0, upper 212, lower 255, pulp 127, dentin 170,
    enamel 85, composite 42. ``hard`` adds distractor blobs with
    tooth-interior luminance outside the teeth and jitters the luminance
    map (the JAX module's docstring has the reason)."""
    s = size
    mask = np.zeros((s, s), np.uint8)
    mid = s // 2
    # jaw bands
    uh = int(rng.uniform(0.12, 0.2) * s)
    lh = int(rng.uniform(0.12, 0.2) * s)
    mask[mid - uh:mid, :] = 212  # upper
    mask[mid:mid + lh, :] = 255  # lower
    # teeth: ellipses straddling the jaw line
    n_teeth = int(rng.integers(3, 7))
    for i in range(n_teeth):
        cx = int((i + 0.5 + rng.uniform(-0.1, 0.1)) * s / n_teeth)
        cy = mid + int(rng.uniform(-0.3, 0.3) * uh)
        a = max(3, int(s / (n_teeth * 2.6)))
        b = max(5, int(rng.uniform(0.1, 0.16) * s))
        # enamel shell, dentin body, pulp core (concentric)
        fill_ellipse(mask, (cx, cy), (a, b), 0, 85)
        fill_ellipse(mask, (cx, cy), (int(a * 0.75), int(b * 0.75)), 0, 170)
        fill_ellipse(mask, (cx, cy), (max(1, int(a * 0.3)),
                                      max(2, int(b * 0.3))), 0, 127)
        if rng.uniform() < 0.3:  # occasional composite filling
            fill_ellipse(mask, (cx, cy - b // 2),
                         (max(1, a // 3), max(1, b // 5)), 0, 42)
    # image: noisy rendering of the anatomy
    img = np.zeros((s, s), np.float32)
    lum_map = {212: 90.0, 255: 110.0, 170: 170.0, 85: 220.0, 127: 60.0,
               42: 240.0}
    if hard:
        g = rng.uniform(-20, 20)
        lum_map = {pv: lum + g + rng.uniform(-10, 10)
                   for pv, lum in lum_map.items()}
    for pv, lum in lum_map.items():
        img[mask == pv] = lum
    if hard:
        dist = np.zeros((s, s), np.float32)
        for _ in range(int(rng.integers(6, 14))):
            dx = int(rng.uniform(0.03, 0.97) * s)
            dy = int(rng.uniform(0.03, 0.97) * s)
            da = max(2, int(rng.uniform(0.015, 0.06) * s))
            db = max(3, int(rng.uniform(0.02, 0.09) * s))
            ang = float(rng.uniform(0, 180))
            lum = float(lum_map[int(rng.choice([127, 170, 85, 42]))]
                        + rng.uniform(-8, 8))
            fill_ellipse(dist, (dx, dy), (da, db), ang, lum)
        outside_teeth = ~np.isin(mask, (85, 170, 127, 42))
        hit = outside_teeth & (dist > 0)
        img[hit] = dist[hit]
    img += rng.normal(0, 12, (s, s)).astype(np.float32)
    img = gaussian_blur5(img, 1.2)
    return np.clip(img, 0, 255).astype(np.uint8), mask


def write_synth_dataset(root: str, n: int, size: int = 128, seed: int = 0,
                        folds: int = 0) -> None:
    """Write images/ + labels/ PNG pairs; with ``folds > 0``, the
    reference's cross-validation layout ``root/fold_N/{train,val}/...``."""
    rng = np.random.default_rng(seed)

    def write_split(d: str, count: int):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(count):
            img, mask = synth_sample(rng, size)
            for sub, arr in (("images", img), ("labels", mask)):
                with open(os.path.join(d, sub, f"{i:04d}.png"), "wb") as f:
                    f.write(encode_png_gray8(arr))

    if folds <= 0:
        write_split(root, n)
    else:
        for f in range(1, folds + 1):
            write_split(os.path.join(root, f"fold_{f}", "train"), n)
            write_split(os.path.join(root, f"fold_{f}", "val"), max(2, n // 4))

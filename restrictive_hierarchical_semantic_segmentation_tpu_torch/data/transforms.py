"""Host-side image and target transforms; counterpart of the JAX package's
``data/transforms.py``, which calls cv2. Here numpy (and PyTorch on the CPU
for the resize), so neither serving nor training needs cv2.

Train-input chain: scale to [0,1] -> resize (bilinear, no antialias) ->
GaussianBlur(k=25, sigma~U[0.001,2]) -> ColorJitter(0.4,0.5,0.25,0.01) ->
Normalize(0.5,0.5). The eval chain drops blur and jitter. Paired
augmentations: hflip and a shared random affine with NEAREST interpolation
and a constant fill (the reference's torchvision ``TF.affine``).

Against the cv2 calls of the JAX module (``tests/test_torch_transforms.py``):
the random draws are the same, in the same order; flip and normalize are
bit-equal; blur and jitter agree within 1e-6 (cv2's fused multiply-adds are
rounded once here too); the nearest affine computes its source coordinates
in float32 as cv2 does, and the test holds its share of pixels that take
another source pixel than cv2's, and the fill border, to the stated bound.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "resize_bilinear_np",
    "gaussian_blur",
    "color_jitter",
    "normalize",
    "hflip",
    "AffineParams",
    "sample_affine",
    "affine_forward_matrix",
    "affine_index_map",
    "affine_nearest",
]

# ITU-R 601 luma, the weights of cv2's RGB2GRAY and torchvision's
# rgb_to_grayscale
_LUMA = (np.float32(0.299), np.float32(0.587), np.float32(0.114))
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def resize_bilinear_np(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Half-pixel bilinear resize of a float32 (H, W) or (H, W, C) image:
    ``F.interpolate(antialias=False)``, the same as cv2 ``INTER_LINEAR`` and
    torchvision ``Resize(antialias=False)``."""
    if img.shape[:2] == tuple(size):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t[None, None] if img.ndim == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(int(size[0]), int(size[1])),
                        mode="bilinear", align_corners=False, antialias=False)
    out = out[0, 0] if img.ndim == 2 else out[0].permute(1, 2, 0)
    return np.ascontiguousarray(out.numpy())


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of ``[-r, n + r)`` under cv2's BORDER_REFLECT_101
    (``gfedcb|abcdefgh|gfedcba``), reflected as often as a size below the
    radius needs."""
    idx = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float, ksize: int = 25
                  ) -> np.ndarray:
    """GaussianBlur((25,25), sigma) with reflect-101 borders, as
    ``cv2.GaussianBlur(..., BORDER_REFLECT101)`` (dataloaders.py:53): a
    separable float32 filter, rows first, each tap added in turn."""
    k = _gaussian_kernel(ksize, sigma)
    r = ksize // 2
    src = np.asarray(img, np.float32)
    h, w = src.shape[:2]
    rows = src[:, _reflect101(w, r)]
    out = np.multiply(rows[:, 0:w], k[0])
    for i in range(1, ksize):
        out += rows[:, i:i + w] * k[i]
    cols = out[_reflect101(h, r)]
    out = np.multiply(cols[0:h], k[0])
    for i in range(1, ksize):
        out += cols[i:i + h] * k[i]
    return out


def _fma(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as cv2's SIMD ``v_fma`` (the
    product of two float32 values is exact in float64)."""
    return (a.astype(np.float64) * np.float64(np.float32(b))
            + c.astype(np.float64)).astype(np.float32)


def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    if isinstance(b, np.ndarray) and b.shape == a.shape:
        # cv2.addWeighted(a, factor, b, 1 - factor, 0)
        out = _fma(a, factor, b * np.float32(1.0 - factor))
    else:
        out = np.multiply(a, factor, dtype=np.float32)
        if b:  # scalar blend target (0.0 for brightness, mean for contrast)
            out += (1.0 - factor) * b
    return np.clip(out, 0.0, 1.0, out=out).astype(np.float32, copy=False)


def _grayscale(img: np.ndarray) -> np.ndarray:
    """cv2's float RGB2GRAY: ``fma(b, 0.114, fma(r, 0.299, g * 0.587))``."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return _fma(b, _LUMA[2], _fma(r, _LUMA[0], g * _LUMA[1]))[..., None]


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2's float RGB2HSV: H in [0, 360), S and V in [0, 1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    d = np.float32(60.0) / (diff + _FLT_EPSILON)
    # each sector's offset is added inside the fused multiply-add; the red
    # sector wraps below 0 by adding 360 there
    offset = np.where(v == r, np.where(g < b, np.float32(360.0),
                                       np.float32(0.0)),
                      np.where(v == g, np.float32(120.0), np.float32(240.0)))
    h = _fma(np.where(v == r, g - b, np.where(v == g, b - r, r - g)), d,
             offset)
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack((h, s, v), axis=-1).astype(np.float32, copy=False)


# cv2's HSV2RGB sector table: (b, g, r) picks from (v, p, q, t)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                     [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2's float HSV2RGB with H in [0, 360)."""
    h = hsv[..., 0] * np.float32(1.0 / 60.0)
    s, v = hsv[..., 1], hsv[..., 2]
    h = np.mod(h, np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0.0), h)
    one = np.float32(1.0)
    tab = np.stack((v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))), axis=-1)
    pick = _SECTORS[sector]  # (..., 3) as (b, g, r)
    bgr = np.take_along_axis(tab, pick, axis=-1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(
        np.float32, copy=False)


def _adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    hsv = _rgb_to_hsv(img)
    hsv[..., 0] = (hsv[..., 0] + factor * 360.0) % 360.0
    return _hsv_to_rgb(hsv)


def color_jitter(
    img: np.ndarray,
    rng: np.random.Generator,
    brightness: float = 0.4,
    contrast: float = 0.5,
    saturation: float = 0.25,
    hue: float = 0.01,
) -> np.ndarray:
    """torchvision ColorJitter(0.4, 0.5, 0.25, 0.01) — dataloaders.py:54.

    Factors sampled U[max(0,1-x), 1+x] (hue: U[-h,h]); the four ops are applied
    in a random permutation, as torchvision does. A single-channel image
    (the radiograph case) takes the gray path: saturation and hue are
    exact no-ops on R == G == B, and the grayscale of the image is the
    image; the draws are the same as on the 3-channel path.
    """
    fb = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    fc = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    fs = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    fh = rng.uniform(-hue, hue)
    order = rng.permutation(4)
    gray = img.ndim == 2 or img.shape[-1] == 1
    for op in order:
        if op == 0:
            img = _blend(img, 0.0, fb)
        elif op == 1:
            g = img if gray else _grayscale(img)
            img = _blend(img, float(g.mean()), fc)
        elif op == 2 and not gray:
            img = _blend(img, np.repeat(_grayscale(img), 3, axis=-1), fs)
        elif op == 3 and not gray:
            img = np.clip(_adjust_hue(img, fh), 0.0, 1.0)
    return img.astype(np.float32, copy=False)


def normalize(img: np.ndarray, mean: float = 0.5, std: float = 0.5
              ) -> np.ndarray:
    return ((img - mean) / std).astype(np.float32)


def hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


class AffineParams:
    __slots__ = ("angle", "translate", "scale", "shear")

    def __init__(self, angle, translate, scale, shear):
        self.angle = angle
        self.translate = translate
        self.scale = scale
        self.shear = shear


def sample_affine(rng: np.random.Generator) -> AffineParams:
    """Reference parameter ranges — dataset.py:438-442."""
    return AffineParams(
        angle=rng.uniform(-50.0, 50.0),
        translate=(rng.uniform(-20, 20), rng.uniform(-20, 20)),
        scale=rng.uniform(0.85, 1.15),
        shear=rng.uniform(-5, 5),
    )


def _torchvision_affine_matrix(params: AffineParams, h: int, w: int
                               ) -> np.ndarray:
    """Forward affine matrix matching torchvision ``TF.affine`` semantics:
    translate, then rotation, shear and scale about the image center
    ``(w * 0.5, h * 0.5)``."""
    cx, cy = w * 0.5, h * 0.5
    rot = math.radians(params.angle)
    sx = math.radians(params.shear)
    sy = 0.0
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    s = params.scale
    tx, ty = params.translate
    m = np.array([[s * a, s * b, 0.0], [s * c, s * d, 0.0], [0, 0, 1]])
    pre = np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1]], np.float64)
    post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    return (pre @ m @ post)[:2]


def affine_forward_matrix(params: AffineParams, h: int, w: int) -> np.ndarray:
    """The forward 2x3 matrix of the paired affine."""
    return _torchvision_affine_matrix(params, h, w)


def affine_index_map(params: AffineParams, h: int, w: int):
    """(flat source index, inside mask) of every output pixel, computed as
    cv2's ``warpAffine(INTER_NEAREST)`` does: the inverse matrix of
    ``invertAffineTransform`` in float64, its entries in float32, the
    source coordinate ``fma(a, x, b * y + c)`` in float32, rounded half to
    even."""
    m = _torchvision_affine_matrix(params, h, w).ravel()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[4] * det, m[0] * det, -m[1] * det, -m[3] * det
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    f32 = np.float32
    sx = np.rint(_fma(np.broadcast_to(xs, (h, w)), a11,
                      np.broadcast_to(f32(a12) * ys + f32(b1), (h, w))))
    sy = np.rint(_fma(np.broadcast_to(xs, (h, w)), a21,
                      np.broadcast_to(f32(a22) * ys + f32(b2), (h, w))))
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    flat = np.where(inside, sy * w + sx, 0).astype(np.int64)
    return flat, inside


def affine_nearest(img: np.ndarray, params: AffineParams,
                   fill: Union[float, Sequence[float]],
                   index_map=None) -> np.ndarray:
    """Apply the shared paired affine with NEAREST interpolation (torchvision
    ``TF.affine`` default) and a constant fill — dataset.py:443-451. ``fill``
    is one value, or one per channel of an (H, W, C) image. ``index_map``:
    :func:`affine_index_map` of the same parameters and size, when the
    caller applies one affine to several arrays."""
    h, w = img.shape[:2]
    flat, inside = (affine_index_map(params, h, w) if index_map is None
                    else index_map)
    src = img.reshape(h * w, -1)
    out = src[flat.ravel()].reshape(h, w, -1)
    fills = np.broadcast_to(np.asarray(fill, img.dtype), (out.shape[-1],))
    out = np.where(inside[..., None], out, fills)
    return out.reshape(img.shape).astype(img.dtype, copy=False)

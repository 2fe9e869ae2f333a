"""On-device augmentation over a device-resident training set; counterpart
of the JAX package's ``data/device_augment.py``, with the same names.

The host chain (``data/dataset.py``) decodes, augments and encodes every
sample on the host every epoch. Here the host uploads the
augmentation-independent base data ONCE (resized [0,1] grayscale images
and resized binarized node masks) and every epoch's randomness (blur,
jitter, flip, affine, ternary re-encode) runs as batched tensor ops on the
device, in NHWC like the host chain. The host's work per epoch is an
integer permutation. ``--device-data True`` selects it for the training
set; validation keeps the host chain.

The arithmetic is the JAX module's: the same parameter ranges, the 25-tap
separable Gaussian blur with REFLECT101 borders, brightness and contrast in
the drawn order, the inverse affine matrix in float32 (closed form, where
JAX calls ``jnp.linalg.inv``), the NEAREST warp as a gather with
``floor(s + 0.5)``, the fills (image -1; target channel 0 its own
per-sample max, the others -1 -> 0 after the re-binarization) and the
augment-then-ternary order. The blur is 25 shifted multiply-adds per axis,
so it does not depend on the TF32 flags that an ``F.conv2d`` would.

Randomness: JAX draws per-sample parameters from threefry keys; here an
explicit ``torch.Generator`` on the device, seeded from (seed, epoch, batch
index) and nothing else, so a resumed run redraws the same epoch. The
streams are not JAX's: ``tests/test_torch_device_augment.py`` holds the
port to JAX at fixed parameters.

Data-parallel training (``shard``, or :meth:`DeviceDataset.set_sharding`
as the trainer calls it, JAX ``train/loop.py:287-290``): every rank draws
and augments the same global batch and keeps its rows of it (as each JAX
process assembles the same global batch), so the ranks' rows together are
the single-process batch. Over a space group each rank then keeps its
band of H (``set_sharding``'s ``band``): the affine gather reaches across
bands, so whole images are augmented and then cut.
:meth:`DeviceDataset.place` moves the base arrays, and with them the
augmentation, to another device (JAX ``data/device_augment.py:310-316``).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..hierarchy.tree import ClassTree
from ..utils.device import resolve_device

__all__ = [
    "AugmentParams",
    "DeviceDataset",
    "augment_sample",
    "load_base_arrays",
    "make_augment_fn",
    "sample_params",
    "ternary_encode",
]

_KSIZE = 25  # GaussianBlur kernel (dataloaders.py:53)


class AugmentParams(NamedTuple):
    """Per-sample augmentation draws: each field a (B,) tensor."""

    sigma: torch.Tensor       # blur sigma ~ U[0.001, 2]
    brightness: torch.Tensor  # ~ U[0.6, 1.4]
    contrast: torch.Tensor    # ~ U[0.5, 1.5]
    bc_order: torch.Tensor    # bool; False: brightness then contrast
    do_hflip: torch.Tensor    # bool
    angle: torch.Tensor       # degrees ~ U[-50, 50]
    tx: torch.Tensor          # pixels ~ U[-20, 20]
    ty: torch.Tensor
    scale: torch.Tensor       # ~ U[0.85, 1.15]
    shear: torch.Tensor       # degrees ~ U[-5, 5]


def sample_params(generator: torch.Generator, n: int) -> AugmentParams:
    """``n`` draws in the reference ranges (dataloaders.py:53-54,
    dataset.py:438-442), on the generator's device. torchvision jitters in
    a random 4-op order; on grayscale only brightness and contrast act, so
    only their relative order matters."""
    dev = generator.device

    def u(lo, hi):
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    def coin():
        return torch.rand(n, generator=generator, device=dev) < 0.5

    return AugmentParams(
        sigma=u(0.001, 2.0), brightness=u(0.6, 1.4), contrast=u(0.5, 1.5),
        bc_order=coin(), do_hflip=coin(), angle=u(-50.0, 50.0),
        tx=u(-20.0, 20.0), ty=u(-20.0, 20.0), scale=u(0.85, 1.15),
        shear=u(-5.0, 5.0),
    )


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    """Source indices of ``[-r, n + r)`` under BORDER_REFLECT_101 (numpy's
    'reflect'), reflected as often as a size below the radius needs."""
    idx = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def _gaussian_blur(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 25-tap blur of (B, S, S) with REFLECT101 borders, the
    kernel per sample (cv2.getGaussianKernel's formula); H first, then W,
    as the JAX module convolves."""
    r = _KSIZE // 2
    i = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(i * i)[None] / (2.0 * sigma * sigma)[:, None])
    k = k / k.sum(-1, keepdim=True)                          # (B, 25)
    x = img
    for dim in (1, 2):
        n = x.shape[dim]
        xp = x.index_select(dim, _reflect101(n, r, x.device))
        out = xp.narrow(dim, 0, n) * k[:, 0, None, None]
        for t in range(1, _KSIZE):
            out.addcmul_(xp.narrow(dim, t, n), k[:, t, None, None])
        x = out
    return x


def _jitter_gray(x: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """Brightness and contrast in the drawn order; saturation and hue are
    exact no-ops on R == G == B inputs. x: (B, S, S)."""
    b = p.brightness[:, None, None]
    c = p.contrast[:, None, None]

    def bright(v):
        return torch.clamp(v * b, 0.0, 1.0)

    def contrast(v):
        m = v.mean(dim=(1, 2), keepdim=True)
        return torch.clamp(m + (v - m) * c, 0.0, 1.0)

    return torch.where(p.bc_order[:, None, None], bright(contrast(x)),
                       contrast(bright(x)))


def _affine_inverse(p: AugmentParams, h: int, w: int):
    """The inverse (dst -> src) 2x3 matrix of the torchvision-convention
    forward affine about the image center, per sample, in float32: six
    (B,) tensors. The trigonometric functions are taken in float64 of the
    float32 angles and rounded once, so the card and the CPU agree; the
    rest is float32 arithmetic in the JAX module's order."""
    f32 = torch.float32
    rot = p.angle * (math.pi / 180.0)
    sx = p.shear * (math.pi / 180.0)
    cos_r = torch.cos(rot.double()).to(f32)
    sin_r = torch.sin(rot.double()).to(f32)
    tan_s = torch.tan(sx.double()).to(f32)
    a = cos_r
    b = -cos_r * tan_s - sin_r
    c = sin_r
    d = -sin_r * tan_s + cos_r
    s = p.scale
    cx, cy = w * 0.5, h * 0.5
    # pre @ [[s a, s b, 0], [s c, s d, 0], [0, 0, 1]] @ post
    m00, m01, m10, m11 = s * a, s * b, s * c, s * d
    m02 = m00 * (-cx) + m01 * (-cy) + (p.tx + cx)
    m12 = m10 * (-cx) + m11 * (-cy) + (p.ty + cy)
    det = m00 * m11 - m01 * m10
    return (m11 / det, -m01 / det, (m01 * m12 - m02 * m11) / det,
            -m10 / det, m00 / det, (m02 * m10 - m00 * m12) / det)


def _affine_nearest(x: torch.Tensor, minv, fill: torch.Tensor) -> torch.Tensor:
    """NEAREST warp of (B, S, S, C) by the inverse matrices; out of frame
    -> ``fill`` (B, C)."""
    bsz, h, w, ch = x.shape
    yy = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    i00, i01, i02, i10, i11, i12 = (v[:, None, None] for v in minv)
    sxi = torch.floor(i00 * xx + i01 * yy + i02 + 0.5)
    syi = torch.floor(i10 * xx + i11 * yy + i12 + 0.5)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    flat = (syi.clamp(0, h - 1) * w + sxi.clamp(0, w - 1)).long()
    warped = x.reshape(bsz, h * w, ch).gather(
        1, flat.reshape(bsz, h * w, 1).expand(-1, -1, ch)).reshape(x.shape)
    return torch.where(valid[..., None], warped, fill[:, None, None, :])


def ternary_encode(binary: torch.Tensor, tree: ClassTree) -> torch.Tensor:
    """Tensor form of ``target_factory.ternary_encode``: child channel c
    with parent p -> 1 where c, 0 where p and not c, -1 outside p
    (dataset.py:227-265). Parents are picked by slicing, so no index
    tensor is copied to the device."""
    a, b = tree.level_slices[0]
    out = [binary[..., a:b]]
    for lv in range(1, tree.num_levels):
        a, b = tree.level_slices[lv]
        pa = tree.level_slices[lv - 1][0]
        parents = torch.stack([binary[..., pa + int(j)]
                               for j in tree.parent_index[lv]], dim=-1)
        child = binary[..., a:b]
        out.append(torch.where(child > 0, 1.0,
                               torch.where(parents > 0, 0.0, -1.0)))
    return torch.cat(out, dim=-1)


def augment_sample(img01: torch.Tensor, y01: torch.Tensor, p: AugmentParams,
                   tree: ClassTree, hierarchical: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train-time chain of a batch, on the tensors' device.

    img01: (B, S, S, 1) float32 in [0, 1] (resized base).
    y01:   (B, S, S, C) float32 {0, 1} (resized, binarized node/leaf masks).
    Returns (image (B, S, S, 1) normalized and augmented, target
    (B, S, S, C) float32, ternary when ``hierarchical``)."""
    x = _gaussian_blur(img01[..., 0], p.sigma)
    x = _jitter_gray(x, p)
    x = ((x - 0.5) / 0.5)[..., None]
    y = y01.float()
    flip = p.do_hflip[:, None, None, None]
    x = torch.where(flip, x.flip(2), x)
    y = torch.where(flip, y.flip(2), y)
    minv = _affine_inverse(p, x.shape[1], x.shape[2])
    x = _affine_nearest(x, minv, torch.full_like(x[:, 0, 0, :], -1.0))
    # fill rules (dataset.py:446-451): channel 0 fills with its own max
    # (out of frame stays background), the others with -1 -> 0 after the
    # >= 0.5 re-binarization
    fills = torch.full_like(y[:, 0, 0, :], -1.0)
    fills[:, 0] = y[..., 0].amax(dim=(1, 2))
    y = _affine_nearest(y, minv, fills)
    y = (y >= 0.5).float()
    if hierarchical:
        y = ternary_encode(y, tree)
    return x, y


def make_augment_fn(tree: ClassTree, hierarchical: bool):
    """``(generator, images01, masks01) -> (x, y)``: one parameter draw
    per sample from ``generator``, then :func:`augment_sample`."""

    def fn(generator, images01, masks01):
        p = sample_params(generator, images01.shape[0])
        return augment_sample(images01, masks01, p, tree, hierarchical)

    return fn


def load_base_arrays(input_paths: List[str], target_paths: List[str],
                     tree: ClassTree, img_size: int, hierarchical: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side one-time load of the augmentation-independent base data:
    resized [0,1] grayscale images (N,S,S,1) f32 and resized binarized
    node/leaf masks (N,S,S,C) uint8."""
    from . import transforms as T
    from .dataset import decode_image_compact, decode_mask
    from .target_factory import leaf_masks, node_masks

    s = int(img_size)
    xs, ys = [], []
    for ip, tp in zip(input_paths, target_paths):
        x = decode_image_compact(ip).astype(np.float32) / 255.0
        if x.ndim != 3 or x.shape[-1] != 1:
            # the device chain implements the grayscale fast path only
            # (radiographs; saturation/hue are exact no-ops there): color
            # sources must use the host chain, which jitters all 4 ops
            raise ValueError(
                f"--device-data supports grayscale sources only; {ip} "
                f"decodes to shape {x.shape}. Use the host pipeline "
                "(device_data=False) for color datasets."
            )
        xs.append(T.resize_bilinear_np(x, (s, s)))
        mask = decode_mask(tp)
        y = (node_masks(mask, tree) if hierarchical
             else leaf_masks(mask, tree)).astype(np.float32)
        y = T.resize_bilinear_np(y, (s, s))
        ys.append((y >= 0.5).astype(np.uint8))
    return np.stack(xs), np.stack(ys)


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """The generator seed of one batch: a function of (seed, epoch, batch
    index) alone."""
    return int(np.random.SeedSequence((int(seed), int(epoch), int(batch))
                                      ).generate_state(1)[0])


class DeviceDataset:
    """Device-resident train set + per-epoch batch iterator.

    Uploads the base arrays once to ``device`` (``cuda`` unless the caller
    asks for the CPU); per epoch the host contributes only a shuffled
    permutation, drawn as the JAX dataset draws it. Each iterated item is
    ``(x, y)`` already on the device: x (B, S, S, 1) f32, y (B, S, S, C)
    f32. The last partial batch is dropped."""

    def __init__(self, input_paths, target_paths, tree: ClassTree,
                 img_size: int, hierarchical: bool, batch_size: int,
                 seed: int = 0, device=None, shard=None):
        self.device = resolve_device(device)
        images, masks = load_base_arrays(
            input_paths, target_paths, tree, img_size, hierarchical)
        self._images = torch.from_numpy(images).to(self.device)
        self._masks = torch.from_numpy(masks).to(self.device)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._n = images.shape[0]
        self._fn = make_augment_fn(tree, hierarchical)
        self._epoch = 0
        self.set_sharding(shard)

    @property
    def nbytes(self) -> int:
        """Bytes of the base arrays held on the device."""
        return (self._images.numel() * self._images.element_size()
                + self._masks.numel() * self._masks.element_size())

    def __len__(self):
        return self._n // self.batch_size  # drop_last, as the loader

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    def set_sharding(self, shard, band=None) -> None:
        """Yield this rank's rows of every global batch: ``shard = (index,
        size, grad_accum)`` in its data group (``data/loader.py:
        shard_rows``), or None for the whole batch; ``band = (lo, hi)``:
        the rows of H this rank of a space group keeps (None: all)."""
        from .loader import shard_rows

        self._rows = (None if shard is None
                      else shard_rows(self.batch_size, shard))
        self._band = None if band is None else slice(*band)

    def place(self, device) -> None:
        """Move the base arrays, and so the augmentation and the batches it
        yields, to ``device``."""
        self.device = resolve_device(device)
        self._images = self._images.to(self.device)
        self._masks = self._masks.to(self.device)

    def close(self):
        """Release the device arrays."""
        self._images = self._masks = None

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        perm = torch.from_numpy(rng.permutation(self._n)).to(self.device)
        gen = torch.Generator(device=self.device)
        for b in range(len(self)):
            idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
            gen.manual_seed(batch_seed(self.seed, self._epoch, b))
            x, y = self._fn(gen, self._images[idx], self._masks[idx].float())
            if self._rows is not None:
                x = torch.cat([x[a:b] for a, b in self._rows])
                y = torch.cat([y[a:b] for a, b in self._rows])
            if self._band is not None:
                x = x[:, self._band].contiguous()
                y = y[:, self._band].contiguous()
            yield x, y

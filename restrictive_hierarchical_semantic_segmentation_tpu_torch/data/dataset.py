"""SegDataset: image and mask decode -> transforms -> paired augmentation ->
targets; counterpart of the JAX package's ``data/dataset.py``, without cv2.

The pipeline order is the reference's (Data/dataset.py:12-476):

1. decode the image (gray stays one channel until the end, which equals
   the reference's stack-first order: every input op is channel-symmetric)
   and the pixel-coded mask;
2. per-node binary channels in canonical order (flat: leaves only);
3. input chain: [0,1] -> resize -> (train: blur, jitter) -> normalize(.5,.5);
4. target chain: per-channel [0,1] -> resize;
5. paired hflip (p=.5) and paired random affine (train only), reference fill
   conventions (image -1; target channel 0 fills with its max, others -1);
6. re-binarize targets at 0.5 (dataset.py:454-455);
7. hierarchical mode: ternary restrictive encoding.

Outputs NHWC: image (S, S, 3) float32 ((S, S, 1) with ``emit_gray``),
target (S, S, C_total) in ``target_dtype``. Randomness is an explicit
``np.random.Generator``; every parameter is drawn up front in a fixed order,
the same draws as the JAX dataset's.

PNGs go through the port's decoder (``data/png.py``); other formats need
cv2, imported at the call. Targets come from the native C++ sample factory
(``data/native.py``, the default ``use_native=True``, as in the JAX
package) except under a vertical flip, where the numpy path runs; the
numpy path alone with ``use_native=False``.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..hierarchy.tree import ClassTree
from . import transforms as T
from .png import PNG_SIGNATURE, decode_png
from .target_factory import leaf_masks, node_masks, ternary_encode

__all__ = ["SegDataset", "ByteCappedCache", "decode_image",
           "decode_image_compact", "decode_image_bytes_compact",
           "decode_mask"]


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except (FileNotFoundError, IsADirectoryError):
        raise FileNotFoundError(path) from None


def _decode_cv2(data: bytes, flag: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        raise ValueError("only PNG images decode without cv2, and cv2 is "
                         "not installed") from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8), getattr(cv2, flag))
    if img is None:
        raise ValueError("not a decodable image")
    if img.ndim == 3 and img.shape[2] == 3 and flag == "IMREAD_UNCHANGED":
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def _compact(data: bytes) -> np.ndarray:
    """Encoded bytes -> (H, W, 1) gray or (H, W, 3) color with the JAX
    package's channel conventions: color is RGB, except that a 4-channel
    image keeps the first three channels of cv2's BGRA order."""
    if data[:8] == PNG_SIGNATURE:
        img = decode_png(data)
        if img is not None:
            if img.ndim == 2:
                return img[..., None]
            if img.shape[2] == 4:
                return np.ascontiguousarray(img[..., 2::-1])  # BGR of BGRA
            return img
    img = _decode_cv2(data, "IMREAD_UNCHANGED")
    if img.ndim == 2:
        return img[..., None]
    return img[..., :3]


def decode_image_bytes_compact(data: bytes) -> np.ndarray:
    """Encoded bytes -> (H, W, 1) gray or (H, W, 3) color, uint8/uint16 (the
    serve CLI's upload path); PNG without cv2, other formats through it."""
    return _compact(data)


def decode_image_compact(path: str) -> np.ndarray:
    """:func:`decode_image_bytes_compact` of a file: grayscale stays
    single-channel (H, W, 1)."""
    return _compact(_read(path))


def decode_image(path: str) -> np.ndarray:
    """A file -> (H, W, 3): gray stacked to 3 channels (dataset.py:416-417)."""
    img = decode_image_compact(path)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img


def decode_mask(path: str) -> np.ndarray:
    """A pixel-coded mask file -> (H, W) uint8, as ``cv2.imread(path,
    IMREAD_GRAYSCALE)``. 8-bit gray PNG is the dataset's format; a 16-bit
    gray PNG keeps each sample's high byte, as libpng's ``strip_16`` does
    for cv2. A colour PNG mask is refused: cv2 reads it through libpng's
    gamma-aware ``rgb_to_gray``, which this decoder does not reproduce."""
    data = _read(path)
    if data[:8] == PNG_SIGNATURE:
        img = decode_png(data)
        if img is not None:
            if img.ndim != 2:
                raise ValueError(f"{path}: a colour mask; the masks are "
                                 "pixel-coded gray PNGs")
            return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 \
                else img
    return _decode_cv2(data, "IMREAD_GRAYSCALE")


class ByteCappedCache:
    """Insert-until-full numpy-array cache bounded by TOTAL BYTES.

    Per-image caches here are hit once per (index, size) per epoch, so
    eviction would only thrash: once the byte budget is spent, further keys
    are simply not cached (re-decoded per epoch, like the reference does for
    everything)."""

    def __init__(self, cap_bytes: int):
        self.cap_bytes = int(cap_bytes)
        self.nbytes = 0
        self._d: dict = {}
        # the loader's worker threads insert concurrently
        self._lock = threading.Lock()

    def __getstate__(self):  # process workers get a pickled copy
        state = dict(self.__dict__)
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def get(self, key, default=None):
        return self._d.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __setitem__(self, key, value):
        nb = int(getattr(value, "nbytes", 0))
        with self._lock:
            if key in self._d or self.nbytes + nb > self.cap_bytes:
                return
            self._d[key] = value
            self.nbytes += nb


class SegDataset:
    def __init__(
        self,
        input_paths: List[str],
        target_paths: List[str],
        tree: ClassTree,
        img_size: int,
        hierarchical: bool,
        augment: bool,
        hflip: bool = True,
        vflip: bool = False,
        affine: bool = True,
        use_native: bool = True,
        target_dtype=np.float32,
        emit_gray: bool = False,
        cache_bytes: int = 1 << 30,
    ):
        assert len(input_paths) == len(target_paths)
        self.input_paths = list(input_paths)
        self.target_paths = list(target_paths)
        self.tree = tree
        self.img_size = int(img_size)
        self.hierarchical = hierarchical
        self.augment = augment
        self.hflip = hflip
        self.vflip = vflip
        self.affine = affine
        self.use_native = use_native
        # int8 targets: ternary {-1,0,1} is exact in int8, 4x smaller host
        # buffers and copies; the train step upcasts on the device
        self.target_dtype = target_dtype
        # keep grayscale sources single-channel (S, S, 1); the train step
        # broadcasts to 3 channels on the device
        self.emit_gray = emit_gray
        self._tables = None
        # decoded and resized [0,1] images, and the native path's channel
        # bitmasks or the numpy path's decoded masks, reused across epochs,
        # up to ``cache_bytes`` in all
        self._cache = ByteCappedCache(cache_bytes)

    def __len__(self) -> int:
        return len(self.input_paths)

    @property
    def num_target_channels(self) -> int:
        return self.tree.num_classes if self.hierarchical else self.tree.num_leaves

    def _target_tables(self):
        if self._tables is None:
            from .native import ChannelTables

            self._tables = ChannelTables(self.tree, self.hierarchical)
        return self._tables

    def _mask(self, index: int) -> np.ndarray:
        mask = self._cache.get(("mask", index))
        if mask is None:
            # the port's PNG decoder undoes Average and Paeth rows in
            # Python: the numpy path decodes each mask once (the native
            # path caches the bitmask instead)
            mask = decode_mask(self.target_paths[index])
            if not self.use_native:
                self._cache[("mask", index)] = mask
        return mask

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None):
        if rng is None:
            rng = np.random.default_rng()
        s = self.img_size
        x = self._cache.get(("img", index, s))
        if x is None:
            x = decode_image_compact(self.input_paths[index]).astype(
                np.float32) / 255.0
            x = T.resize_bilinear_np(x, (s, s))
            self._cache[("img", index, s)] = x
        mask = None
        if not (self.use_native and ("bits", index, s) in self._cache):
            mask = self._mask(index)

        # every random parameter up front, in the JAX dataset's order
        do_blur_jitter = self.augment
        sigma = rng.uniform(0.001, 2.0) if do_blur_jitter else 0.0
        do_hflip = bool(self.augment and self.hflip and rng.uniform() > 0.5)
        do_vflip = bool(self.augment and self.vflip and rng.uniform() > 0.5)
        aff = T.sample_affine(rng) if (self.augment and self.affine) else None

        # ---- input chain (resize done at cache fill) ----------------------
        if do_blur_jitter:
            x = T.gaussian_blur(x, sigma)  # a new array: the cache stays
            x = T.color_jitter(x, rng)
        x = T.normalize(x)
        if do_hflip:
            x = T.hflip(x)
        if do_vflip:
            x = x[::-1].copy()
        amap = T.affine_index_map(aff, s, s) if aff is not None else None
        if aff is not None:
            x = T.affine_nearest(x, aff, fill=-1.0, index_map=amap)
        if x.shape[-1] == 1 and not self.emit_gray:
            x = np.repeat(x, 3, axis=-1)

        # ---- target chain: the native factory, or numpy under a vflip ------
        if self.use_native and not do_vflip:
            from .native import make_target_native

            m = T.affine_forward_matrix(aff, s, s) if aff is not None else None
            y = make_target_native(
                mask, self._target_tables(), s, do_hflip, m,
                bits_cache=self._cache, cache_key=("bits", index, s),
                dtype=self.target_dtype)
            return np.asarray(x, np.float32), y

        if mask is None:
            mask = self._mask(index)
        y = (node_masks(mask, self.tree) if self.hierarchical
             else leaf_masks(mask, self.tree)).astype(np.float32)
        y = T.resize_bilinear_np(y, (s, s))
        if do_hflip:
            y = T.hflip(y)
        if do_vflip:
            y = y[::-1].copy()
        if aff is not None:
            # dataset.py:446-451: channel 0 fills with its max value
            # (out-of-frame stays background), the rest fill -1
            fills = np.full(y.shape[-1], -1.0, np.float32)
            fills[0] = y[..., 0].max()
            y = T.affine_nearest(y, aff, fills, index_map=amap)

        y = (y >= 0.5).astype(np.float32)  # dataset.py:454-455
        if self.hierarchical:
            y = ternary_encode(y, self.tree)
        return np.asarray(x, np.float32), np.asarray(y, self.target_dtype)

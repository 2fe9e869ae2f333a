"""ctypes bridge to the native C++ sample factory
(``csrc/sample_factory.cpp``); counterpart of the JAX package's
``data/native.py``, with the same API.

The library is built at first use with ``g++`` into ``build/native/`` at the
repository root, under a name that carries a hash of the source and the
flags, through a temporary file and an atomic rename, so processes that
build at the same time never load a partial file (as ``ops/_build.py``
builds the CUDA sources). Where the JAX bridge returns None and its callers
fall back to numpy, this one raises with g++'s output: ``SegDataset(
use_native=True)`` runs the native path or fails.

Two-stage API mirroring the kernel split:
* :func:`mask_bits` — augmentation-independent per-pixel channel bitmask
  (fused resize+threshold); **cacheable across epochs**;
* :func:`expand_bits` — per-epoch hflip/affine gather + ternary expansion.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..hierarchy.tree import ClassTree

__all__ = ["ChannelTables", "library_path", "mask_bits", "expand_bits",
           "make_target_native"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "sample_factory.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17", "-Wall")

_LIB = None
_LOCK = threading.Lock()

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I8P = ctypes.POINTER(ctypes.c_int8)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsample_factory-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: the native sample factory "
                           "(use_native=True) needs it") from None
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a reader never sees a partial file


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.rhss_mask_bits.restype = ctypes.c_int
        lib.rhss_mask_bits.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _I32P, _I32P, ctypes.c_int, _U32P,
        ]
        for name, out in (("rhss_expand_bits", _F32P),
                          ("rhss_expand_bits_i8", _I8P)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_U32P, ctypes.c_int, ctypes.c_int, _I32P,
                           ctypes.c_int, ctypes.c_int, _F64P, out]
        _LIB = lib
        return lib


class ChannelTables:
    """Per-channel pixel-value sets + parent links, precomputed once."""

    def __init__(self, tree: ClassTree, hierarchical: bool):
        self.hierarchical = hierarchical
        names = tree.names if hierarchical else tree.leaf_names
        nvals: List[int] = []
        vals: List[int] = []
        parent: List[int] = []
        desc = dict(zip(tree.parent_names_bfs, tree.descendant_leaves))
        chan_index = {n: i for i, n in enumerate(names)}
        for n in names:
            if tree.children[n]:
                pvs = [tree.pixel_value[tree.leaf_names[i]] for i in desc[n]]
            else:
                pvs = [tree.pixel_value[n]]
            nvals.append(len(pvs))
            vals.extend(int(v) for v in pvs)
            p = tree.parent_name.get(n)
            parent.append(chan_index[p] if (hierarchical and p in chan_index)
                          else -1)
        self.nvals = np.ascontiguousarray(nvals, np.int32)
        self.vals = np.ascontiguousarray(vals, np.int32)
        self.parent = np.ascontiguousarray(parent, np.int32)
        self.n_channels = len(names)
        if self.n_channels > 32:
            raise ValueError(f"{self.n_channels} target channels: the "
                             "native bitmask holds at most 32")


def mask_bits(mask: np.ndarray, tables: ChannelTables,
              size: int) -> np.ndarray:
    """(h, w) uint8 mask -> (size, size) uint32 channel bitmask."""
    lib = _load()
    mask = np.ascontiguousarray(mask, np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"mask of shape {mask.shape}: expected (h, w)")
    h, w = mask.shape
    bits = np.empty((size, size), np.uint32)
    rc = lib.rhss_mask_bits(
        mask.ctypes.data_as(_U8P), h, w, size,
        tables.nvals.ctypes.data_as(_I32P),
        tables.vals.ctypes.data_as(_I32P),
        tables.n_channels,
        bits.ctypes.data_as(_U32P),
    )
    if rc != 0:
        raise RuntimeError(f"rhss_mask_bits returned {rc}")
    return bits


def expand_bits(bits: np.ndarray, tables: ChannelTables,
                hflip: bool = False,
                affine_matrix: Optional[np.ndarray] = None,
                dtype=np.float32) -> np.ndarray:
    """Bitmask -> (S, S, C) targets after the optional hflip and forward
    2x3 ``affine_matrix``. dtype=np.int8 emits ternary targets as int8
    ({-1,0,1} are exact): 4x less host memory traffic and a 4x smaller
    host->device transfer; the train step upcasts on the device."""
    lib = _load()
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.int8):
        raise ValueError(f"dtype {dtype}: the native targets are float32 "
                         "or int8")
    bits = np.ascontiguousarray(bits, np.uint32)
    size = bits.shape[0]
    if bits.shape != (size, size):
        raise ValueError(f"bitmask of shape {bits.shape}: expected square")
    out = np.empty((size, size, tables.n_channels), dtype)
    aff = None
    if affine_matrix is not None:
        aff = np.ascontiguousarray(affine_matrix, np.float64).reshape(6)
    i8 = dtype == np.int8
    fn = lib.rhss_expand_bits_i8 if i8 else lib.rhss_expand_bits
    rc = fn(
        bits.ctypes.data_as(_U32P), size, tables.n_channels,
        tables.parent.ctypes.data_as(_I32P),
        1 if tables.hierarchical else 0,
        1 if hflip else 0,
        aff.ctypes.data_as(_F64P) if aff is not None else None,
        out.ctypes.data_as(_I8P if i8 else _F32P),
    )
    if rc != 0:
        raise RuntimeError(f"rhss_expand_bits returned {rc}")
    return out


def make_target_native(
    mask: Optional[np.ndarray],
    tables: ChannelTables,
    size: int,
    hflip: bool = False,
    affine_matrix: Optional[np.ndarray] = None,
    bits_cache=None,
    cache_key=None,
    dtype=np.float32,
) -> np.ndarray:
    """Full fused target build. With ``bits_cache``/``cache_key``, the
    augmentation-independent bitmask is reused across epochs (``mask`` may
    then be None once the key is cached)."""
    bits = None
    if bits_cache is not None and cache_key is not None:
        bits = bits_cache.get(cache_key)
    if bits is None:
        bits = mask_bits(mask, tables, size)
        if bits_cache is not None and cache_key is not None:
            bits_cache[cache_key] = bits
    return expand_bits(bits, tables, hflip, affine_matrix, dtype=dtype)

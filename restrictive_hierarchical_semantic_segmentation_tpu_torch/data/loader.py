"""Host data loading: splits, batched multi-worker decode, device prefetch;
counterpart of the JAX package's ``data/loader.py``.

* deterministic 80/10/10 splits equal to the reference's
  ``train_test_split(random_state=42)`` (dataloaders.py:12-39), here without
  sklearn: its shuffle split is the first ``round(0.1 n)`` indices of
  ``RandomState(42).permutation(n)``;
* a batch assembler over a thread pool (numpy releases the GIL) or a pool of
  spawned processes, producing static-shape NHWC numpy batches (train:
  shuffle + drop_last, dataloaders.py:170-176) and loading the next batch
  while the caller uses the current one; every sample's generator is
  seeded from (seed, epoch, index), so both modes give the same batches;
* ``prefetch_to_device``: keeps ``size`` batches in flight on the device,
  copied from pinned host memory without blocking the host;
* ``shard_rows``: the rows of every global batch that one rank of a
  data-parallel group loads (``BatchLoader(shard=...)``): each sample's
  seed depends on (seed, epoch, dataset index) alone, so the ranks' rows,
  concatenated, are the single-process batch bit for bit;
* ``band``: the rows of H that one rank of a space group keeps
  (``parallel/bands.py:band``), of images and targets alike, cut after the
  whole samples are loaded and augmented.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import copy
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataset import ByteCappedCache, SegDataset

__all__ = ["split_ids", "BatchLoader", "to_device", "prefetch_to_device",
           "shard_rows"]

_WORKER_DS = None


def _worker_init(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _worker_load(args):
    ds_index, sample_seed = args
    rng = np.random.default_rng(sample_seed)
    return _WORKER_DS.__getitem__(int(ds_index), rng)


def _split_cache_budget(dataset, num_workers: int):
    """Each spawn worker gets its OWN pickled copy of the dataset, so a
    per-dataset byte budget would multiply by num_workers; split it so the
    TOTAL across workers honors the documented cache_bytes bound."""
    cache = getattr(dataset, "_cache", None)
    if cache is None or num_workers <= 1 or getattr(
            cache, "cap_bytes", 0) <= 0:
        return dataset
    dataset = copy.copy(dataset)
    per_worker = cache.cap_bytes // num_workers
    if per_worker == 0:
        print(f"[loader] cache_bytes={cache.cap_bytes} split over "
              f"{num_workers} workers -> 0 bytes each: per-worker caching "
              "disabled (raise cache_bytes or lower num_workers)",
              flush=True)
    dataset._cache = ByteCappedCache(per_worker)
    return dataset


def _make_process_pool(dataset, num_workers: int):
    import multiprocessing as mp

    dataset = _split_cache_budget(dataset, num_workers)
    return mp.get_context("spawn").Pool(
        num_workers, initializer=_worker_init, initargs=(dataset,))


def _train_test_split(idx: np.ndarray, test_size: int, seed: int):
    """``sklearn.model_selection.train_test_split(idx, test_size=k,
    random_state=seed)`` for an int ``k``: (train, test)."""
    n = len(idx)
    if test_size <= 0 or test_size >= n:
        raise ValueError(
            f"test_size={test_size} should be positive and smaller than the "
            f"number of samples {n}")
    perm = np.random.RandomState(seed).permutation(n)
    return idx[perm[test_size:]], idx[perm[:test_size]]


def split_ids(
    n: int, has_val: bool, has_test: bool, test_remove: bool, seed: int = 42
):
    """Reference split_ids semantics (dataloaders.py:12-39), fixed.

    Returns (train_idx, test_idx or None, val_idx)."""
    idx = np.arange(n)
    val_size = int(round(0.10 * n))
    test_size = int(round(0.10 * n))
    if has_val:
        train_idx, val_idx = idx, None
    else:
        train_idx, val_idx = _train_test_split(idx, val_size, seed)
    test_idx = None
    if not test_remove and not has_test:
        train_idx, test_idx = _train_test_split(train_idx, test_size, seed)
    return train_idx, test_idx, val_idx


def shard_rows(batch_size: int, shard: Optional[Tuple[int, int, int]]
               ) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` row ranges of a global batch that rank
    ``index`` of a data group of ``size`` ranks takes, for ``shard = (index,
    size, micro)``: with ``micro`` microbatches of gradient accumulation,
    its share of each microbatch (so microbatch ``a`` of every rank,
    together, is microbatch ``a`` of the global batch); ``micro = 1``
    gives rows ``[index B / size, (index + 1) B / size)``. None: the whole
    batch."""
    if shard is None:
        return [(0, batch_size)]
    index, size, micro = shard
    if batch_size % (size * micro) or not 0 <= index < size:
        raise ValueError(
            f"batch {batch_size} does not split over {size} ranks x "
            f"{micro} microbatches (rank {index})")
    per = batch_size // (size * micro)
    step = batch_size // micro
    return [(a * step + index * per, a * step + (index + 1) * per)
            for a in range(micro)]


class BatchLoader:
    """Iterable over (image, target) numpy batches with static shapes.
    With ``shard`` (:func:`shard_rows`), each batch holds this rank's rows
    of the global batch of ``batch_size``, and only those are loaded; with
    ``band`` (``(lo, hi)``), the rows ``[lo, hi)`` of H of each image."""

    def __init__(
        self,
        dataset: SegDataset,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int = 0,
        num_workers: int = 8,
        indices: Optional[Sequence[int]] = None,
        worker_mode: str = "thread",
        shard: Optional[Tuple[int, int, int]] = None,
        band: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, int(num_workers))
        self.indices = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(len(dataset))
        )
        self.epoch = 0
        if shard is not None and not drop_last:
            raise ValueError("a sharded loader drops the last partial batch")
        self._rows = None if shard is None else np.concatenate(
            [np.arange(a, b) for a, b in shard_rows(self.batch_size, shard)])
        self._band = None if band is None else slice(*band)
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode: {worker_mode!r}")
        self.worker_mode = worker_mode
        if worker_mode == "process":
            self._pool = _make_process_pool(dataset, self.num_workers)
        else:
            self._pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)

    def close(self):
        """Shut the worker pool down (process pools hold OS resources)."""
        if self.worker_mode == "process":
            self._pool.terminate()
            self._pool.join()
        else:
            self._pool.shutdown(wait=False)

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _load_one(self, ds_index: int, sample_seed: int):
        rng = np.random.default_rng(sample_seed)
        return self.dataset.__getitem__(int(ds_index), rng)

    def _submit(self, chunk):
        """Start loading one batch's samples; returns a callable that waits
        for them, in order."""
        seeds = [self.seed * 1_000_003 + self.epoch * 131_071 + int(i)
                 for i in chunk]
        if self.worker_mode == "process":
            res = self._pool.map_async(
                _worker_load, [(int(i), s) for i, s in zip(chunk, seeds)])
            return res.get
        futs = [self._pool.submit(self._load_one, i, s)
                for i, s in zip(chunk, seeds)]
        return lambda: [f.result() for f in futs]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        chunks = [order[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        if self._rows is not None:  # this rank's rows
            chunks = [c[self._rows] for c in chunks]
        # the workers load batch b + 1 while the caller uses batch b
        pending = self._submit(chunks[0]) if chunks else None
        for b in range(len(chunks)):
            samples = pending()
            pending = (self._submit(chunks[b + 1]) if b + 1 < len(chunks)
                       else None)
            ims = [s[0] for s in samples]
            if len({im.shape[-1] for im in ims}) > 1:
                # mixed gray(1ch-compact)/RGB sources in one batch: broadcast
                # the compact ones so the stack is rectangular
                ims = [
                    np.broadcast_to(im, im.shape[:-1] + (3,))
                    if im.shape[-1] == 1 else im
                    for im in ims
                ]
            xs = np.stack(ims)
            ys = np.stack([s[1] for s in samples])
            if self._band is not None:  # this rank's rows of H
                xs = np.ascontiguousarray(xs[:, self._band])
                ys = np.ascontiguousarray(ys[:, self._band])
            yield xs, ys


def to_device(batch, device: torch.device) -> tuple:
    """A tuple of numpy arrays as tensors on ``device``. On a CUDA device
    each array is copied into pinned host memory and sent with
    ``non_blocking=True``, so the copy overlaps the host's next batch and
    the card's work; on the CPU the tensors share the arrays' memory."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
    if device.type == "cpu":
        return tuple(ts)
    return tuple(t.pin_memory().to(device, non_blocking=True) for t in ts)


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Yield the batches of ``iterator`` (tuples of numpy arrays) as tensors
    on ``device`` (:func:`to_device`), keeping ``size`` batches in
    flight."""
    device = torch.device("cpu" if device is None else device)
    queue = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(to_device(batch, device))
        if len(queue) >= size:
            break
    while queue:
        yield queue.popleft()
        for batch in it:
            queue.append(to_device(batch, device))
            break

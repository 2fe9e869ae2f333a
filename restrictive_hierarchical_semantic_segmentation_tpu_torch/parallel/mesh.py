"""The rank mesh: data-parallel, spatial and fold-parallel training over
``torch.distributed``; counterpart of the JAX package's
``parallel/mesh.py``, with its names.

In the JAX package a mesh entry is a device of one SPMD program, and XLA
compiles the collectives from sharding annotations. In the port a mesh
entry is a **rank**: one process driving one card (or the CPU). A
:class:`RankMesh` holds the array of ranks over its named axes and one
``torch.distributed`` process group per line of its ``data`` axis (a data
group: the ranks that differ only in their ``data`` position), per line of
its ``space`` axis (a space group), per line of its ``fold`` axis (a fold
group) and per step group (the ranks that differ only in their ``data``
and ``space`` positions: one fold's submesh), made with
``dist.new_group`` by every rank in the same order, as ``new_group``
requires: data, space, fold, then step groups. A group of one rank is
None: there is nothing to reduce.

* ``data``: each rank takes its rows of every global batch;
* ``fold``: independent folds over groups of ranks
  (``train/fold_parallel.py``); a fold ensemble's folds over the ranks of a
  fold group, whose per-level probabilities are averaged over it
  (``train/serving.py:Predictor``'s ``mesh``);
* ``space``: each rank of a space group holds a band of the rows of every
  activation (``parallel/bands.py``), exchanging halos with its
  neighbours;
* the step group (``data`` x ``space``): the BatchNorm statistics span its
  rows (``models/norm.py:set_bn_group``, the JAX ``LeanBatchNorm`` over
  the data and space axes), and the gradients, the loss's counts and the
  confusion matrices are all-reduced over it (``train/steps.py``).

:func:`init_distributed` starts the process group (``tcp://`` rendezvous
at the coordinator); without a coordinator it does nothing and every
function here sees one rank.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "SPACE_AXIS", "FOLD_AXIS", "DataGroup", "RankMesh",
           "make_mesh", "make_fold_mesh", "init_distributed", "world"]

DATA_AXIS = "data"
SPACE_AXIS = "space"
FOLD_AXIS = "fold"


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of this process: ``(0, 1)`` without an
    initialized process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _check_space(n_space: int) -> None:
    if n_space < 1:
        raise ValueError(f"n_space={n_space}: needs at least 1")


@dataclass(frozen=True)
class DataGroup:
    """The ranks of one group (a line of a mesh axis, or a step group), in
    mesh order, seen from ``rank`` (a member): ``group`` is their process
    group, None for one rank."""

    ranks: Tuple[int, ...]
    rank: int
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position in the group (on its axis)."""
        return self.ranks.index(self.rank)

    @property
    def root(self) -> int:
        """The global rank of the group's first member: its writer, and the
        source of the host decisions broadcast to the others."""
        return self.ranks[0]

    @property
    def is_main(self) -> bool:
        return self.rank == self.root


def single() -> DataGroup:
    """The data group of a process that trains alone."""
    rank, _ = world()
    return DataGroup((rank,), rank)


class RankMesh:
    """Ranks over named axes (the JAX ``Mesh`` with ranks for devices):
    ``devices`` is the integer array of ranks, ``shape`` the axis sizes by
    name. ``data_groups`` (``space_groups``, ``fold_groups``) maps the
    position of every axis but ``data`` (``space``, ``fold``) to the process
    group of the ranks along that axis there (None for one rank, or a mesh
    without the axis); ``step_groups`` maps the fold position (``()``
    without a fold axis) to the group of the ranks over ``data`` and
    ``space`` there."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        # every rank makes every group, in the same order; without a
        # process group (a mesh only sized, as the tests do) there are none;
        # a line of ranks met again (a step group of one axis) reuses its
        # group
        self._made: Dict[tuple, object] = {}
        self._lines, self.data_groups = self._axis_groups((DATA_AXIS,))
        self._space_lines, self.space_groups = self._axis_groups(
            (SPACE_AXIS,))
        self._fold_lines, self.fold_groups = self._axis_groups((FOLD_AXIS,))
        self._step_lines, self.step_groups = self._axis_groups(
            (DATA_AXIS, SPACE_AXIS))

    def _axis_groups(self, axes: Tuple[str, ...]):
        """``(lines, groups)`` of ``axes``: the ranks along them (in mesh
        order) at each position of the other axes, and their process
        groups."""
        axes = tuple(a for a in axes if a in self.axis_names)
        if not axes:
            return {}, {}
        dims = [self.axis_names.index(a) for a in axes]
        moved = np.moveaxis(self.devices, dims,
                            list(range(-len(dims), 0)))
        lead = moved.shape[:moved.ndim - len(dims)]
        lines = {idx: tuple(int(r) for r in moved[idx].ravel())
                 for idx in np.ndindex(*lead)}
        live = dist.is_available() and dist.is_initialized()
        groups = {}
        for idx, r in lines.items():
            if live and len(r) > 1 and r not in self._made:
                self._made[r] = _group(r)
            groups[idx] = self._made.get(r) if live and len(r) > 1 else None
        return lines, groups

    def position(self, rank: Optional[int] = None) -> Optional[tuple]:
        """The index of ``rank`` (this process's by default) in
        ``devices``, or None for a rank the mesh leaves idle."""
        rank = world()[0] if rank is None else rank
        found = np.argwhere(self.devices == rank)
        return tuple(int(i) for i in found[0]) if len(found) else None

    def data_group(self, rank: Optional[int] = None) -> DataGroup:
        """The :class:`DataGroup` ``rank`` (this process's by default)
        belongs to."""
        return self._axis_group((DATA_AXIS,), self._lines,
                                self.data_groups, rank)

    def space_group(self, rank: Optional[int] = None) -> DataGroup:
        """The ranks of ``rank``'s space group (this process's by default):
        those that share every position with it but ``space``, in
        space-axis order (its ``index`` is the rank's band)."""
        return self._axis_group((SPACE_AXIS,), self._space_lines,
                                self.space_groups, rank)

    def step_group(self, rank: Optional[int] = None) -> DataGroup:
        """The ranks of ``rank``'s step group (this process's by default):
        those that share every position with it but ``data`` and
        ``space``, in (data, space) order. Its first rank writes."""
        return self._axis_group((DATA_AXIS, SPACE_AXIS), self._step_lines,
                                self.step_groups, rank)

    def fold_group(self, rank: Optional[int] = None) -> DataGroup:
        """The ranks of ``rank``'s fold group (this process's by default):
        those that share every position with it but ``fold``, in fold-axis
        order, as a :class:`DataGroup` (its ``index`` is the rank's fold
        position)."""
        return self._axis_group((FOLD_AXIS,), self._fold_lines,
                                self.fold_groups, rank)

    def _axis_group(self, axes: Tuple[str, ...], lines: dict, groups: dict,
                    rank: Optional[int]) -> DataGroup:
        axes = tuple(a for a in axes if a in self.axis_names)
        if not axes:
            raise ValueError(f"this mesh has none of the axes {axes}; got "
                             f"{self.axis_names}")
        rank = world()[0] if rank is None else rank
        pos = self.position(rank)
        if pos is None:
            raise ValueError(f"rank {rank} is idle in this mesh")
        dims = {self.axis_names.index(a) for a in axes}
        idx = tuple(p for d, p in enumerate(pos) if d not in dims)
        group = groups[idx]
        if group is None and len(lines[idx]) > 1:
            raise RuntimeError(
                f"a {'x'.join(axes)} group of {len(lines[idx])} ranks needs "
                "torch.distributed (init_distributed) before the mesh")
        return DataGroup(lines[idx], rank, group)


def _group(ranks: Tuple[int, ...]):
    """The process group of ``ranks``: the default group when they are
    every rank, else a new one (every rank must call this alike)."""
    if sorted(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def _ranks(ranks: Optional[Sequence[int]]) -> list:
    return list(range(world()[1]) if ranks is None else ranks)


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              ranks: Optional[Sequence[int]] = None) -> RankMesh:
    """A (data, space) mesh over ``ranks`` (every rank by default); all of
    them on the data axis unless ``n_data`` says fewer."""
    _check_space(n_space)
    ranks = _ranks(ranks)
    if n_data is None:
        n_data = len(ranks) // n_space
    use = n_data * n_space
    if use > len(ranks):
        raise ValueError(
            f"mesh {n_data}x{n_space} needs {use} ranks, have {len(ranks)}")
    arr = np.asarray(ranks[:use]).reshape(n_data, n_space)
    return RankMesh(arr, (DATA_AXIS, SPACE_AXIS))


def fold_mesh_shape(n_folds: int, batch_size: int, n_ranks: int,
                    n_space: int = 1) -> Tuple[int, int, int]:
    """The (fold, data, space) sizes of :func:`make_fold_mesh`: the fold
    axis the largest divisor of ``n_folds`` that fits the ranks, the data
    axis the largest divisor of ``batch_size`` in what remains (JAX
    ``parallel/mesh.py:make_fold_mesh``)."""
    if n_space < 1 or n_space > n_ranks:
        raise ValueError(f"n_space={n_space} with {n_ranks} ranks")
    n_fold = max(f for f in range(1, n_folds + 1)
                 if n_folds % f == 0 and f * n_space <= n_ranks)
    avail = n_ranks // (n_fold * n_space)
    n_data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    return n_fold, n_data, n_space


def make_fold_mesh(n_folds: int, batch_size: int, n_space: int = 1,
                   ranks: Optional[Sequence[int]] = None) -> RankMesh:
    """(fold, data, space) mesh for fold-parallel cross-validation: fold
    group ``i`` trains folds ``[i F / n_fold, (i + 1) F / n_fold)`` in
    lockstep, each data-parallel over its data group. Sized as the JAX
    ``make_fold_mesh`` (:func:`fold_mesh_shape`); ranks beyond the mesh
    idle, and the same line as JAX's says so."""
    ranks = _ranks(ranks)
    n_fold, n_data, n_space = fold_mesh_shape(n_folds, batch_size,
                                              len(ranks), n_space)
    _check_space(n_space)
    use = n_fold * n_data * n_space
    if use < len(ranks):
        print(f"make_fold_mesh: using {use} of {len(ranks)} devices "
              f"(fold={n_fold} x data={n_data} x space={n_space}; "
              f"{len(ranks) - use} idle — fold/batch divisibility)")
    arr = np.asarray(ranks[:use]).reshape(n_fold, n_data, n_space)
    return RankMesh(arr, (FOLD_AXIS, DATA_AXIS, SPACE_AXIS))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join the process group of a multi-process run: call it once per
    process, before anything touches the card. Without a coordinator
    (``host:port``) it does nothing. ``backend``, unless given: ``nccl``
    when ``device`` (``cuda`` by default) is a CUDA device and this node
    has a card for each of its ranks (``LOCAL_WORLD_SIZE``, else all
    ``num_processes``: one node), else ``gloo``. NCCL refuses two ranks on
    one device, so ranks that outnumber the cards share them over gloo,
    which moves CUDA tensors through host memory where it must; the first
    rank says so. On a CUDA device this process's card is made current
    first."""
    if not coordinator:
        return
    if num_processes is None or process_id is None or num_processes < 1 \
            or not 0 <= process_id < num_processes:
        raise ValueError(
            f"init_distributed: process {process_id} of {num_processes}: "
            "needs 0 <= process_id < num_processes")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "gloo"
        if dev.type == "cuda":
            ranks = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
            cards = torch.cuda.device_count()
            if ranks <= cards:
                backend = "nccl"
            elif process_id == 0:
                print(f"init_distributed: {ranks} ranks share {cards} "
                      "card(s) on this node: gloo (NCCL takes one rank a "
                      "card)")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)

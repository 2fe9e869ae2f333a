"""Bands of rows over the ranks of a space group: the ``space`` mesh axis
of the JAX package (``parallel/mesh.py``: ``batch_sharding`` is
``P(data, space, None, None)``).

The JAX package has no module to port here. It annotates H as sharded and
GSPMD inserts the halo exchanges of the convolutions and the cross-shard
reductions itself. In the port every rank of a space group holds a band of
rows of every activation, and the exchanges are explicit:

* :func:`band` is the split: a tensor of global height ``H`` over ``n``
  ranks has bands of ``ceil(H / n)`` rows, the last one short (the split
  XLA's SPMD partitioner uses for an uneven dimension). Every layer's
  output has its own bands, from the layer's global output height. A band
  of no rows is refused (:func:`check_bands`).
* :func:`fetch_rows` gives each rank any global rows of a banded tensor
  (zeros outside ``[0, H)``), exchanged point to point with the ranks that
  own them; its backward sends each row's gradient back to its owner.
  The convolutions' halos (:func:`conv2d`), the max-pool on an odd band
  start (:func:`max_pool2`), the resize's source rows (:func:`resize`) and
  the UNet's pad (:func:`pad_rows`) are fetches. Every rank computes every
  rank's request from the global heights, so the exchanges need no
  handshake, and a fetch that every rank serves from its own band sends
  nothing.
* :func:`all_reduce_sum` is a spatial sum that every rank uses whole (the
  FiLM pooling, the loss terms): its backward is an all-reduce too, so
  each rank's rows get the gradient of every rank's use of the sum.
* :func:`gather_bands` assembles the whole height for the host (PNG dumps,
  the flat model's reconstruction).
* A forward installed on a conv for the duration of a call (int8 serving
  and its calibration, ``train/quantize.py``) runs in :func:`conv2d` too,
  on the fetched rows and with this rank's band beside them;
  :func:`all_reduce_max` gives every rank the maximum over its group.

A model built for one rank runs banded after :func:`set_space_group`:
its modules then take the global height of their input as an argument
(``h``) and compute the bands of their outputs from it. gloo moves no CUDA
tensor between two ranks, so on a gloo group the rows go through host
memory; NCCL sends them from the card.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_band_nchw, resize_nchw, source_rows
from .mesh import DataGroup

__all__ = ["band", "bands", "check_bands", "fetch_rows", "all_reduce_sum",
           "all_reduce_max", "spatial_mean", "gather_bands", "global_height",
           "set_space_group", "conv2d", "conv_height", "max_pool2", "resize",
           "pad_rows", "active", "EXCHANGES"]

# exchanges that moved rows (forward and backward), and the bytes this
# rank sent in them: the halo metrics of PERF.md
EXCHANGES = {"fetches": 0, "bytes_sent": 0}


def active(space: Optional[DataGroup]) -> Optional[DataGroup]:
    """``space`` where it spans more than one rank, else None (the whole
    height on this rank)."""
    return space if space is not None and space.size > 1 else None


def band(size: int, n: int, index: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` rows of rank ``index`` of ``n`` along an axis of
    ``size``: ``ceil(size / n)`` rows each, the last band short."""
    per = -(-size // n)
    lo = min(index * per, size)
    return lo, min(lo + per, size)


def bands(size: int, n: int) -> List[Tuple[int, int]]:
    """Every rank's :func:`band`."""
    return [band(size, n, i) for i in range(n)]


def check_bands(size: int, n: int) -> None:
    """Raise for a height that leaves a rank of ``n`` no row."""
    if band(size, n, n - 1)[0] >= size:
        raise ValueError(
            f"a height of {size} rows over {n} space ranks leaves a band "
            f"of no rows (bands of {-(-size // n)}); choose a larger image "
            "or fewer space ranks")


def _stage(group) -> bool:
    """True where the rows of a CUDA tensor must go through the host."""
    return dist.get_backend(group) == dist.Backend.GLOO


def _exchange(sends: dict, recvs: dict, space: DataGroup, like: torch.Tensor
              ) -> dict:
    """Send ``sends[j]`` to space rank ``j`` and receive a tensor of shape
    ``recvs[j]`` from rank ``j``, all at once; returns the received
    tensors on ``like``'s device."""
    if not sends and not recvs:
        return {}
    stage = like.is_cuda and _stage(space.group)
    host = torch.device("cpu") if stage else like.device
    ops, bufs = [], {}
    for j, t in sorted(sends.items()):
        t = t.contiguous()
        if stage:
            t = t.cpu()
        EXCHANGES["bytes_sent"] += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t, space.ranks[j], space.group))
    for j, shape in sorted(recvs.items()):
        bufs[j] = torch.empty(shape, dtype=like.dtype, device=host)
        ops.append(dist.P2POp(dist.irecv, bufs[j], space.ranks[j],
                              space.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    EXCHANGES["fetches"] += 1
    return {j: b.to(like.device) for j, b in bufs.items()}


def _rows_like(x: torch.Tensor, m: int) -> torch.Tensor:
    """Zeros of ``x``'s shape with ``m`` rows (axis -2), in its memory
    format (a channels_last NCHW tensor stays channels_last)."""
    shape = list(x.shape)
    shape[-2] = m
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        b, c, _, w = shape
        return x.new_zeros((b, m, w, c)).permute(0, 3, 1, 2)
    return x.new_zeros(shape)


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (0, 0)


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, lo, hi, space):
        ctx.plan = (h, lo, hi, space)
        return _fetch(x, h, lo, hi, space)

    @staticmethod
    def backward(ctx, g):
        h, lo, hi, space = ctx.plan
        return _return_rows(g, h, lo, hi, space), None, None, None, None


def _fetch(x, h, lo, hi, space):
    owners = bands(h, space.size)
    me = space.index
    own = owners[me]
    want = (lo[me], hi[me])
    out = _rows_like(x, want[1] - want[0])
    sends, recvs = {}, {}
    for j in range(space.size):
        if j == me:
            continue
        a, b = _overlap(own, (lo[j], hi[j]))
        if b > a:
            sends[j] = x[..., a - own[0]:b - own[0], :]
        a, b = _overlap(owners[j], want)
        if b > a:
            shape = list(x.shape)
            shape[-2] = b - a
            recvs[j] = shape
    got = _exchange(sends, recvs, space, x)
    a, b = _overlap(own, want)
    if b > a:
        out[..., a - want[0]:b - want[0], :] = x[..., a - own[0]:b - own[0],
                                                 :]
    for j, t in got.items():
        a, b = _overlap(owners[j], want)
        out[..., a - want[0]:b - want[0], :] = t
    return out


def _return_rows(g, h, lo, hi, space):
    """The adjoint of :func:`_fetch`: each fetched row's gradient added to
    its owner's band, local rows first, then by rank."""
    owners = bands(h, space.size)
    me = space.index
    own = owners[me]
    want = (lo[me], hi[me])
    grad = _rows_like(g, own[1] - own[0])
    sends, recvs = {}, {}
    for j in range(space.size):
        if j == me:
            continue
        a, b = _overlap(owners[j], want)
        if b > a:
            sends[j] = g[..., a - want[0]:b - want[0], :]
        a, b = _overlap(own, (lo[j], hi[j]))
        if b > a:
            shape = list(g.shape)
            shape[-2] = b - a
            recvs[j] = shape
    got = _exchange(sends, recvs, space, g)
    a, b = _overlap(own, want)
    if b > a:
        grad[..., a - own[0]:b - own[0], :] += g[..., a - want[0]:
                                                 b - want[0], :]
    for j, t in sorted(got.items()):
        a, b = _overlap(own, (lo[j], hi[j]))
        grad[..., a - own[0]:b - own[0], :] += t
    return grad


def fetch_rows(x: torch.Tensor, h: int, lo: Sequence[int],
               hi: Sequence[int], space: DataGroup) -> torch.Tensor:
    """Global rows ``[lo[i], hi[i])`` (axis -2) of a tensor of global
    height ``h`` banded over ``space``, for this rank ``i``, with zero rows
    outside ``[0, h)``. ``lo`` and ``hi`` hold every rank's request (every
    rank passes the same lists). A request that every rank serves from its
    own band returns ``x`` itself."""
    n, me = space.size, space.index
    own = band(h, n, me)
    if x.shape[-2] != own[1] - own[0]:
        raise ValueError(
            f"rank {me} of {n} holds {x.shape[-2]} rows of a tensor of "
            f"height {h}; its band is {own}")
    if all((lo[j], hi[j]) == band(h, n, j) for j in range(n)):
        return x
    return _FetchRows.apply(x, h, tuple(lo), tuple(hi), space)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, space: Optional[DataGroup]
                   ) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``space`` on every rank; its
    backward all-reduces the gradient (every rank uses the whole sum)."""
    if space is None or space.group is None:
        return t
    return _AllReduceSum.apply(t, space.group)


def all_reduce_max(t: torch.Tensor, space: Optional[DataGroup]
                   ) -> torch.Tensor:
    """The element-wise maximum of ``t`` over the ranks of ``space`` on
    every rank (``t`` itself without a group); no gradient."""
    if space is None or space.group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=space.group)
    return t


def spatial_mean(t: torch.Tensor, dims: tuple, space: Optional[DataGroup]
                 ) -> torch.Tensor:
    """``t.mean(dims)`` over the whole height of a banded ``t``: the bands'
    sums and element counts added by one :func:`all_reduce_sum`."""
    if space is None or space.group is None:
        return t.mean(dim=dims)
    s = t.sum(dim=dims)
    count = t.new_full((1,), t.numel() / max(1, s.numel()))
    tot = all_reduce_sum(torch.cat([s.reshape(-1), count]), space)
    return (tot[:-1] / tot[-1]).view(s.shape)


def gather_bands(x: torch.Tensor, h: int, space: Optional[DataGroup],
                 dim: int = -2) -> torch.Tensor:
    """The whole height ``h`` of a banded tensor (axis ``dim``) on every
    rank of ``space``: an all-reduce of the bands in a zero tensor (exact:
    every element is one rank's value plus zeros; gloo reduces CUDA
    tensors but gathers none). No gradient."""
    if space is None or space.group is None:
        return x
    dim = dim % x.dim()
    lo, hi = band(h, space.size, space.index)
    shape = list(x.shape)
    shape[dim] = h
    full = x.new_zeros(shape)
    full.narrow(dim, lo, hi - lo).copy_(x)
    dist.all_reduce(full, group=space.group)
    return full


def global_height(local: int, space: DataGroup, device) -> int:
    """The global height whose bands the ranks of ``space`` hold (their
    rows added: one small all-reduce)."""
    dev = torch.device(device)
    if dev.type == "cuda" and _stage(space.group):
        dev = torch.device("cpu")
    t = torch.tensor([local], dtype=torch.int64, device=dev)
    dist.all_reduce(t, group=space.group)
    h = int(t.item())
    if local != band(h, space.size, space.index)[1] \
            - band(h, space.size, space.index)[0]:
        raise ValueError(
            f"rank {space.index} of {space.size} holds {local} rows of a "
            f"height of {h}; its band is {band(h, space.size, space.index)}")
    return h


def set_space_group(model: nn.Module, space: Optional[DataGroup]
                    ) -> nn.Module:
    """Make every module of ``model`` that runs on bands (those with a
    ``space`` attribute) take its rows from the ranks of ``space`` (a
    :class:`..parallel.mesh.DataGroup` of the space axis; None, or one
    rank: the whole height on this rank). The counterpart of
    ``models/norm.py:set_bn_group`` for the spatial axis; the BatchNorms
    take their group from that function."""
    space = active(space)
    for m in model.modules():
        if hasattr(m, "space"):
            m.space = space
    return model


# ------------------------------------------------------- banded operations
def conv_height(conv: nn.Conv2d, h: Optional[int]) -> Optional[int]:
    """The output height of ``conv`` for an input of height ``h``."""
    if h is None:
        return None
    k, s, p, d = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                  conv.dilation[0])
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def conv2d(conv: nn.Conv2d, x: torch.Tensor, h: Optional[int],
           space: Optional[DataGroup]) -> torch.Tensor:
    """``conv(x)`` for the band ``x`` of a tensor of height ``h``: this
    rank's output rows, from its input rows and the halo its kernel, stride
    and padding reach (zero rows beyond the tensor: the zero padding), H
    padded 0 and W as the conv pads it. ``conv(x)`` itself without a
    space group. A forward installed on the conv for a call (an instance
    attribute ``forward``: ``train/quantize.py``'s int8 forward or its
    calibration) takes the fetched rows with that padding, and the band
    ``x`` as ``band``."""
    if space is None:
        return conv(x)
    k, s, p, d = (conv.kernel_size[0], conv.stride[0], conv.padding[0],
                  conv.dilation[0])
    ho = conv_height(conv, h)
    check_bands(ho, space.size)
    out = bands(ho, space.size)
    lo = [a * s - p for a, _ in out]
    hi = [(b - 1) * s - p + d * (k - 1) + 1 for _, b in out]
    rows = fetch_rows(x, h, lo, hi, space)
    installed = vars(conv).get("forward")
    if installed is not None:
        return installed(rows, padding=(0, conv.padding[1]), band=x)
    return F.conv2d(rows, conv.weight, conv.bias, (s, conv.stride[1]),
                    (0, conv.padding[1]), conv.dilation, conv.groups)


def max_pool2(x: torch.Tensor, h: Optional[int],
              space: Optional[DataGroup]) -> torch.Tensor:
    """``F.max_pool2d(x, 2)`` (odd sizes floored) on a band: the rows of
    this rank's output band, fetched where a band starts on an odd row."""
    if space is None:
        return F.max_pool2d(x, 2)
    out = bands(h // 2, space.size)
    check_bands(h // 2, space.size)
    rows = fetch_rows(x, h, [2 * a for a, _ in out], [2 * b for _, b in out],
                      space)
    return F.max_pool2d(rows, 2)


def resize(x: torch.Tensor, h: Optional[int], size, align_corners: bool,
           space: Optional[DataGroup]) -> torch.Tensor:
    """``ops/resize.py:resize_nchw(x, size, align_corners)`` on a band of a
    tensor of height ``h``: this rank's band of the output height
    ``size[0]``, from the source rows its interpolation reads (the tables
    of the global sizes); W as without bands."""
    if space is None:
        return resize_nchw(x, size, align_corners)
    out_h = int(size[0])
    check_bands(out_h, space.size)
    out = bands(out_h, space.size)
    if out_h == h:  # the H axis unchanged: the same bands
        return resize_nchw(x, (x.shape[-2], size[1]), align_corners)
    src = [source_rows(h, out_h, align_corners, a, b) for a, b in out]
    rows = fetch_rows(x, h, [a for a, _ in src], [b for _, b in src], space)
    a, b = out[space.index]
    return resize_band_nchw(rows, src[space.index][0], h, size,
                            align_corners, a, b)


def pad_rows(x: torch.Tensor, h: int, top: int, bottom: int,
             space: Optional[DataGroup]) -> torch.Tensor:
    """``F.pad`` of H by ``(top, bottom)`` rows of zeros on a band of a
    tensor of height ``h``: this rank's band of the padded height (a
    shift of the rows, through :func:`fetch_rows`)."""
    if space is None:
        return F.pad(x, (0, 0, top, bottom))
    ho = h + top + bottom
    check_bands(ho, space.size)
    out = bands(ho, space.size)
    return fetch_rows(x, h, [a - top for a, _ in out],
                      [b - top for _, b in out], space)

"""BatchNorm + activation kernels: the folded eval-mode pass, the batch
statistics and the train-mode backward.

Counterpart of the JAX package's ``ops/fused_bn_act.py``. Each of its three
Pallas kernels is a CUDA kernel written for Hopper here, built with ``nvcc``
at first use and called through ``ctypes``, with a plain PyTorch version
beside it:

=====================================  ===================  ==============================
Pallas kernel (JAX file)               CUDA source          plain version
=====================================  ===================  ==============================
``_scale_bias_act_kernel``             ``scale_bias_act.cu``  :func:`_scale_bias_act_ref`
``_scale_bias_act_kernel`` with the    ``scale_bias_act.cu``  :func:`_bn_act_forward_ref`
XLA prologue of ``_fba_fwd``           (``bn_act_forward``)
``_stats_kernel`` (``bn_stats``)       ``bn_stats.cu``        :func:`_bn_stats_ref`
                                       (one launch per call)
``_bwd_kernel`` + the tail of          ``bn_backward.cu``     :func:`_bn_backward_ref`
``_fba_bwd`` that forms dx             (one cooperative pass)
=====================================  ===================  ==============================

Every wrapper picks by where the tensor lies: a CPU tensor goes through the
plain version, a CUDA tensor through the kernel (or the call raises).
``LAUNCHES`` counts ``scale_bias_act`` launches (the eval entry of kernel 2)
and ``TRAIN_LAUNCHES`` the train-mode kernels', by name (``bn_act_forward``:
kernel 2's train entry); both count kernel launches and nothing else.
``GRAD_COPIES`` counts backward launches whose incoming gradient had to be
copied into the contiguous ``(rows, C)`` layout first.

The statistics kernel is one launch per call: its blocks' partial sums are
added by the blocks that draw the last ticket from integer counters (one
per chunk of 16 strips, one per column group); so are those of the BN
backward's reduce entry (one per chain of strips, one per column group).
Those counters must be 0 before every launch, and every launch leaves them
at 0 again. They live in one int32 buffer per device, made with
``torch.zeros`` at the first call on that device (which must not be inside
CUDA graph capture) and never freed: one slot of ``_COUNTERS_PER_STREAM``
counters per stream, which the two kernels' launches on that stream take
in turn, so calls on two streams never share a counter. A launch captured
in a CUDA graph keeps the slot of the stream it was captured on, so do not
replay a graph while calls run on that stream. A call that raises does so
before its launch and leaves the counters as they were.

:class:`FusedBNAct` is the train-mode ``act(gamma * (x - mean) * rstd +
beta)`` as an autograd Function (the JAX ``fused_bn_act`` custom VJP): its
forward is kernel 2's train entry (:func:`bn_act_forward`: one launch that
forms rstd, scale and shift from the statistics, streams y and, when asked,
moves the running statistics in place), it saves only x and ``(C,)``
vectors, and its backward is the BN backward kernel (one launch per call).
:func:`batch_norm_act` takes the statistics first, on ``x.detach()``: a
train-mode BatchNorm on the card is kernel 1, then kernel 2, and no PyTorch
op between them.

Global-batch BatchNorm over a data-parallel group of ranks
(:func:`sync_batch_norm_act`, :class:`SyncFusedBNAct`; the JAX
``LeanBatchNorm``'s statistics over the batch of the whole ``data`` mesh
axis) splits kernels 1 and 3 at their reductions, through three more entry
points, each counted in ``TRAIN_LAUNCHES`` under its own name and each with
a plain version here:

=================================  ==========================================
entry (CUDA source)                plain version
=================================  ==========================================
``bn_stats_sums`` (bn_stats.cu)    :func:`_bn_stats_sums_ref`: f64 Σx, Σx², n
``bn_backward_reduce``             :func:`_bn_backward_reduce_ref`: the local
(bn_backward.cu)                   dgamma, dbeta, and f64 Σdy, Σdy·x̂, n
``bn_backward_dx``                 :func:`_bn_backward_dx_ref`: dx from the
(bn_backward.cu)                   group's sums
=================================  ==========================================

The forward all-reduces the ``(2C + 1)`` f64 sums of kernel 1 over the
group and hands them to kernel 2's train entry, which forms mean and var in
f64 with kernel 1's own last step (:func:`stats_from_sums` is the same
arithmetic in PyTorch, the plain version's) before it streams y; the
backward all-reduces the sums of the reduce entry between it and the dx
entry. dgamma and dbeta stay the local sums: the trainer's gradient
all-reduce adds them. On one rank the split equals the fused kernels bit
for bit (mean, var, dx, dgamma, dbeta); a group of one rank never takes it.

Any C: the kernels read the contiguous ``(rows, C)`` tensor as rows of
``L = lcm(C, 8)`` elements (:func:`_view_width`; ``L / C`` image rows
each, ``L = C`` where ``C % 8 == 0``), so their 16-byte vectors of 8
channels never straddle a row of the view. Kernels 1 and 3's wrappers tile
the per-channel vectors to ``L`` once per call (:func:`_tiled`); kernel 2
takes them untiled (column j of the view is channel ``j mod C``). The last
``rows mod (L / C)`` image rows are a tail that each launch takes on its
own, and kernels 1 and 3 fold the ``L / C`` columns of each channel into
its sums in a fixed order (``csrc/bn_reduce.cuh``). At ``C % 8 == 0`` the launches are
what they were. ``L`` is at most 16384 (:data:`_MAX_WIDTH`: any C up to
2048, multiples of 8 up to 16384), the dx entry's at most 4096.

The kernels write new tensors (out of place): the eval-mode caller could
let scale-bias-act overwrite the dead conv output, but the saving is one
allocation from PyTorch's caching allocator, not device traffic.

Export: ``torch.export`` traces with tensors that hold no data, so it
cannot see a ``ctypes`` launch. The scale-bias-act kernel is therefore also
the operator ``torch.ops.rhss.scale_bias_act`` (``torch.library``): its
CUDA implementation is :func:`_launch` (checks, the kernel, ``LAUNCHES``),
its CPU implementation the plain version, and its fake implementation
gives the output's shape and dtype from the inputs'. Under
``torch.compiler.is_exporting()`` :func:`fused_scale_bias_act` calls the
operator, so an exported program holds one node per launch and runs the
kernel (or, on the CPU, the plain version) when it is called. Eager calls
go to :func:`_launch` directly: the operator's dispatch would add host
time to every call of a host-bound forward (``PERF.md``).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch
import torch.distributed as dist

__all__ = ["fused_scale_bias_act", "bn_stats", "bn_act_backward",
           "bn_act_forward", "FusedBNAct", "fused_bn_act", "batch_norm_act",
           "bn_stats_sums",
           "stats_from_sums", "bn_backward_reduce", "bn_backward_dx",
           "SyncFusedBNAct", "sync_batch_norm_act", "ACTS", "TRAIN_ACTS",
           "LAUNCHES", "TRAIN_LAUNCHES", "GRAD_COPIES"]

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
# the train-mode backward differentiates these two only
TRAIN_ACTS = ("none", "relu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernel launches since the count was last set to 0 (chip_smoke.py reads it)
LAUNCHES = 0
TRAIN_LAUNCHES = {"bn_stats": 0, "bn_backward": 0, "bn_stats_sums": 0,
                  "bn_backward_reduce": 0, "bn_backward_dx": 0,
                  "bn_act_forward": 0}
GRAD_COPIES = 0


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64 (the plain versions' math type:
    f64 lets ``torch.autograd.gradcheck`` check them)."""
    return t if t.dtype == torch.float64 else t.float()


def _scale_bias_act_ref(x: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version: f32 math, one rounding to x's dtype at the end."""
    y = _wide(x) * _wide(scale) + _wide(shift)
    if act == "relu":
        y = torch.relu(y)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, 0.01 * y)
    return y.to(x.dtype)


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points: (library, symbol) -> argtypes; each is loaded (and its
# library built) at first use
_SIGNATURES = {
    ("scale_bias_act", "rhss_scale_bias_act"):
        [_P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # x, y, rows, C, dtype, act, gamma, beta, eps, mean, var, sums, the
    # running mean and var, momentum, update, the out mean, var, rstd,
    # scale and shift, stream
    ("scale_bias_act", "rhss_bn_act_forward"):
        [_P, _P, _I64, _I, _I, _I, _P, _P, ctypes.c_float, _P, _P, _P, _P,
         _P, ctypes.c_double, _I, _P, _P, _P, _P, _P, _P],
    ("bn_stats", "rhss_bn_stats"): [_P, _I64, _I, _I, _P, _P, _P, _P, _P],
    ("bn_backward", "rhss_bn_backward"):
        [_P, _P, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    ("bn_stats", "rhss_bn_stats_sums"): [_P, _I64, _I, _I, _P, _P, _P, _P],
    ("bn_backward", "rhss_bn_backward_reduce"):
        [_P, _P, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    ("bn_backward", "rhss_bn_backward_dx"):
        [_P, _P, _I64, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
}
_FNS = {}


def _fn(lib: str, name: str):
    key = (lib, name)
    if key not in _FNS:
        from ._build import load

        fn = getattr(load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[key]
        _FNS[key] = fn
    return _FNS[key]


def _call(x: torch.Tensor, what: str, fn, *args) -> None:
    """Run a C entry point with x's device current; raise on a CUDA error."""
    if x.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:  # the stream belongs to x's device: launch with it current
        with torch.cuda.device(x.device):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# the widest view lcm(C, 8) of a C that is no multiple of 8 (kMaxWidth in
# csrc/common.cuh): any C up to 2048
_MAX_WIDTH = 16384


def _view_width(c: int) -> int:
    """The width L = lcm(C, 8) of the rows the kernels read."""
    return c * 8 // math.gcd(c, 8)


def _check_width(c: int, most: int, what: str) -> None:
    if _view_width(c) > most:
        raise ValueError(f"{what} takes C <= {most} where C % 8 == 0 and "
                         f"C <= {most // 8} otherwise (lcm(C, 8) <= "
                         f"{most}); got C = {c}")


def _tiled(t: torch.Tensor, c: int) -> torch.Tensor:
    """Per-channel values (..., C) tiled to the view's width L along the
    last axis (t itself where L = C)."""
    per = _view_width(c) // c
    return t if per == 1 else t.repeat(*([1] * (t.dim() - 1)), per)


def _check_layout(x: torch.Tensor, what: str) -> int:
    """The (rows, C) checks that read no data (a fake tensor passes them
    too); returns C."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (..., C) tensor "
                         "(channels_last activations, viewed as NHWC)")
    c = x.shape[-1]
    if c % 8:
        _check_width(c, _MAX_WIDTH, what)
    return c


def _check_rows_c(x: torch.Tensor, what: str) -> int:
    """The (rows, C) checks every kernel shares; returns C."""
    c = _check_layout(x, what)
    if x.data_ptr() % 16:
        raise ValueError(f"{what} needs x 16-byte aligned")
    return c


def _check_vector(t: torch.Tensor, c: int, what: str) -> None:
    if t.shape != (c,):
        raise ValueError(f"{what} must have shape ({c},), got {tuple(t.shape)}")


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    return x.device.type


def _per_channel(t: torch.Tensor, c: int, device, what: str) -> torch.Tensor:
    _check_vector(t, c, what)
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, x on {device}")
    t = t.to(torch.float32).contiguous()
    if t.data_ptr() % 16:  # the kernel reads 4 floats at a time
        t = t.clone()
    return t


def _launch(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            act: str) -> torch.Tensor:
    global LAUNCHES
    c = _check_rows_c(x, "scale_bias_act")
    scale = _per_channel(scale, c, x.device, "scale")
    shift = _per_channel(shift, c, x.device, "shift")
    y = torch.empty_like(x)
    _call(x, "scale_bias_act", _fn("scale_bias_act", "rhss_scale_bias_act"),
          x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
          x.numel() // c, c, _DTYPES[x.dtype], ACTS[act], _stream(x))
    LAUNCHES += 1
    return y


@torch.library.custom_op("rhss::scale_bias_act", mutates_args=(),
                         device_types="cuda")
def _scale_bias_act_op(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, act: str) -> torch.Tensor:
    """``torch.ops.rhss.scale_bias_act``: the kernel on a CUDA tensor."""
    return _launch(x, scale, shift, act)


@_scale_bias_act_op.register_kernel("cpu")
def _scale_bias_act_op_cpu(x, scale, shift, act):
    return _scale_bias_act_ref(x, scale, shift, act)


@_scale_bias_act_op.register_fake
def _scale_bias_act_op_fake(x, scale, shift, act):
    c = _check_layout(x, "scale_bias_act")
    _check_vector(scale, c, "scale")
    _check_vector(shift, c, "shift")
    return torch.empty_like(x)


def fused_scale_bias_act(x: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor,
                         act: str = "relu") -> torch.Tensor:
    """``act(x * scale + shift)`` over the last (channel) axis of ``x``.

    ``scale`` and ``shift`` are ``(C,)`` and taken as f32; the result has
    x's dtype and shape. ``act``: "none" | "relu" | "leaky_relu" (0.01).
    Under ``torch.export`` the call is the operator
    ``torch.ops.rhss.scale_bias_act``."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; expected one of "
                         f"{sorted(ACTS)}")
    if torch.compiler.is_exporting():
        return torch.ops.rhss.scale_bias_act(x, scale, shift, act)
    if _device_of(x, "scale_bias_act") == "cpu":
        return _scale_bias_act_ref(x, scale, shift, act)
    return _launch(x, scale, shift, act)


# ----------------------------------------------------------- batch statistics
def _bn_stats_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: f32 sums over the rows of (rows, C), JAX's formula."""
    xf = _wide(x.reshape(-1, x.shape[-1]))
    n = xf.shape[0]
    mean = xf.sum(0) / n
    var = (xf * xf).sum(0) / n - mean * mean
    return mean, torch.clamp(var, min=0.0)


# the most strips a column reduction splits its rows into (kTargetBlocks in
# csrc/bn_reduce.cuh: the two must be equal); the BN backward keeps its edz /
# n and eydz / n in the workspace's last rows and uses fewer strips
_MAX_STRIPS = 528


# the widest view lcm(C, 8) the dx entry takes (kDxMaxChannels in
# csrc/bn_backward.cu: one block's threads per channel vector)
_DX_MAX_CHANNELS = 4096


def _workspace(x: torch.Tensor, c: int) -> torch.Tensor:
    """Scratch for a column reduction's per-strip partials: two f32 sums
    per column of the view and strip."""
    return torch.empty(2 * _MAX_STRIPS * _view_width(c), dtype=torch.float32,
                       device=x.device)


# the ticket counters of the statistics kernel (csrc/bn_stats.cu) and the BN
# backward's reduce entry (csrc/bn_backward.cu): for each of at most
# kMaxGroups = 64 column groups of 32 channel vectors (so L <= 8 * 32 * 64),
# one for the group and one per chunk of 16 strips (at most 33); the reduce
# entry 17 per column group (its chains' tree, one per chain of strips), the
# first 64 * 17; then the one both draw from to fold a view wider than C
# (kFoldCounter in csrc/bn_reduce.cuh). A launch leaves them at 0, so the
# two kernels share a stream's slot. Slots: the streams of one device that
# may call them (torch's stream pools hold 32 per priority, plus the
# default stream and the graph capture stream)
_STATS_GROUPS = 64
_STATS_CHUNKS = -(-_MAX_STRIPS // 16)
_COUNTERS_PER_STREAM = _STATS_GROUPS * (1 + _STATS_CHUNKS) + 1
_COUNTER_SLOTS = 256
_COUNTERS = {}  # device index -> int32 (_COUNTER_SLOTS, _COUNTERS_PER_STREAM)
_SLOTS = {}  # (device index, stream handle) -> slot
_COUNTER_LOCK = threading.Lock()


def _counters(x: torch.Tensor, stream: int) -> torch.Tensor:
    """The zeroed ticket counters of x's device and ``stream``."""
    dev = x.device.index
    with _COUNTER_LOCK:
        buf = _COUNTERS.get(dev)
        if buf is None:
            with torch.cuda.device(x.device):
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        "bn_stats, bn_backward_reduce: call one of them once "
                        "on this device outside CUDA graph capture first "
                        "(their ticket counters are made then)")
                buf = torch.zeros(_COUNTER_SLOTS, _COUNTERS_PER_STREAM,
                                  dtype=torch.int32, device=x.device)
                torch.cuda.synchronize()  # zero before any stream reads them
            _COUNTERS[dev] = buf
        slot = _SLOTS.get((dev, stream))
        if slot is None:
            slot = sum(d == dev for d, _ in _SLOTS)
            if slot >= _COUNTER_SLOTS:
                raise RuntimeError(f"bn_stats: more than {_COUNTER_SLOTS} "
                                   f"streams on {x.device}")
            _SLOTS[(dev, stream)] = slot
        return buf[slot]


def _stats_workspace(x: torch.Tensor, c: int) -> torch.Tensor:
    """The column reduction's workspace, then two f64 sums per column of
    the view and chunk of 16 strips (the statistics kernel's second level),
    then two per column (the sums it folds where L > C)."""
    width = _view_width(c)
    return torch.empty((2 * _MAX_STRIPS + 4 * _STATS_CHUNKS + 4) * width,
                       dtype=torch.float32, device=x.device)


def _stats_args(x: torch.Tensor, what: str):
    """The checks and scratch of a statistics launch: (rows, C, stream,
    workspace, counters)."""
    c = _check_rows_c(x, what)
    rows = x.numel() // c
    if rows == 0:
        raise ValueError(f"{what} needs at least one row")
    _check_width(c, 8 * 32 * _STATS_GROUPS, what)
    stream = _stream(x)
    return rows, c, stream, _stats_workspace(x, c), _counters(x, stream)


def _launch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    rows, c, stream, ws, counters = _stats_args(x, "bn_stats")
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    _call(x, "bn_stats", _fn("bn_stats", "rhss_bn_stats"), x.data_ptr(),
          rows, c, _DTYPES[x.dtype], ws.data_ptr(), counters.data_ptr(),
          out[0].data_ptr(), out[1].data_ptr(), stream)
    TRAIN_LAUNCHES["bn_stats"] += 1
    return out[0], out[1]


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(mean, var)`` of ``x`` (..., C) over every other axis,
    in f32: ``mean = Σx / n`` and the biased ``var = max(Σx² / n − mean², 0)``
    (JAX ``bn_stats``). Not differentiable: the train-mode backward folds
    the statistics' gradient into dx."""
    if _device_of(x, "bn_stats") == "cpu":
        return _bn_stats_ref(x)
    return _launch_stats(x)


# ------------------------------------- statistics over a data-parallel group
def _bn_stats_sums_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the sums entry: ``[Σx, Σx², n]`` (2C + 1,) in f64
    over the rows of (rows, C)."""
    xd = x.reshape(-1, x.shape[-1]).double()
    n = xd.new_full((1,), float(xd.shape[0]))
    return torch.cat([xd.sum(0), (xd * xd).sum(0), n])


def _launch_stats_sums(x: torch.Tensor) -> torch.Tensor:
    rows, c, stream, ws, counters = _stats_args(x, "bn_stats_sums")
    sums = torch.empty(2 * c + 1, dtype=torch.float64, device=x.device)
    _call(x, "bn_stats_sums", _fn("bn_stats", "rhss_bn_stats_sums"),
          x.data_ptr(), rows, c, _DTYPES[x.dtype], ws.data_ptr(),
          counters.data_ptr(), sums.data_ptr(), stream)
    TRAIN_LAUNCHES["bn_stats_sums"] += 1
    return sums


def bn_stats_sums(x: torch.Tensor) -> torch.Tensor:
    """``[Σx, Σx², n]`` of ``x`` (..., C) per channel over every other
    axis, one (2C + 1,) f64 tensor: kernel 1's sums before it divides, for
    an all-reduce over the ranks of a group (kernel 2's train entry,
    :func:`bn_act_forward`, then forms the statistics; on the CPU
    :func:`stats_from_sums`). One launch per call."""
    if _device_of(x, "bn_stats_sums") == "cpu":
        return _bn_stats_sums_ref(x)
    return _launch_stats_sums(x)


def stats_from_sums(sums: torch.Tensor,
                    dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` in ``dtype`` from ``[Σx, Σx², n]``: ``mean = Σx ·
    (1/n)``, ``var = max(Σx² · (1/n) − mean², 0)`` in f64, each operation
    rounded once, then one rounding to ``dtype``: kernel 1's last step
    (``csrc/bn_stats.cu``), so one rank's sums give its statistics bit for
    bit."""
    c = (sums.shape[0] - 1) // 2
    inv_n = 1.0 / sums[2 * c:]
    mean = sums[:c] * inv_n
    var = sums[c:2 * c] * inv_n - mean * mean
    var = torch.where(var > 0.0, var, 0.0)
    return mean.to(dtype), var.to(dtype)


# ---------------------------------------------------------------- BN backward
def _bn_backward_ref(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, mean: torch.Tensor,
                     rstd: torch.Tensor, act: str, need_dx: bool = True):
    """Plain version on (rows, C): ``(dx or None, dgamma, dbeta)`` with the
    JAX custom VJP's identities (``_fba_bwd``), f32 math, dx in x's dtype."""
    xf = _wide(x)
    gf = _wide(g)
    if act == "relu":
        dy = torch.where(xf * scale + shift > 0, gf, 0.0)
    else:
        dy = gf
    xhat = (xf - mean) * rstd
    edz = dy.sum(0)
    eydz = (dy * xhat).sum(0)
    dx = None
    if need_dx:
        n = xf.shape[0]
        dx = (scale * (dy - (xhat * eydz + edz) / n)).to(x.dtype)
    return dx, eydz, edz


def _grad_layout(g: torch.Tensor) -> torch.Tensor:
    """g in the contiguous, 16-byte aligned (rows, C) layout the kernels
    read: the gradient autograd brings back may come in another layout (a
    slice of a concat's gradient, a resize's scatter); a copy is counted in
    ``GRAD_COPIES``."""
    global GRAD_COPIES
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.contiguous() if not g.is_contiguous() else g.clone()
        GRAD_COPIES += 1
    return g


def _backward_args(x: torch.Tensor, g: torch.Tensor, scale, shift, mean,
                   rstd, what: str):
    """The checks of a BN-backward launch: (C, rows, g in the (rows, C)
    layout, the pointers of scale, shift, mean, rstd)."""
    c = _check_rows_c(x, what)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"{what} needs g like x {tuple(x.shape)} "
                         f"{x.dtype} {x.device}; got {tuple(g.shape)} "
                         f"{g.dtype} {g.device}")
    g = _grad_layout(g)
    vecs = [_per_channel(t, c, x.device, name) for t, name in
            ((scale, "scale"), (shift, "shift"), (mean, "mean"),
             (rstd, "rstd"))]
    if _view_width(c) != c:  # tiled to the view's width, in one copy
        vecs = list(_tiled(torch.stack(vecs), c))
    rows = x.numel() // c
    if rows == 0:
        raise ValueError(f"{what} needs at least one row")
    # the vectors stay referenced by the caller until its launch returns
    return c, rows, g, vecs


def _launch_backward(x: torch.Tensor, g: torch.Tensor, scale, shift, mean,
                     rstd, act: str, need_dx: bool):
    c, rows, g, vecs = _backward_args(x, g, scale, shift, mean, rstd,
                                      "bn_backward")
    ptrs = [t.data_ptr() for t in vecs]
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    edz, eydz = sums[0], sums[1]
    dx = torch.empty_like(x) if need_dx else None
    _call(x, "bn_backward", _fn("bn_backward", "rhss_bn_backward"),
          x.data_ptr(), g.data_ptr(), rows, c, _DTYPES[x.dtype], ACTS[act],
          *ptrs, _workspace(x, c).data_ptr(), edz.data_ptr(), eydz.data_ptr(),
          dx.data_ptr() if need_dx else None, _stream(x))
    TRAIN_LAUNCHES["bn_backward"] += 1
    return dx, eydz, edz


def bn_act_backward(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, mean: torch.Tensor,
                    rstd: torch.Tensor, act: str, need_dx: bool = True):
    """Backward of ``y = act(x * scale + shift)`` where ``scale = γ·rstd``,
    ``shift = β − mean·γ·rstd`` and (mean, rstd) are x's batch statistics.

    x and g are (rows, C) (or (..., C)); the ``(C,)`` vectors are f32.
    Returns ``(dx, dgamma, dbeta)``: dx in x's dtype (None unless
    ``need_dx``), ``dgamma = Σ dy·x̂`` and ``dbeta = Σ dy`` in f32.
    ``act``: "none" or "relu"."""
    _check_train_act(act)
    if _device_of(x, "bn_backward") == "cpu":
        c = x.shape[-1]
        dx, dg, db = _bn_backward_ref(x.reshape(-1, c), g.reshape(-1, c),
                                      scale, shift, mean, rstd, act, need_dx)
        return (None if dx is None else dx.reshape(x.shape)), dg, db
    return _launch_backward(x, g, scale, shift, mean, rstd, act, need_dx)


def _bn_backward_reduce_ref(x: torch.Tensor, g: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor, act: str):
    """Plain version of the reduce entry on (rows, C): ``(dgamma, dbeta,
    sums)`` with the f32 products of the fused version summed in f64,
    ``sums = [Σdy, Σdy·x̂, n]`` (2C + 1,) f64 and ``dgamma``, ``dbeta`` its
    first two rows rounded to f32 (f64 for f64 x)."""
    xf = _wide(x)
    gf = _wide(g)
    if act == "relu":
        dy = torch.where(xf * scale + shift > 0, gf, 0.0)
    else:
        dy = gf
    xhat = (xf - mean) * rstd
    n = dy.new_full((1,), float(xf.shape[0]), dtype=torch.float64)
    sums = torch.cat([dy.double().sum(0), (dy * xhat).double().sum(0), n])
    c = xf.shape[1]
    return sums[c:2 * c].to(xf.dtype), sums[:c].to(xf.dtype), sums


def _bn_backward_dx_ref(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, mean: torch.Tensor,
                        rstd: torch.Tensor, sums: torch.Tensor,
                        act: str) -> torch.Tensor:
    """Plain version of the dx entry on (rows, C): ``dx = scale · (dy −
    (x̂ · eydz/n + edz/n))`` with ``edz/n`` and ``eydz/n`` formed in f64 from
    the group's ``sums = [Σdy, Σdy·x̂, n]`` and rounded once; dx in x's
    dtype."""
    xf = _wide(x)
    gf = _wide(g)
    if act == "relu":
        dy = torch.where(xf * scale + shift > 0, gf, 0.0)
    else:
        dy = gf
    xhat = (xf - mean) * rstd
    c = xf.shape[1]
    scaled = (sums[:2 * c] / sums[2 * c]).to(xf.dtype)
    return (scale * (dy - (xhat * scaled[c:] + scaled[:c]))).to(x.dtype)


def _launch_backward_reduce(x, g, scale, shift, mean, rstd, act: str):
    c, rows, g, vecs = _backward_args(x, g, scale, shift, mean, rstd,
                                      "bn_backward_reduce")
    _check_width(c, 8 * 32 * _STATS_GROUPS, "bn_backward_reduce")
    out = torch.empty(2, c, dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * c + 1, dtype=torch.float64, device=x.device)
    stream = _stream(x)
    _call(x, "bn_backward_reduce",
          _fn("bn_backward", "rhss_bn_backward_reduce"), x.data_ptr(),
          g.data_ptr(), rows, c, _DTYPES[x.dtype], ACTS[act],
          *[t.data_ptr() for t in vecs], _workspace(x, c).data_ptr(),
          _counters(x, stream).data_ptr(), out[0].data_ptr(),
          out[1].data_ptr(), sums.data_ptr(), stream)
    TRAIN_LAUNCHES["bn_backward_reduce"] += 1
    return out[1], out[0], sums


def _launch_backward_dx(x, g, scale, shift, mean, rstd, sums, act: str):
    c, rows, g, vecs = _backward_args(x, g, scale, shift, mean, rstd,
                                      "bn_backward_dx")
    _check_width(c, _DX_MAX_CHANNELS, "bn_backward_dx")
    if (sums.shape != (2 * c + 1,) or sums.dtype != torch.float64
            or sums.device != x.device):
        raise ValueError(f"bn_backward_dx needs sums ({2 * c + 1},) f64 on "
                         f"{x.device}; got {tuple(sums.shape)} {sums.dtype} "
                         f"{sums.device}")
    sums = sums.contiguous()
    dx = torch.empty_like(x)
    _call(x, "bn_backward_dx", _fn("bn_backward", "rhss_bn_backward_dx"),
          x.data_ptr(), g.data_ptr(), rows, c, _DTYPES[x.dtype], ACTS[act],
          *[t.data_ptr() for t in vecs], sums.data_ptr(), dx.data_ptr(),
          _stream(x))
    TRAIN_LAUNCHES["bn_backward_dx"] += 1
    return dx


def _check_train_act(act: str) -> None:
    if act not in TRAIN_ACTS:
        raise ValueError(f"the train-mode BN backward takes act in "
                         f"{TRAIN_ACTS}, not {act!r}")


def bn_backward_reduce(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor, act: str):
    """The sums of :func:`bn_act_backward` without dx: ``(dgamma, dbeta,
    sums)``, ``dgamma = Σ dy·x̂`` and ``dbeta = Σ dy`` in f32 as the fused
    call returns them, and ``sums = [Σdy, Σdy·x̂, n]`` (2C + 1,) in f64 for
    an all-reduce over a group. One launch per call; lcm(C, 8) <= 16384."""
    _check_train_act(act)
    if _device_of(x, "bn_backward_reduce") == "cpu":
        c = x.shape[-1]
        return _bn_backward_reduce_ref(x.reshape(-1, c), g.reshape(-1, c),
                                       scale, shift, mean, rstd, act)
    return _launch_backward_reduce(x, g, scale, shift, mean, rstd, act)


def bn_backward_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, sums: torch.Tensor,
                   act: str) -> torch.Tensor:
    """dx of :func:`bn_act_backward` from ``sums = [Σdy, Σdy·x̂, n]`` of
    the whole group (the reduce entry's sums, all-reduced): dx in x's dtype
    and shape. One launch per call; lcm(C, 8) <= 4096."""
    _check_train_act(act)
    if _device_of(x, "bn_backward_dx") == "cpu":
        c = x.shape[-1]
        return _bn_backward_dx_ref(x.reshape(-1, c), g.reshape(-1, c), scale,
                                   shift, mean, rstd, sums,
                                   act).reshape(x.shape)
    return _launch_backward_dx(x, g, scale, shift, mean, rstd, sums, act)


# ------------------------------------------------- the train-mode BN forward
def _bn_act_forward_ref(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float, act: str,
                        mean=None, var=None, sums=None, running=None):
    """Plain version of the train entry: ``(y, mean, var, rstd, scale,
    shift)`` by the PyTorch ops the entry takes in, in their order: mean and
    var from ``sums`` (:func:`stats_from_sums`) where given, ``rstd =
    rsqrt(var + eps)``, ``scale = gamma * rstd``, ``shift = beta - mean *
    gamma * rstd``, y by :func:`_scale_bias_act_ref`; with ``running =
    (running_mean, running_var, m)`` the running update ``m * r + (1 - m) *
    v`` with var times ``n / (n - 1)``, n the rows (of the group, from
    sums). The buffers are written through ``.data``, as the kernel writes
    them: their version counters are the caller's to move."""
    if sums is not None:
        mean, var = stats_from_sums(sums, _wide(x).dtype)
        n = sums[-1]
        bessel = torch.where(n > 1, n / (n - 1), 1.0)
    else:
        n = x.numel() // x.shape[-1]
        bessel = n / (n - 1) if n > 1 else 1.0
    mean, var, gamma, beta = map(_wide, (mean, var, gamma, beta))
    rstd = torch.rsqrt(var + eps)
    scale = gamma * rstd
    shift = beta - mean * gamma * rstd
    y = _scale_bias_act_ref(x, scale, shift, act)
    if running is not None:
        running_mean, running_var, m = running
        with torch.no_grad():
            running_mean.data.copy_(m * running_mean + (1 - m) * mean)
            running_var.data.copy_(m * running_var
                                   + (1 - m) * (var * bessel))
    return y, mean, var, rstd, scale, shift


def _f32_vector(t: torch.Tensor, c: int, device, what: str) -> torch.Tensor:
    """A (C,) f32 vector on x's device, as the train entry reads it (one
    float at a time: no alignment asked)."""
    _check_vector(t, c, what)
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, x on {device}")
    return t.to(torch.float32).contiguous()


def _launch_bn_act_forward(x, gamma, beta, eps: float, act: str, mean, var,
                           sums, running):
    c = _check_rows_c(x, "bn_act_forward")
    rows = x.numel() // c
    if rows == 0:
        raise ValueError("bn_act_forward needs at least one row")
    dev = x.device
    gamma = _f32_vector(gamma, c, dev, "gamma")
    beta = _f32_vector(beta, c, dev, "beta")
    out = [torch.empty(c, dtype=torch.float32, device=dev) for _ in range(5)]
    if sums is None:
        mean = _f32_vector(mean, c, dev, "mean")
        var = _f32_vector(var, c, dev, "var")
        stats = (mean.data_ptr(), var.data_ptr(), None, None, None)
    else:
        if (sums.shape != (2 * c + 1,) or sums.dtype != torch.float64
                or sums.device != dev):
            raise ValueError(f"bn_act_forward needs sums ({2 * c + 1},) f64 "
                             f"on {dev}; got {tuple(sums.shape)} "
                             f"{sums.dtype} {sums.device}")
        sums = sums.contiguous()
        mean, var = out[0], out[1]
        stats = (None, None, sums.data_ptr(), mean.data_ptr(),
                 var.data_ptr())
    rm = rv = None
    momentum = 0.0
    if running is not None:
        rm, rv, momentum = running
        for t, name in ((rm, "running_mean"), (rv, "running_var")):
            _check_vector(t, c, name)
            if (t.dtype != torch.float32 or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"bn_act_forward moves {name} in place: it "
                                 f"must be contiguous f32 on {dev}")
    rstd, scale, shift = out[2:]
    y = torch.empty_like(x)
    _call(x, "bn_act_forward", _fn("scale_bias_act", "rhss_bn_act_forward"),
          x.data_ptr(), y.data_ptr(), rows, c, _DTYPES[x.dtype], ACTS[act],
          gamma.data_ptr(), beta.data_ptr(), eps, stats[0], stats[1],
          stats[2], None if rm is None else rm.data_ptr(),
          None if rv is None else rv.data_ptr(), momentum,
          int(running is not None), stats[3], stats[4], rstd.data_ptr(),
          scale.data_ptr(), shift.data_ptr(), _stream(x))
    TRAIN_LAUNCHES["bn_act_forward"] += 1
    return y, mean, var, rstd, scale, shift


def bn_act_forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5, act: str = "relu", mean=None, var=None,
                   sums=None, running=None):
    """The train-mode BatchNorm's forward after its statistics, kernel 2's
    train entry (one launch per call on the card): ``y = act(x * scale +
    shift)`` with ``rstd = rsqrt(var + eps)``, ``scale = gamma * rstd`` and
    ``shift = beta - mean * gamma * rstd``, from either ``mean`` and ``var``
    (f32, kernel 1's) or ``sums = [Σx, Σx², n]`` (f64, a group's, kernel 1's
    last step forming mean and var). ``running = (running_mean,
    running_var, momentum)`` moves the running statistics in place,
    ``m * r + (1 - m) * v`` with var times ``n / (n - 1)`` (the flax
    momentum m, n the rows of x or of the group), and bumps their version
    counters; None leaves them. Returns ``(y, mean, var, rstd, scale,
    shift)``, the vectors ``(C,)`` f32. ``act``: "none" or "relu"."""
    _check_train_act(act)
    if (sums is None) == (mean is None or var is None):
        raise ValueError("bn_act_forward takes mean and var, or sums")
    if _device_of(x, "bn_act_forward") == "cpu":
        out = _bn_act_forward_ref(x, gamma, beta, eps, act, mean, var, sums,
                                  running)
    else:
        out = _launch_bn_act_forward(x, gamma, beta, eps, act, mean, var,
                                     sums, running)
    if running is not None:  # the folded (a, b) of eval read them anew
        torch.autograd.graph.increment_version(running[0])
        torch.autograd.graph.increment_version(running[1])
    return out


class FusedBNAct(torch.autograd.Function):
    """``act(gamma * (x - mean) * rstd + beta)`` with ``rstd = rsqrt(var +
    eps)`` and (mean, var) the batch statistics of x, computed without
    gradient by the caller (JAX ``fused_bn_act`` and its custom VJP).

    Forward: kernel 2's train entry (:func:`bn_act_forward`), which also
    moves the running statistics when ``running`` is given. Saved: x and
    ``(C,)`` vectors only; saving y as well would double the activation
    memory of a train step. Backward: the BN backward kernel, whose dx
    carries the gradient that flows through the batch statistics. Autocast
    is off inside: x keeps its dtype (bf16 under a bf16 autocast), every
    ``(C,)`` vector stays f32."""

    @staticmethod
    def forward(ctx, x, mean, var, gamma, beta, eps: float, act: str,
                running=None):
        with torch.autocast(x.device.type, enabled=False):
            y, mean, _, rstd, scale, shift = bn_act_forward(
                x, gamma, beta, eps, act, mean=mean, var=var,
                running=running)
        ctx.save_for_backward(x, mean, rstd, scale, shift)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale, shift = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        with torch.autocast(x.device.type, enabled=False):
            dx, dgamma, dbeta = bn_act_backward(x, g, scale, shift, mean,
                                                rstd, ctx.act, need_dx)
        return dx, None, None, dgamma, dbeta, None, None, None


def fused_bn_act(x, mean, var, gamma, beta, eps: float = 1e-5,
                 act: str = "relu", running=None) -> torch.Tensor:
    """Train-mode fused BN + act on (..., C) ``x`` (see :class:`FusedBNAct`;
    ``running`` as in :func:`bn_act_forward`). ``act``: "relu" | "none"."""
    if act not in TRAIN_ACTS:
        # the JAX custom VJP treats every act but relu as the identity,
        # which is wrong for leaky_relu: refuse rather than copy that
        raise ValueError(f"train-mode BN takes act in {TRAIN_ACTS}, not "
                         f"{act!r} (the backward differentiates those only)")
    return FusedBNAct.apply(x, mean, var, gamma, beta, eps, act, running)


def batch_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5, act: str = "relu", running=None):
    """Train-mode BN + act from raw activations: ``(y, mean, var)``, the
    batch statistics taken on ``x.detach()`` (their gradient is folded into
    the backward's dx). ``running = (running_mean, running_var, momentum)``
    moves the running statistics in the same launch as y (None: left as
    they are). On the card: kernel 1, then kernel 2's train entry."""
    mean, var = bn_stats(x.detach())
    return fused_bn_act(x, mean, var, gamma, beta, eps, act, running), \
        mean, var


class SyncFusedBNAct(torch.autograd.Function):
    """:class:`FusedBNAct` whose statistics are those of the whole batch of
    a data-parallel ``group``: the forward is kernel 2's train entry on the
    group's all-reduced sums (from :func:`sync_batch_norm_act`), which
    forms mean and var itself; it returns ``(y, mean, var)``, the two
    statistics not differentiable. The backward splits kernel 3: the reduce
    entry, one all-reduce of its (2C + 1) f64 sums over the group, then the
    dx entry. dgamma and dbeta are this rank's sums (the gradient all-reduce
    adds them). Without dx (the input needs no gradient; the same on every
    rank) the backward is the reduce entry alone, with no all-reduce."""

    @staticmethod
    def forward(ctx, x, sums, gamma, beta, eps: float, act: str, group,
                running=None):
        with torch.autocast(x.device.type, enabled=False):
            y, mean, var, rstd, scale, shift = bn_act_forward(
                x, gamma, beta, eps, act, sums=sums, running=running)
        ctx.save_for_backward(x, mean, rstd, scale, shift)
        ctx.act = act
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _mean_grad, _var_grad):
        x, mean, rstd, scale, shift = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            if x.device.type == "cuda":  # one copy for both entries
                g = _grad_layout(g)
            dgamma, dbeta, sums = bn_backward_reduce(x, g, scale, shift,
                                                     mean, rstd, ctx.act)
            dx = None
            if ctx.needs_input_grad[0]:
                dist.all_reduce(sums, group=ctx.group)
                dx = bn_backward_dx(x, g, scale, shift, mean, rstd, sums,
                                    ctx.act)
        return dx, None, dgamma, dbeta, None, None, None, None


def sync_batch_norm_act(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, group, eps: float = 1e-5,
                        act: str = "relu", running=None):
    """:func:`batch_norm_act` over the batch of every rank of ``group``:
    ``(y, mean, var)`` with mean and var (f32) those of the concatenated
    batches; ``running`` as in :func:`bn_act_forward`, its Bessel factor
    from the group's row count. One all-reduce of kernel 1's (2C + 1) f64
    sums in the forward (on the card: the sums entry, the all-reduce, then
    kernel 2's train entry), one of kernel 3's in the backward."""
    if act not in TRAIN_ACTS:
        raise ValueError(f"train-mode BN takes act in {TRAIN_ACTS}, not "
                         f"{act!r} (the backward differentiates those only)")
    sums = bn_stats_sums(x.detach())
    dist.all_reduce(sums, group=group)
    return SyncFusedBNAct.apply(x, sums, gamma, beta, eps, act, group,
                                running)

"""Tracing and profiling hooks; counterpart of the JAX package's
``utils/profiling.py``, with its names.

* :class:`StepTimer`: steady-state step timing with a warm-up discarded
  (the JAX class, copied);
* :func:`trace`: ``torch.profiler`` around a block (the host, and the card
  when the run is on one), writing a Chrome trace file into a directory
  (the layout of ``torch.profiler.tensorboard_trace_handler``:
  ``<worker>.<ms>.pt.trace.json``), nothing when the directory is falsy;
* :func:`annotate`: a named host span (``torch.profiler.record_function``).

On an H100 ``torch.profiler`` can drop the first device events of a trace
(``PERF.md`` §5: a profiled UNet train step lacked its first kernels, and
later in a process most traces lacked their first few). So on a card
:func:`trace` launches ``TRACE_LEAD`` marker kernels (``torch.cuda._sleep``,
whose kernel is ``spin_kernel``), waits for them, pauses, and launches one
more before the block: the events a trace loses are the markers', and a
trace that holds a marker holds everything launched after it. The
markers are left in the file; a reader skips them by name
(``TRACE_MARKER``).
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import torch

__all__ = ["StepTimer", "trace", "annotate"]

TRACE_MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
TRACE_LEAD = 64               # marker kernels before the pause


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t: Optional[float] = None
        self._n = 0

    def tic(self):
        self._t = time.perf_counter()

    def toc(self):
        if self._t is None:
            return
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self._times.append(dt)
        self._t = None

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def images_per_sec(self, batch: int) -> float:
        return batch / self.mean if self.mean else 0.0


def _worker_name() -> str:
    """This process's file name stem: its rank in a multi-process run."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    return f"rank{rank}"


def _lead_markers() -> None:
    for _ in range(TRACE_LEAD):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)
    torch.cuda._sleep(1000)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Profile the enclosed block with ``torch.profiler`` (nothing if
    ``log_dir`` is falsy): host activity, and the card's when ``device``
    is a CUDA device (None: a card if there is one). The trace is written
    into ``log_dir`` when the block ends, named after this process's rank
    (``rank{r}.<ms>.pt.trace.json``), so the ranks of a run write files of
    their own."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(log_dir, worker_name=_worker_name())
    with profile(activities=activities, on_trace_ready=handler):
        if cuda:
            _lead_markers()
        yield
        if cuda:
            torch.cuda.synchronize()


def annotate(name: str):
    """A named span of host time in a trace."""
    return torch.profiler.record_function(name)

"""Stage timing, spans, copy counters and traces.

Counterpart of ``transport_analysis_tpu/utils/profiling.py``. Every
analysis records a stage-timing breakdown (``analysis.timing``) with
derived throughput counters, and :func:`trace` wraps ``torch.profiler``
for a Chrome trace of the host and, where there is a card, of its
kernels (viewable in Perfetto or ``chrome://tracing``).

Inside a run the program marks its layers with :func:`span`, profiler
ranges named ``ta.*`` that a session records beside the card's kernels
and copies, on its clock: ``ta.run.<run_id>`` around a run (and around
the Green–Kubo integral of its results), ``ta.feed.read``,
``ta.feed.select``, ``ta.h2d``, ``ta.h2d.register`` (an array of the
trajectory page-locked), ``ta.fft``, ``ta.lag``, ``ta.d2h`` (with
``ta.d2h.alloc`` around a new page-locked block) and ``ta.fit``; a run
streamed in atom chunks adds ``ta.chunk`` around each chunk's turn, with
``ta.chunk.gather`` and ``ta.chunk.merge`` in it (``parallel.streaming``).
With no session recording, a span enters nothing. The run's host copies
are counted in bytes (:func:`count`; ``select_bytes``, ``h2d_bytes``,
``h2d_pinned_bytes``, those whose host side was page-locked,
``h2d_register_bytes``, those of the trajectory's arrays the run
page-locked, ``d2h_bytes``, ``d2h_pool_hit_bytes``, the result bytes
that landed in a recycled page-locked block, ``chunk_gather_bytes`` and
``chunk_merge_bytes``), and its atom chunks in ``chunks`` (0 for a run
that was not chunked), on the run that is current on the thread;
``analysis.timing.counts()`` returns them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Optional

import torch

# the counters of a run (StageTimer.counts): bytes, and atom chunks run
COUNTS = ("select_bytes", "h2d_bytes", "h2d_pinned_bytes",
          "h2d_register_bytes", "d2h_bytes", "d2h_pool_hit_bytes",
          "chunks", "chunk_gather_bytes", "chunk_merge_bytes")
# runs whose timing run_timing still finds by id
RECENT_RUNS = 4096
NO_SPAN = contextlib.nullcontext()

_run_ids = itertools.count()
_current = threading.local()
_recent: collections.OrderedDict = collections.OrderedDict()
_recent_lock = threading.Lock()


def span(name: str):
    """A profiler range ``name`` (``torch.profiler.record_function``)
    while a profiler session records; else :data:`NO_SPAN`, which enters
    nothing. Either way no synchronisation and no copy."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of this thread's current run
    (:meth:`StageTimer.running`); outside a run it counts nowhere."""
    timer = getattr(_current, "timer", None)
    if timer is not None:
        timer.count(name, n)


def run_timing(run_id: int):
    """The :class:`StageTimer` of run ``run_id``, as a trace's
    ``ta.run.<run_id>`` span names it, while it is one of the process's
    last :data:`RECENT_RUNS`; else None."""
    with _recent_lock:
        return _recent.get(run_id)


class StageTimer:
    """Wall-clock stage timer with throughput derivation.

    ``device``: where the timed work runs. On a CUDA device a stage
    synchronises it before it reads the clock on exit, so that a stage
    times the work it queued on the card, not only the launches.

    Each timer takes the process's next ``run_id``; its counters
    (:data:`COUNTS`) grow by :meth:`count`, and by :func:`count` while
    it is the thread's current run (:meth:`running`).

    Usage::

        t = StageTimer(device)
        with t.running():
            with t.stage("io"): ...
            with t.stage("compute"): ...
        t.counters(n_frames=N, n_particles=P, n_lags=L)
        t.as_dict()  # {'io': ..., 'compute': ..., 'total': ...,
                     #  'frames_per_s': ..., 'atom_frame_lags_per_s': ...}
        t.counts()   # {'select_bytes': ..., 'h2d_bytes': ...,
                     #  'd2h_bytes': ..., 'd2h_pool_hit_bytes': ...,
                     #  'chunks': ..., 'chunk_gather_bytes': ...,
                     #  'chunk_merge_bytes': ...}
    """

    def __init__(self, device=None):
        self._stages: dict[str, float] = {}
        self._t0 = time.perf_counter()
        self.sizes: dict[str, int] = {}
        device = None if device is None else torch.device(device)
        self._cuda = device if device is not None and device.type == "cuda" \
            else None
        self._counts = dict.fromkeys(COUNTS, 0)
        self.run_id = next(_run_ids)
        with _recent_lock:
            _recent[self.run_id] = self
            while len(_recent) > RECENT_RUNS:
                _recent.popitem(last=False)

    @contextlib.contextmanager
    def running(self):
        """This timer as the thread's current run, inside a
        ``ta.run.<run_id>`` span."""
        outer = getattr(_current, "timer", None)
        _current.timer = self
        try:
            with span(f"ta.run.{self.run_id}"):
                yield self
        finally:
            _current.timer = outer

    def count(self, name: str, n: int) -> None:
        self._counts[name] += int(n)

    def counts(self) -> dict:
        return dict(self._counts)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda is not None:
                torch.cuda.synchronize(self._cuda)
            self._stages[name] = (
                self._stages.get(name, 0.0) + time.perf_counter() - start
            )

    def counters(self, n_frames: int = 0, n_particles: int = 0,
                 n_lags: Optional[int] = None):
        """The run's frames N, particles P and lags L (default N), kept
        in ``sizes``, for the throughputs."""
        self.sizes["n_frames"] = n_frames
        self.sizes["n_particles"] = n_particles
        self.sizes["n_lags"] = n_frames if n_lags is None else n_lags

    def as_dict(self) -> dict:
        total = time.perf_counter() - self._t0
        out = dict(self._stages)
        out["total"] = total
        n = self.sizes.get("n_frames", 0)
        p = self.sizes.get("n_particles", 0)
        lags = self.sizes.get("n_lags", n)
        if n and total > 0:
            out["frames_per_s"] = n / total
            # effective windowed-lag work units (the JAX package's bench.py):
            # P · Σ_{lag<L} (N − lag), N(N + 1)/2 a particle for L = N
            out["atom_frame_lags_per_s"] = (
                (lags * n - lags * (lags - 1) // 2) * max(p, 1) / total
            )
        return out


# Seconds of idle trace kept before and after the traced block on a card:
# the profiler drops device events that fall outside its window, and a
# kernel's timestamp, put on the host's clock, can land milliseconds off.
TRACE_MARGIN_S = 0.05


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace context: CPU activity, and CUDA activity
    where a card is present; on exit a Chrome trace
    (``<worker>.<time>.pt.trace.json``) is written into ``log_dir``. A
    no-op when ``log_dir`` is None.

    With a card, the device tracer is switched on in a warm-up step of
    one small launch before the traced window opens, and the window
    holds ``TRACE_MARGIN_S`` of idle time on each side of the block,
    whose queued work is waited for: so the block's first and last
    kernels stay inside the window."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, schedule

    log_dir = str(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(TRACE_MARGIN_S)
            try:
                yield
            finally:
                torch.cuda.synchronize()
                time.sleep(TRACE_MARGIN_S)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))

"""Stage timing and traces.

Counterpart of ``transport_analysis_tpu/utils/profiling.py``. Every
analysis records a stage-timing breakdown (``analysis.timing``) with
derived throughput counters, and :func:`trace` wraps ``torch.profiler``
for a Chrome trace of the host and, where there is a card, of its
kernels (viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StageTimer:
    """Wall-clock stage timer with throughput derivation.

    ``device``: where the timed work runs. On a CUDA device a stage
    synchronises it before it reads the clock on exit, so that a stage
    times the work it queued on the card, not only the launches.

    Usage::

        t = StageTimer(device)
        with t.stage("io"): ...
        with t.stage("compute"): ...
        t.counters(n_frames=N, n_particles=P)
        t.as_dict()  # {'io': ..., 'compute': ..., 'total': ...,
                     #  'frames_per_s': ..., 'atom_frame_lags_per_s': ...}
    """

    def __init__(self, device=None):
        self._stages: dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._meta: dict[str, float] = {}
        device = None if device is None else torch.device(device)
        self._cuda = device if device is not None and device.type == "cuda" \
            else None

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

    def counters(self, n_frames: int = 0, n_particles: int = 0):
        self._meta["n_frames"] = n_frames
        self._meta["n_particles"] = n_particles

    def as_dict(self) -> dict:
        total = time.perf_counter() - self._t0
        out = dict(self._stages)
        out["total"] = total
        n = self._meta.get("n_frames", 0)
        p = self._meta.get("n_particles", 0)
        if n and total > 0:
            out["frames_per_s"] = n / total
            # effective windowed-lag work units (the JAX package's bench.py)
            out["atom_frame_lags_per_s"] = (
                (n * (n + 1) // 2) * max(p, 1) / total
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

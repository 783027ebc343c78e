"""The traced run: one ``torch.profiler`` session over the measured
window, read into a record that the per-layer metrics' readers take.

The method is that of ``utils/profiling.trace`` in the program (commit
9de1e251565c3cb324bee311820446c2df28e3a3): the device tracer switched on
in a warm-up step of one small launch, 50 ms of idle trace on each side
of the window, one session a process; busy time as the union of device
intervals, as ``profile_phase`` in ``chip_smoke.py`` takes it.

The record (all times in seconds):

* ``window_s``: the traced window, from the harness's ``bench.window``
  span;
* ``device``: every device interval in the window, as dicts with
  ``name``, ``cat`` (``kernel``, ``memcpy`` or ``memset``), ``kind``
  (``HtoD``, ``DtoH``, ``DtoD`` for a copy), ``start``, ``dur``,
  ``bytes`` and ``request`` (the request whose span holds it);
* ``spans``: the harness's host spans, with ``name``, ``start``,
  ``dur``;
* ``requests``: one dict per request, filled in by the harness (its
  ``kind``, ``fft``, ``least_s``, ``io_s``, ``wall_s``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

MARGIN_S = 0.05
WINDOW_SPAN = "bench.window"
REQUEST_PREFIX = "request."
TOP = 10


class Tracer:
    """Spans around the harness's calls into the program; with
    ``enabled``, a profiler session over the window that the spans are
    recorded into."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.enabled:
            with torch.profiler.record_function(name):
                yield
        else:
            yield

    @contextlib.contextmanager
    def window(self):
        """The measured window, traced when enabled."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, schedule

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(MARGIN_S)
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        self._prof = prof

    def events(self) -> list:
        """The session's Chrome trace events (written to a temporary
        file, read back and deleted)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def copy_kind(name: str):
    for kind in ("HtoD", "DtoH", "DtoD"):
        if kind in name:
            return kind
    return None


def build_record(events: list) -> dict:
    """The record of a Chrome trace's events: the window, device
    intervals inside it and host spans, each device interval given the
    request span that holds its midpoint (or the nearest one)."""
    spans, device = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start, dur = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        if cat == "user_annotation":
            if ev["name"].startswith("ProfilerStep"):
                continue      # the profiler's own step, not the harness's
            spans.append({"name": ev["name"], "start": start, "dur": dur})
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append({
                "name": ev["name"],
                "cat": {"kernel": "kernel", "gpu_memcpy": "memcpy",
                        "gpu_memset": "memset"}[cat],
                "kind": copy_kind(ev["name"]) if cat == "gpu_memcpy"
                else None,
                "start": start, "dur": dur,
                "bytes": (ev.get("args") or {}).get("bytes", 0)})
    windows = [s for s in spans if s["name"] == WINDOW_SPAN]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0 = windows[0]["start"]
    w1 = w0 + windows[0]["dur"]
    device = [d for d in device
              if d["start"] < w1 and d["start"] + d["dur"] > w0]
    requests = sorted((s for s in spans
                       if s["name"].startswith(REQUEST_PREFIX)),
                      key=lambda s: s["start"])
    starts = [s["start"] for s in requests]
    for d in device:
        d["request"] = owner(requests, starts, d["start"] + 0.5 * d["dur"])
    return {"window": (w0, w1), "window_s": w1 - w0, "device": device,
            "spans": [s for s in spans if s["name"] != WINDOW_SPAN],
            "requests": []}


def owner(requests: list, starts: list, t: float):
    """Index (from the span's name) of the request span, of ``requests``
    sorted by their ``starts``, that holds time ``t``, else of the
    nearest one; None where there is none."""
    if not requests:
        return None
    i = bisect.bisect_right(starts, t)

    def dist(s):
        lo, hi = s["start"], s["start"] + s["dur"]
        return 0.0 if lo <= t <= hi else min(abs(t - lo), abs(t - hi))

    best = min(requests[max(0, i - 1):i + 1], key=dist)
    return int(best["name"][len(REQUEST_PREFIX):].split(".")[0])


def busy_intervals(record: dict) -> list[tuple[float, float]]:
    """The union of the device intervals, clipped to the window."""
    w0, w1 = record["window"]
    out = []
    for d in sorted(record["device"], key=lambda d: d["start"]):
        lo, hi = max(d["start"], w0), min(d["start"] + d["dur"], w1)
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def busy_s(record: dict) -> float:
    return sum(hi - lo for lo, hi in busy_intervals(record))


def innermost(spans: list, t: float) -> str:
    """Name of the shortest host span that holds ``t``."""
    holding = [s for s in spans if s["start"] <= t <= s["start"] + s["dur"]]
    if not holding:
        return "harness"
    return min(holding, key=lambda s: s["dur"])["name"]


def breakdown(record: dict) -> dict:
    """The device operations that took most time (summed by name) and
    the longest idle gaps of the window, each named by the innermost
    host span that holds it; at most TOP of each."""
    totals: dict = {}
    for d in record["device"]:
        totals[d["name"]] = totals.get(d["name"], 0.0) + d["dur"]
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    w0, w1 = record["window"]
    edges = [w0]
    for lo, hi in busy_intervals(record):
        edges += [lo, hi]
    edges.append(w1)
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = [s for s in record["spans"]
             if not s["name"].startswith(REQUEST_PREFIX)]
    idle = [[innermost(spans, 0.5 * (lo + hi)), hi - lo]
            for lo, hi in gaps[:TOP]]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": idle}

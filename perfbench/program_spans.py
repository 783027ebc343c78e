#!/usr/bin/env python3
"""The program's own spans and byte counters in a traced run.

The program marks its layers with ``ta.*`` profiler ranges
(``transport_analysis_tpu_torch/utils/profiling.py``): ``ta.run.<id>``
around each analysis run, and inside it ``ta.feed.read``,
``ta.feed.select``, ``ta.h2d``, ``ta.fft``, ``ta.lag``, ``ta.d2h`` and
``ta.fit``. Each run counts the bytes of its host copies
(``select_bytes``, ``h2d_bytes``, ``d2h_bytes``), and
``utils.profiling.run_timing(id)`` finds a recent run's timing by the id
its span carries. A program without them (an older commit) gives
nothing here, and the readers built on this module return None.

:func:`runs` ties the record's run spans to their requests and timings;
the per-layer readers ``select_gbps`` and ``h2d_feed_ratio`` use it.

:func:`attribute` reads a Chrome trace's raw events, which the record
does not keep: each device interval of the window is given the ``ta.*``
spans that held its launch (the ``cuda_runtime`` call of the same
correlation id) on the launching thread, so work is charged to the call
that made it, whatever the device's clock says. Run as a script, this
file runs one traced cell as ``run.py --trace 1`` does and prints what
the attribution shows: each layer's share of kernel time, the kernels'
offsets from their launches, and the copy counters against the trace's
copy bytes:

    python3 perfbench/program_spans.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file.json>]
"""

from __future__ import annotations

import bisect
import statistics

RUN_PREFIX = "ta.run."
PROGRAM_PREFIX = "ta."
# the host calls that launch device work (the port launches through
# the CUDA runtime)
LAUNCHES = "cuda_runtime"
# the correlation entries' spans: kernels outside them are the glue
CORRELATION_SPANS = ("ta.fft", "ta.lag")


def run_id(name: str):
    """The id of a ``ta.run.<id>`` span's name, else None."""
    if name.startswith(RUN_PREFIX) and name[len(RUN_PREFIX):].isdigit():
        return int(name[len(RUN_PREFIX):])
    return None


def runs(record: dict):
    """run id -> {"request": the index of the request span that holds
    the run's first span, "timing": its ``StageTimer``}, for each
    ``ta.run.<id>`` span of ``record``; None where the program has no
    ``run_timing``, the record no run span, or a run is no longer found
    (it is not one of the process's last ``RECENT_RUNS``)."""
    try:
        from transport_analysis_tpu_torch.utils.profiling import run_timing
    except ImportError:
        return None
    from perfbench import tracing

    requests = sorted((s for s in record["spans"]
                       if s["name"].startswith(tracing.REQUEST_PREFIX)),
                      key=lambda s: s["start"])
    starts = [s["start"] for s in requests]
    out = {}
    for s in sorted(record["spans"], key=lambda s: s["start"]):
        rid = run_id(s["name"])
        if rid is None or rid in out:
            continue
        timing = run_timing(rid)
        if timing is None:
            return None
        out[rid] = {"request": tracing.owner(requests, starts, s["start"]),
                    "timing": timing}
    return out or None


def total(found: dict, counter: str) -> int:
    """Σ of one byte counter over the runs :func:`runs` found."""
    return sum(r["timing"].counts()[counter] for r in found.values())


# --- launch attribution over the raw events ---------------------------------

def attribute(events: list) -> list:
    """Each device interval (kernel, memcpy, memset) of the trace's
    ``bench.window`` as a dict: ``name``, ``cat``, ``kind``, ``start``,
    ``dur``, ``bytes`` (as ``tracing.build_record`` has them), ``launch``
    (the host time of the runtime call of its correlation id, None where
    the trace has none), ``spans`` (the names of the ``ta.*`` spans that
    hold the launch on its thread, outermost first) and ``span`` (the
    innermost of them, None where none holds it). Times in seconds."""
    from perfbench import tracing

    events = [e for e in events if e.get("ph") == "X"]
    window = [e for e in events if e.get("name") == tracing.WINDOW_SPAN]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = window[0]["ts"] * 1e-6
    w1 = w0 + window[0].get("dur", 0) * 1e-6
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == LAUNCHES and corr is not None:
            launches[corr] = e
    by_thread: dict = {}
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e["name"].startswith(PROGRAM_PREFIX)):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6,
                 e["name"]))
    for spans in by_thread.values():
        spans.sort()
    out = []
    for e in events:
        cat = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}.get(e.get("cat"))
        if cat is None:
            continue
        start, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if not (start < w1 and start + dur > w0):
            continue
        args = e.get("args") or {}
        launch = launches.get(args.get("correlation"))
        holding = []
        t = None
        if launch is not None:
            t = launch["ts"] * 1e-6
            spans = by_thread.get((launch.get("pid"), launch.get("tid")),
                                  [])
            i = bisect.bisect_right(spans, (t, float("inf"), ""))
            holding = [name for lo, hi, name in spans[:i] if lo <= t <= hi]
        out.append({
            "name": e["name"], "cat": cat,
            "kind": tracing.copy_kind(e["name"]) if cat == "memcpy"
            else None,
            "start": start, "dur": dur, "bytes": args.get("bytes", 0),
            "launch": t, "spans": holding,
            "span": holding[-1] if holding else None})
    return out


def layer(interval: dict) -> str:
    """The layer a device interval is charged to: the first of
    ``ta.fft``, ``ta.lag`` among the spans that held its launch, else its
    innermost span (``ta.run`` for the run's own work), else None."""
    for name in CORRELATION_SPANS:
        if name in interval["spans"]:
            return name
    span = interval["span"]
    if span is None:
        return None
    return "ta.run" if run_id(span) is not None else span


def glue_kernel_pct(attributed: list):
    """Kernel time launched inside a ``ta.run.*`` span but outside
    ``ta.fft`` and ``ta.lag`` over all kernel time launched inside one,
    in %; None where no kernel was."""
    inside = glue = 0.0
    for d in attributed:
        if d["cat"] != "kernel" or not any(
                run_id(s) is not None for s in d["spans"]):
            continue
        inside += d["dur"]
        if not any(s in CORRELATION_SPANS for s in d["spans"]):
            glue += d["dur"]
    return 100.0 * glue / inside if inside > 0 else None


def launch_offsets(attributed: list) -> dict:
    """Of each kernel's start minus its launch's host time, in s: the
    smallest, the median and the count (negative: the kernel's time,
    put on the host's clock, lies before its launch)."""
    offsets = sorted(d["start"] - d["launch"] for d in attributed
                     if d["cat"] == "kernel" and d["launch"] is not None)
    if not offsets:
        return {"n": 0, "min_s": None, "median_s": None}
    return {"n": len(offsets), "min_s": offsets[0],
            "median_s": statistics.median(offsets)}


def report(attributed: list, found) -> dict:
    """The attribution's numbers: kernel time by layer, the launch
    offsets, the share of intervals no run span holds, and the copy
    counters against the trace's copy bytes."""
    by_layer: dict = {}
    for d in attributed:
        if d["cat"] == "kernel":
            key = str(layer(d))
            by_layer[key] = by_layer.get(key, 0.0) + d["dur"]
    unheld = [d for d in attributed
              if not any(run_id(s) is not None for s in d["spans"])]
    out = {"kernel_s_by_layer": by_layer,
           "glue_kernel_pct": glue_kernel_pct(attributed),
           "launch_offsets": launch_offsets(attributed),
           "intervals": len(attributed),
           "intervals_outside_runs": len(unheld),
           "outside_runs": sorted({d["name"] for d in unheld})[:10]}
    for kind, counter in (("HtoD", "h2d_bytes"), ("DtoH", "d2h_bytes")):
        traced = sum(d["bytes"] for d in attributed if d["kind"] == kind)
        counted = total(found, counter) if found else None
        out[counter] = {"counted": counted, "traced": traced,
                        "ratio": counted / traced if counted is not None
                        and traced else None}
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from pathlib import Path

    t_start = time.perf_counter()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness, tracing
    from perfbench.spec import Cell

    if not torch.cuda.is_available():
        print("no CUDA card: nothing measured", file=sys.stderr)
        return 2
    cell = Cell(args.workload, root=root)
    kept = []
    build_record = tracing.build_record

    def keeping(events):
        # the record drops the runtime calls that attribution needs
        kept.append(events)
        return build_record(events)

    tracing.build_record = keeping
    try:
        result = harness.run_cell(
            cell, args.seed, args.seconds, True, device="cuda",
            t_start=t_start,
            log=lambda *a: print(*a, file=sys.stderr, flush=True))
    finally:
        tracing.build_record = build_record
    found = runs(result["record"])
    line = {"workload": cell.name, "seed": args.seed,
            "device": torch.cuda.get_device_name(0),
            "correct": result["correct"], "per_layer": result["per_layer"],
            "breakdown": result["breakdown"],
            "attribution": report(attribute(kept[0]), found)}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

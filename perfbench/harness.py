"""One run of one cell: set-up, the measured window, the check.

Set-up: the cell's trajectory drawn on the device from the seed and
copied once to the host arrays of a ``MemoryReader``; the program's
``Universe`` built on them as its users build one (``Universe.empty``,
topology attributes, ``load_new``); one warm-up request of each analysis
of the cell at its shapes, which builds and loads the kernels.

The window: requests in a closed loop with one client, one analysis at
a time, from the first call's start until ``seconds`` are spent, no
request cut. A request runs from the analysis's construction until its
results are numpy arrays on the host: ``VelocityAutocorr(...).run(start,
stop)`` and ``self_diffusivity_gk()``, or ``ViscosityHelfand(...).run(
start, stop)`` with its fit.

The device's peak memory counts from the end of the trajectory's
drawing, whose scratch is the benchmark's: it covers the warm-up and the
window. The check (``check.py``) runs after the window, once the peak is
read and the program's state is freed; besides the reference, it holds
that no answer's arrays share memory with an earlier answer's.
"""

from __future__ import annotations

import gc
import statistics
import time
import traceback
import weakref

import numpy as np
import torch

from perfbench import check, reference, tracing, traffic as traffic_mod, work
from perfbench.spec import Cell

GIB = 2.0 ** 30


def build_universe(port, system: dict):
    """The program's Universe of the generated arrays, as a user builds
    one from in-memory float32 arrays."""
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader

    top = system["topology"]
    n_atoms = len(top["masses"])
    u = port.Universe.empty(n_atoms, n_residues=top["n_residues"],
                            atom_resindex=top["resindex"])
    for attr in ("names", "resnames", "resids", "masses"):
        u.add_TopologyAttr(attr, top[attr])
    u.load_new(MemoryReader(system["positions"],
                            velocities=system["velocities"],
                            dimensions=list(system["dimensions"]),
                            dt=system["dt"]))
    return u


def call(port, u, analysis: dict, start: int, stop: int, dtype, device,
         tracer) -> dict:
    """One request of the program; its results as host arrays."""
    kind = analysis["kind"]
    ag = u.select_atoms(analysis["select"])
    if kind == "vacf":
        a = port.VelocityAutocorr(ag, fft=analysis["fft"],
                                  max_lag=analysis.get("max_lag"),
                                  dtype=dtype, device=device)
        with tracer.span("vacf.run"):
            a.run(start, stop)
        with tracer.span("vacf.gk"):
            scalar = a.self_diffusivity_gk()
        particles = a.results.vacf_by_particle
    elif kind == "helfand":
        a = port.ViscosityHelfand(
            ag, temp_avg=analysis["temp_avg"],
            linear_fit_window=tuple(analysis["linear_fit_window"]),
            fft=analysis["fft"], max_lag=analysis.get("max_lag"),
            dtype=dtype, device=device)
        with tracer.span("helfand.run"):
            a.run(start, stop)
        scalar = a.results.viscosity
        particles = a.results.visc_by_particle
    else:
        raise ValueError(f"unknown analysis kind {kind!r}")
    return {"series": a.results.timeseries, "scalar": scalar,
            "particles": particles, "io_s": a.timing.as_dict()["io"]}


def weak(array) -> list:
    """A weak reference to ``array`` where it takes one."""
    try:
        return [weakref.ref(array)]
    except TypeError:
        return []


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             dtype: str | None = None, log=print) -> dict:
    """One run of ``cell``; returns the result's fields. ``t_start`` is
    the process's start (set-up counts from it); ``dtype`` overrides the
    workload's (the control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    traffic = cell.traffic
    dtype = np.dtype(dtype or traffic["dtype"])
    cuda = torch.device(device).type == "cuda"

    def stamp(what):
        log(f"{time.perf_counter() - t_start:9.3f} s  {what}")

    import transport_analysis_tpu_torch as port

    stamp("program imported")
    system = cell.generator.generate(cell.config, seed, device)
    stamp("trajectory drawn and copied to the host")
    gc.collect()
    if cuda:
        # the generator's scratch is the benchmark's, not the program's:
        # the peak counts from here
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    u = build_universe(port, system)
    n_frames, _, d = system["positions"].shape
    quiet = tracing.Tracer(False)
    setup_peak = peak_window = 0
    start, stop = traffic_mod.blocks(traffic, n_frames)[0]
    for analysis in traffic["analyses"]:
        call(port, u, analysis, start, stop, dtype, device, quiet)
        stamp(f"warm-up {analysis['kind']}")
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    tracer = tracing.Tracer(trace)
    answers, failed, errors, held = [], [], [], []
    samples = {ai: check.Reservoir(check.SAMPLE, seed, ai)
               for ai in range(len(traffic["analyses"]))}
    # the selections' sizes, counted by the benchmark itself
    selected = [len(reference.select(cell.config, a["select"]))
                for a in traffic["analyses"]]
    stream = traffic_mod.requests(traffic, n_frames, seed)
    with tracer.window():
        t0 = time.perf_counter()
        while True:
            done = len(answers) + len(failed)
            # every analysis of the mix runs at least once
            if (done >= len(traffic["analyses"])
                    and time.perf_counter() - t0 >= seconds):
                break
            ai, start, stop = next(stream)
            analysis = traffic["analyses"][ai]
            i = done
            with tracer.span(f"{tracing.REQUEST_PREFIX}{i}"):
                r0 = time.perf_counter()
                try:
                    got = call(port, u, analysis, start, stop, dtype,
                               device, tracer)
                except Exception:     # a request that fails is counted
                    failed.append(i)
                    errors.append(traceback.format_exc())
                    continue
                r1 = time.perf_counter()
            n, lags = work.request_shape(analysis.get("max_lag"), start,
                                         stop)
            p = selected[ai]
            answer = {"index": i, "analysis": ai, "start": start,
                      "stop": stop, "wall_s": r1 - r0, "io_s": got["io_s"],
                      "series": got["series"], "scalar": got["scalar"],
                      "afl": work.atom_frame_lags(n, p, lags),
                      "kind": analysis["kind"], "fft": analysis["fft"],
                      "least_s": work.least_time(
                          analysis["kind"], analysis["fft"], n, p, d, lags,
                          dtype.itemsize)}
            samples[ai].offer(dict(answer, particles=got["particles"]))
            answers.append(answer)
            held.append((i, [got["series"]], weak(got["particles"])))
        t1 = time.perf_counter()
    window_s = t1 - t0
    del stream
    if cuda:
        peak_window = torch.cuda.max_memory_allocated()
    memory_peak = max(setup_peak, peak_window)

    result = {"attempted": len(answers) + len(failed),
              "window_s": window_s,
              "answers": answers, "errors": errors,
              "memory_peak_bytes": memory_peak}
    walls = sorted(a["wall_s"] for a in answers)
    if walls:
        log("request walls (s): min %.4f median %.4f max %.4f"
            % (walls[0], statistics.median(walls), walls[-1]))
    result["end_to_end"] = {
        "afl_rate": sum(a["afl"] for a in answers) / window_s,
        "peak_dev_gib": peak_window / GIB,
        "setup_s": t0 - t_start,
    }
    stamp(f"window closed: {len(answers) + len(failed)} requests")
    if trace:
        record = tracing.build_record(tracer.events())
        stamp("trace read")
        record["requests"] = [
            {k: a[k] for k in ("index", "kind", "fft", "least_s", "io_s",
                               "wall_s")} for a in answers]
        result["record"] = record
        result["busy_s"] = tracing.busy_s(record)
        result["traced_window_s"] = record["window_s"]
        result["breakdown"] = tracing.breakdown(record)
        result["per_layer"] = {}
        for metric, read in cell.readers().items():
            value = read(record)
            if value is not None:
                result["per_layer"][metric] = value

    # the program's state goes before the reference runs
    del u
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept = {ai: res.items for ai, res in samples.items()}
    checked = check.compare(answers, kept, traffic, system, cell.config,
                            device)
    result["checked"] = {
        name: {"value": value, "limit": traffic["limits"][name]}
        for name, value in sorted(checked["numbers"].items())}
    shared = check.shared_buffers(held)
    result["checked"]["shared_buffers"] = {"value": len(shared), "limit": 0}
    stamp("reference compared")
    result["failed"] = len(failed) + len(set(checked["failed"])
                                         | set(shared))
    missing = sorted(set(traffic["limits"]) - set(checked["numbers"]))
    result["correct"] = (result["attempted"] > 0 and result["failed"] == 0
                         and not missing)
    if missing:
        log(f"not compared: {', '.join(missing)}")
    return result

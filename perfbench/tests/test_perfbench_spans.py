"""The program's spans in a trace: the accepted readers unmoved by them,
the readers of its counters (``select_gbps``, ``h2d_feed_ratio``), and
the attribution of device work to the spans that launched it
(``program_spans``), on synthetic Chrome-trace events, on the CPU."""

from __future__ import annotations

import pytest

from perfbench_tiny import ROOT  # noqa: F401 (puts the checkout on the path)

from perfbench import program_spans, tracing
from perfbench.spec import Cell

from test_perfbench_units import synthetic_events

from transport_analysis_tpu_torch.utils import profiling

MS = 1000.0   # µs
HOST = {"pid": 1, "tid": 7}


def x(cat, name, ts, dur, where=None, **args):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "args": args}
    event.update(where or {})
    return event


def timed_runs(counts_and_sizes):
    """New program timings with the given counters and sizes."""
    timers = []
    for counts, sizes in counts_and_sizes:
        t = profiling.StageTimer()
        for name, n in counts.items():
            t.count(name, n)
        t.counters(**sizes)
        timers.append(t)
    return timers


def program_events(vacf, helfand):
    """The program's spans in the synthetic window of
    ``synthetic_events``: a VACF run (with its integral) in request 0, a
    Helfand run in request 1."""
    run0, run1 = f"ta.run.{vacf.run_id}", f"ta.run.{helfand.run_id}"
    return [
        x("user_annotation", run0, 1 * MS, 380 * MS, HOST),
        x("user_annotation", "ta.feed.select", 2 * MS, 8 * MS, HOST),
        x("user_annotation", "ta.h2d", 10 * MS, 100 * MS, HOST),
        x("user_annotation", "ta.fft", 115 * MS, 5 * MS, HOST),
        x("user_annotation", "ta.d2h", 190 * MS, 110 * MS, HOST),
        x("user_annotation", run0, 385 * MS, 4 * MS, HOST),
        x("user_annotation", "ta.fit", 385 * MS, 4 * MS, HOST),
        x("user_annotation", run1, 505 * MS, 490 * MS, HOST),
        x("user_annotation", "ta.feed.select", 505 * MS, 40 * MS, HOST),
        x("user_annotation", "ta.h2d", 548 * MS, 152 * MS, HOST),
        x("user_annotation", "ta.lag", 702 * MS, 3 * MS, HOST),
    ]


@pytest.fixture
def runs_and_record():
    vacf, helfand = timed_runs([
        ({"select_bytes": 300_000_000, "h2d_bytes": 500_000_100,
          "d2h_bytes": 200_000_000},
         {"n_frames": 1000, "n_particles": 125_000}),
        ({"select_bytes": 200_000_000, "h2d_bytes": 1_000_000_000},
         {"n_frames": 1000, "n_particles": 125_000, "n_lags": 100}),
    ])
    record = tracing.build_record(synthetic_events()
                                  + program_events(vacf, helfand))
    record["requests"] = [
        {"index": 0, "kind": "vacf", "fft": True, "least_s": 0.01,
         "io_s": 0.02, "wall_s": 0.4},
        {"index": 1, "kind": "helfand", "fft": False, "least_s": 0.06,
         "io_s": 0.03, "wall_s": 0.5}]
    return (vacf, helfand), record


def readers():
    return (Cell("ec_solvent.fft_blocks").readers()
            | Cell("dhfr_jac.fft_full").readers()
            | Cell("ec_solvent.windowed_lag8k").readers())


def test_program_spans_move_no_accepted_reader(runs_and_record):
    """The seven accepted readers read the same with the program's spans
    in the trace as without (values of ``test_readers_by_hand``); only
    the idle gaps take the program's names."""
    read = readers()
    _, record = runs_and_record
    assert read["feed_io_pct"](record) == pytest.approx(5.0)
    assert read["h2d_gbps"](record) == pytest.approx(6.0)
    assert read["d2h_gbps"](record) == pytest.approx(2.0)
    assert read["fft_roofline_pct"](record) == pytest.approx(20.0)
    assert read["lag_roofline_pct"](record) == pytest.approx(40.0)
    assert read["device_idle_pct"](record) == pytest.approx(44.0)
    assert read["solve_p95_s.blocks"](record) == pytest.approx(0.585)
    assert [d["request"] for d in record["device"]] == [0, 0, 0, 0, 1, 1]
    gaps = tracing.breakdown(record)["idle_gaps"]
    assert gaps[0] == ["harness", pytest.approx(0.25)]
    # 850-1000 ms: Helfand's run, after its lag sums' launch
    assert gaps[1] == [f"ta.run.{runs_and_record[0][1].run_id}",
                       pytest.approx(0.15)]


def test_counter_readers_by_hand(runs_and_record):
    read = readers()
    _, record = runs_and_record
    # 500 MB gathered in 8 + 40 ms of selection spans
    assert read["select_gbps"](record) == pytest.approx(0.5 / 0.048)
    # feeds: 1 · 4 · 3 · 1000 · 125,000 (VACF) and twice that (Helfand)
    assert read["h2d_feed_ratio"](record) == pytest.approx(
        1_500_000_100 / 4.5e9)


def test_counter_readers_find_nothing_to_read(runs_and_record, monkeypatch):
    read = readers()
    (vacf, _), record = runs_and_record
    no_select = dict(record, spans=[s for s in record["spans"]
                                    if s["name"] != "ta.feed.select"])
    assert read["select_gbps"](no_select) is None
    # a request that failed has no answer: its run is left out
    one = dict(record, requests=record["requests"][:1])
    assert read["h2d_feed_ratio"](one) == pytest.approx(
        500_000_100 / 1.5e9)
    # the parent's program: no run spans, or no run_timing to find them
    parent = dict(record, spans=[s for s in record["spans"]
                                 if not s["name"].startswith("ta.")])
    for name in ("select_gbps", "h2d_feed_ratio"):
        assert read[name](parent) is None
    monkeypatch.delattr(profiling, "run_timing")
    for name in ("select_gbps", "h2d_feed_ratio"):
        assert read[name](record) is None


def test_runs_give_up_on_a_run_no_longer_found(runs_and_record,
                                               monkeypatch):
    (vacf, helfand), record = runs_and_record
    found = program_spans.runs(record)
    assert found == {vacf.run_id: {"request": 0, "timing": vacf},
                     helfand.run_id: {"request": 1, "timing": helfand}}
    monkeypatch.setattr(profiling, "RECENT_RUNS", 1)
    profiling.StageTimer()
    assert program_spans.runs(record) is None


# --- attribution by launch ---------------------------------------------------

def launch_trace():
    """A window with one run: an HtoD copy and a glue kernel launched in
    the run, two FFT kernels launched in ``ta.fft``, a DtoH copy, and a
    kernel launched outside any run. The device's clock runs 2 ms behind
    the host's, so one FFT kernel starts before its launch; device events
    are listed out of order."""
    other = {"pid": 1, "tid": 9}
    run = "ta.run.42"
    return [
        x("user_annotation", "bench.window", 0, 100 * MS, HOST),
        x("user_annotation", run, 1 * MS, 60 * MS, HOST),
        x("user_annotation", "ta.h2d", 2 * MS, 10 * MS, HOST),
        x("user_annotation", "ta.fft", 20 * MS, 5 * MS, HOST),
        x("user_annotation", "ta.d2h", 30 * MS, 30 * MS, HOST),
        # on another thread, a span that holds every launch's time
        x("user_annotation", "ta.lag", 0, 100 * MS, other),
        x("cuda_runtime", "cudaMemcpyAsync", 3 * MS, 1 * MS, HOST,
          correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 15 * MS, 0.1 * MS, HOST,
          correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 21 * MS, 0.1 * MS, HOST,
          correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 22 * MS, 0.1 * MS, HOST,
          correlation=4),
        x("cuda_runtime", "cudaMemcpyAsync", 31 * MS, 0.1 * MS, HOST,
          correlation=5),
        x("cuda_runtime", "cudaLaunchKernel", 70 * MS, 0.1 * MS, HOST,
          correlation=6),
        x("kernel", "fft_level_columns_kernel", 40 * MS, 6 * MS,
          correlation=4),
        x("kernel", "elementwise_kernel", 16 * MS, 4 * MS, correlation=2),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 47 * MS,
          8 * MS, correlation=5, bytes=800),
        x("kernel", "unpack_power_inva_kernel", 19 * MS, 10 * MS,
          correlation=3),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4 * MS,
          9 * MS, correlation=1, bytes=4000),
        x("kernel", "late_fill_kernel", 71 * MS, 2 * MS, correlation=6),
        x("kernel", "after_window", 150 * MS, 1 * MS, correlation=7),
    ]


def test_attribution_follows_the_launch_not_the_clock():
    got = {d["name"]: d for d in program_spans.attribute(launch_trace())}
    assert "after_window" not in got
    assert got["unpack_power_inva_kernel"]["spans"] == ["ta.run.42",
                                                         "ta.fft"]
    # it ran before its launch on the host's clock, still ta.fft's
    assert got["unpack_power_inva_kernel"]["start"] < \
        got["unpack_power_inva_kernel"]["launch"]
    assert got["fft_level_columns_kernel"]["span"] == "ta.fft"
    assert got["elementwise_kernel"]["span"] == "ta.run.42"
    assert got["Memcpy HtoD (Pageable -> Device)"]["span"] == "ta.h2d"
    assert got["Memcpy DtoH (Device -> Pageable)"]["span"] == "ta.d2h"
    # the other thread's span holds no launch of this one
    assert got["late_fill_kernel"]["spans"] == []
    assert got["late_fill_kernel"]["span"] is None
    assert [program_spans.layer(got[n]) for n in (
        "elementwise_kernel", "fft_level_columns_kernel",
        "late_fill_kernel")] == ["ta.run", "ta.fft", None]


def test_glue_share_offsets_and_copy_completeness():
    attributed = program_spans.attribute(launch_trace())
    # kernels launched in the run: 4 ms of glue, 6 + 10 ms of ta.fft
    assert program_spans.glue_kernel_pct(attributed) == pytest.approx(20.0)
    offsets = program_spans.launch_offsets(attributed)
    assert offsets["n"] == 4
    assert offsets["min_s"] == pytest.approx(-0.002)
    # -2, 1, 1 and 18 ms
    assert offsets["median_s"] == pytest.approx(0.001)
    run = profiling.StageTimer()
    run.count("h2d_bytes", 4000)
    run.count("d2h_bytes", 808)
    found = {42: {"request": 0, "timing": run}}
    report = program_spans.report(attributed, found)
    assert report["h2d_bytes"] == {"counted": 4000, "traced": 4000,
                                   "ratio": 1.0}
    assert report["d2h_bytes"]["ratio"] == pytest.approx(1.01)
    assert report["intervals_outside_runs"] == 1
    assert report["outside_runs"] == ["late_fill_kernel"]
    assert report["kernel_s_by_layer"] == {
        "ta.run": pytest.approx(0.004), "ta.fft": pytest.approx(0.016),
        "None": pytest.approx(0.002)}
    assert program_spans.glue_kernel_pct([]) is None
    assert program_spans.launch_offsets([])["n"] == 0

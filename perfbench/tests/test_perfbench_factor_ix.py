"""The FactorIX cell on the CPU: its two readers of the program's atom
chunks (``chunk_host_pct``, ``chunk_merge_gbps``) on synthetic
Chrome-trace events, in the manner of ``test_perfbench_spans.py``, and
a tiny copy of the cell whose budget forces chunks, through the harness
against the plain reference."""

from __future__ import annotations

import pytest

from perfbench_tiny import SEED, tiny

from perfbench import tracing
from perfbench.harness import run_cell
from perfbench.spec import Cell

from test_perfbench_units import synthetic_events
from test_perfbench_spans import HOST, MS, timed_runs, x

from transport_analysis_tpu_torch.models import base
from transport_analysis_tpu_torch.ops import acf
from transport_analysis_tpu_torch.utils import profiling

CELL = "factor_ix.fft_chunked"


def chunk_events(vacf, helfand):
    """The program's spans of two chunked runs in the synthetic window:
    the VACF's two chunks in request 0, Helfand's in request 1, each
    with its gather and merge, and Helfand's division after its last
    chunk."""
    run0, run1 = f"ta.run.{vacf.run_id}", f"ta.run.{helfand.run_id}"
    return [
        x("user_annotation", run0, 1 * MS, 380 * MS, HOST),
        x("user_annotation", "ta.chunk", 2 * MS, 200 * MS, HOST),
        x("user_annotation", "ta.chunk.gather", 2 * MS, 20 * MS, HOST),
        x("user_annotation", "ta.chunk.merge", 180 * MS, 20 * MS, HOST),
        x("user_annotation", "ta.chunk", 205 * MS, 170 * MS, HOST),
        x("user_annotation", "ta.chunk.gather", 205 * MS, 10 * MS, HOST),
        x("user_annotation", "ta.chunk.merge", 360 * MS, 10 * MS, HOST),
        x("user_annotation", run1, 505 * MS, 490 * MS, HOST),
        x("user_annotation", "ta.chunk", 505 * MS, 400 * MS, HOST),
        x("user_annotation", "ta.chunk.gather", 505 * MS, 30 * MS, HOST),
        x("user_annotation", "ta.chunk.gather", 540 * MS, 30 * MS, HOST),
        x("user_annotation", "ta.chunk.merge", 880 * MS, 20 * MS, HOST),
        x("user_annotation", "ta.chunk.merge", 960 * MS, 20 * MS, HOST),
    ]


@pytest.fixture
def chunked_record():
    vacf, helfand = timed_runs([
        ({"chunks": 2, "chunk_gather_bytes": 300_000_000,
          "chunk_merge_bytes": 60_000_000},
         {"n_frames": 1000, "n_particles": 125_000}),
        ({"chunks": 1, "chunk_gather_bytes": 400_000_000,
          "chunk_merge_bytes": 60_000_000},
         {"n_frames": 1000, "n_particles": 125_000}),
    ])
    record = tracing.build_record(synthetic_events()
                                  + chunk_events(vacf, helfand))
    record["requests"] = [
        {"index": 0, "kind": "vacf", "fft": True, "least_s": 0.01,
         "io_s": 0.02, "wall_s": 0.4},
        {"index": 1, "kind": "helfand", "fft": True, "least_s": 0.06,
         "io_s": 0.03, "wall_s": 0.5}]
    return record


def readers():
    return Cell(CELL).readers()


def test_the_cell_reports_its_metrics():
    """The cell reports the two new metrics and the seven accepted ones
    whose readers apply to a chunked run unchanged."""
    assert set(readers()) == {
        "chunk_host_pct", "chunk_merge_gbps", "feed_io_pct", "h2d_gbps",
        "d2h_gbps", "fft_roofline_pct", "device_idle_pct",
        "h2d_feed_ratio", "d2h_pool_hit_pct"}


def test_chunk_readers_by_hand(chunked_record):
    read = readers()
    # gathers 20 + 10 + 30 + 30 ms, merges 20 + 10 + 20 + 20 ms of 1 s
    assert read["chunk_host_pct"](chunked_record) == pytest.approx(16.0)
    # 120 MB merged in 70 ms of merge spans
    assert read["chunk_merge_gbps"](chunked_record) == pytest.approx(
        0.12 / 0.07)


def test_chunk_readers_find_nothing_to_read(chunked_record, monkeypatch):
    """A window with no chunk span (no run chunked, or the parent's
    program, which streams no chunks by itself) reads None, and so does
    a program without the counters or ``run_timing``."""
    read = readers()
    unchunked = dict(chunked_record, spans=[
        s for s in chunked_record["spans"]
        if not s["name"].startswith("ta.chunk")])
    for name in ("chunk_host_pct", "chunk_merge_gbps"):
        assert read[name](unchunked) is None
    parent = dict(chunked_record, spans=[
        s for s in chunked_record["spans"]
        if not s["name"].startswith("ta.")])
    for name in ("chunk_host_pct", "chunk_merge_gbps"):
        assert read[name](parent) is None
    monkeypatch.delattr(profiling, "run_timing")
    assert read["chunk_merge_gbps"](chunked_record) is None


def test_tiny_cell_streams_chunks_and_is_correct(monkeypatch):
    """A hundredth of the cell's molecules over 384 frames, with a
    budget that cuts them into four chunks: every request goes through
    the chunk loop, and the run is correct against the plain
    reference."""
    cell = tiny(CELL)
    n = cell.config["n_frames"]
    atoms = sum(s["count"] * len(s["atoms"]) for s in cell.config["species"])
    chunk = -(-atoms // 4)
    monkeypatch.setenv(acf.HBM_BUDGET_ENV,
                       repr(acf.chunk_peak_bytes(n, chunk, 3) / 1e9))
    calls = []
    real = base.chunked_per_particle

    def counting(kernel, series, chunk_particles, **kwargs):
        calls.append(-(-series.shape[1] // chunk_particles))
        return real(kernel, series, chunk_particles, **kwargs)

    monkeypatch.setattr(base, "chunked_per_particle", counting)
    result = run_cell(cell, SEED, 0.3, False, device="cpu",
                      log=lambda *a: None)
    assert result["correct"], result["checked"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    # the warm-up's two requests and the window's, four chunks each
    assert calls == [4] * (result["attempted"] + 2)

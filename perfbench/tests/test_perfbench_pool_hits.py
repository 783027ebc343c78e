"""The reader of ``d2h_pool_hit_pct`` on synthetic records: the program's
run spans in the window of ``synthetic_events`` and run timings with
the given byte counters, on the CPU."""

from __future__ import annotations

import pytest

from perfbench_tiny import ROOT  # noqa: F401 (puts the checkout on the path)

from perfbench import tracing
from perfbench.spec import Cell

from test_perfbench_spans import program_events, timed_runs
from test_perfbench_units import synthetic_events

from transport_analysis_tpu_torch.utils import profiling

COUNTER = "d2h_pool_hit_bytes"
CELLS = ("ec_solvent.fft_blocks", "dhfr_jac.fft_full",
         "ec_solvent.windowed_lag8k")
SIZES = {"n_frames": 1000, "n_particles": 125_000}


def record_of(vacf_counts, helfand_counts):
    """A record of two answered requests, a VACF run and a Helfand run
    with the given counters; a run not given ``d2h_pool_hit_bytes`` has
    none, as the runs of a program without the pool."""
    vacf, helfand = timed_runs([(vacf_counts, SIZES),
                                (helfand_counts, SIZES)])
    for timer, counts in ((vacf, vacf_counts), (helfand, helfand_counts)):
        if COUNTER not in counts:
            del timer._counts[COUNTER]
    record = tracing.build_record(synthetic_events()
                                  + program_events(vacf, helfand))
    record["requests"] = [
        {"index": 0, "kind": "vacf", "fft": True, "least_s": 0.01,
         "io_s": 0.02, "wall_s": 0.4},
        {"index": 1, "kind": "helfand", "fft": False, "least_s": 0.06,
         "io_s": 0.03, "wall_s": 0.5}]
    return record


def read(record, cell=CELLS[0]):
    return Cell(cell).readers()["d2h_pool_hit_pct"](record)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reads_the_hit_share(cell):
    record = record_of(
        {"d2h_bytes": 300, "d2h_pool_hit_bytes": 300},
        {"d2h_bytes": 100, "d2h_pool_hit_bytes": 100})
    assert read(record, cell) == pytest.approx(100.0)


@pytest.mark.parametrize("vacf_hit, helfand_hit, share", [
    (0, 0, 0.0),            # every block new: the runs hold the counter
    (300, 0, 75.0),
    (0, 100, 25.0),
    (150, 50, 50.0),
])
def test_hit_share_by_hand(vacf_hit, helfand_hit, share):
    record = record_of(
        {"d2h_bytes": 300, "d2h_pool_hit_bytes": vacf_hit},
        {"d2h_bytes": 100, "d2h_pool_hit_bytes": helfand_hit})
    assert read(record) == pytest.approx(share)


def test_a_run_that_bypassed_the_pool_counts_its_bytes():
    """A run without the counter: its bytes count as copied, none as
    hits."""
    record = record_of({"d2h_bytes": 300, "d2h_pool_hit_bytes": 300},
                       {"d2h_bytes": 100})
    assert read(record) == pytest.approx(75.0)


def test_a_failed_request_is_left_out():
    record = record_of({"d2h_bytes": 300, "d2h_pool_hit_bytes": 0},
                       {"d2h_bytes": 100, "d2h_pool_hit_bytes": 100})
    record["requests"] = record["requests"][:1]
    assert read(record) == pytest.approx(0.0)


def test_nothing_to_read(monkeypatch):
    # a program without the pool: no run holds the counter
    assert read(record_of({"d2h_bytes": 300}, {"d2h_bytes": 100})) is None
    # no result copied at all
    assert read(record_of({"d2h_pool_hit_bytes": 0}, {})) is None
    record = record_of({"d2h_bytes": 300, "d2h_pool_hit_bytes": 300},
                       {"d2h_bytes": 100, "d2h_pool_hit_bytes": 100})
    # the parent's program: no run spans, or no run_timing to find them
    parent = dict(record, spans=[s for s in record["spans"]
                                 if not s["name"].startswith("ta.")])
    assert read(parent) is None
    monkeypatch.delattr(profiling, "run_timing")
    assert read(record) is None

"""The reader of ``h2d_pinned_pct`` on synthetic records: the program's
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

COUNTER = "h2d_pinned_bytes"
CELLS = ("ec_solvent.fft_blocks", "dhfr_jac.fft_full",
         "ec_solvent.windowed_lag8k")
SIZES = {"n_frames": 1000, "n_particles": 125_000}


def record_of(vacf_counts, helfand_counts):
    """A record of two answered requests, a VACF run and a Helfand run
    with the given counters; a run not given ``h2d_pinned_bytes`` has
    none, as the runs of a program that does not count it."""
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
    return Cell(cell).readers()["h2d_pinned_pct"](record)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reads_the_pinned_share(cell):
    record = record_of({"h2d_bytes": 300, COUNTER: 300},
                       {"h2d_bytes": 100, COUNTER: 100})
    assert read(record, cell) == pytest.approx(100.0)


@pytest.mark.parametrize("vacf_pinned, helfand_pinned, share", [
    (0, 0, 0.0),            # every copy pageable: the runs hold the counter
    (300, 0, 75.0),
    (0, 100, 25.0),
    (296, 96, 98.0),        # the masses and the fit's tables stay pageable
])
def test_pinned_share_by_hand(vacf_pinned, helfand_pinned, share):
    record = record_of({"h2d_bytes": 300, COUNTER: vacf_pinned},
                       {"h2d_bytes": 100, COUNTER: helfand_pinned})
    assert read(record) == pytest.approx(share)


def test_a_run_that_copied_nothing_adds_nothing():
    record = record_of({"h2d_bytes": 300, COUNTER: 225},
                       {"h2d_bytes": 0, COUNTER: 0})
    assert read(record) == pytest.approx(75.0)


def test_a_failed_request_is_left_out():
    record = record_of({"h2d_bytes": 300, COUNTER: 0},
                       {"h2d_bytes": 100, COUNTER: 100})
    record["requests"] = record["requests"][:1]
    assert read(record) == pytest.approx(0.0)


def test_nothing_to_read(monkeypatch):
    # a program that does not count it: no run holds the counter
    assert read(record_of({"h2d_bytes": 300}, {"h2d_bytes": 100})) is None
    # nothing copied to the card at all
    assert read(record_of({COUNTER: 0}, {})) is None
    record = record_of({"h2d_bytes": 300, COUNTER: 300},
                       {"h2d_bytes": 100, COUNTER: 100})
    # the parent's program: no run spans, or no run_timing to find them
    parent = dict(record, spans=[s for s in record["spans"]
                                 if not s["name"].startswith("ta.")])
    assert read(parent) is None
    monkeypatch.delattr(profiling, "run_timing")
    assert read(record) is None

"""The port's spans and copy counters (``utils.profiling``): the ``ta.*``
profiler ranges of a run and their nesting, that no range is entered
without a profiler session, the byte counters of ``analysis.timing``,
run ids, and the lag-cut throughput. The file imports no jax: the tests
marked ``gpu`` check the counters and copy spans on the card, where

    python -m pytest tests/test_torch_tracing.py -m gpu --noconftest -q

runs them; without a card they skip.
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from transport_analysis_tpu_torch import (  # noqa: E402
    VelocityAutocorr, ViscosityHelfand, convert)
from transport_analysis_tpu_torch.utils import profiling  # noqa: E402

N_FRAMES, N_ATOMS = 48, 7
FIT = (2, 9)
KEYS = {"io", "compute", "total", "frames_per_s", "atom_frame_lags_per_s"}
ENGINES = {"batch": {}, "frame_block": {"frame_block": 16}}
# the spans of a run's layers, by model and path (the CPU device makes no
# copy to or from a card, so no ta.h2d, no ta.d2h)
LAYERS = {("vacf", True): {"ta.feed.read", "ta.feed.select", "ta.fft",
                           "ta.fit"},
          ("vacf", False): {"ta.feed.read", "ta.feed.select", "ta.lag",
                            "ta.fit"},
          ("helfand", True): {"ta.feed.read", "ta.feed.select", "ta.fft",
                              "ta.fit"},
          ("helfand", False): {"ta.feed.read", "ta.feed.select", "ta.lag",
                               "ta.fit"}}


@pytest.fixture(scope="module")
def universe():
    rng = np.random.default_rng(7)
    shape = (N_FRAMES, N_ATOMS, 3)
    return convert.universe_from_arrays(
        N_ATOMS, {"masses": np.linspace(1.0, 16.0, N_ATOMS),
                  "resids": np.arange(N_ATOMS)},
        rng.normal(size=shape).astype(np.float32),
        velocities=rng.normal(size=shape).astype(np.float32),
        dimensions=[20.0, 20.0, 20.0, 90.0, 90.0, 90.0])


def analyse(model, atoms, fft=True, device="cpu", **kwargs):
    """One request as a user makes it: the run, then the VACF's
    Green–Kubo integral or Helfand's fit."""
    if model == "vacf":
        a = VelocityAutocorr(atoms, fft=fft, device=device, **kwargs).run()
        a.self_diffusivity_gk()
    else:
        a = ViscosityHelfand(atoms, fft=fft, linear_fit_window=FIT,
                             device=device, **kwargs).run()
    return a


def traced(tmp_path, work):
    """The ``ta.*`` spans a CPU-only profiler session records over
    ``work()``, as (name, start, end) in µs, sorted by start; and
    ``work()``'s value."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        value = work()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.unlink(path)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("ta."))
    return [(name, lo, hi) for lo, hi, name in spans], value


def inside(span, outer) -> bool:
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("model", ["vacf", "helfand"])
def test_spans_of_a_run_nest_in_it(universe, tmp_path, model, fft, engine):
    """One ``ta.run.<run_id>`` per run (the VACF's integral opens it
    again), every layer's span inside it, the feed's before the
    correlation's, and no copy span on the CPU."""
    spans, a = traced(tmp_path, lambda: analyse(
        model, universe.atoms[[0, 2, 3, 6]], fft=fft, max_lag=12,
        **ENGINES[engine]))
    runs = [s for s in spans if s[0].startswith("ta.run.")]
    assert {s[0] for s in runs} == {f"ta.run.{a.timing.run_id}"}
    assert len(runs) == (2 if model == "vacf" else 1)
    layers = [s for s in spans if s not in runs]
    assert {s[0] for s in layers} == LAYERS[model, fft]
    assert all(any(inside(s, r) for r in runs) for s in layers)
    work = [s for s in layers if s[0] in ("ta.fft", "ta.lag")]
    feed = [s for s in layers if s[0].startswith("ta.feed.")]
    assert max(s[2] for s in feed) <= min(s[1] for s in work)
    # the frame-blocked feed waits for each block, and the end, apart
    reads = sum(s[0] == "ta.feed.read" for s in layers)
    assert reads == (1 if engine == "batch" else N_FRAMES // 16 + 1)
    # the fit: inside the VACF's second run span, after Helfand's work
    fit = [s for s in layers if s[0] == "ta.fit"]
    assert len(fit) == 1
    if model == "vacf":
        assert inside(fit[0], runs[1]) and not inside(fit[0], runs[0])
    else:
        assert fit[0][1] >= max(s[2] for s in work)


@pytest.mark.parametrize("model", ["vacf", "helfand"])
def test_chunk_spans_and_counters(universe, tmp_path, model, monkeypatch):
    """A default run past the budget (the environment's
    ``TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB`` at a chunk of 3 atoms): one
    ``ta.chunk`` a chunk inside the run, a ``ta.chunk.gather`` before
    each chunk's correlation, a ``ta.chunk.merge`` after it (Helfand's
    division one more, after the last chunk), and the counters of the
    chunks, the gathered feed and the merged results."""
    from transport_analysis_tpu_torch.ops import acf

    monkeypatch.setenv(acf.HBM_BUDGET_ENV,
                       repr(acf.chunk_peak_bytes(N_FRAMES, 3, 3) / 1e9))
    spans, a = traced(tmp_path, lambda: analyse(model, universe.atoms))
    run = [s for s in spans if s[0] == f"ta.run.{a.timing.run_id}"][0]
    chunks = [s for s in spans if s[0] == "ta.chunk"]
    assert len(chunks) == 3 and all(inside(c, run) for c in chunks)
    gathers = [s for s in spans if s[0] == "ta.chunk.gather"]
    merges = [s for s in spans if s[0] == "ta.chunk.merge"]
    feeds = 1 if model == "vacf" else 2
    assert len(gathers) == feeds * 3
    assert len(merges) == 3 + (model == "helfand")
    for chunk in chunks:
        held = [s for s in spans if inside(s, chunk) and s != chunk]
        work = [s for s in held if s[0] == "ta.fft"]
        assert len(work) == 1
        assert [s[0] for s in held if s[2] <= work[0][1]] == \
            ["ta.chunk.gather"] * feeds
        assert [s[0] for s in held if s[1] >= work[0][2]] == \
            ["ta.chunk.merge"]
    assert all(inside(s, run) for s in merges)
    counts = a.timing.counts()
    result = N_FRAMES * N_ATOMS * 8
    assert counts["chunks"] == 3
    assert counts["chunk_gather_bytes"] == feeds * N_FRAMES * N_ATOMS * 12
    # each chunk's results once, and Helfand's whole result divided
    assert counts["chunk_merge_bytes"] == result * (
        2 if model == "helfand" else 1)


def test_runs_take_distinct_ids(universe, tmp_path):
    spans, done = traced(tmp_path, lambda: [
        analyse(model, universe.atoms, fft=fft)
        for model in ("vacf", "helfand") for fft in (True, False)])
    ids = [a.timing.run_id for a in done]
    assert len(set(ids)) == 4 and ids == sorted(ids)
    assert {s[0] for s in spans if s[0].startswith("ta.run.")} == {
        f"ta.run.{i}" for i in ids}


def test_no_session_enters_no_record_function(universe, tmp_path,
                                              monkeypatch):
    """Without a profiler session a span checks one flag and enters no
    ``record_function``; with one, each span enters one."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for model in ("vacf", "helfand"):
        for fft in (True, False):
            for engine in ENGINES.values():
                analyse(model, universe.atoms[[1, 4]], fft=fft,
                        max_lag=12, **engine)
    assert entered == []
    spans, _ = traced(tmp_path, lambda: analyse("helfand", universe.atoms))
    assert len(entered) == len(spans) > 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_select_bytes_count_a_gather(universe, engine):
    """A selection the feed has to gather counts the new array's bytes
    (float32 samples stay float32); a whole universe in xyz is a view
    and counts 0."""
    some = universe.atoms[[0, 2, 5]]
    one = N_FRAMES * len(some) * 3 * 4
    got = {model: analyse(model, some, **ENGINES[engine]).timing.counts()
           for model in ("vacf", "helfand")}
    assert got["vacf"]["select_bytes"] == one
    assert got["helfand"]["select_bytes"] == 2 * one
    for model in ("vacf", "helfand"):
        whole = analyse(model, universe.atoms, **ENGINES[engine])
        assert whole.timing.counts()["select_bytes"] == 0


def test_copy_counters_are_zero_on_the_cpu(universe):
    for model in ("vacf", "helfand"):
        counts = analyse(model, universe.atoms[[0, 3]]).timing.counts()
        assert set(counts) == set(profiling.COUNTS)
        assert counts["h2d_bytes"] == counts["d2h_bytes"] == 0
        assert all(isinstance(v, int) for v in counts.values())


def test_counts_go_to_the_current_run_of_the_thread():
    outer, inner = profiling.StageTimer(), profiling.StageTimer()
    profiling.count("h2d_bytes", 5)     # no current run: counts nowhere
    with outer.running():
        profiling.count("h2d_bytes", 3)
        with inner.running():
            profiling.count("d2h_bytes", 7)
        profiling.count("select_bytes", 2)
        worker = threading.Thread(
            target=profiling.count, args=("h2d_bytes", 11))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    profiling.count("h2d_bytes", 13)
    none = dict.fromkeys(profiling.COUNTS, 0)
    assert outer.counts() == dict(none, select_bytes=2, h2d_bytes=3)
    assert inner.counts() == dict(none, d2h_bytes=7)
    with pytest.raises(KeyError):
        outer.count("bytes", 1)


def test_run_timing_finds_the_recent_runs(universe, monkeypatch):
    a = analyse("vacf", universe.atoms)
    assert profiling.run_timing(a.timing.run_id) is a.timing
    assert profiling.run_timing(-1) is None
    monkeypatch.setattr(profiling, "RECENT_RUNS", 2)
    later = [profiling.StageTimer() for _ in range(3)]
    assert profiling.run_timing(a.timing.run_id) is None
    assert profiling.run_timing(later[0].run_id) is None
    assert [profiling.run_timing(t.run_id) for t in later[1:]] == later[1:]


@pytest.mark.parametrize("max_lag", [None, 10, N_FRAMES + 5])
def test_atom_frame_lags_count_the_lag_cut(universe, max_lag):
    """``atom_frame_lags_per_s`` counts P · Σ_{lag<L} (N − lag): L = N
    without a cut (N(N + 1)/2 a particle), the cut's L on a windowed
    run; the keys stay the JAX package's."""
    a = analyse("vacf", universe.atoms[[0, 1, 4]], fft=False,
                max_lag=max_lag)
    timing = a.timing.as_dict()
    assert set(timing) == KEYS
    n, lags = N_FRAMES, min(max_lag or N_FRAMES, N_FRAMES)
    assert a.timing.sizes == {"n_frames": n, "n_particles": 3,
                              "n_lags": lags}
    pairs = lags * n - lags * (lags - 1) // 2
    assert timing["atom_frame_lags_per_s"] * n == pytest.approx(
        timing["frames_per_s"] * pairs * 3)


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA Hopper card: run on the H100 with "
                    "python -m pytest tests/test_torch_tracing.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("fft", [True, False])
def test_copy_counters_on_the_card(universe, cuda_device, fft, engine):
    """The counters against the bytes reckoned from the shapes: the
    float32 feed once (P·N·d·4 an array), the masses, the tables of the
    integral or the fit; back, the (L, P) and (L,) float64 results."""
    some = universe.atoms[[0, 2, 3, 6]]
    n, p, lags = N_FRAMES, len(some), (N_FRAMES if fft else 12)
    feed = n * p * 3 * 4
    results = lags * p * 8 + lags * 8
    vacf = analyse("vacf", some, fft=fft, device=cuda_device,
                   max_lag=None if fft else lags, **ENGINES[engine])
    none = dict.fromkeys(profiling.COUNTS, 0)
    assert vacf.timing.counts() == dict(
        none, select_bytes=feed, h2d_bytes=feed + 2 * lags * 8,
        d2h_bytes=results)
    helfand = analyse("helfand", some, fft=fft, device=cuda_device,
                      max_lag=None if fft else lags, **ENGINES[engine])
    assert helfand.timing.counts() == dict(
        none, select_bytes=2 * feed,
        h2d_bytes=2 * feed + p * 8 + 2 * (FIT[1] - FIT[0]) * 8,
        d2h_bytes=results)


@pytest.mark.gpu
def test_copy_spans_on_the_card(universe, cuda_device, tmp_path):
    """Each host copy is a ``ta.h2d`` span and each result copy a
    ``ta.d2h`` span, inside the run. The spans are the host's: a
    CPU-only session records them and leaves the card's tracer alone (a
    pytest process that holds several CUDA sessions can lose a later
    session's kernel records)."""
    spans, a = traced(tmp_path, lambda: analyse(
        "helfand", universe.atoms[[0, 2, 3, 6]], device=cuda_device))
    run = [s for s in spans if s[0] == f"ta.run.{a.timing.run_id}"]
    assert len(run) == 1
    copies = [s for s in spans if s[0] in ("ta.h2d", "ta.d2h")]
    # velocities, positions, masses, the fit's two tables; two results
    assert sorted(s[0] for s in copies) == ["ta.d2h"] * 2 + ["ta.h2d"] * 5
    assert all(inside(s, run[0]) for s in copies)

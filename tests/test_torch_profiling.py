"""The port's stage timing and traces (``utils.profiling``) against the
JAX package's, and ``analysis.timing`` on the three engines of
``AnalysisBase.run``: batch, frame-blocked and per-frame.

The timers are driven by one fake clock, so their dictionaries are
compared exactly.
"""

import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu.utils import profiling as jprofiling  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import ops  # noqa: E402
from transport_analysis_tpu_torch.utils import profiling  # noqa: E402

from test_torch_models import port_universe  # noqa: E402

KEYS = {"io", "compute", "total", "frames_per_s", "atom_frame_lags_per_s"}
ENGINES = {"batch": {}, "frame_block": {"frame_block": 5},
           "frame": {"engine": "frame"}}


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` as a clock that advances 0.25 s a read."""
    ticks = iter(np.arange(1000) * 0.25)
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


def drive(timer, n_frames, n_particles):
    with timer.stage("io"):
        pass
    with timer.stage("compute"):
        pass
    with timer.stage("io"):
        pass
    if n_frames is not None:
        timer.counters(n_frames=n_frames, n_particles=n_particles)
    return timer.as_dict()


@pytest.mark.parametrize("counts", [(None, None), (100, 7), (100, 0),
                                    (0, 5)])
def test_stage_timer_matches_jax(clock, counts):
    """Same stages, accumulation, keys and throughput formula as the JAX
    ``StageTimer`` (its ``profiling.py:48-58``)."""
    got = drive(profiling.StageTimer(), *counts)
    want = drive(jprofiling.StageTimer(), *counts)
    assert got == want
    assert got["io"] == 0.5 and got["compute"] == 0.25


def test_stage_timer_synchronises_a_card(monkeypatch):
    """On a CUDA device every stage synchronises it before reading the
    clock; on the CPU none does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    timer = profiling.StageTimer(torch.device("cuda", 0))
    with timer.stage("compute"):
        assert calls == []
    assert calls == [torch.device("cuda", 0)]
    with profiling.StageTimer("cpu").stage("compute"):
        pass
    with profiling.StageTimer().stage("compute"):
        pass
    assert len(calls) == 1


@pytest.fixture(scope="module")
def universes(u_random):
    return u_random, port_universe(u_random)


def analyses(pkg, u, **kwargs):
    device = {"device": "cpu"} if pkg is ta else {}
    return {
        "vacf": lambda: pkg.VelocityAutocorr(u.atoms, **device, **kwargs),
        "helfand": lambda: pkg.ViscosityHelfand(u.atoms, **device,
                                                **kwargs),
        "msd": lambda: pkg.EinsteinMSD(u, select="all", **device, **kwargs),
    }


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("model", ["vacf", "helfand", "msd"])
def test_timing_on_every_engine(universes, engine, model):
    """``analysis.timing`` has the JAX keys after a run of each engine,
    its throughputs follow its counters, and the run still releases its
    device feed."""
    ju, pu = universes
    got = analyses(ta, pu, **ENGINES[engine])[model]().run()
    want = analyses(jta, ju, **ENGINES[engine])[model]().run()
    timing = got.timing.as_dict()
    assert set(timing) == set(want.timing.as_dict()) == KEYS
    assert timing["total"] >= timing["io"] + timing["compute"] > 0
    n, p = got.n_frames, got.n_particles
    assert timing["atom_frame_lags_per_s"] * n == pytest.approx(
        timing["frames_per_s"] * (n * (n + 1) // 2) * p)
    assert got._buffers == {}


def test_trace_none_is_a_no_op(tmp_path):
    before = set(os.listdir(tmp_path))
    with profiling.trace(None) as ctx:
        ops.acf_fft(torch.ones(8, 2, 3))
    assert ctx is None and set(os.listdir(tmp_path)) == before


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(dir)`` writes one Chrome trace with the host's operators
    of the traced work."""
    log_dir = tmp_path / "trace"
    with profiling.trace(log_dir):
        ops.acf_fft(torch.from_numpy(
            np.random.RandomState(0).normal(size=(64, 4, 3))))
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)

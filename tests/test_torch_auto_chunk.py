"""The default path's own atom chunks: an analysis called without
``atom_chunk`` streams ``ops.acf.auto_atom_chunk`` chunks through
``parallel.streaming`` when the whole FFT run's
``ops.acf.chunk_peak_bytes`` is past the device's budget
(``models.base.ParticleAnalysis._run_chunk``, reckoned once a run),
and runs whole otherwise.

A system of 24 frames × 13 atoms, loaded by both packages from the same
float32 arrays, with the budget set through
``TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB`` to what a chunk of 4 atoms
reckons, so that a default run takes four chunks. Both packages run on
the CPU (the port with ``device="cpu"``). Bounds: the particle means
within 1e-12 of the maximum (the chunks sum them in another order); the
per-particle values within 1e-14 (the inverse transform packs particle q
with particle q + ⌈P/2⌉ of its batch, so a chunk rounds them in other
pairs: a few ulps).
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu.core.topology import Topology as JTopology  # noqa: E402
from transport_analysis_tpu.core.trajectory import MemoryReader as JMemoryReader  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import convert, parallel  # noqa: E402
from transport_analysis_tpu_torch.ops import acf  # noqa: E402

TOL = 1e-12
PARTICLE_TOL = 1e-14
N_FRAMES, N_ATOMS, D = 24, 13, 3
CHUNK = 4
BOX = [20.0, 20.0, 20.0, 90.0, 90.0, 90.0]
GB = 1e9

MODELS = {
    "vacf": (lambda pkg, u, **kw: pkg.VelocityAutocorr(u.atoms, **kw),
             "vacf_by_particle"),
    "helfand": (lambda pkg, u, **kw: pkg.ViscosityHelfand(
        u.atoms, linear_fit_window=(2, 8), **kw), "visc_by_particle"),
    "msd": (lambda pkg, u, **kw: pkg.EinsteinMSD(u, **kw),
            "msds_by_particle"),
}
# float32 arrays each model's feed gathers, chunk by chunk
FEED_ARRAYS = {"vacf": 1, "helfand": 2, "msd": 1}


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def system():
    """(JAX universe, port universe) of the same float32 arrays."""
    rng = np.random.RandomState(11)
    shape = (N_FRAMES, N_ATOMS, D)
    pos = rng.uniform(0, 20, shape).astype(np.float32)
    vel = rng.normal(0, 8, shape).astype(np.float32)
    masses = np.linspace(1.0, 16.0, N_ATOMS)
    ju = jta.Universe(JTopology(N_ATOMS), JMemoryReader(
        pos, velocities=vel, dimensions=BOX))
    ju.add_TopologyAttr("masses", masses)
    pu = convert.universe_from_arrays(N_ATOMS, {"masses": masses}, pos,
                                      velocities=vel, dimensions=BOX)
    return ju, pu


def budget_of(chunk, dtype=np.float64) -> float:
    """The budget, in GB, whose auto_atom_chunk at the system's shape is
    ``chunk``."""
    return acf.chunk_peak_bytes(N_FRAMES, chunk, D, dtype) / GB


@pytest.fixture
def tight(monkeypatch):
    """A budget that cuts the system into chunks of CHUNK atoms."""
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, repr(budget_of(CHUNK)))
    assert acf.auto_atom_chunk(N_FRAMES, D, device="cpu") == CHUNK
    return monkeypatch


def whole(system, model, **kwargs):
    """The port's run with the budget of the CPU, which takes the
    system whole."""
    assert os.environ.get(acf.HBM_BUDGET_ENV) is None
    make, _ = MODELS[model]
    return make(ta, system[1], device="cpu", **kwargs).run()


@pytest.mark.parametrize("model", list(MODELS))
def test_default_run_streams_chunks_past_the_budget(system, model, tight):
    """Default arguments past the budget: ⌈P / chunk⌉ chunks, each
    chunk's feed gathered once and its results merged once (Helfand's
    divided once more), the results the whole run's and the JAX
    package's."""
    make, key = MODELS[model]
    got = make(ta, system[1], device="cpu").run()
    counts = got.timing.counts()
    assert counts["chunks"] == math.ceil(N_ATOMS / CHUNK) >= 3
    feed = FEED_ARRAYS[model] * N_FRAMES * N_ATOMS * D * 4
    assert counts["chunk_gather_bytes"] == feed
    result = N_FRAMES * N_ATOMS * 8
    assert counts["chunk_merge_bytes"] == result * (
        2 if model == "helfand" else 1)
    tight.delenv(acf.HBM_BUDGET_ENV)
    ref = whole(system, model)
    assert ref.timing.counts()["chunks"] == 0
    assert got.results[key].shape == ref.results[key].shape
    assert got.results[key].dtype == np.float64
    assert rel(got.results[key], ref.results[key]) <= PARTICLE_TOL
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    jax_run = make(jta, system[0]).run()
    assert rel(got.results[key], jax_run.results[key]) <= TOL
    assert rel(got.results.timeseries, jax_run.results.timeseries) <= TOL
    if model == "helfand":
        assert abs(got.results.viscosity - ref.results.viscosity) <= \
            1e-10 * abs(ref.results.viscosity)


@pytest.mark.parametrize("model", list(MODELS))
def test_whole_run_within_the_budget_is_unchanged(system, model):
    """Within the budget nothing is chunked, gathered or merged."""
    counts = whole(system, model).timing.counts()
    assert counts["chunks"] == counts["chunk_gather_bytes"] == \
        counts["chunk_merge_bytes"] == 0


@pytest.mark.parametrize("model", list(MODELS))
def test_explicit_atom_chunk_keeps_its_chunks(system, model, tight,
                                              tmp_path):
    """An explicit ``atom_chunk`` is taken as given, with its checkpoint;
    the run's own chunks write none."""
    make, key = MODELS[model]
    ckpt = str(tmp_path / "given.npz")
    given = make(ta, system[1], device="cpu", atom_chunk=5,
                 checkpoint=ckpt).run()
    assert given.timing.counts()["chunks"] == 3
    with np.load(ckpt) as z:
        assert int(z["chunk_particles"]) == 5
    unused = str(tmp_path / "auto.npz")
    auto = make(ta, system[1], device="cpu", checkpoint=unused).run()
    assert auto.timing.counts()["chunks"] == math.ceil(N_ATOMS / CHUNK)
    assert not os.path.exists(unused)
    assert rel(auto.results[key], given.results[key]) <= PARTICLE_TOL


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("atom_chunk", [None, 5])
def test_the_plan_is_decided_once_a_run(system, model, atom_chunk, tight):
    """The run plan (``ParticleAnalysis._run_chunk``) is reckoned once a
    run, in ``_prepare``, and the run keeps to it: the budget's chunks,
    or the chunks given."""
    make, _ = MODELS[model]
    cls = type(make(ta, system[1], device="cpu"))
    calls = []
    real = cls._run_chunk

    def counted(self):
        calls.append(self)
        return real(self)

    tight.setattr(cls, "_run_chunk", counted)
    for _ in range(2):
        got = make(ta, system[1], device="cpu", atom_chunk=atom_chunk).run()
        assert calls == [got]
        assert got.timing.counts()["chunks"] == math.ceil(
            N_ATOMS / (atom_chunk or CHUNK))
        calls.clear()


@pytest.mark.parametrize("model", list(MODELS))
def test_mesh_keeps_its_shards(system, model, tight):
    """Under a mesh the particle axis is sharded, not chunked."""
    make, key = MODELS[model]
    with parallel.use_mesh(parallel.analysis_mesh(["cpu"] * 2)):
        got = make(ta, system[1], device="cpu").run()
    assert got.timing.counts()["chunks"] == 0
    tight.delenv(acf.HBM_BUDGET_ENV)
    assert rel(got.results[key], whole(system, model).results[key]) <= TOL


@pytest.mark.parametrize("model", list(MODELS))
def test_windowed_path_is_never_chunked(system, model, monkeypatch):
    """The windowed path reckons nothing: not even a budget below one
    atom's FFT chunk cuts it."""
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, repr(budget_of(1) / 2))
    make, key = MODELS[model]
    got = make(ta, system[1], device="cpu", fft=False, max_lag=9).run()
    assert got.timing.counts()["chunks"] == 0
    monkeypatch.delenv(acf.HBM_BUDGET_ENV)
    ref = whole(system, model, fft=False, max_lag=9)
    assert np.array_equal(got.results[key], ref.results[key])


@pytest.mark.parametrize("model", list(MODELS))
def test_float32_work_mode_reckons_its_own_bytes(system, model,
                                                 monkeypatch):
    """The float32 work mode reckons float32 bytes: a budget that the
    whole float64 run is past and the whole float32 run fits leaves the
    float32 run whole; below that it takes float32-sized chunks, whose
    results are float64 accumulators."""
    make, key = MODELS[model]
    f64 = acf.chunk_peak_bytes(N_FRAMES, N_ATOMS, D, np.float64) / GB
    f32 = acf.chunk_peak_bytes(N_FRAMES, N_ATOMS, D, np.float32) / GB
    assert f32 < f64
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, repr((f32 + f64) / 2))
    fits = make(ta, system[1], device="cpu", dtype=np.float32).run()
    assert fits.timing.counts()["chunks"] == 0
    assert fits.results[key].dtype == np.float32
    assert make(ta, system[1], device="cpu").run().timing.counts()[
        "chunks"] > 0
    monkeypatch.setenv(acf.HBM_BUDGET_ENV,
                       repr(budget_of(CHUNK, np.float32)))
    chunk = acf.auto_atom_chunk(N_FRAMES, D, dtype=np.float32, device="cpu")
    assert chunk == CHUNK
    got = make(ta, system[1], device="cpu", dtype=np.float32).run()
    assert got.timing.counts()["chunks"] == math.ceil(N_ATOMS / chunk)
    assert got.results[key].dtype == np.float64
    # float32 sums of other particle pairs: float32 rounding
    assert rel(got.results[key], fits.results[key]) <= 1e-5


# the benchmark's cells: (frames, atoms of the largest analysis) and
# whether a whole FFT run of that shape fits 0.8 × 80 GB
CELL_SHAPES = {
    "ec_solvent.fft_blocks": (8192, 3680, True),        # 4.2 GB
    "dhfr_jac.fft_full": (16384, 23558, True),          # 54.0 GB
    "ec_solvent.windowed_lag8k": (65536, 3680, True),   # 33.8 GB
    "factor_ix.fft_chunked": (8192, 90906, False),      # 104.3 GB
}


@pytest.mark.parametrize("cell", list(CELL_SHAPES))
def test_the_cells_reckon_against_the_card(cell):
    """The three earlier cells run whole on one 80 GB card, FactorIX's
    90,906 atoms at 8,192 frames do not: two chunks under the budget of
    the H100's 85.0 GB total (0.8 of it, 68.4 GB)."""
    n, p, fits = CELL_SHAPES[cell]
    peak = acf.chunk_peak_bytes(n, p, 3)
    assert (peak <= acf.CARD_HEADROOM * 80 * GB) == fits
    if not fits:
        assert 100 * GB < peak < 110 * GB
        chunk = acf.auto_atom_chunk(n, 3, hbm_budget_gb=68.4)
        assert math.ceil(p / chunk) == 2
        assert acf.chunk_peak_bytes(n, chunk, 3) <= 68.4 * GB


def test_device_budget_order(monkeypatch):
    """The environment variable, else the CPU's constant budget."""
    monkeypatch.delenv(acf.HBM_BUDGET_ENV, raising=False)
    assert acf.device_budget_gb("cpu") == acf.CPU_BUDGET_GB
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, "2.5")
    assert acf.device_budget_gb("cpu") == 2.5

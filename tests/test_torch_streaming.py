"""The port's streaming layer against the JAX package's: atom chunks
(``parallel.streaming.chunked_per_particle``) with checkpoint/resume, the
frame-blocked feed (``frame_block=``, ``models.base.DeviceSeriesBuffer``)
and ``atom_chunk``/``checkpoint`` in the three models, plus the port's
own device-memory model ``ops.acf.auto_atom_chunk``.

Inputs are drawn from numpy seeds: series of 24 frames × 13 atoms, and
one system of 24 frames × 13 atoms that both packages load from the same
float32 arrays. Both run on the CPU (the port with ``device="cpu"``).
Bound: 1e-12 of the maximum; checkpoints and frame-blocked feeds of the
same bytes are bit-equal where stated.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu.core.topology import Topology as JTopology  # noqa: E402
from transport_analysis_tpu.core.trajectory import MemoryReader as JMemoryReader  # noqa: E402
from transport_analysis_tpu.parallel import streaming as jstreaming  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import convert, ops  # noqa: E402
from transport_analysis_tpu_torch.models import base  # noqa: E402
from transport_analysis_tpu_torch.models.base import DeviceSeriesBuffer  # noqa: E402
from transport_analysis_tpu_torch.ops import acf  # noqa: E402
from transport_analysis_tpu_torch.parallel import streaming  # noqa: E402
from transport_analysis_tpu_torch.utils.errors import NoDataError  # noqa: E402

TOL = 1e-12
N_FRAMES, N_ATOMS = 24, 13
BOX = [20.0, 20.0, 20.0, 90.0, 90.0, 90.0]


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def series():
    return np.random.RandomState(4).normal(size=(N_FRAMES, N_ATOMS, 3))


def arrays(seed=11, n_frames=N_FRAMES, n_atoms=N_ATOMS):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 20, (n_frames, n_atoms, 3)).astype(np.float32)
    vel = rng.normal(0, 8, (n_frames, n_atoms, 3)).astype(np.float32)
    masses = np.linspace(1.0, 16.0, n_atoms)
    return pos, vel, masses


def jax_universe(pos, vel, masses, dims=None):
    u = jta.Universe(JTopology(len(masses)), JMemoryReader(
        pos, velocities=vel, dimensions=BOX if dims is None else dims))
    u.add_TopologyAttr("masses", masses)
    return u


def port_universe(pos, vel, masses, dims=None):
    return convert.universe_from_arrays(
        len(masses), {"masses": masses}, pos, velocities=vel,
        dimensions=BOX if dims is None else dims)


@pytest.fixture(scope="module")
def system():
    """(JAX universe, port universe) of the same float32 arrays."""
    pos, vel, masses = arrays()
    return jax_universe(pos, vel, masses), port_universe(pos, vel, masses)


# --- chunked_per_particle ---------------------------------------------------

def port_acf(x):
    return ops.acf_fft(x)


@pytest.mark.parametrize("chunk", [1, 3, 4, 13, 100])
def test_chunked_per_particle_vs_jax(series, chunk):
    """Odd d·chunk at 1 and 3, a short last chunk at 4, one chunk at 13
    and 100."""
    jts, jbp = jstreaming.chunked_per_particle(jta.ops.acf_fft, series,
                                               chunk)
    ts, bp = streaming.chunked_per_particle(port_acf, series, chunk,
                                            device="cpu")
    assert bp.shape == (N_FRAMES, N_ATOMS) and ts.shape == (N_FRAMES,)
    assert rel(bp, jbp) <= TOL and rel(ts, jts) <= TOL
    full = ops.acf_fft(series, device="cpu").numpy()
    assert rel(bp, full) <= TOL


@pytest.mark.parametrize("chunk", [3, 5])
def test_chunked_capped_kernel_and_no_by_particle(series, chunk):
    """Kernels may return fewer rows than frames (max_lag); without
    ``want_by_particle`` only the mean comes back."""
    def jkernel(x):
        return jta.ops.acf_fft(x)[:7]

    jts, _ = jstreaming.chunked_per_particle(jkernel, series, chunk)
    ts, bp = streaming.chunked_per_particle(
        lambda x: port_acf(x)[:7], series, chunk, want_by_particle=False,
        device="cpu")
    assert bp is None and ts.shape == (7,)
    assert rel(ts, jts) <= TOL


def test_chunked_tensor_series_stays_on_its_device(series):
    seen = []

    def kernel(x):
        seen.append((x.device.type, x.is_contiguous()))
        return port_acf(x)

    ts, _ = streaming.chunked_per_particle(kernel, torch.from_numpy(series),
                                           4)
    assert seen == [("cpu", True)] * 4
    assert rel(ts, ops.acf_fft(series, device="cpu").numpy().mean(1)) <= TOL


class Boom(Exception):
    pass


def crash_after(n_calls, calls, kernel):
    def crashing(x):
        if len(calls) == n_calls:
            raise Boom()
        calls.append(x.shape[1])
        return kernel(x)
    return crashing


def test_checkpoint_crash_and_resume(series, tmp_path):
    ckpt = str(tmp_path / "acc.npz")
    calls = []
    with pytest.raises(Boom):
        streaming.chunked_per_particle(crash_after(2, calls, port_acf),
                                       series, 4, checkpoint=ckpt,
                                       device="cpu")
    assert calls == [4, 4]
    assert not os.path.exists(ckpt + ".tmp")
    with np.load(ckpt) as z:
        assert sorted(z.files) == sorted(
            ["n_frames", "n_particles", "chunk_particles", "next_chunk",
             "acc", "by_particle"])
        assert int(z["next_chunk"]) == 2

    def counting(x):
        calls.append(x.shape[1])
        return port_acf(x)

    ts, bp = streaming.chunked_per_particle(counting, series, 4,
                                            checkpoint=ckpt, device="cpu")
    assert calls == [4, 4, 4, 1]   # only chunks 2 and 3 ran again
    ref_ts, ref_bp = streaming.chunked_per_particle(port_acf, series, 4,
                                                    device="cpu")
    assert np.array_equal(bp, ref_bp) and np.array_equal(ts, ref_ts)


def test_checkpoint_of_another_shape_is_ignored(series, tmp_path):
    ckpt = str(tmp_path / "acc.npz")
    streaming.chunked_per_particle(port_acf, series, 4, checkpoint=ckpt,
                                   device="cpu")
    calls = []
    ts, _ = streaming.chunked_per_particle(
        crash_after(99, calls, port_acf), series, 3, checkpoint=ckpt,
        device="cpu")
    assert calls == [3, 3, 3, 3, 1]
    assert rel(ts, ops.acf_fft(series, device="cpu").numpy().mean(1)) <= TOL


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(series, tmp_path, writer):
    """A checkpoint left by one package's crashed run resumes in the
    other, which runs only the remaining chunks."""
    ckpt = str(tmp_path / f"{writer}.npz")
    calls = []
    if writer == "jax":
        with pytest.raises(Boom):
            jstreaming.chunked_per_particle(
                crash_after(2, calls, jta.ops.acf_fft), series, 4,
                checkpoint=ckpt)
        calls.clear()
        ts, bp = streaming.chunked_per_particle(
            crash_after(99, calls, port_acf), series, 4, checkpoint=ckpt,
            device="cpu")
    else:
        with pytest.raises(Boom):
            streaming.chunked_per_particle(
                crash_after(2, calls, port_acf), series, 4,
                checkpoint=ckpt, device="cpu")
        calls.clear()
        ts, bp = jstreaming.chunked_per_particle(
            crash_after(99, calls, jta.ops.acf_fft), series, 4,
            checkpoint=ckpt)
    assert calls == [4, 1]
    jts, jbp = jstreaming.chunked_per_particle(jta.ops.acf_fft, series, 4)
    assert rel(np.asarray(bp), jbp) <= TOL and rel(ts, jts) <= TOL


# --- the three models -------------------------------------------------------

MODELS = {
    "vacf": (lambda pkg, u, **kw: pkg.VelocityAutocorr(u.atoms, **kw),
             "vacf_by_particle"),
    "helfand": (lambda pkg, u, **kw: pkg.ViscosityHelfand(
        u.atoms, linear_fit_window=(2, 8), **kw), "visc_by_particle"),
    "msd": (lambda pkg, u, **kw: pkg.EinsteinMSD(u, **kw),
            "msds_by_particle"),
}
# the device feeds of a frame-blocked run
FEEDS = {"vacf": ("_velocities",), "helfand": ("_velocities", "_positions"),
         "msd": ("_positions",)}


def run_both(system, model, jax_kwargs, port_kwargs):
    ju, pu = system
    make, key = MODELS[model]
    ref = make(jta, ju, **jax_kwargs).run()
    got = make(ta, pu, device="cpu", **port_kwargs).run()
    return ref, got, key


def agree(ref, got, key):
    assert got.results[key].shape == ref.results[key].shape
    assert rel(got.results[key], ref.results[key]) <= TOL
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    if "viscosity" in ref.results:
        assert abs(got.results.viscosity - ref.results.viscosity) <= \
            1e-10 * abs(ref.results.viscosity)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("max_lag", [None, 9])
def test_atom_chunk_vs_jax(system, model, fft, max_lag):
    kwargs = {"fft": fft, "max_lag": max_lag, "atom_chunk": 4}
    agree(*run_both(system, model, kwargs, kwargs))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("chunk", [1, 3, 13])
def test_atom_chunk_sizes_vs_unchunked(system, model, chunk):
    """Chunked against the port's own unchunked run: odd d·chunk at 1 and
    3, a single chunk at 13."""
    _, pu = system
    make, key = MODELS[model]
    base = make(ta, pu, device="cpu").run()
    got = make(ta, pu, device="cpu", atom_chunk=chunk).run()
    agree(base, got, key)


@pytest.mark.parametrize("model", list(MODELS))
def test_model_checkpoint_vs_jax(system, model, tmp_path):
    """``checkpoint`` with ``atom_chunk``: the run leaves the JAX keys
    behind, a second run resumes from the finished file without running a
    chunk, and both equal the JAX package's."""
    ckpt = str(tmp_path / f"{model}.npz")
    ref, got, key = run_both(system, model, {"atom_chunk": 5},
                             {"atom_chunk": 5, "checkpoint": ckpt})
    agree(ref, got, key)
    with np.load(ckpt) as z:
        assert int(z["next_chunk"]) == 3
        assert int(z["chunk_particles"]) == 5
    _, pu = system
    make, _ = MODELS[model]
    again = make(ta, pu, device="cpu", atom_chunk=5, checkpoint=ckpt).run()
    assert np.array_equal(again.results[key], got.results[key])


@pytest.mark.parametrize("model", list(MODELS))
def test_checkpoint_without_atom_chunk_is_ignored(system, model, tmp_path):
    ckpt = str(tmp_path / "unused.npz")
    ref, got, key = run_both(system, model, {"checkpoint": ckpt},
                             {"checkpoint": ckpt})
    agree(ref, got, key)
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("frame_block", [5, N_FRAMES + 6])
def test_frame_block_vs_jax(system, model, fft, frame_block, monkeypatch):
    """Frame blocks of 5 (a short last block) and one block longer than
    the trajectory against the JAX package's frame-blocked run; the
    port's own batch run of the same bytes is bit-equal. The device
    buffers take the blocks' float32 samples and are released after the
    run."""
    made = []

    class Recorded(DeviceSeriesBuffer):
        def __init__(self, shape, dtype, device):
            super().__init__(shape, dtype, device)
            made.append(self.array().dtype)

    monkeypatch.setattr(base, "DeviceSeriesBuffer", Recorded)
    kwargs = {"fft": fft, "frame_block": frame_block}
    ref, got, key = run_both(system, model, kwargs, kwargs)
    agree(ref, got, key)
    assert np.array_equal(got.times, ref.times)
    assert made == [torch.float32] * len(FEEDS[model])
    assert all(getattr(got, f) is None for f in FEEDS[model])
    assert not got._buffers
    _, pu = system
    batch = MODELS[model][0](ta, pu, device="cpu", fft=fft).run()
    assert np.array_equal(got.results[key], batch.results[key])


@pytest.mark.parametrize("model", list(MODELS))
def test_frame_block_with_atom_chunk_vs_jax(system, model):
    kwargs = {"frame_block": 7, "atom_chunk": 3, "max_lag": 11}
    agree(*run_both(system, model, kwargs, kwargs))


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("frame_block", [0, -3])
def test_frame_block_below_one_raises(system, model, frame_block):
    _, pu = system
    with pytest.raises(ValueError, match="frame_block"):
        MODELS[model][0](ta, pu, device="cpu", frame_block=frame_block)


@pytest.mark.parametrize("frame_block", [None, 5])
def test_helfand_zero_volume_block_raises(frame_block):
    """A zero box volume in frame 12 (the third block of 5) raises
    NoDataError, in the batch feed and in the frame-blocked one."""
    pos, vel, masses = arrays()
    dims = np.tile(np.asarray(BOX), (N_FRAMES, 1))
    dims[12, :3] = 0.0
    pu = port_universe(pos, vel, masses, dims)
    with pytest.raises(NoDataError, match="box volume"):
        ta.ViscosityHelfand(pu.atoms, frame_block=frame_block,
                            device="cpu").run()


def test_frame_block_progress_bar(system, capsys):
    _, pu = system
    v = ta.VelocityAutocorr(pu.atoms, frame_block=5, device="cpu")
    v.run(verbose=True)
    assert "VelocityAutocorr" in capsys.readouterr().err


@pytest.mark.parametrize("dtype,want", [(np.float32, torch.float32),
                                        (np.float64, torch.float64)])
def test_device_series_buffer(dtype, want):
    buf = DeviceSeriesBuffer((7, 2, 3), dtype, torch.device("cpu"))
    blocks = np.arange(42, dtype=dtype).reshape(7, 2, 3)
    buf.write(blocks[:4], 0)
    buf.write(blocks[4:], 4)
    out = buf.array()
    assert out.dtype == want and np.array_equal(out.numpy(), blocks)


# --- auto_atom_chunk --------------------------------------------------------

@pytest.mark.parametrize("n_frames,d,budget", [
    (24, 3, 0.02), (8192, 3, 2.0), (65536, 3, 8.0), (65536, 1, 8.0),
    (2 ** 20, 3, 40.0), (1000, 2, 0.05)])
def test_auto_atom_chunk_fits_and_is_largest(n_frames, d, budget):
    chunk = acf.auto_atom_chunk(n_frames, d=d, hbm_budget_gb=budget)
    assert chunk >= 1
    assert acf.chunk_peak_bytes(n_frames, chunk, d) <= budget * 1e9
    assert acf.chunk_peak_bytes(n_frames, chunk + 1, d) > budget * 1e9


def test_auto_atom_chunk_at_the_deep_shape():
    """An 8 GB budget at 65,536 frames: about 870 atoms, so the 3,680
    atoms of the EC system run in five chunks."""
    chunk = acf.auto_atom_chunk(65536, d=3, hbm_budget_gb=8.0)
    assert 850 <= chunk <= 900 and -(-3680 // chunk) == 5


def test_chunk_peak_bytes_terms():
    """The model's stages at a small shape, by hand: 24 frames, M = 64,
    5 atoms of 3 components (15 series, 8 packed columns); the MSD's
    float32 chunk and float64 copy under both stages."""
    n, m, s, c = 24, 64, 15, 5
    spectra = 2 * 16 * m * 8
    assert acf.chunk_peak_bytes(n, c, 3) == 12 * n * s + max(
        8 * n * s + 8 * n * c, 8 * n * c + spectra) + 32 * m \
        + acf.ALLOCATOR_SLACK


def test_auto_atom_chunk_budget_order(monkeypatch):
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, "2.0")
    from_env = acf.auto_atom_chunk(8192, device="cpu")
    assert from_env == acf.auto_atom_chunk(8192, hbm_budget_gb=2.0)
    assert acf.auto_atom_chunk(8192, hbm_budget_gb=4.0) > from_env
    monkeypatch.delenv(acf.HBM_BUDGET_ENV)
    assert acf.auto_atom_chunk(8192, device="cpu") == acf.auto_atom_chunk(
        8192, hbm_budget_gb=acf.CPU_BUDGET_GB)


def test_auto_atom_chunk_refuses_a_budget_below_one_atom():
    with pytest.raises(ValueError, match="one atom"):
        acf.auto_atom_chunk(2 ** 20, hbm_budget_gb=0.01)


# --- the parallel package ---------------------------------------------------

def test_parallel_streaming_imports_while_mesh_raises():
    from transport_analysis_tpu_torch.parallel import out_of_core
    from transport_analysis_tpu_torch.parallel import streaming as st
    assert st.chunked_per_particle is streaming.chunked_per_particle
    assert callable(out_of_core.correlate_spools)
    assert ta.parallel.streaming is st

"""The port's VelocityAutocorr and ViscosityHelfand against the JAX
package's, on the same systems.

Each system is a JAX-package Universe from tests/conftest.py (the random
10-atom box and the step-trajectory oracles); its arrays and topology
cross to the port through ``convert.universe_from_arrays``, so both
packages analyse the identical system. Bounds: timeseries within 1e-12 of
their maximum; Green–Kubo diffusivities and the fitted viscosity within
1e-10 relative.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import convert  # noqa: E402
from transport_analysis_tpu_torch.core.trajectory import MemoryReader  # noqa: E402
from transport_analysis_tpu_torch.models import base  # noqa: E402
from transport_analysis_tpu_torch.utils.errors import NoDataError  # noqa: E402

TS_TOL = 1e-12
SCALAR_TOL = 1e-10


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def port_universe(u):
    """The JAX-package Universe ``u`` rebuilt in the port from its arrays
    and per-atom topology attributes."""
    traj = u.trajectory
    dims = np.array([np.zeros(6) if ts.dimensions is None
                     else np.array(ts.dimensions, np.float64)
                     for ts in traj])
    top = u._topology
    attrs = {name: top.get_atom_values(name)
             for name in ("names", "resnames", "resids", "masses")
             if top.has(name)}
    return convert.universe_from_arrays(
        top.n_atoms, attrs, traj.get_array("positions"),
        velocities=traj.get_array("velocities"), dimensions=dims,
        dt=traj.dt)


@pytest.fixture(scope="module")
def systems(u_random, step_vtraj, step_vtraj_full):
    """name -> (JAX universe, port universe)."""
    return {name: (u, port_universe(u)) for name, u in
            (("random", u_random), ("step", step_vtraj),
             ("step_full", step_vtraj_full))}


@pytest.fixture
def pu(systems):
    return systems["random"][1]


@pytest.mark.parametrize("system,dim_type", [
    ("random", "xyz"), ("random", "xy"), ("random", "xz"), ("random", "z"),
    ("step", "xyz"), ("step", "yz"),
])
def test_vacf_vs_jax(systems, system, dim_type):
    ju, pu = systems[system]
    ref = jta.VelocityAutocorr(ju.atoms, dim_type=dim_type).run()
    got = ta.VelocityAutocorr(pu.atoms, dim_type=dim_type,
                              device="cpu").run()
    assert got.results.vacf_by_particle.shape == \
        ref.results.vacf_by_particle.shape
    assert rel(got.results.timeseries, ref.results.timeseries) <= TS_TOL
    assert rel(got.results.vacf_by_particle,
               ref.results.vacf_by_particle) <= TS_TOL
    assert np.array_equal(got.times, ref.times)
    for fn in ("self_diffusivity_gk", "self_diffusivity_gk_odd"):
        assert getattr(got, fn)() == pytest.approx(getattr(ref, fn)(),
                                                   rel=SCALAR_TOL)


@pytest.mark.parametrize("system,dim_type,window", [
    ("random", "xyz", (2, 9)), ("random", "xz", (2, 9)),
    ("random", "x", (1, 6)), ("step_full", "xyz", (10, 100)),
    ("step_full", "xy", (10, 100)),
])
def test_viscosity_vs_jax(systems, system, dim_type, window):
    ju, pu = systems[system]
    ref = jta.ViscosityHelfand(ju.atoms, dim_type=dim_type,
                               linear_fit_window=window).run()
    got = ta.ViscosityHelfand(pu.atoms, dim_type=dim_type,
                              linear_fit_window=window, device="cpu").run()
    assert rel(got.results.timeseries, ref.results.timeseries) <= TS_TOL
    assert rel(got.results.visc_by_particle,
               ref.results.visc_by_particle) <= TS_TOL
    assert got.results.timeseries[0] == 0.0
    assert got.results.viscosity == pytest.approx(ref.results.viscosity,
                                                  rel=SCALAR_TOL)


@pytest.mark.parametrize("kwargs", [dict(start=1, step=2),
                                    dict(stop=9), dict(frames=[0, 2, 3, 7])])
def test_frame_selection_vs_jax(systems, kwargs):
    ju, pu = systems["random"]
    ref = jta.VelocityAutocorr(ju.atoms).run(**kwargs)
    got = ta.VelocityAutocorr(pu.atoms, device="cpu").run(**kwargs)
    assert rel(got.results.timeseries, ref.results.timeseries) <= TS_TOL
    ref = jta.ViscosityHelfand(ju.atoms).run(**kwargs)
    got = ta.ViscosityHelfand(pu.atoms, device="cpu").run(**kwargs)
    assert rel(got.results.timeseries, ref.results.timeseries) <= TS_TOL


def test_selection_and_max_lag_vs_jax(systems):
    ju, pu = systems["random"]
    sel = "name O and resname WAT and resid 2-7"
    ref = jta.VelocityAutocorr(ju.select_atoms(sel), max_lag=5).run()
    got = ta.VelocityAutocorr(pu.select_atoms(sel), max_lag=5,
                              device="cpu").run()
    assert got.results.timeseries.shape == (5,)
    assert rel(got.results.timeseries, ref.results.timeseries) <= TS_TOL
    assert got.self_diffusivity_gk() == pytest.approx(
        ref.self_diffusivity_gk(), rel=SCALAR_TOL)


def test_engines_agree(pu):
    batch = ta.ViscosityHelfand(pu.atoms, device="cpu").run()
    frame = ta.ViscosityHelfand(pu.atoms, engine="frame", device="cpu").run()
    assert rel(frame.results.timeseries, batch.results.timeseries) <= TS_TOL
    batch = ta.VelocityAutocorr(pu.atoms, device="cpu").run()
    frame = ta.VelocityAutocorr(pu.atoms, engine="frame", device="cpu").run()
    assert rel(frame.results.timeseries, batch.results.timeseries) <= TS_TOL


def test_save_load_results(pu, tmp_path):
    vh = ta.ViscosityHelfand(pu.atoms, linear_fit_window=(2, 9),
                             device="cpu")
    with pytest.raises(RuntimeError):
        vh.save(tmp_path / "empty.npz")
    vh.run()
    vh.save(tmp_path / "visc.npz")
    results, meta = vh.load_results(tmp_path / "visc.npz")
    assert np.array_equal(results.timeseries, vh.results.timeseries)
    assert results.viscosity == vh.results.viscosity
    assert meta["class"] == "ViscosityHelfand"


def test_plots(pu):
    vacf = ta.VelocityAutocorr(pu.atoms, device="cpu").run()
    (line,) = vacf.plot_vacf()
    assert np.array_equal(line.get_ydata(), vacf.results.timeseries)
    (line,) = vacf.plot_running_integral()
    assert line.get_ydata()[-1] == pytest.approx(vacf.self_diffusivity_gk())
    vh = ta.ViscosityHelfand(pu.atoms, linear_fit_window=(2, 9),
                             device="cpu").run()
    vh.plot_viscosity_function()


# --- error contracts ----------------------------------------------------


def _positions_only():
    u = ta.Universe.empty(2, n_frames=4)
    u.add_TopologyAttr("masses", [1.0, 2.0])
    return u


@pytest.mark.parametrize("model", [ta.VelocityAutocorr, ta.ViscosityHelfand])
@pytest.mark.parametrize("engine", [None, "frame"])
def test_no_velocities(model, engine):
    u = _positions_only()
    with pytest.raises(NoDataError):
        model(u.atoms, engine=engine, device="cpu").run()


def test_no_volume(pu):
    u = convert.universe_from_arrays(
        2, {"masses": [1.0, 1.0]}, np.ones((3, 2, 3)),
        velocities=np.ones((3, 2, 3)))
    with pytest.raises(NoDataError):
        ta.ViscosityHelfand(u.atoms, device="cpu").run()


@pytest.mark.parametrize("model", [ta.VelocityAutocorr, ta.ViscosityHelfand])
def test_updating_atomgroup_rejected(pu, model):
    ag = pu.select_atoms("resid 1-5", updating=True)
    with pytest.raises(TypeError):
        model(ag, device="cpu")


@pytest.mark.parametrize("model", [ta.VelocityAutocorr, ta.ViscosityHelfand])
@pytest.mark.parametrize("dim_type", ["xyzt", "a", ""])
def test_bad_dim_type(pu, model, dim_type):
    with pytest.raises(ValueError, match="invalid dim_type"):
        model(pu.atoms, dim_type=dim_type, device="cpu")


@pytest.mark.parametrize("fn", ["self_diffusivity_gk",
                                "self_diffusivity_gk_odd", "plot_vacf",
                                "plot_running_integral"])
def test_use_before_run(pu, fn):
    with pytest.raises(RuntimeError, match="must be run prior"):
        getattr(ta.VelocityAutocorr(pu.atoms, device="cpu"), fn)()


GOLDEN_TRR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden", "golden.trr")


@pytest.mark.parametrize("call,n_atoms,n_frames", [
    (lambda: ta.Universe(ta.data.files.ec_top,
                         ta.data.files.ec_traj_trr).trajectory, 3680, 100),
    (lambda: ta.Universe.empty(5).load_new(GOLDEN_TRR).trajectory, 5, 3),
    (lambda: ta.io.open_trajectory(GOLDEN_TRR), 5, 3),
    (lambda: ta.io.open_trajectory(ta.data.files.ec_traj_trr), 3680, 100),
], ids=["Universe(file)", "load_new(file)", "io.open_trajectory",
        "data.files"])
def test_file_entry_points_work(call, n_atoms, n_frames):
    """The file entry points that raised before io/ and data/ were ported
    open the golden TRR and the EC files."""
    traj = call()
    assert (traj.n_atoms, traj.n_frames) == (n_atoms, n_frames)
    assert traj.ts.has_velocities


def test_not_ported_packages_keep_introspection():
    for pkg in (ta.parallel,):
        assert not hasattr(pkg, "__wrapped__")


# --- the float32 feed in every engine --------------------------------------

ENGINE_MODELS = {
    "vacf": (lambda u, **kw: ta.VelocityAutocorr(u.atoms, **kw),
             "vacf_by_particle", ("_velocities",)),
    "helfand": (lambda u, **kw: ta.ViscosityHelfand(
        u.atoms, linear_fit_window=(2, 8), **kw),
        "visc_by_particle", ("_velocities", "_positions")),
    "msd": (lambda u, **kw: ta.EinsteinMSD(u, **kw), "msds_by_particle",
            ("_positions",)),
}


@pytest.mark.parametrize("model", list(ENGINE_MODELS))
def test_frame_engine_feeds_float32_bit_equal_to_batch(pu, model):
    """The per-frame engine feeds the reader's float32 samples, as the
    batch engine does, and its results are bit-equal to the batch
    engine's."""
    make, key, feeds = ENGINE_MODELS[model]
    batch = make(pu, device="cpu").run()
    frame = make(pu, engine="frame", device="cpu").run()
    for feed in feeds:
        assert getattr(frame, feed).dtype == np.float32
        assert np.array_equal(getattr(frame, feed), getattr(batch, feed))
    assert np.array_equal(frame.results[key], batch.results[key])
    assert np.array_equal(frame.results.timeseries,
                          batch.results.timeseries)
    if model == "helfand":
        assert frame.results.viscosity == batch.results.viscosity


# --- state carried across --------------------------------------------------


def test_universe_from_arrays(systems):
    ju, pu = systems["random"]
    assert pu._topology.n_residues == 10
    for sel in ("resid 3-5", "name O and resname WAT", "resid 1 or resid 10"):
        assert np.array_equal(pu.select_atoms(sel).indices,
                              ju.select_atoms(sel).indices)
    assert np.array_equal(pu.atoms.masses, ju.atoms.masses)
    assert pu.trajectory.n_frames == ju.trajectory.n_frames


def test_select_series_layouts():
    """select_series gives C-contiguous selections equal to fancy
    indexing, for evenly spaced and irregular atom sets and every
    dim_type's components."""
    block = np.arange(5 * 7 * 3, dtype=np.float32).reshape(5, 7, 3)
    for idx in ([0, 1, 2, 3, 4, 5, 6], [2, 4, 6], [5, 1, 2], [3]):
        for dim in ([0, 1, 2], [0, 2], [1, 2], [1]):
            got = base.select_series(block, idx, dim)
            assert got.flags.c_contiguous
            assert np.array_equal(got, block[:, idx][:, :, dim])


def test_box_volumes_match_per_frame_formula():
    """The port's vectorised volumes against the JAX package's per-frame
    ``box_volume``, including a missing box and a degenerate cell."""
    from transport_analysis_tpu.core.timestep import box_volume as jax_volume
    from transport_analysis_tpu_torch.core.timestep import (
        box_volume, box_volumes)

    rng = np.random.RandomState(4)
    dims = np.column_stack([rng.uniform(5, 50, (40, 3)),
                            rng.uniform(50, 130, (40, 3))])
    dims[3, :3] = [0.0, 10.0, 10.0]          # no box
    dims[5, 3:] = [180.0, 180.0, 180.0]      # degenerate cell
    dims[7] = [41.432, 41.432, 41.432, 90.0, 90.0, 90.0]
    ref = np.array([jax_volume(row) for row in dims])
    got = box_volumes(dims)
    assert got[3] == 0.0 and got[5] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)
    assert box_volume(None) == 0.0 and jax_volume(None) == 0.0
    np.testing.assert_allclose(box_volume(dims[7]), 41.432 ** 3,
                               rtol=1e-14)


def test_memory_reader_batch_views():
    pos = np.random.RandomState(0).normal(size=(6, 2, 3))
    reader = MemoryReader(pos, velocities=pos * 2)
    batch = reader.read_frames_batch(range(0, 6, 2))
    assert np.shares_memory(batch["velocities"], reader.get_array(
        "velocities"))
    assert np.array_equal(batch["positions"],
                          pos.astype(np.float32)[::2])
    batch = reader.read_frames_batch([4, 1])
    assert np.array_equal(batch["positions"], pos.astype(np.float32)[[4, 1]])

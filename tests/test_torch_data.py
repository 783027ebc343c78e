"""The port's data/ against transport_analysis_tpu.data: the generated
ethylene-carbonate (EC) files and the regression analyses on them.

Both packages generate the EC topology and trajectory from the same seed
and recipe, so their files are byte-equal. The port's analyses, on the CPU
(``device="cpu"``), on ``Universe(ec_top, ec_traj_trr)`` of the port
agree with the JAX package's on its own files within 1e-11 of the
maximum, and meet the regression values the JAX package pins
(tests/test_data.py).
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu.data import generate as jgenerate  # noqa: E402
from transport_analysis_tpu_torch.data import files, generate  # noqa: E402

TOL = 1e-11
FIT_WINDOW = (10, 40)


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def u_ec():
    return ta.Universe(files.ec_top, files.ec_traj_trr)


@pytest.fixture(scope="module")
def ju_ec(tmp_path_factory):
    """The JAX package's Universe on EC files its own generator writes
    (into a directory of this module, not the JAX package's data
    directory, which its generator fills without a temporary name)."""
    top, trr = jgenerate.ensure_generated(str(tmp_path_factory.mktemp("ec")))
    return jta.Universe(top, trr)


def test_logo_file():
    with open(files.LOGO) as fh:
        assert "transport" in fh.read()
    assert files.MDANALYSIS_LOGO == files.LOGO
    with pytest.raises(AttributeError):
        files.ec_traj_xtc


def test_packaged_files_in_the_port():
    """ec_top / ec_traj_trr live in the port's own data directory."""
    here = os.path.dirname(os.path.abspath(files.__file__))
    for path in (files.ec_top, files.ec_traj_trr):
        assert os.path.dirname(path) == os.path.join(here,
                                                     "ethylene_carbonate")
        assert os.path.getsize(path) > 0


@pytest.mark.parametrize("name", ["topology.pdb", "trajectory.trr"])
def test_generated_files_byte_equal(name, tmp_path):
    port = generate.ensure_generated(str(tmp_path / "port"))
    ref = jgenerate.ensure_generated(str(tmp_path / "jax"))
    i = ["topology.pdb", "trajectory.trr"].index(name)
    with open(port[i], "rb") as a, open(ref[i], "rb") as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(tmp_path / "port")) == ["topology.pdb",
                                                     "trajectory.trr"]


def test_concurrent_generation_leaves_whole_files(tmp_path):
    """Writers racing on one directory each write their own temporary
    file and move it into place: the result is the whole file, and no
    temporary is left behind."""
    out = tmp_path / "race"
    errors = []

    def gen():
        try:
            generate.ensure_generated(str(out))
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=gen) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert sorted(os.listdir(out)) == ["topology.pdb", "trajectory.trr"]
    ref = jgenerate.ensure_generated(str(tmp_path / "jax"))
    with open(out / "trajectory.trr", "rb") as a, open(ref[1], "rb") as b:
        assert a.read() == b.read()


def test_ec_universe_shape(u_ec, ju_ec):
    assert len(u_ec.atoms) == 3680
    assert u_ec.trajectory.n_frames == 100
    assert u_ec.trajectory.has_velocities
    np.testing.assert_allclose(u_ec.trajectory.ts.volume, 71122.607,
                               rtol=1e-5)
    np.testing.assert_array_equal(u_ec.atoms.masses, ju_ec.atoms.masses)
    for sel in ("name O1 O2 O3", "resid 1-10", "resname ECA"):
        assert np.array_equal(u_ec.select_atoms(sel).indices,
                              ju_ec.select_atoms(sel).indices)
    # the generator writes the residue name one column early (PDB's
    # altLoc column), so both packages read "CA A" and "resname ECA"
    # matches nothing; the port keeps the bytes of the JAX package's files
    assert set(u_ec.atoms.resnames) == {"CA A"}


@pytest.mark.parametrize("fft", [True, False])
def test_ec_viscosity_vs_jax(u_ec, ju_ec, fft):
    got = ta.ViscosityHelfand(u_ec.atoms, linear_fit_window=FIT_WINDOW,
                              fft=fft, device="cpu").run()
    ref = jta.ViscosityHelfand(ju_ec.atoms, linear_fit_window=FIT_WINDOW,
                               fft=fft).run()
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.visc_by_particle,
               ref.results.visc_by_particle) <= TOL
    assert got.results.viscosity == pytest.approx(ref.results.viscosity,
                                                  rel=TOL)


@pytest.mark.parametrize("fft", [True, False])
def test_ec_vacf_vs_jax(u_ec, ju_ec, fft):
    got = ta.VelocityAutocorr(u_ec.atoms, fft=fft, device="cpu").run()
    ref = jta.VelocityAutocorr(ju_ec.atoms, fft=fft).run()
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.vacf_by_particle,
               ref.results.vacf_by_particle) <= TOL
    assert got.self_diffusivity_gk() == pytest.approx(
        ref.self_diffusivity_gk(), rel=TOL)


@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("select", ["all", "name O1 O2 O3"])
def test_ec_msd_vs_jax(u_ec, ju_ec, fft, select):
    got = ta.EinsteinMSD(u_ec, select=select, fft=fft, device="cpu").run()
    ref = jta.EinsteinMSD(ju_ec, select=select, fft=fft).run()
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.msds_by_particle,
               ref.results.msds_by_particle) <= TOL


def test_ec_viscosity_regression(u_ec):
    """The JAX package's pinned Helfand viscosity of the generated EC
    system (tests/test_data.py)."""
    vh = ta.ViscosityHelfand(u_ec.atoms, linear_fit_window=FIT_WINDOW,
                             device="cpu").run()
    assert np.allclose(0.00098984, vh.results.viscosity, atol=5e-5)


def test_ec_vacf_regression(u_ec):
    """VACF lag 0: the mean kinetic |v|² of the 300 K ensemble."""
    v = ta.VelocityAutocorr(u_ec.atoms, device="cpu").run()
    np.testing.assert_allclose(v.results.timeseries[0], 328.965, rtol=1e-4)
    masses = u_ec.atoms.masses
    expected = 3 * 100 * 0.008314462159 * 300 * np.mean(1.0 / masses)
    assert abs(v.results.timeseries[0] - expected) / expected < 0.05


def test_ec_file_backed_equals_in_memory(u_ec):
    """The TRR-backed run equals, bit for bit, the run on a MemoryReader
    that holds the reader's own decoded arrays."""
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader

    batch = u_ec.trajectory.read_frames_batch(range(100))
    mem = ta.Universe(u_ec._topology, MemoryReader(
        batch["positions"], velocities=batch["velocities"],
        dimensions=u_ec.trajectory.ts.dimensions, dt=1.0))
    for model in (ta.VelocityAutocorr, ta.ViscosityHelfand):
        got = model(u_ec.atoms, device="cpu").run().results.timeseries
        want = model(mem.atoms, device="cpu").run().results.timeseries
        assert np.array_equal(got, want)

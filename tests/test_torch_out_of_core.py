"""The port's out-of-core spool pipeline (``parallel.out_of_core``)
against the JAX package's, on the same TRR file.

The TRR (24 frames × 10 atoms, drawn from a numpy seed, as in the JAX
package's tests/test_out_of_core.py) is read by both packages' readers,
which return the same float32 bits. Bounds: timeseries within 1e-12 of
the JAX package's; spool files byte-equal, and each package reuses the
other's complete spools. The Helfand spools hold m·v·x rounded to float32
in both packages, so ``helfand_out_of_core`` is held to the JAX package's
at 1e-12, to a host oracle of its own float32 spools at 1e-11, and to the
in-memory ``ViscosityHelfand`` only at the float32 grade (2e-5, the JAX
package's own bound).
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu.core.topology import Topology as JTopology  # noqa: E402
from transport_analysis_tpu.io.trr import TRRReader as JTRRReader  # noqa: E402
from transport_analysis_tpu.parallel import out_of_core as jooc  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch.core.topology import Topology  # noqa: E402
from transport_analysis_tpu_torch.io.trr import TRRReader, TRRWriter  # noqa: E402
from transport_analysis_tpu_torch.ops.acf import acf_fft_numpy  # noqa: E402
from transport_analysis_tpu_torch.parallel import out_of_core as ooc  # noqa: E402
from transport_analysis_tpu_torch.utils.errors import NoDataError  # noqa: E402
from transport_analysis_tpu_torch.utils.units import constants  # noqa: E402

TOL = 1e-12
N_FRAMES, N_ATOMS = 24, 10
MASSES = np.linspace(1.0, 16.0, N_ATOMS)


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def write_trr(path, zero_box_frame=None):
    rng = np.random.RandomState(9)
    vel = rng.normal(0, 8, (N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    pos = rng.uniform(0, 20, (N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    with TRRWriter(path, N_ATOMS) as w:
        for i in range(N_FRAMES):
            box = [0.0] * 3 if i == zero_box_frame else [20.0] * 3
            w.write(positions=pos[i], velocities=vel[i],
                    dimensions=box + [90.0] * 3, time=float(i))


@pytest.fixture()
def trr(tmp_path):
    """(JAX universe, port universe) on one TRR file, with masses."""
    path = str(tmp_path / "t.trr")
    write_trr(path)
    ju = jta.Universe(JTopology(N_ATOMS), JTRRReader(path))
    pu = ta.Universe(Topology(N_ATOMS), TRRReader(path))
    for u in (ju, pu):
        u.add_TopologyAttr("masses", MASSES)
    return ju, pu


def helfand_ts(result):
    return result[0]


RUNS = {  # name -> (function, JAX function, output -> timeseries)
    "vacf": (ooc.vacf_out_of_core, jooc.vacf_out_of_core, np.asarray),
    "helfand": (ooc.helfand_out_of_core, jooc.helfand_out_of_core,
                helfand_ts),
    "msd": (ooc.msd_out_of_core, jooc.msd_out_of_core, np.asarray),
}
SLICES = {"all": {}, "strided_capped": {"start": 2, "stop": 20, "step": 2,
                                        "max_lag": 5}}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("frames", list(SLICES))
def test_out_of_core_vs_jax(trr, tmp_path, run, frames):
    ju, pu = trr
    fn, jfn, ts_of = RUNS[run]
    kwargs = SLICES[frames]
    want = ts_of(jfn(ju, str(tmp_path / "j"), atom_chunk=3, **kwargs))
    got = ts_of(fn(pu, str(tmp_path / "p"), atom_chunk=3, device="cpu",
                   **kwargs))
    assert got.shape == want.shape == (kwargs.get("max_lag", N_FRAMES // (
        kwargs.get("step", 1))),)
    assert rel(got, want) <= TOL


def test_out_of_core_vs_in_memory(trr, tmp_path):
    """VACF and MSD equal the in-memory analyses of the same file at
    1e-12; the Helfand function only at the float32 grade of its spool,
    and its slope at 1e-3, the JAX package's own bounds."""
    _, pu = trr
    vacf = ooc.vacf_out_of_core(pu, str(tmp_path / "v"), atom_chunk=4,
                                device="cpu")
    assert rel(vacf, ta.VelocityAutocorr(pu.atoms, device="cpu").run()
               .results.timeseries) <= TOL
    msd = ooc.msd_out_of_core(pu, str(tmp_path / "m"), atom_chunk=4,
                              device="cpu")
    assert rel(msd, ta.EinsteinMSD(pu, device="cpu").run()
               .results.timeseries) <= TOL
    ts, visc = ooc.helfand_out_of_core(
        pu, str(tmp_path / "h"), atom_chunk=3, linear_fit_window=(2, 10),
        device="cpu")
    ref = ta.ViscosityHelfand(pu.atoms, linear_fit_window=(2, 10),
                              device="cpu").run()
    np.testing.assert_allclose(ts, ref.results.timeseries, rtol=2e-5,
                               atol=1e-12)
    assert visc == pytest.approx(ref.results.viscosity, rel=1e-3)


def test_helfand_out_of_core_vs_oracle_of_its_spools(trr, tmp_path):
    """The Helfand function from the float32 m·v·x spools against a host
    float64 oracle of those same float32 values: 1e-11."""
    _, pu = trr
    spool = str(tmp_path / "h")
    ts, _ = ooc.helfand_out_of_core(pu, spool, atom_chunk=4, device="cpu")
    mvx = np.concatenate([np.load(os.path.join(spool, f"mvx_chunk{c:05d}"
                                               ".f32"))
                          for c in range(3)], axis=1).astype(np.float64)
    assert mvx.dtype == np.float64 and mvx.shape == (N_FRAMES, N_ATOMS, 3)
    a = mvx - mvx.mean(axis=0)
    n = N_FRAMES
    corr = acf_fft_numpy(a) * (n - np.arange(n))[:, None]
    sq = (a * a).sum(-1)
    lags = np.arange(n)
    css = np.cumsum(sq, axis=0)
    prev = np.concatenate([np.zeros((1, N_ATOMS)), css[:-1]])
    w = css[n - 1 - lags] + css[-1][None] - prev
    by_particle = (w - 2.0 * corr) / ((n - lags) * 3)[:, None]
    by_particle[0] = 0.0
    vol = float(np.mean(ooc.load_aux(spool, "mvx")["volumes"]))
    oracle = by_particle.mean(axis=1) / (
        2.0 * constants["Boltzmann_constant"] * vol * 300.0)
    assert rel(ts, oracle) <= 1e-11


@pytest.mark.parametrize("field", ["velocities", "positions", "mvx"])
def test_spools_byte_equal_to_jax(trr, tmp_path, field):
    ju, pu = trr
    paths = {}
    for pkg, u, mod in (("j", ju, jooc), ("p", pu, ooc)):
        spool = str(tmp_path / pkg)
        if field == "mvx":
            kwargs = {"device": "cpu"} if pkg == "p" else {}
            mod.helfand_out_of_core(u, spool, atom_chunk=4, **kwargs)
        else:
            mod.build_spools(u.trajectory, np.arange(N_FRAMES),
                             u.atoms.indices, [0, 1, 2], spool, 4,
                             field=field)
        paths[pkg] = sorted(os.listdir(spool))
    assert paths["j"] == paths["p"]
    assert f"{field}.complete" in paths["p"]
    assert len([p for p in paths["p"] if p.endswith(".f32")]) == 3
    for name in paths["p"]:
        if name.endswith(".npz"):
            for key, want in jooc.load_aux(str(tmp_path / "j"),
                                           field).items():
                got = ooc.load_aux(str(tmp_path / "p"), field)[key]
                assert np.array_equal(got, want)
        else:
            assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "p" / name,
                               shallow=False), name


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_complete_spools_are_reused_across_packages(trr, tmp_path, maker):
    """Spools marked complete by one package are read, not rebuilt, by
    the other, and give the same VACF."""
    ju, pu = trr
    spool = str(tmp_path / "s")
    first, second = ((jooc, ju), (ooc, pu))[:: 1 if maker == "jax" else -1]
    paths = first[0].build_spools(first[1].trajectory, np.arange(N_FRAMES),
                                  first[1].atoms.indices, [0, 1, 2], spool,
                                  4)
    mtimes = [os.path.getmtime(p) for p in paths]
    again = second[0].build_spools(second[1].trajectory, np.arange(N_FRAMES),
                                   second[1].atoms.indices, [0, 1, 2], spool,
                                   4)
    assert again == paths
    assert [os.path.getmtime(p) for p in paths] == mtimes
    got = ooc.vacf_out_of_core(pu, spool, atom_chunk=4, device="cpu")
    want = jooc.vacf_out_of_core(ju, spool, atom_chunk=4)
    assert rel(got, want) <= TOL


class Boom(Exception):
    pass


def test_correlate_spools_checkpoint_and_stats(trr, tmp_path):
    """A crash after two spools resumes from the checkpoint (only the
    rest run); the stats hold a read, a stall and a kernel wall per
    spool; with and without the reader thread the result is the same."""
    _, pu = trr
    spool = str(tmp_path / "s")
    paths = ooc.build_spools(pu.trajectory, np.arange(N_FRAMES),
                             pu.atoms.indices, [0, 1, 2], spool, 3)
    assert len(paths) == 4
    calls = []

    def kernel(block):
        if len(calls) == 2 and crash:
            raise Boom()
        calls.append(block.shape[1])
        return ta.ops.acf_fft_from_f32(ooc.device_f32(block, "cpu")).sum(1)

    ckpt = str(tmp_path / "c.npz")
    crash = True
    with pytest.raises(Boom):
        ooc.correlate_spools(kernel, paths, N_ATOMS, checkpoint=ckpt)
    crash = False
    stats = {}
    got = ooc.correlate_spools(kernel, paths, N_ATOMS, checkpoint=ckpt,
                               stats=stats)
    assert calls == [3, 3, 3, 1]
    with np.load(ckpt) as z:
        assert sorted(z.files) == ["acc", "n_particles", "next_spool"]
        assert int(z["next_spool"]) == 4
    assert [len(stats[k]) for k in ("read_s", "stall_s", "kernel_s")] == \
        [2, 2, 2]
    whole = ooc.correlate_spools(kernel, paths, N_ATOMS, prefetch=False)
    threaded = ooc.correlate_spools(kernel, paths, N_ATOMS)
    assert np.array_equal(whole, threaded)
    assert rel(got, whole) <= TOL
    jwhole = jooc.correlate_spools(
        lambda b: jta.ops.acf_fft(b.astype(np.float64)).sum(axis=1),
        paths, N_ATOMS)
    assert rel(whole, jwhole) <= TOL


def test_auto_chunk_on_the_cpu(trr, tmp_path):
    _, pu = trr
    got = ooc.vacf_out_of_core(pu, str(tmp_path / "a"), device="cpu")
    assert len(os.listdir(tmp_path / "a")) == 2   # one spool and its marker
    want = ooc.vacf_out_of_core(pu, str(tmp_path / "b"), atom_chunk=4,
                                device="cpu")
    assert rel(got, want) <= TOL


def test_helfand_out_of_core_zero_volume_raises(tmp_path):
    path = str(tmp_path / "z.trr")
    write_trr(path, zero_box_frame=7)
    pu = ta.Universe(Topology(N_ATOMS), TRRReader(path))
    pu.add_TopologyAttr("masses", MASSES)
    with pytest.raises(NoDataError, match="nonzero box volume"):
        ooc.helfand_out_of_core(pu, str(tmp_path / "s"), atom_chunk=4,
                                device="cpu")


def test_device_copies():
    block = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    f32, f64 = ooc.device_f32(block, "cpu"), ooc.device_f64(block, "cpu")
    assert f32.dtype == torch.float32 and f64.dtype == torch.float64
    assert np.array_equal(f64.numpy(), block.astype(np.float64))

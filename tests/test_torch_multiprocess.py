"""The sequence-parallel paths of the port over a mesh of several
processes: the ring (``parallel.ring``), the frame-sharded FFT
(``parallel.sharded_fft``) and the sharded out-of-core runs, each on
``multihost.global_mesh`` of a ``torch.distributed`` gloo group.

Two worker processes, which import no jax, each hold two CPU devices of
one four-position 'frames' axis; a third runs the same work in a group of
one process. The workers write their results, and this process holds
them against the JAX functions on four of the eight virtual CPU devices
of tests/conftest.py (1e-12, the bound of tests/test_torch_ring.py and
tests/test_torch_sharded_fft.py), against the port on a one-process mesh
of four CPU devices, and the two ranks against each other. Each worker
has a timeout and a free port bound from port 0, so a hung collective
fails the tests instead of hanging them.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu.core.topology import Topology as JTopology  # noqa: E402
from transport_analysis_tpu.io.trr import TRRReader as JTRRReader  # noqa: E402
from transport_analysis_tpu.parallel import out_of_core as jooc  # noqa: E402
from transport_analysis_tpu.parallel import ring as jring  # noqa: E402
from transport_analysis_tpu.parallel import sharded_fft as jsf  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch.core.topology import Topology  # noqa: E402
from transport_analysis_tpu_torch.io.trr import TRRReader  # noqa: E402
from transport_analysis_tpu_torch.parallel import multihost  # noqa: E402
from transport_analysis_tpu_torch.parallel import out_of_core as ooc  # noqa: E402
from transport_analysis_tpu_torch.parallel import ring  # noqa: E402
from transport_analysis_tpu_torch.parallel import sharded_fft as sf  # noqa: E402
from transport_analysis_tpu_torch.parallel.mesh import Mesh  # noqa: E402

from test_torch_out_of_core import MASSES, N_ATOMS, write_trr  # noqa: E402

TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# What the workers and this process share, as source that each runs: the
# workers may not import this module, which imports jax.
_SHARED = r'''
import numpy as np

BLOCKS = 4           # positions of the global 'frames' axis
RING_CASES = {       # key -> (mode, sum_d, dtype)
    "ring_acf": ("acf", True, np.float64),
    "ring_einstein_sum": ("einstein", True, np.float64),
    "ring_einstein_mean": ("einstein", False, np.float64),
    "ring_acf_f32": ("acf", True, np.float32),
    "ring_einstein_f32": ("einstein", True, np.float32),
}


def inputs():
    """The arrays every process draws from the same seeds: the ring's
    series (4 blocks of 8 frames), the complex FFT operand, the VACF and
    MSD series (the inputs of tests/test_torch_ring.py and
    tests/test_torch_sharded_fft.py)."""
    return {
        "series": np.random.RandomState(17).normal(size=(32, 3, 3)),
        "fft": np.random.RandomState(0).normal(size=(2, 1024, 6)),
        "vel": np.random.RandomState(3).normal(size=(500, 7, 3)),
        "pos": np.cumsum(np.random.RandomState(4).normal(size=(400, 5, 3)),
                         axis=0) + 50.0,
    }
'''
exec(_SHARED)


# The worker: argv = rank, world, port, repo, trajectory, output path.
# It runs each sequence-parallel path over the global mesh and saves what
# each returned; with world 2 it also checks the refusals of meshes the
# paths cannot take.
_WORKER = r'''
import os, sys
rank, world, port, repo, traj, out = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=world, rank=rank)
import transport_analysis_tpu_torch as ta
from transport_analysis_tpu_torch.core.topology import Topology
from transport_analysis_tpu_torch.io.trr import TRRReader
from transport_analysis_tpu_torch.parallel import (multihost, out_of_core,
                                                   ring, sharded_fft)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "transport_analysis_tpu")]
assert not bad, bad

mesh = multihost.global_mesh(["cpu"] * (BLOCKS // world), "frames")
assert mesh.shape["frames"] == BLOCKS and mesh.processes == world
data = inputs()
res = {}
for key, (mode, sum_d, dtype) in RING_CASES.items():
    res[key] = ring.windowed_correlation_ring(
        data["series"].astype(dtype), mesh, mode=mode, sum_d=sum_d).numpy()
zr, zi = sharded_fft.sharded_fft(data["fft"][0], data["fft"][1], mesh)
assert zr.distributed == (world > 1) and len(zr.shards) == BLOCKS // world
res["fft_re"], res["fft_im"] = zr.gather().numpy(), zi.gather().numpy()
xr, xi = sharded_fft.sharded_fft(zr, zi, mesh, inverse=True)
res["fft_back_re"], res["fft_back_im"] = (xr.gather().numpy(),
                                          xi.gather().numpy())
res["acf"] = sharded_fft.sharded_acf_fft(data["vel"], mesh)
for reduce_mode in ("sum", "mean"):
    res["msd_" + reduce_mode] = sharded_fft.sharded_msd_fft(
        data["pos"], mesh, reduce_mode=reduce_mode)
u = ta.Universe(Topology(10), TRRReader(traj))
u.add_TopologyAttr("masses", np.linspace(1.0, 16.0, 10))  # write_trr's
spools = out + ".spools"
res["ooc_vacf"] = out_of_core.vacf_out_of_core_sharded(
    u, os.path.join(spools, "v"), mesh, atom_chunk=4)
res["ooc_helfand"], visc = out_of_core.helfand_out_of_core_sharded(
    u, os.path.join(spools, "h"), mesh, atom_chunk=4,
    linear_fit_window=(2, 10))
res["ooc_viscosity"] = np.asarray(visc)
res["sent"] = np.asarray(multihost.traffic.sent)
if world > 1:
    try:
        ring.windowed_correlation_ring(data["series"][:30], mesh)
    except ValueError as err:
        assert "divisible" in str(err), err
    else:
        raise AssertionError("30 frames over 4 ring blocks accepted")
    # three devices a process: 6 positions, which no power-of-two M factors
    six = multihost.global_mesh(["cpu"] * 3, "frames")
    try:
        sharded_fft.sharded_acf_fft(data["vel"], six)
    except ValueError as err:
        assert "cannot factor" in str(err), err
    else:
        raise AssertionError("a 6-position axis accepted by the FFT")
np.savez(out, **res)
dist.destroy_process_group()
print("MP_OK", rank, world, flush=True)
'''


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results: {(world, rank): npz}, two ranks of a
    two-process group and the one rank of a group of one, run at once."""
    tmp = tmp_path_factory.mktemp("mp")
    traj = str(tmp / "t.trr")
    write_trr(traj)
    worker = tmp / "mp_worker.py"
    worker.write_text(_SHARED + _WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ports = {1: _free_port(), 2: _free_port()}
    jobs = {(world, rank): subprocess.Popen(
        [sys.executable, str(worker), str(rank), str(world), ports[world],
         REPO, traj, str(tmp / f"w{world}r{rank}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, rank in ((2, 0), (2, 1), (1, 0))}
    outs = {}
    try:
        for key, p in jobs.items():
            outs[key], _ = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        for p in jobs.values():
            p.kill()
        pytest.fail("a multi-process worker timed out:\n"
                    + "\n".join(outs.values()))
    for (world, rank), p in jobs.items():
        out = outs[(world, rank)]
        assert p.returncode == 0, f"worker {world}/{rank} failed:\n{out}"
        assert f"MP_OK {rank} {world}" in out, out
    return {key: dict(np.load(tmp / f"w{key[0]}r{key[1]}.npz"))
            for key in jobs}


@pytest.fixture(scope="module")
def universes(tmp_path_factory):
    """(JAX universe, port universe) on the workers' TRR, with masses."""
    traj = str(tmp_path_factory.mktemp("mpu") / "t.trr")
    write_trr(traj)
    ju = jta.Universe(JTopology(N_ATOMS), JTRRReader(traj))
    pu = ta.Universe(Topology(N_ATOMS), TRRReader(traj))
    for u in (ju, pu):
        u.add_TopologyAttr("masses", MASSES)
    return ju, pu


def one_process_mesh():
    return Mesh(["cpu"] * BLOCKS, ("frames",))


def jax_mesh():
    return JMesh(np.array(jax.devices()[:BLOCKS]), ("frames",))


def close(got, want, tol=TOL):
    """Within ``tol`` of ``want``'s maximum (the float32 cases: their
    grade)."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("key", list(RING_CASES))
def test_ring_two_processes(runs, key):
    """The ring over two processes equals the JAX ring on four devices
    and the port's one-process ring; both ranks hold the same means."""
    mode, sum_d, dtype = RING_CASES[key]
    series = inputs()["series"].astype(dtype)
    got = runs[(2, 0)][key]
    assert np.array_equal(got, runs[(2, 1)][key])
    tol = TOL if dtype == np.float64 else 2e-6
    close(got, ring.windowed_correlation_ring(
        series, one_process_mesh(), mode=mode, sum_d=sum_d).numpy(), tol)
    if dtype == np.float64:
        close(got, np.asarray(jring.windowed_correlation_ring(
            series, jax_mesh(), mode=mode, sum_d=sum_d)))


def test_sharded_fft_two_processes(runs):
    """The forward transform's transposed-order rows equal the JAX
    package's and the one-process port's bit for bit; the inverse returns
    the input."""
    re, im = inputs()["fft"]
    res = runs[(2, 0)]
    jr, ji = jsf.sharded_fft(re, im, jax_mesh())
    want = np.asarray(jr) + 1j * np.asarray(ji)
    got = res["fft_re"] + 1j * res["fft_im"]
    assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    zr, zi = sf.sharded_fft(re, im, one_process_mesh())
    assert np.array_equal(res["fft_re"], zr.gather().numpy())
    assert np.array_equal(res["fft_im"], zi.gather().numpy())
    assert_allclose(res["fft_back_re"], re, atol=1e-11)
    assert_allclose(res["fft_back_im"], im, atol=1e-11)
    for key in ("fft_re", "fft_im", "fft_back_re", "fft_back_im"):
        assert np.array_equal(res[key], runs[(2, 1)][key])


@pytest.mark.parametrize("key", ["acf", "msd_sum", "msd_mean"])
def test_sharded_correlations_two_processes(runs, key):
    """``sharded_acf_fft`` and ``sharded_msd_fft`` over two processes
    against the JAX functions and, bit for bit, the one-process port."""
    data = inputs()
    got = runs[(2, 0)][key]
    assert np.array_equal(got, runs[(2, 1)][key])
    if key == "acf":
        want = jsf.sharded_acf_fft(data["vel"], jax_mesh())
        mine = sf.sharded_acf_fft(data["vel"], one_process_mesh())
    else:
        mode = key[4:]
        want = jsf.sharded_msd_fft(data["pos"], jax_mesh(),
                                   reduce_mode=mode)
        mine = sf.sharded_msd_fft(data["pos"], one_process_mesh(),
                                  reduce_mode=mode)
    close(got, want)
    assert np.array_equal(got, mine)


def test_out_of_core_sharded_two_processes(runs, universes, tmp_path):
    """The sharded out-of-core VACF and Helfand runs, each process with
    its own spools, equal the one-process runs and the JAX package's."""
    ju, pu = universes
    res = runs[(2, 0)]
    mine = ooc.vacf_out_of_core_sharded(pu, str(tmp_path / "v"),
                                        one_process_mesh(), atom_chunk=4)
    mine_h, mine_visc = ooc.helfand_out_of_core_sharded(
        pu, str(tmp_path / "h"), one_process_mesh(), atom_chunk=4,
        linear_fit_window=(2, 10))
    assert np.array_equal(res["ooc_vacf"], mine)
    assert np.array_equal(res["ooc_helfand"], mine_h)
    assert float(res["ooc_viscosity"]) == mine_visc
    close(res["ooc_vacf"], jooc.vacf_out_of_core_sharded(
        ju, str(tmp_path / "jv"), jax_mesh(), atom_chunk=4))
    close(res["ooc_helfand"], jooc.helfand_out_of_core_sharded(
        ju, str(tmp_path / "jh"), jax_mesh(), atom_chunk=4)[0])
    for key in ("ooc_vacf", "ooc_helfand"):
        assert np.array_equal(res[key], runs[(2, 1)][key])


def test_world_one_group_is_the_one_process_path(runs):
    """A group of one process runs no transfer (nothing sent) and returns
    what the one-process mesh does, bit for bit."""
    one = runs[(1, 0)]
    assert int(one["sent"]) == 0
    assert int(runs[(2, 0)]["sent"]) > 0 and int(runs[(2, 1)]["sent"]) > 0
    data = inputs()
    for key, (mode, sum_d, dtype) in RING_CASES.items():
        assert np.array_equal(one[key], ring.windowed_correlation_ring(
            data["series"].astype(dtype), one_process_mesh(), mode=mode,
            sum_d=sum_d).numpy()), key
    assert np.array_equal(one["acf"], sf.sharded_acf_fft(
        data["vel"], one_process_mesh()))


def test_mesh_of_other_processes_raises():
    """A mesh of two processes in a process with no group is refused by
    the ring and the FFT before any transfer."""
    mesh = Mesh(["cpu"] * 2, ("frames",), processes=2)
    series = inputs()["series"]
    with pytest.raises(ValueError, match="process"):
        ring.windowed_correlation_ring(series, mesh)
    with pytest.raises(ValueError, match="process"):
        sf.sharded_acf_fft(series, mesh)
    assert multihost.axis_position(one_process_mesh()) == 0

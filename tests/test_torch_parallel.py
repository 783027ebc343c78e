"""The port's particle sharding (``parallel.mesh``, ``parallel.sharding``)
and multi-process feed (``parallel.multihost``) against the JAX package's,
on the same systems.

The port's mesh repeats the CPU (``analysis_mesh(["cpu"] * n)``); the JAX
package's is the 8-virtual-device CPU mesh of tests/conftest.py. Each
system is a JAX-package Universe carried over to the port through its
arrays (tests/test_torch_models.py ``port_universe``). Bounds: the JAX
tests' own, 1e-12 relative; 2e-5 of the maximum for the float32 work
mode, the float32 tests' bound.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu import parallel as jparallel  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import parallel  # noqa: E402
from transport_analysis_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from transport_analysis_tpu_torch.parallel import multihost  # noqa: E402

from test_torch_models import port_universe  # noqa: E402

RTOL = 1e-12
F32_TOL = 2e-5
MODELS = {
    "vacf": (ta.VelocityAutocorr, jta.VelocityAutocorr, "vacf_by_particle"),
    "helfand": (ta.ViscosityHelfand, jta.ViscosityHelfand,
                "visc_by_particle"),
    "msd": (ta.EinsteinMSD, jta.EinsteinMSD, "msds_by_particle"),
}


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.analysis_mesh()


@pytest.fixture(scope="module")
def mesh():
    return parallel.analysis_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def systems(u_random):
    return u_random, port_universe(u_random)


def uneven_system():
    """10 particles over 8 shards: the particle axis is padded to 16."""
    rng = np.random.RandomState(0)
    u = jta.Universe.empty(10, n_frames=16, velocities=True)
    from transport_analysis_tpu.core.transformations import set_dimensions

    setter = set_dimensions([20.0, 20.0, 20.0, 90.0, 90.0, 90.0])
    for ts in u.trajectory:
        u.atoms.velocities = rng.normal(size=(10, 3))
        u.atoms.positions = rng.uniform(0, 20, (10, 3))
        setter(ts)
    u.add_TopologyAttr("masses", np.full(10, 12.0))
    return u, port_universe(u)


# --- the mesh -----------------------------------------------------------------

def test_mesh_of_repeated_devices():
    m = parallel.analysis_mesh(["cpu"] * 4)
    assert m.shape[pmesh.ATOM_AXIS] == 4 and m.axis_names == ("atoms",)
    assert m.devices == (torch.device("cpu"),) * 4
    assert pmesh.Mesh(["cpu"] * 3, ("frames",)).shape == {"frames": 3}


def test_mesh_refuses_mixed_and_bad_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        pmesh.Mesh([torch.device("cpu"), torch.device("meta")], ("atoms",))
    with pytest.raises(ValueError, match="one axis"):
        pmesh.Mesh(["cpu"], ("a", "b"))
    with pytest.raises(ValueError, match="at least one"):
        pmesh.Mesh([], ("a",))


def test_mesh_mixing_cpu_and_cuda_raises(monkeypatch):
    """A mesh of the CPU and a card raises ValueError (the card's check
    stubbed, so the case runs without one)."""
    monkeypatch.setattr(pmesh, "_resolved", lambda d: torch.device(d))
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        pmesh.Mesh(["cpu", "cuda:0"], ("atoms",))


def test_analysis_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.analysis_mesh()


def test_use_mesh_is_scoped(mesh):
    assert parallel.current_mesh() is None
    with parallel.use_mesh(mesh) as m:
        assert m is mesh and parallel.current_mesh() is mesh
        with parallel.use_mesh(parallel.analysis_mesh(["cpu"])):
            assert parallel.current_mesh().size == 1
        assert parallel.current_mesh() is mesh
    assert parallel.current_mesh() is None


# --- sharding -----------------------------------------------------------------

@pytest.mark.parametrize("n_particles", [8, 10, 16, 3])
def test_shard_particles_pads_and_splits(mesh, n_particles):
    """The particle axis padded with zeros to a multiple of the mesh size
    and cut into contiguous shards, as the JAX package's
    ``shard_particles`` places it."""
    arr = np.random.RandomState(n_particles).normal(size=(5, n_particles, 3))
    with jparallel.use_mesh(jparallel.analysis_mesh()):
        jarr, jn = jparallel.shard_particles(arr)
    with parallel.use_mesh(mesh):
        block, n = parallel.shard_particles(arr)
    assert n == jn == n_particles
    assert block.shape == jarr.shape
    width = block.shape[1] // 8
    assert block.offsets == [i * width for i in range(8)]
    assert all(s.shape == (5, width, 3) for s in block.shards)
    assert np.array_equal(block.gather().numpy(), np.asarray(jarr))
    with parallel.use_mesh(mesh):
        assert parallel.shard_frames_axis(arr).shape == block.shape


def test_shard_particles_without_mesh():
    arr = np.ones((4, 3, 2))
    t, n = parallel.shard_particles(arr, device="cpu")
    assert isinstance(t, torch.Tensor) and n == 3
    assert parallel.shard_frames_axis(arr, device="cpu").shape == (4, 3, 2)


# --- the models under a mesh ----------------------------------------------------

@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("fft", [True, False])
def test_models_sharded_vs_jax(systems, mesh, jmesh, name, fft):
    port, jax_cls, key = MODELS[name]
    ju, pu = systems
    with jparallel.use_mesh(jmesh):
        ref = jax_cls(ju.atoms, fft=fft).run()
    with parallel.use_mesh(mesh):
        got = port(pu.atoms, fft=fft, device="cpu").run()
    assert got.results[key].shape == ref.results[key].shape
    assert_allclose(got.results.timeseries, ref.results.timeseries,
                    rtol=RTOL)
    assert_allclose(got.results[key], ref.results[key], rtol=RTOL,
                    atol=RTOL * np.abs(ref.results[key]).max())


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("fft", [True, False])
def test_models_sharded_uneven_particles(mesh, jmesh, name, fft):
    """10 particles over 8 shards: the padded particles are sliced away
    before the mean."""
    port, jax_cls, key = MODELS[name]
    ju, pu = uneven_system()
    with jparallel.use_mesh(jmesh):
        ref = jax_cls(ju.atoms, fft=fft).run()
    with parallel.use_mesh(mesh):
        got = port(pu.atoms, fft=fft, device="cpu").run()
    assert got.results[key].shape == (16, 10)
    assert_allclose(got.results.timeseries, ref.results.timeseries,
                    rtol=RTOL)


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_models_sharded_equal_the_unsharded_port(systems, name, n_shards):
    """Sharded over 1, 3 (a shard of padding) and 8 devices, with
    max_lag and the frame-blocked feed, against the port's own unsharded
    run."""
    port, _, key = MODELS[name]
    _, pu = systems
    kwargs = dict(fft=False, max_lag=7, frame_block=5, device="cpu")
    base = port(pu.atoms, **kwargs).run()
    with parallel.use_mesh(parallel.analysis_mesh(["cpu"] * n_shards)):
        got = port(pu.atoms, **kwargs).run()
    assert got.results[key].shape == base.results[key].shape == (7, 10)
    assert_allclose(got.results[key], base.results[key], rtol=RTOL)
    assert_allclose(got.results.timeseries, base.results.timeseries,
                    rtol=RTOL)


def test_sharded_float32_mode_vs_jax(systems, mesh, jmesh):
    """The float32 work mode under a mesh, within the float32 bound of the
    JAX package's, with its result dtype."""
    ju, pu = systems
    with jparallel.use_mesh(jmesh):
        ref = jta.VelocityAutocorr(ju.atoms, dtype=np.float32).run()
    with parallel.use_mesh(mesh):
        got = ta.VelocityAutocorr(pu.atoms, dtype=np.float32,
                                  device="cpu").run()
    assert got.results.timeseries.dtype == np.float32
    ts, want = got.results.timeseries, np.asarray(ref.results.timeseries)
    assert np.abs(ts - want).max() <= F32_TOL * np.abs(want).max()


def test_atom_chunk_ignores_the_mesh(systems, mesh):
    """``atom_chunk`` streams its chunks as without a mesh, as in the JAX
    package."""
    _, pu = systems
    base = ta.VelocityAutocorr(pu.atoms, atom_chunk=3, device="cpu").run()
    with parallel.use_mesh(mesh):
        got = ta.VelocityAutocorr(pu.atoms, atom_chunk=3, device="cpu").run()
    assert np.array_equal(got.results.timeseries, base.results.timeseries)


# --- the multi-process feed, one process ------------------------------------------

def test_multihost_feed_single_process(mesh, jmesh):
    """distribute_atom_block on a one-process mesh: the whole array in
    the mesh's shards, equal to the JAX package's feed."""
    from transport_analysis_tpu import ops as jops
    from transport_analysis_tpu.parallel import multihost as jmultihost
    from transport_analysis_tpu_torch import ops

    rng = np.random.RandomState(2)
    block = rng.normal(size=(16, 16, 3))
    sl = multihost.atom_shard_for_process(16, mesh)
    assert sl == jmultihost.atom_shard_for_process(16, jmesh) == slice(0, 16)
    garr = multihost.distribute_atom_block(block[:, sl], 16, mesh)
    assert garr.shape == (16, 16, 3) and not garr.distributed
    assert garr.offsets == list(range(0, 16, 2))
    got = ops.acf_fft(garr.gather()).numpy()
    want = np.asarray(jops.acf_fft(jmultihost.distribute_atom_block(
        block[:, sl], 16, jmesh)))
    assert_allclose(got, want, rtol=RTOL)
    total = garr.psum(lambda s: (s * s).sum(dim=(1, 2)))
    assert_allclose(total.numpy(), np.sum(block * block, axis=(1, 2)),
                    rtol=RTOL)


def test_multihost_feed_uneven_rejected(mesh):
    with pytest.raises(ValueError, match="divide evenly"):
        multihost.atom_shard_for_process(10, mesh)


def test_multihost_one_process_mesh():
    assert multihost.process_index_count() == (0, 1)
    m = multihost.global_mesh(["cpu"] * 4)
    assert m.shape["atoms"] == 4 and m.processes == 1


_MP_WORKER = r'''
import os, sys
pid, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=2, rank=pid)
from transport_analysis_tpu_torch.parallel import multihost
assert "jax" not in sys.modules
mesh = multihost.global_mesh(["cpu"] * 4)
assert mesh.shape["atoms"] == 8 and mesh.processes == 2
n_frames, n_atoms, d = 16, 24, 3
rng = np.random.default_rng(0)  # same full array in both processes
full = rng.standard_normal((n_frames, n_atoms, d))
sl = multihost.atom_shard_for_process(n_atoms, mesh)
assert (sl.start, sl.stop) == (12 * pid, 12 * pid + 12), sl
arr = multihost.distribute_atom_block(full[:, sl, :], n_atoms, mesh)
assert arr.shape == (n_frames, n_atoms, d) and arr.distributed
# cross-shard reduction through all_reduce: wrong assembly cannot cancel
got = arr.psum(lambda s: (s * s).sum(dim=(1, 2)))
np.testing.assert_allclose(got.numpy(), np.sum(full * full, axis=(1, 2)),
                           rtol=1e-12)
# per-shard identity: each process holds ITS shards
for s, lo in zip(arr.shards, arr.offsets):
    np.testing.assert_array_equal(s.numpy(), full[:, lo:lo + 3, :])
# gather through all_gather: the whole array in every process
np.testing.assert_array_equal(arr.gather().numpy(), full)
try:
    multihost.global_mesh(["cpu"] * (2 + pid))
except ValueError as err:
    assert "same number of devices" in str(err)
else:
    raise AssertionError("unequal global mesh accepted")
dist.destroy_process_group()
print("MP_FEED_OK", pid, flush=True)
'''


def test_multihost_feed_two_processes(tmp_path):
    """The multi-process feed over two gloo processes (4 CPU shards each
    -> one 8-shard global mesh): each feeds only its own atom slab, the
    cross-process sum and gather are right, and unequal device counts are
    refused. The workers import no jax."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    worker = tmp_path / "mp_worker.py"
    worker.write_text(_MP_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port, repo],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process feed worker timed out:\n"
                    + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MP_FEED_OK {pid}" in out, out


"""The port's frame-sharded four-step FFT (``parallel.sharded_fft``) and
the sharded out-of-core runs (``parallel.out_of_core``
``*_out_of_core_sharded``) against the JAX package's, on the same inputs.

The port's mesh repeats the CPU (``Mesh(["cpu"] * D, ("frames",))``); the
JAX package's is D of the 8 virtual CPU devices of tests/conftest.py. Its
``sharded_fft`` keeps the JAX package's N1 (``_pick_n1``), so the
transposed-order outputs are compared row for row. Bounds: the JAX
tests' own (1e-12 relative where they hold a result to another, 1e-10 of
the maximum against numpy, 2e-4 of it in float32).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from transport_analysis_tpu.parallel import sharded_fft as jsf  # noqa: E402
from transport_analysis_tpu.parallel import out_of_core as jooc  # noqa: E402
from transport_analysis_tpu_torch import ops  # noqa: E402
from transport_analysis_tpu_torch.ops.acf import next_pow_2  # noqa: E402
from transport_analysis_tpu_torch.parallel import sharded_fft as sf  # noqa: E402
from transport_analysis_tpu_torch.parallel import out_of_core as ooc  # noqa: E402
from transport_analysis_tpu_torch.parallel.mesh import Mesh  # noqa: E402

from test_torch_out_of_core import trr  # noqa: E402,F401

TOL = 1e-12


def meshes(n):
    return (Mesh(["cpu"] * n, ("frames",)),
            JMesh(np.array(jax.devices()[:n]), ("frames",)))


def joined(re, im):
    return re.gather().numpy() + 1j * im.gather().numpy()


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_forward_transposed_order_vs_jax(n_dev):
    """The forward transform's transposed-order rows equal the JAX
    package's, and its inverse returns the input."""
    rng = np.random.RandomState(0)
    m, b = 1024, 6
    re, im = rng.normal(size=(m, b)), rng.normal(size=(m, b))
    mesh, jmesh = meshes(n_dev)
    zr, zi = sf.sharded_fft(re, im, mesh)
    jr, ji = jsf.sharded_fft(re, im, jmesh)
    want = np.asarray(jr) + 1j * np.asarray(ji)
    assert len(zr.shards) == n_dev and zr.shape == (m, b)
    assert_allclose(joined(zr, zi), want, rtol=0,
                    atol=TOL * np.abs(want).max())
    xr, xi = sf.sharded_fft(zr, zi, mesh, inverse=True)
    assert_allclose(xr.gather().numpy(), re, atol=1e-11)
    assert_allclose(xi.gather().numpy(), im, atol=1e-11)
    jxr, jxi = jsf.sharded_fft(jr, ji, jmesh, inverse=True)
    assert_allclose(xr.gather().numpy(), np.asarray(jxr), rtol=0,
                    atol=TOL * np.abs(re).max())


def test_power_spectrum_matches_numpy():
    """Transposed order: row k1·N2 + k2 holds frequency k2·N1 + k1."""
    rng = np.random.RandomState(1)
    m, b = 512, 3
    x = rng.normal(size=(m, b))
    mesh, _ = meshes(8)
    got = joined(*sf.sharded_fft(x, np.zeros_like(x), mesh))
    want = np.fft.fft(x, axis=0)
    n1 = sf._pick_n1(m, 8)
    n2 = m // n1
    k1, k2 = np.divmod(np.arange(m), n2)
    assert_allclose(got, want[k2 * n1 + k1],
                    atol=1e-10 * np.max(np.abs(want)))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_raw_autocorr_vs_jax(n_dev):
    rng = np.random.RandomState(2)
    n, s = 300, 5
    x = rng.normal(size=(n, s))
    m = 2 * next_pow_2(n)
    xp = np.zeros((m, s))
    xp[:n] = x
    mesh, jmesh = meshes(n_dev)
    got = sf.sharded_raw_autocorr(xp, mesh).gather().numpy()[:n]
    want = np.asarray(jsf.sharded_raw_autocorr(xp, jmesh))[:n]
    ref = np.stack([np.correlate(x[:, i], x[:, i], "full")[n - 1:]
                    for i in range(s)], axis=1)
    assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert_allclose(got, ref, atol=1e-10 * np.max(np.abs(ref)))


def test_sharded_acf_vs_jax_and_acf_fft():
    rng = np.random.RandomState(3)
    x = rng.normal(size=(500, 7, 3))
    mesh, jmesh = meshes(8)
    got = sf.sharded_acf_fft(x, mesh)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert_allclose(got, jsf.sharded_acf_fft(x, jmesh), rtol=1e-10,
                    atol=TOL)
    assert_allclose(got, ops.acf_fft(torch.from_numpy(x)).numpy(),
                    rtol=1e-10, atol=TOL)


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
def test_sharded_msd_vs_jax_and_einstein_fft(reduce_mode):
    rng = np.random.RandomState(4)
    a = np.cumsum(rng.normal(size=(400, 5, 3)), axis=0) + 50.0
    mesh, jmesh = meshes(8)
    got = sf.sharded_msd_fft(a, mesh, reduce_mode=reduce_mode)
    want = jsf.sharded_msd_fft(a, jmesh, reduce_mode=reduce_mode)
    assert got.dtype == np.float64 and got[0].max() == 0.0
    assert_allclose(got, want, rtol=1e-9, atol=1e-10)
    assert_allclose(got, ops.einstein_difference_fft(
        torch.from_numpy(a), reduce_mode).numpy(), rtol=1e-9, atol=1e-10)


def test_sharded_acf_float32_branch():
    """float32 input runs complex64 and returns float32, as the JAX
    function's float32 branch does."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(256, 6, 3)).astype(np.float32)
    mesh, jmesh = meshes(8)
    m = 2 * next_pow_2(256)
    xp = np.zeros((m, 18), np.float32)
    xp[:256] = x.reshape(256, 18)
    got = sf.sharded_raw_autocorr(xp, mesh).gather().numpy()[:256]
    assert got.dtype == np.float32
    want = np.asarray(jsf.sharded_raw_autocorr(xp, jmesh))[:256]
    ref = np.stack([np.correlate(xp[:256, i], xp[:256, i], "full")[255:]
                    for i in range(18)], axis=1)
    scale = np.abs(ref).max()
    assert_allclose(got, ref, atol=2e-4 * scale)
    assert_allclose(got, want, atol=2e-4 * scale)
    assert sf.sharded_acf_fft(x, mesh).dtype == \
        jsf.sharded_acf_fft(x, jmesh).dtype


def test_bad_factorization_raises():
    mesh, _ = meshes(8)
    with pytest.raises(ValueError, match="cannot factor"):
        sf.sharded_raw_autocorr(np.zeros((20, 2)), mesh)
    # M = 16 over 8 devices: N1 = 8 divides it, but N2 = 2 leaves no
    # whole all-to-all block for each of 8 devices
    with pytest.raises(ValueError, match="cannot factor"):
        sf._factor(16, 8)


def test_transposed_output_false_raises():
    mesh, _ = meshes(2)
    x = np.zeros((16, 2))
    with pytest.raises(NotImplementedError, match="natural-order"):
        sf.sharded_fft(x, x, mesh, transposed_output=False)


def test_pick_n1_is_the_jax_packages():
    for m in (16, 64, 512, 1024, 2 ** 17):
        for d in (1, 2, 4, 8):
            assert sf._pick_n1(m, d) == jsf._pick_n1(m, d)


# --- sharded out of core ----------------------------------------------------

def test_vacf_out_of_core_sharded_vs_jax(trr, tmp_path):  # noqa: F811
    """Spooled atoms × frame-sharded FFT against the JAX package's and the
    port's plain out-of-core VACF."""
    ju, pu = trr
    mesh, jmesh = meshes(8)
    got = ooc.vacf_out_of_core_sharded(pu, str(tmp_path / "p"), mesh,
                                       atom_chunk=4)
    want = jooc.vacf_out_of_core_sharded(ju, str(tmp_path / "j"), jmesh,
                                         atom_chunk=4)
    assert_allclose(got, want, rtol=TOL)
    plain = ooc.vacf_out_of_core(pu, str(tmp_path / "q"), atom_chunk=4,
                                 device="cpu")
    assert_allclose(got, plain, rtol=1e-10, atol=TOL)


def test_helfand_out_of_core_sharded_vs_jax(trr, tmp_path):  # noqa: F811
    ju, pu = trr
    mesh, jmesh = meshes(8)
    got_ts, got_visc = ooc.helfand_out_of_core_sharded(
        pu, str(tmp_path / "p"), mesh, atom_chunk=4,
        linear_fit_window=(2, 10))
    want_ts, want_visc = jooc.helfand_out_of_core_sharded(
        ju, str(tmp_path / "j"), jmesh, atom_chunk=4,
        linear_fit_window=(2, 10))
    assert_allclose(got_ts, want_ts, rtol=TOL)
    assert got_visc == pytest.approx(want_visc, rel=1e-10)
    plain_ts, _ = ooc.helfand_out_of_core(pu, str(tmp_path / "q"),
                                          atom_chunk=4, device="cpu")
    assert_allclose(got_ts, plain_ts, rtol=1e-9, atol=TOL)


def test_sharded_out_of_core_auto_chunk_and_checkpoint(trr, tmp_path):  # noqa: F811
    """``atom_chunk='auto'`` sizes the chunk for the mesh's first device;
    a checkpoint written by the sharded run resumes it."""
    _, pu = trr
    mesh, _ = meshes(4)
    ckpt = str(tmp_path / "c.npz")
    first = ooc.vacf_out_of_core_sharded(pu, str(tmp_path / "s"), mesh,
                                         atom_chunk=3, checkpoint=ckpt)
    again = ooc.vacf_out_of_core_sharded(pu, str(tmp_path / "s"), mesh,
                                         atom_chunk=3, checkpoint=ckpt)
    assert np.array_equal(first, again)
    auto = ooc.vacf_out_of_core_sharded(pu, str(tmp_path / "a"), mesh)
    assert_allclose(auto, first, rtol=TOL)

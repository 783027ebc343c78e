"""The port's ring-distributed windowed correlation (``parallel.ring``)
and its pair sums (``ops.cuda_lag.lag_sums_pair_plain``, the two-block
launch's plain version) against the JAX package's, on the same inputs.

The port's mesh repeats the CPU (``Mesh(["cpu"] * B, ("frames",))``); the
JAX package's is B of the 8 virtual CPU devices of tests/conftest.py.
Bound: the JAX tests' own, 1e-12 relative and absolute.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from transport_analysis_tpu.parallel import ring as jring  # noqa: E402
from transport_analysis_tpu_torch import ops  # noqa: E402
from transport_analysis_tpu_torch.ops import cuda_lag  # noqa: E402
from transport_analysis_tpu_torch.parallel import ring  # noqa: E402
from transport_analysis_tpu_torch.parallel.mesh import Mesh  # noqa: E402

TOL = 1e-12
CASES = [("acf", True), ("acf", False), ("einstein", True),
         ("einstein", False)]


def meshes(n):
    return (Mesh(["cpu"] * n, ("frames",)),
            JMesh(np.array(jax.devices()[:n]), ("frames",)))


@pytest.fixture(scope="module")
def series():
    rng = np.random.RandomState(17)
    # 4 blocks of 8 frames, 3 particles, 3 components
    return rng.normal(size=(32, 3, 3))


@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,sum_d", CASES)
def test_ring_vs_jax(series, n_blocks, mode, sum_d):
    mesh, jmesh = meshes(n_blocks)
    got = ring.windowed_correlation_ring(series, mesh, mode=mode,
                                         sum_d=sum_d)
    want = np.asarray(jring.windowed_correlation_ring(
        series, jmesh, mode=mode, sum_d=sum_d))
    assert got.dtype == torch.float64 and got.shape == (32, 3)
    assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_blocks", [1, 4, 8])
@pytest.mark.parametrize("mode,sum_d", CASES)
def test_ring_matches_serial(series, n_blocks, mode, sum_d):
    """The ring against the port's serial windowed ops (the JAX test's
    check)."""
    mesh, _ = meshes(n_blocks)
    got = ring.windowed_correlation_ring(series, mesh, mode=mode,
                                         sum_d=sum_d).numpy()
    x = torch.from_numpy(series)
    if mode == "acf":
        want = ops.acf_windowed(x).numpy()
    else:
        want = ops.einstein_difference_windowed(
            x, reduce_mode="sum" if sum_d else "mean").numpy()
    assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ring_float32_keeps_its_type(series):
    """A float32 operand runs the float32 pair sums and returns float32,
    within the float32 grade of the float64 ring."""
    mesh, _ = meshes(4)
    got = ring.windowed_correlation_ring(series.astype(np.float32), mesh,
                                         mode="einstein")
    want = ring.windowed_correlation_ring(series, mesh, mode="einstein")
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()
                 / want.abs().max()) <= 2e-6


def test_ring_rejects_uneven_split(series):
    mesh, _ = meshes(4)
    with pytest.raises(ValueError, match="divisible"):
        ring.windowed_correlation_ring(series[:30], mesh)


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("mode,sum_d", CASES)
def test_pair_plain_vs_jax_pair_accumulate(series, k, mode, sum_d):
    """One ring round's pair sums: ``lag_sums_pair_plain`` over the
    round's lag window against JAX's ``_pair_accumulate`` of the same
    blocks (blocks 0 and k of 4)."""
    n, block = 32, 8
    xa, xb = series[:block], series[k * block:(k + 1) * block]
    want = np.asarray(jring._pair_accumulate(
        jax.numpy.zeros((n, 3)), xa, xb, k, block, n, mode, sum_d))
    lo, count = ring.round_window(k, block, n)
    reduce_mode = "mean" if mode == "einstein" and not sum_d else "sum"
    got = np.zeros((n, 3))
    got[lo:lo + count] = cuda_lag.lag_sums_pair_plain(
        torch.from_numpy(xa), torch.from_numpy(xb), k * block, lo, count,
        mode, reduce_mode).numpy()
    assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_round_windows_cover_every_lag_once():
    """Over the rounds, each device pair's windows take each (frame, lag)
    pair of the series once: the rounds' pair counts sum to the serial
    sums' N − lag."""
    n, n_blocks = 40, 5
    block = n // n_blocks
    counts = np.zeros(n)
    ones = torch.ones((block, 1, 1), dtype=torch.float64)
    for k in range(n_blocks):
        lo, count = ring.round_window(k, block, n)
        for _ in range(n_blocks - k):
            # acf of ones counts the pairs of each lag
            counts[lo:lo + count] += cuda_lag.lag_sums_pair_plain(
                ones, ones, k * block, lo, count, "acf")[:, 0].numpy()
    assert np.array_equal(counts, n - np.arange(n))


def test_pair_sums_check_their_blocks():
    x = torch.zeros((4, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="blocks differ"):
        cuda_lag.lag_sums_pair(x, x[:3], 0, 0, 4)
    with pytest.raises(ValueError, match="n_lags"):
        cuda_lag.lag_sums_pair(x, x, 0, 0, 0)
    with pytest.raises(ValueError, match="mode"):
        cuda_lag.lag_sums_pair(x, x, 0, 0, 4, mode="msd")


@pytest.mark.parametrize("offset,lag_lo,n_lags", [(0, 0, 9), (9, 1, 17),
                                                  (27, 19, 17), (13, 0, 30)])
@pytest.mark.parametrize("mode", ["acf", "einstein"])
def test_pair_plain_vs_brute_force(offset, lag_lo, n_lags, mode):
    """The plain version against a loop over the frame pairs, with lags
    past the pairs at both ends, d = 5 and the component mean."""
    rng = np.random.RandomState(offset)
    xa, xb = rng.normal(size=(2, 9, 4, 5))
    want = np.zeros((n_lags, 4))
    for j in range(n_lags):
        for a in range(9):
            b = a + lag_lo + j - offset
            if 0 <= b < 9:
                term = (xa[a] * xb[b] if mode == "acf"
                        else (xa[a] - xb[b]) ** 2)
                want[j] += term.sum(-1) / 5
    got = cuda_lag.lag_sums_pair(torch.from_numpy(xa), torch.from_numpy(xb),
                                 offset, lag_lo, n_lags, mode, "mean")
    assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


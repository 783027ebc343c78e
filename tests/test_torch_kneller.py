"""The port's Kneller/Calandrini assembly (transport_analysis_tpu_torch/ops/
cuda_kneller.py, ops/einstein.py) against the JAX package.

On the CPU the K6 wrappers run their plain PyTorch versions; the JAX side
runs ``einstein._einstein_fft_impl`` and, where its shape gate allows
(N % 512 == 0, N >= 1024), the Pallas kernels of ``pallas_kneller`` in
interpret mode. The port takes any N >= 1: the odd sizes below are the
ragged edges the TPU gate excluded. Bound: 1e-12 of the maximum, with
lag 0 exactly 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from transport_analysis_tpu.ops import einstein as jein  # noqa: E402
from transport_analysis_tpu.ops import pallas_kneller as jpk  # noqa: E402
from transport_analysis_tpu_torch.ops import cuda_kneller, einstein  # noqa: E402

TOL = 1e-12


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _centered_inputs(n, p, d, seed=11):
    """Centered operand a (N, P, d), its |a|² component sums and its raw
    component-summed autocorrelation, from a numpy seed."""
    a = np.random.RandomState(seed).normal(0, 1.5, (n, p, d))
    a -= a.mean(axis=0, keepdims=True)
    sq = np.sum(a * a, axis=-1)
    f = np.fft.rfft(a.reshape(n, p * d), n=4 * n, axis=0)
    corr = np.fft.irfft(f * np.conj(f), n=4 * n, axis=0)[:n]
    return a, sq, corr.reshape(n, p, d).sum(axis=-1)


SHAPES = [(1024, 37, 3), (1000, 5, 3), (7, 2, 1)]


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("n,p,d", SHAPES)
def test_assembly_vs_jax_xla(n, p, d, reduce_mode):
    _, sq, corr = _centered_inputs(n, p, d)
    got = cuda_kneller.einstein_assembly(
        torch.from_numpy(sq), torch.from_numpy(corr), reduce_mode, d)
    ref = np.asarray(jein._einstein_fft_impl(
        jnp.asarray(sq), reduce_mode, d, jnp.asarray(corr)))
    assert got.shape == (n, p)
    assert rel(got, ref) <= TOL
    assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
def test_assembly_vs_jax_pallas_interpret(reduce_mode):
    n, p, d = SHAPES[0]
    assert jpk.supported(n)
    _, sq, corr = _centered_inputs(n, p, d)
    got = cuda_kneller.einstein_assembly(
        torch.from_numpy(sq), torch.from_numpy(corr), reduce_mode, d)
    ref = np.asarray(jpk.einstein_assembly(
        jnp.asarray(sq), jnp.asarray(corr), reduce_mode, d))
    assert rel(got, ref) <= TOL
    assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("n,p", [(1, 1), (127, 3), (128, 2), (300, 129)])
def test_totals_plain_vs_numpy(n, p):
    """Block totals of sq and of sq in reverse frame order, with the
    ragged last block."""
    rows = cuda_kneller.KNELLER_ROWS
    sq = np.random.RandomState(n).uniform(0, 2, (n, p))
    got = cuda_kneller.kneller_totals(torch.from_numpy(sq)).numpy()
    nb = -(-n // rows)
    ref = np.zeros((2, nb, p))
    for b in range(nb):
        ref[0, b] = sq[b * rows:(b + 1) * rows].sum(0)
        ref[1, b] = sq[::-1][b * rows:(b + 1) * rows].sum(0)
    assert got.shape == (2, nb, p)
    assert rel(got, ref) <= TOL


def emulate_totals(sq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K6a as ``csrc/kneller.cu`` runs it, in numpy, from its work split
    (``totals_split``, ``totals_run``): the totals and how often each row
    of ``sq`` was read."""
    n, p = sq.shape
    rows = cuda_kneller.KNELLER_ROWS
    nb = -(-n // rows)
    run, runs, r = cuda_kneller.totals_split(n)
    tot = np.full((2, nb, p), np.nan)
    reads = np.zeros(n, dtype=np.int64)
    for j in range(runs):
        halo, blocks = cuda_kneller.totals_run(n, j, run)
        carry = np.zeros(p)
        if halo is not None:
            reads[halo.start:halo.stop] += 1
            carry = sq[halo.start:halo.stop].sum(0)
        for k, lo, hi, rev in blocks:
            reads[lo.start:hi.stop] += 1
            lo_sum = sq[lo.start:lo.stop].sum(0)
            hi_sum = sq[hi.start:hi.stop].sum(0)
            assert np.isnan(tot[0, k]).all() and np.isnan(tot[1, rev]).all()
            tot[0, k] = lo_sum + hi_sum
            if r == 0:
                tot[1, rev] = hi_sum
            else:
                tot[1, rev] = carry + lo_sum
                carry = hi_sum
    return tot, reads


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 255, 256, 1000, 1151,
                               8192, 8193, 16383])
@pytest.mark.parametrize("p", [1, 3])
def test_totals_lo_hi_recombination(n, p):
    """K6a's lo/hi split, recombined in numpy run by run, reproduces
    kneller_totals_plain for every r = N mod R (0, 1, R − 1 and between),
    with one run or many; every total is written once, every row of sq
    read once but for the halos, which stay within 1/8 of sq."""
    sq = np.random.RandomState(n + p).uniform(0, 2, (n, p))
    tot, reads = emulate_totals(sq)
    ref = cuda_kneller.kneller_totals_plain(torch.from_numpy(sq)).numpy()
    assert not np.isnan(tot).any()
    assert rel(tot, ref) <= TOL
    assert reads.min() == 1
    assert reads.sum() - n <= n / 8
    if n % cuda_kneller.KNELLER_ROWS == 0:
        assert reads.max() == 1


@pytest.mark.parametrize("n", [1, 128, 1000, 65536, 65536 + 1, 2 ** 23])
def test_totals_split_runs(n):
    """One row block a run where r = 0, TOTALS_MIN_RUN where r > 0 (or
    all nb blocks if fewer); the runs cover the nb blocks."""
    run, runs, r = cuda_kneller.totals_split(n)
    nb = -(-n // cuda_kneller.KNELLER_ROWS)
    assert (runs - 1) * run < nb <= runs * run
    assert run == (min(cuda_kneller.TOTALS_MIN_RUN, nb) if r else 1)


def test_windows_deep_lags_without_cancellation():
    """The window sums at the deepest lags come out at the grade of the
    few squares they hold, not at eps·total: the plain version takes
    total - css[lag-1] as a suffix sum, as the kernel does."""
    n = 4096
    sq = np.full((n, 1), 1.0)
    sq[0] = sq[-1] = 1e-6
    corr = np.zeros((n, 1))
    out = cuda_kneller.kneller_windows(
        torch.from_numpy(sq), torch.from_numpy(corr),
        cuda_kneller.kneller_totals(torch.from_numpy(sq)), 1).numpy()
    assert out[n - 1, 0] == pytest.approx(2e-6, rel=1e-12)


def test_windows_rejects_mismatched_totals():
    sq = torch.ones((10, 2), dtype=torch.float64)
    tot = torch.ones((2, 2, 2), dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_kneller.kneller_windows(sq, sq, tot, 1)
    with pytest.raises(ValueError):
        cuda_kneller.einstein_assembly(sq, sq, "median", 1)


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("n,p,d", [(200, 6, 3), (65, 3, 2), (1, 2, 3)])
def test_einstein_difference_fft_vs_jax(n, p, d, reduce_mode):
    """The whole FFT path: per-series centering, the autocorrelation and
    the assembly, on an operand with a large mean offset."""
    a = np.random.RandomState(n + p).normal(50.0, 2.0, (n, p, d))
    got = einstein.einstein_difference_fft(a, reduce_mode, device="cpu")
    ref = np.asarray(jein.einstein_difference_fft(jnp.asarray(a),
                                                  reduce_mode))
    if n == 1:
        assert np.array_equal(got.numpy(), ref)
        return
    assert rel(got, ref) <= TOL


def test_einstein_difference_fft_corr_argument():
    """``corr=`` supplies the raw autocorrelation of an already centered
    operand; the result equals the one-call path."""
    a, _, corr = _centered_inputs(96, 4, 3, seed=3)
    full = einstein.einstein_difference_fft(a, "mean", device="cpu")
    given = einstein.einstein_difference_fft(a, "mean", corr=corr,
                                             device="cpu")
    assert rel(given, full) <= TOL


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


SHAPES = [(1024, 37, 3), (1000, 5, 3), (7, 2, 1), (4097, 4, 2),
          (129, 33, 3)]


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


def emulate_windows(sq: np.ndarray, corr: np.ndarray, tot: np.ndarray,
                    dfac: float):
    """K6b as ``csrc/kneller.cu`` runs it, in numpy, from its work split
    (``windows_split``, ``scan_tiles``, ``windows_lags``): the scan of
    ``tot`` into each tile's offsets, then each row lane's lags, walked
    from the last down. Returns out, the offsets, and how often each
    total and each row of sq was read and each row of out written."""
    n, p = sq.shape
    nb = tot.shape[1]
    sp = cuda_kneller.windows_split(n, p)
    tot_reads = np.zeros(nb, dtype=np.int64)
    sq_reads = np.zeros(n, dtype=np.int64)
    writes = np.zeros(n, dtype=np.int64)

    def tile_total(i):
        rows = slice(i * sp.g, min((i + 1) * sp.g, nb))
        tot_reads[rows] += 1
        return tot[:, rows].sum(1)

    # first launch: each segment's sum, its row lanes striding its rows
    seg = np.zeros((2, sp.segs, p))
    seg_rows = sp.segt * sp.g
    for s in range(sp.segs):
        for j in range(sp.lanes):
            rows = range(s * seg_rows, min((s + 1) * seg_rows, nb))[
                j::sp.lanes]
            tot_reads[rows.start:rows.stop:sp.lanes] += 1
            seg[:, s] += tot[:, rows.start:rows.stop:sp.lanes].sum(1)
    # second launch: the later segments' sums, then the segment's tiles,
    # a chunk of them a row lane, each lane on top of the later lanes
    off = np.full((2, sp.tiles, p), np.nan)
    for s in range(sp.segs):
        base = seg[:, s + 1:].sum(1)
        mine = [sum((tile_total(i) for i in cuda_kneller.scan_tiles(
            sp, s, j)), np.zeros((2, p))) for j in range(sp.lanes)]
        for j in range(sp.lanes):
            run = base + sum(mine[j + 1:], np.zeros((2, p)))
            for i in reversed(cuda_kneller.scan_tiles(sp, s, j)):
                assert np.isnan(off[:, i]).all()
                off[:, i] = run
                run = run + tile_total(i)
    # the windows: each row lane on top of the tile's offsets and the
    # later row lanes' sums of its forward and reversed rows
    out = np.full((n, p), np.nan)
    for y in range(sp.tiles):
        tile = cuda_kneller.windows_tile(sp, y)
        lags = [cuda_kneller.windows_lags(n, sp, tile, j)
                for j in range(sp.lanes)]
        own = [np.stack([sq[lg.start:lg.stop].sum(0),
                         sq[n - lg.stop:n - lg.start].sum(0)])
               for lg in lags]
        for j, lg in enumerate(lags):
            run = off[:, tile] + sum(own[j + 1:], np.zeros((2, p)))
            for lag in reversed(lg):
                sq_reads[lag] += 1
                sq_reads[n - 1 - lag] += 1
                writes[lag] += 1
                run = run + np.stack([sq[lag], sq[n - 1 - lag]])
                out[lag] = (0.0 if lag == 0 else
                            (run.sum(0) - 2.0 * corr[lag])
                            / ((n - lag) * dfac))
    return out, off, tot_reads, sq_reads, writes


WINDOW_NS = [1, 5, 127, 128, 129, 1000, 1151, 4097, 8192, 16383]


@pytest.mark.parametrize("segment", [cuda_kneller.WINDOWS_SEGMENT, 3])
@pytest.mark.parametrize("n", WINDOW_NS)
@pytest.mark.parametrize("p", [1, 4, 31, 33, 300])
def test_windows_replay_vs_plain(monkeypatch, n, p, segment):
    """K6b's split, replayed in numpy, at r = N mod R of 0, 1, R − 1 and
    between, N < R and narrow and wide P, with the default segments of
    the scan and with short ones (many segments): every lag written once, each
    tile's offsets the suffix sums of the totals past it, each total read
    three times and each row of sq twice, whatever nb is; the result
    equals kneller_windows_plain."""
    monkeypatch.setattr(cuda_kneller, "WINDOWS_SEGMENT", segment)
    rng = np.random.RandomState(n * 7 + p)
    sq = rng.uniform(0, 2, (n, p))
    corr = rng.normal(size=(n, p))
    tot = cuda_kneller.kneller_totals_plain(torch.from_numpy(sq)).numpy()
    out, off, tot_reads, sq_reads, writes = emulate_windows(sq, corr, tot, 3)
    sp = cuda_kneller.windows_split(n, p)
    suffix = np.stack([tot[:, (i + 1) * sp.g:].sum(1)
                       for i in range(sp.tiles)], axis=1)
    assert np.abs(off - suffix).max() <= TOL * tot.sum(1).max()
    assert np.all(writes == 1) and np.all(sq_reads == 2)
    assert np.all(tot_reads == 3)
    ref = cuda_kneller.kneller_windows_plain(
        torch.from_numpy(sq), torch.from_numpy(corr), 3).numpy()
    assert np.all(out[0] == 0.0)
    if n > 1:
        assert rel(out, ref) <= TOL


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("n,p,d", [(1000, 5, 3), (1151, 33, 3), (7, 2, 1)])
def test_windows_replay_vs_jax(n, p, d, reduce_mode):
    """The replayed K6b on centered inputs against the JAX package's
    ``einstein._einstein_fft_impl``."""
    _, sq, corr = _centered_inputs(n, p, d)
    tot = cuda_kneller.kneller_totals_plain(torch.from_numpy(sq)).numpy()
    out = emulate_windows(sq, corr, tot,
                          d if reduce_mode == "mean" else 1)[0]
    ref = np.asarray(jein._einstein_fft_impl(
        jnp.asarray(sq), reduce_mode, d, jnp.asarray(corr)))
    assert rel(out, ref) <= TOL


@pytest.mark.parametrize("n", [1, 128, 8193, 2 ** 23, 2 ** 23 + 1, 2 ** 24])
@pytest.mark.parametrize("p", [1, 4, 31, 33, 3680])
def test_windows_split_covers(n, p):
    """K6b's split alone, up to 2^24 frames (past grid y's 65,535 tiles
    at wide P): columns covered by the column tiles; tiles a whole number
    of K6a's row blocks, covering the lags, each taken once in the mirror
    order; segments covering the tiles,
    at most ``segt`` of them; every tile's offsets written by one row lane
    of the scan."""
    sp = cuda_kneller.windows_split(n, p)
    rows = cuda_kneller.KNELLER_ROWS
    assert sp.cols == min(32, 1 << (p - 1).bit_length()) == 1 << sp.log2c
    assert (sp.col_tiles - 1) * sp.cols < p <= sp.col_tiles * sp.cols
    assert sp.lanes * sp.cols == cuda_kneller.WINDOWS_THREADS
    assert sp.tile_rows == sp.g * rows == sp.lanes * cuda_kneller.WINDOWS_RUN
    assert (sp.tiles - 1) * sp.tile_rows < n <= sp.tiles * sp.tile_rows
    assert (sp.segs - 1) * sp.segt < sp.tiles <= sp.segs * sp.segt
    assert sp.segs <= sp.segt and sp.chunk * sp.lanes >= sp.segt
    grid = cuda_kneller._build.launch_grid(sp.col_tiles, sp.tiles)
    assert grid == (sp.col_tiles, min(sp.tiles, 65535))
    # row lanes of a tile, and tiles, abut; the last lag is N − 1
    for t in {0, sp.tiles // 2, sp.tiles - 1}:
        lags = [cuda_kneller.windows_lags(n, sp, t, j)
                for j in range(sp.lanes)]
        assert lags[0].start == min(t * sp.tile_rows, n)
        assert all(a.stop == b.start for a, b in zip(lags, lags[1:]))
        assert lags[-1].stop == min((t + 1) * sp.tile_rows, n)
    assert cuda_kneller.windows_lags(n, sp, sp.tiles - 1,
                                     sp.lanes - 1).stop == n
    order = [cuda_kneller.windows_tile(sp, y) for y in range(sp.tiles)]
    assert sorted(order) == list(range(sp.tiles))
    written = np.zeros(sp.tiles, dtype=np.int64)
    for s in range(sp.segs):
        for j in range(sp.lanes):
            tiles = cuda_kneller.scan_tiles(sp, s, j)
            written[tiles.start:tiles.stop] += 1
    assert np.all(written == 1)


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


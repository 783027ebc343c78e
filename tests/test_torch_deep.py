"""The port's multi-level FFT plan (transport_analysis_tpu_torch/ops/
cuda_fft.py) over the deep range, M > 65,536, against numpy and the JAX
package's deep composition (ops/deep_acf.py), and K2's work split.

On the CPU every level, the unpack and the epilogue run their plain
PyTorch versions through the orchestration the card runs, so these tests
check the plans, the index maps of three and more levels, the twiddles of
each level's sub-order and the epilogue's rows and columns; the kernels
are held against the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py). A small ``PLAN_LEVEL`` makes the
plan take three or four levels at M = 2^9 … 2^12, where the CPU is quick.

Bounds: 1e-12 of the maximum against numpy (the f64 grade of a length-M
transform); 1e-11 on lags < N/2 against the JAX deep composition (its
contract: it carries f32 pairs); bit equality where the same operations
run in the same order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import transport_analysis_tpu as jta  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu.core.trajectory import MemoryReader as JaxReader  # noqa: E402
from transport_analysis_tpu.ops import acf as jacf  # noqa: E402
from transport_analysis_tpu.ops import deep_acf  # noqa: E402
from transport_analysis_tpu_torch import _build, convert  # noqa: E402
from transport_analysis_tpu_torch.ops import acf, cuda_fft, einstein  # noqa: E402
from test_deep_acf import exact_fft_banded_pair  # noqa: E402

TOL = 1e-12
DEEP_TOL = 1e-11
F32_TOL = 1e-5   # complex64 replays: a few float32 roundings of each output


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.fixture
def small_levels(monkeypatch):
    """Plans of levels <= 8, so M = 2^9 … 2^12 takes three or four."""
    monkeypatch.setattr(cuda_fft, "PLAN_LEVEL", 8)


# ---------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------

def plan_launches(m, w, P, d):
    """(tile count, rows) of every launch the autocorrelation of an
    (N, P·d) operand packed into w columns makes at M: the forward levels,
    K2, the inverse levels and the epilogue, as autocorr_power_sum lays
    them out."""
    plan = cuda_fft.plan_levels(m)
    ph = (P + 1) // 2
    launches = [(tl.tiles, tl.groups) for tl in (
        cuda_fft.LevelTiles(a, n, c)
        for a, n, c, _, _ in cuda_fft.level_shapes(plan, w))]
    k2 = cuda_fft.UnpackTiles(m, plan[-1], w, P, d)
    launches.append((k2.tiles, k2.runs))
    *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
    launches += [(tl.tiles, tl.groups) for tl in (
        cuda_fft.LevelTiles(a, n, c) for a, n, c, _, _ in levels)]
    k5 = cuda_fft.LevelTiles(*last[:3], epilogue=True)
    launches.append((k5.tiles, k5.groups))
    return plan, launches


@pytest.mark.parametrize("bits", range(1, 29))
def test_plan_levels_cover_the_range(monkeypatch, bits):
    """Every power of two 2 … 2^28, past the old cap of 2^24: the levels
    multiply to M, each is a power of two within the kernels' maximum,
    and every launch of the EC width (w = 5,520, P = 3,680) and of a
    narrow width fits the grid (y folded at its limit, x within its own;
    at the EC width the first level's column tiles reach grid x's limit
    past 2^28, where the spectrum would take 24 TB)."""
    m = 1 << bits
    for w, P, d in ((5520, 3680, 3), (4, 8, 1)):
        plan, launches = plan_launches(m, w, P, d)
        assert np.prod(plan) == m and len(plan) >= 2
        assert all(1 <= n <= cuda_fft.MAX_LEVEL and not n & (n - 1)
                   for n in plan)
        for tiles, rows in launches:
            gx, gy = _build.launch_grid(tiles, rows)
            assert 1 <= gx <= _build.MAX_GRID_X
            assert 1 <= gy <= _build.MAX_GRID_Y
    monkeypatch.setattr(cuda_fft, "PLAN_LEVEL", 8)
    small = cuda_fft.plan_levels(m)
    assert np.prod(small) == m and max(small) <= 8


def test_plan_levels_rejects_outside_the_range():
    """The range ends at 2^53, where the roots' float64 angles stop being
    exact: M = 2^53 has a plan, 2^54 raises naming the limit."""
    assert cuda_fft.MAX_M == 2 ** 53
    plan = cuda_fft.plan_levels(cuda_fft.MAX_M)
    assert np.prod(plan, dtype=object) == 2 ** 53 and max(plan) <= 16
    with pytest.raises(ValueError, match=str(cuda_fft.MAX_M)):
        cuda_fft.plan_levels(2 * cuda_fft.MAX_M)
    for bad in (0, 1, 3 * 2 ** 20):
        with pytest.raises(ValueError):
            cuda_fft.plan_levels(bad)


def test_deep_operand_past_the_range_raises():
    """A series whose M is past the plan's range raises ValueError before
    anything is allocated for the transform (the operand is a meta
    tensor: it has a shape and no storage)."""
    x = torch.zeros((cuda_fft.MAX_M // 2 + 1, 1), dtype=torch.float64,
                    device="meta")
    with pytest.raises(ValueError, match="range"):
        acf.raw_autocorr_sumlast_flat(x, 1, 1)


def test_launch_grid_folds_y_and_bounds_x():
    assert _build.launch_grid(3, 65536) == (3, _build.MAX_GRID_Y)
    assert _build.launch_grid(1, 5) == (1, 5)
    with pytest.raises(ValueError):
        _build.launch_grid(_build.MAX_GRID_X + 1, 1)


# ---------------------------------------------------------------------
# (b) three and four levels against numpy and the JAX package
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n,P,d,levels", [(200, 3, 3, 3), (1000, 4, 1, 4),
                                          (2048, 2, 3, 4), (250, 5, 2, 3)])
def test_multi_level_autocorr_vs_numpy_and_jax(small_levels, n, P, d,
                                               levels):
    m = 2 * acf.next_pow_2(n)
    assert len(cuda_fft.plan_levels(m)) == levels
    x = np.random.RandomState(n + P).normal(0.5, 2.0, (n, P, d))
    got = acf.raw_autocorr_sumlast_flat(
        torch.from_numpy(x.reshape(n, P * d)), P, d).numpy()
    ref_np = acf.acf_fft_numpy(x) * (n - np.arange(n))[:, None]
    ref_jax = np.asarray(jacf._raw_autocorr_native_sumlast(jnp.asarray(x)))
    assert got.shape == (n, P)
    assert rel(got, ref_np) <= TOL
    assert rel(got, ref_jax) <= TOL


@pytest.mark.parametrize("m,b", [(512, 3), (4096, 2), (2 ** 13, 5)])
def test_multi_level_forward_vs_numpy(small_levels, m, b):
    z = crandn(np.random.RandomState(m), m, b)
    got = cuda_fft.fft_forward(torch.from_numpy(z))
    assert len(cuda_fft.plan_levels(m)) >= 3
    assert rel(got, np.fft.fft(z, axis=0)) <= TOL


@pytest.mark.parametrize("sign", [-1, +1])
def test_fft_level_sub_order_twiddle(sign):
    """A level inside a sub-transform of order R < M: the twiddle is
    W_R^(k·j'), j' = c // twiddle_cols."""
    a, n, c, order, tw = 3, 8, 12, 32, 3
    x = crandn(np.random.RandomState(11), a, n, c)
    got = cuda_fft.fft_level(torch.from_numpy(x), order, sign,
                             twiddle_cols=tw)
    k, j = np.arange(n), np.arange(n)
    ref = np.einsum("kj,ajc->kac",
                    np.exp(sign * 2j * np.pi * np.outer(k, j) / n), x)
    f = np.arange(c) // tw
    ref = ref * np.exp(sign * 2j * np.pi * np.outer(k, f) / order)[:, None]
    assert rel(got, ref) <= TOL


# ---------------------------------------------------------------------
# (c) the deep range against the JAX deep composition
# ---------------------------------------------------------------------

@pytest.fixture
def host_engine(monkeypatch):
    """The JAX deep chain with its engine stage replaced by the exact
    host-FFT stand-in of tests/test_deep_acf.py; its outer level and
    its Pallas unpack run in interpret mode on the CPU."""
    monkeypatch.setattr(deep_acf._pf, "fft_banded_pair",
                        exact_fft_banded_pair)


@pytest.mark.parametrize("n", [40000, 65536])
def test_deep_range_vs_jax_deep_composition(host_engine, n):
    """M = 2^17, P = 3 particles of d = 3: the port's default plan
    (three levels) against deep_acf.raw_autocorr_deep(..., sum_d=3) on
    lags < N/2 within 1e-11, and against numpy over every lag within
    1e-12; the JAX composition's full-range error is reported."""
    P, d = 3, 3
    m = 2 * acf.next_pow_2(n)
    assert m == 2 ** 17 and len(cuda_fft.plan_levels(m)) >= 3
    x = np.random.default_rng(n).standard_normal((n, P * d))
    got = acf.raw_autocorr_sumlast_flat(torch.from_numpy(x), P, d).numpy()
    ref = np.asarray(deep_acf.raw_autocorr_deep(jnp.asarray(x), n, m=m,
                                                sum_d=d))
    head = slice(0, n // 2)
    assert got.shape == ref.shape == (n, P)
    err_head = rel(got[head], ref[head])
    err_full = float(np.abs(got - ref).max() / np.abs(ref[head]).max())
    print(f"N={n}: port vs JAX deep {err_head:.3e} (lags < N/2), "
          f"{err_full:.3e} (all lags)")
    assert err_head <= DEEP_TOL
    ref_np = acf.acf_fft_numpy(x.reshape(n, P, d)) * (n - np.arange(n))[
        :, None]
    assert rel(got, ref_np) <= TOL


# ---------------------------------------------------------------------
# (d) K2 at a split that is not the plan's
# ---------------------------------------------------------------------

def unpack_oracle(z, P, d, n_top):
    """Direct numpy form of unpack_power_inva with top level n_top:
    Hermitian split, power spectra summed over components, particles
    (q, q+ph) packed as real and imaginary parts, then the inverse DFT
    over k_top of k = k_top·R + k_low and the twiddle W_M^(-k_low·dd),
    in (dd, k_low, q) order."""
    m, w = z.shape
    r = m // n_top
    ph = (P + 1) // 2
    zm = np.conj(z[(-np.arange(m)) % m])
    power = np.concatenate([np.abs((z + zm) / 2) ** 2,
                            np.abs((z - zm) / 2j) ** 2], axis=1)
    psum = power[:, : P * d].reshape(m, P, d).sum(-1) / m
    packed = np.zeros((m, ph), complex)
    packed.real = psum[:, :ph]
    packed.imag[:, : P - ph] = psum[:, ph:]
    dd = np.arange(n_top)
    inner = np.exp(2j * np.pi * np.outer(dd, np.arange(n_top)) / n_top)
    t = np.einsum("dk,kiq->diq", inner, packed.reshape(n_top, r, ph))
    return t * np.exp(2j * np.pi * np.outer(dd, np.arange(r)) / m)[:, :, None]


@pytest.mark.parametrize("m,n_top,P,d", [(256, 4, 3, 3), (256, 64, 4, 1),
                                         (512, 32, 5, 2), (128, 2, 2, 3)])
def test_unpack_power_inva_at_any_split(m, n_top, P, d):
    assert n_top != cuda_fft.plan_levels(m)[-1]
    w = (P * d + 1) // 2
    z = crandn(np.random.RandomState(m + n_top), m, w)
    z[m // 2 + 1:] = 0  # the k > M/2 half comes in only through the mirror
    got = cuda_fft.unpack_power_inva(torch.from_numpy(z), P, d, n_top)
    ref = unpack_oracle(z, P, d, n_top)
    assert got.shape == ref.shape == (n_top, m // n_top, (P + 1) // 2)
    assert rel(got, ref) <= TOL


def test_unpack_rejects_a_bad_top_level():
    z = torch.zeros((64, 2), dtype=torch.complex128)
    with pytest.raises(ValueError):
        cuda_fft.unpack_power_inva(z, 4, 1, n_top=3)


def particle_series(tl, q):
    """The series of pair q's two particles: q's d, then q + ph's (none
    when q + ph = P)."""
    first = [q * tl.d + c for c in range(tl.d)]
    if q + tl.ph < tl.P:
        return first, [(q + tl.ph) * tl.d + c for c in range(tl.d)]
    return first, []


def replay_unpack_split(m, n_top, P, d):
    """K2's work split (cuda_fft.UnpackTiles) as csrc/fft.cu runs it:
    every spectrum element is read by one block (at odd P the ``shift``
    columns a tile shares with its neighbour, and the wrap, by at most
    one more), every output (dd, k_low, q) is written once, the mirror
    row of each loaded row is one the block loads, k_low = 0 and R/2 are
    their own mirrors, and each particle's series are staged where the
    component sums read them. A block reads the rows of its k_lows and
    their mirrors (all k_top) at the columns of its tile, and writes the
    outputs of the same k_lows at the pairs of its tile, so the counts
    factor into columns by tile and k_low rows by run."""
    w = (P * d + 1) // 2
    tl = cuda_fft.UnpackTiles(m, n_top, w, P, d)
    r = m // n_top
    assert (tl.r, tl.ph, tl.pairs) == (r, (P + 1) // 2, r // 2 + 1)
    assert tl.shift == (0 if P % 2 == 0 else d // 2)
    assert 1 <= tl.tq <= cuda_fft.UNPACK_PAIRS
    assert tl.nj & (tl.nj - 1) == 0 and tl.ktc & (tl.ktc - 1) == 0
    assert n_top % tl.ktc == 0
    assert tl.smem <= cuda_fft.SMEM_LIMIT
    gx, gy = _build.launch_grid(tl.tiles, tl.runs)
    assert gx == tl.tiles and 1 <= gy <= _build.MAX_GRID_Y
    # columns by tile, and the pairs each tile writes
    col_reads = np.zeros(w, dtype=np.int64)
    q_writes = np.zeros(tl.ph, dtype=np.int64)
    for t in range(tl.tiles):
        c_lo, span, wrap = tl.columns(t)
        assert span >= 1 and wrap in (0, tl.shift)
        assert span + wrap <= tl.cols and c_lo + span <= w
        col_reads[c_lo:c_lo + span] += 1
        col_reads[:wrap] += 1
        pairs = tl.pairs_of(t)
        q_writes[pairs.start:pairs.stop] += 1
        for q in pairs:
            for half_of, series in zip((0, 1), particle_series(tl, q)):
                for s in series:
                    slot, half = tl.slot(t, s)
                    col = slot + c_lo if slot < span else slot - span
                    assert 0 <= slot < span + wrap
                    assert (col, half) == ((s, 0) if s < w else (s - w, 1))
    np.testing.assert_array_equal(q_writes, 1)
    if tl.shift == 0:
        np.testing.assert_array_equal(col_reads, 1)
    else:
        assert col_reads.min() == 1 and col_reads.max() <= 2
        assert (col_reads == 2).sum() <= tl.tiles * tl.shift
    # k_low rows by run: the runs' k_lows partition [0, R/2], and with
    # their mirrors they cover every k_low once, for reads and writes
    assert (tl.runs - 1) * tl.nj < tl.pairs <= tl.runs * tl.nj
    assert all(tl.klows(b) == range(b * tl.nj, min((b + 1) * tl.nj,
                                                     tl.pairs))
               for b in (0, tl.runs - 1))
    kl = np.arange(tl.pairs)
    mirror = cuda_fft.mirror_klow(kl, r)
    own = mirror == kl
    np.testing.assert_array_equal(own, (kl == 0) | (2 * kl == r))
    rows = np.bincount(np.concatenate([kl, mirror[~own]]), minlength=r)
    np.testing.assert_array_equal(rows, 1)
    for kt in range(n_top):
        k = kt * r + kl
        mk = (m - k) & (m - 1)
        np.testing.assert_array_equal(mk % r, mirror)
        np.testing.assert_array_equal(
            mk // r, np.where(kl == 0, (n_top - kt) % n_top, n_top - 1 - kt))
    return tl


UNPACK_SHAPES = [  # (name, M, n_top, P, d): the chip's shapes
    ("model", 2 ** 14, 8, 3680, 3), ("deep", 2 ** 17, 8, 3680, 3),
    ("depth", 2 ** 21, 8, 80, 3), ("top", 2 ** 24, 16, 4, 2),
    ("past the old range", 2 ** 25, 8, 4, 2)]


@pytest.mark.parametrize("name,m,n_top,P,d", UNPACK_SHAPES)
def test_unpack_split_at_the_chip_shapes(name, m, n_top, P, d):
    """Wide: column tiles of at most 32 pairs, spread evenly, and a few
    k_lows a block; narrow: every column and many k_lows a block, so
    every lane has work."""
    assert n_top == cuda_fft.plan_levels(m)[-1]
    tl = replay_unpack_split(m, n_top, P, d)
    if tl.ph > cuda_fft.UNPACK_PAIRS:
        assert tl.tiles == -(-tl.ph // cuda_fft.UNPACK_PAIRS) > 1
    else:
        assert tl.tiles == 1 and tl.nj * tl.cols >= 128


@pytest.mark.parametrize("d", range(1, 8))
@pytest.mark.parametrize("m,n_top,P", [(4096, 2, 1), (4096, 4, 3),
                                       (4096, 8, 7), (4096, 16, 65),
                                       (2 ** 12, 16, 131), (2 ** 13, 8, 130),
                                       (64, 16, 9), (16, 16, 5)])
def test_unpack_split_reads_each_row_once(m, n_top, P, d):
    """Odd and even P (odd P shifts the partners' imaginary halves by
    ph·d − w columns and wraps the last particle's upper components to
    the first columns), d = 1 … 7, n_top 2 … 16, and R = 1."""
    replay_unpack_split(m, n_top, P, d)


def unpack_replay(z, P, d, n_top):
    """K2's arithmetic replayed in numpy block by block from
    cuda_fft.UnpackTiles, as csrc/fft.cu runs it: each row pair's two
    halves' powers staged once, the component sums read from the staging
    slots, A1 and A2 over k_top from the real p1, p2, the low output
    tw·(A1 + i·A2) and the mirror's conj(tw)·(conj A1 + i·conj A2), tw
    the product of a fine and a coarse entry of the order-M table."""
    m, w = z.shape
    tl = cuda_fft.UnpackTiles(m, n_top, w, P, d)
    r, ph = tl.r, tl.ph
    roots = cuda_fft.unit_roots(m)
    fine = (1 << tl.fine_bits) - 1
    kt = np.arange(n_top)
    dd = np.arange(n_top)
    w_n = np.conj(roots[(np.outer(kt, dd) % n_top) * (m // n_top)])
    out = np.zeros((n_top, r, ph), dtype=complex)
    written = np.zeros(out.shape, dtype=np.int64)
    for t in range(tl.tiles):
        c_lo, span, wrap = tl.columns(t)
        cols = np.r_[c_lo:c_lo + span, 0:wrap]
        qs = np.array(tl.pairs_of(t))
        for b in range(tl.runs):
            kls = np.array(tl.klows(b))
            k = kt[:, None] * r + kls[None, :]
            a = z[k][:, :, cols]
            bm = z[(m - k) & (m - 1)][:, :, cols]
            staged = ((a.real + bm.real) ** 2 + (a.imag - bm.imag) ** 2,
                      (a.real - bm.real) ** 2 + (a.imag + bm.imag) ** 2)
            p = np.zeros((2, n_top, len(kls), len(qs)))
            for i, q in enumerate(qs):
                for h, series in enumerate(particle_series(tl, q)):
                    for s in series:
                        slot, half = tl.slot(t, s)
                        p[h, :, :, i] += staged[half][:, :, slot]
            p *= 0.25 / m
            a1 = np.einsum("kjq,kd->djq", p[0], w_n)
            a2 = np.einsum("kjq,kd->djq", p[1], w_n)
            e = (dd[:, None] * kls[None, :]) & (m - 1)
            tw = np.conj(roots[e & fine] * roots[e & ~fine])[:, :, None]
            out[np.ix_(dd, kls, qs)] = tw * (a1 + 1j * a2)
            written[np.ix_(dd, kls, qs)] += 1
            high = cuda_fft.mirror_klow(kls, r) != kls
            kh = r - kls[high]
            out[np.ix_(dd, kh, qs)] = (np.conj(tw[:, high])
                                       * (np.conj(a1[:, high])
                                          + 1j * np.conj(a2[:, high])))
            written[np.ix_(dd, kh, qs)] += 1
    np.testing.assert_array_equal(written, 1)
    return out


@pytest.mark.parametrize("m,n_top,P,d,pairs,stage", [
    (256, 8, 6, 3, 32, 2048), (256, 8, 7, 3, 2, 64), (512, 16, 9, 5, 2, 40),
    (256, 4, 13, 7, 4, 128), (128, 16, 4, 2, 32, 2048), (64, 64, 3, 1, 1, 8),
    (64, 2, 5, 4, 2, 16), (32, 32, 2, 1, 32, 2048)])
def test_unpack_replay_matches_the_plain_version(monkeypatch, m, n_top, P,
                                                  d, pairs, stage):
    """The kernel's arithmetic, on splits of several column tiles, k_low
    runs and staging passes (small UNPACK_PAIRS and UNPACK_STAGE), odd P
    with its wrap, R = 1 and 2: within 1e-12 of the plain version."""
    monkeypatch.setattr(cuda_fft, "UNPACK_PAIRS", pairs)
    monkeypatch.setattr(cuda_fft, "UNPACK_STAGE", stage)
    w = (P * d + 1) // 2
    z = crandn(np.random.RandomState(m + P + d), m, w)
    got = unpack_replay(z, P, d, n_top)
    ref = cuda_fft.unpack_power_inva_plain(torch.from_numpy(z), P, d,
                                           n_top).numpy()
    assert rel(got, ref) <= TOL


# ---------------------------------------------------------------------
# (e) K1's and K5's split: whole rows of A a block at narrow widths
# ---------------------------------------------------------------------

def bank_degree(addr):
    """The most distinct slab addresses (16-byte values) that the lanes of
    one quarter-warp send to one 16-byte bank group (address mod 8), per
    quarter-warp: ``addr`` (quarters, 8), −1 for an idle lane. Lanes on
    one address are one broadcast."""
    a = np.sort(addr, axis=1)
    fresh = np.ones(a.shape, dtype=bool)
    fresh[:, 1:] = a[:, 1:] != a[:, :-1]
    banks = np.where(fresh & (a >= 0), a % 8, -1 - np.arange(8))
    b = np.sort(banks, axis=1)
    run = np.ones(b.shape, dtype=np.int64)
    for i in range(1, 8):
        run[:, i] = np.where((b[:, i] == b[:, i - 1]) & (b[:, i] >= 0),
                             run[:, i - 1] + 1, 1)
    return run.max(axis=1)


def quarters(values, active, threads=256):
    """Per-item ``values`` laid out as the kernels' lanes take them (item
    idx on thread idx mod 256, so a quarter-warp holds eight consecutive
    items), −1 where the lane idles."""
    v = np.where(active, values, -1)
    pad = -len(v) % threads
    return np.concatenate([v, np.full(pad, -1)]).reshape(-1, 8)


def level_items(tl, rows, n_k, tile=0):
    """The DFT items of one block pass, as csrc/fft.cu enumerates them:
    over a group of ``rows`` rows of A (narrow) or one row and column
    tile ``tile`` (wide), for k < ``n_k``. Per item idx: k (K1 narrow:
    the first of k and k + n/2), its row a_l within the group, its
    column c, the slab address it reads at j = 0 (every lane adds the
    same j·tc at step j) and whether the lane has a column."""
    cols = tl.tc
    if tl.wide:
        k, cl = np.divmod(np.arange(n_k * cols), cols)
        c = tile * cols + cl
        return k, np.zeros_like(k), c, cl, c < tl.c
    width = rows * cols
    k, r = np.divmod(np.arange(n_k * width), width)
    al, c = np.divmod(r, cols)
    return k, al, c, al * tl.pitch + c, np.ones(len(k), dtype=bool)


def pair_count(tl):
    """K1's k of an item's first output: n/2 at a narrow level (the item
    also forms k + n/2), n at a wide one and at n = 1."""
    return tl.n // 2 if not tl.wide and tl.n > 1 else tl.n


def replay_level_split(a, n, c, P=None, n_rows=None, full=None):
    """K1's (``P`` None) or K5's work split (cuda_fft.LevelTiles) as
    csrc/fft.cu runs it: grid y strides so that every group of rows is
    taken by one block; the groups' rows partition A; a group stages each
    of its input elements once (narrow: its rows' contiguous run, row a_l
    at a_l·pitch, inside the slab); each output (k, a, c), or (lag, p)
    for K5, is written once, and K5's output lanes read only stage slots
    its sums wrote; and a quarter-warp's lanes send at most one address
    to a bank group, two where they straddle two values of k. The counts
    over every block are taken element by element when A·n·C is at most
    2^20 (``full``), else from one full and the last group, whose offsets
    are linear in the group's first row."""
    k5 = P is not None
    tl = cuda_fft.LevelTiles(a, n, c, epilogue=k5)
    n_out = min(n, -(-n_rows // a)) if k5 else n
    gx, gy = tl.grid
    assert 1 <= gx <= _build.MAX_GRID_X and 1 <= gy <= _build.MAX_GRID_Y
    assert tl.smem <= cuda_fft.SMEM_LIMIT
    if tl.columns:
        return replay_column_split(tl, full)
    assert tl.ra >= 1 and tl.ra & (tl.ra - 1) == 0
    if tl.wide:
        assert (tl.tc, tl.ra, tl.pitch) == (cuda_fft.tile_cols(n), 1,
                                            n * tl.tc)
        assert tl.tiles == -(-c // tl.tc) and tl.groups == a
    else:
        assert tl.tc == c and tl.tiles == 1 and c <= cuda_fft.tile_cols(n)
        assert tl.ra * n * c <= max(cuda_fft.LEVEL_SLAB, n * c)
        assert (tl.ra == 1 or tl.ra >= a
                or 2 * tl.ra * n * c > cuda_fft.LEVEL_SLAB)
        assert tl.pitch >= n * c
        if tl.ra > 1:
            assert tl.pitch % 8 == c % 8 and tl.pitch < n * c + 8
    # grid y: block y takes groups y, y + gy, …
    g = np.arange(gy)[:, None] + gy * np.arange(-(-tl.groups // gy))
    np.testing.assert_array_equal(
        np.bincount(g[g < tl.groups], minlength=tl.groups), 1)
    assert tl.rows(0).start == 0 and tl.rows(tl.groups - 1).stop == a
    assert all(len(tl.rows(i)) == tl.ra for i in range(min(tl.groups - 1, 4)))
    every = full if full is not None else a * n * c <= 2 ** 20
    groups = range(tl.groups) if every else sorted({0, tl.groups - 1})
    writes = np.zeros((n * a * c if not k5 else n_rows * P) if every else 0,
                      np.int64)
    half = n // 2 if pair_count(tl) < n else 0
    for grp in groups:
        a0, rows = tl.rows(grp).start, len(tl.rows(grp))
        for t in range(tl.tiles):
            if tl.wide:
                j, cl = np.divmod(np.arange(n * tl.tc), tl.tc)
                slots = (j * tl.tc + cl)[t * tl.tc + cl < c]
            else:
                i = np.arange(rows * n * c)
                slots = i + (i // (n * c)) * (tl.pitch - n * c)
                assert slots.max() < tl.ra * tl.pitch
            assert len(np.unique(slots)) == len(slots)
            k, al, col, addr, active = level_items(
                tl, rows, n_out if k5 else pair_count(tl), t)
            assert (k < n_out).all() and (al < rows).all()
            if k5:
                lag = k * a + a0 + al
                active = active & (lag < n_rows)
            deg = bank_degree(quarters(addr, active))
            kq = quarters(k, active)
            lo = np.where(kq >= 0, kq, kq.max(1)[:, None]).min(1)
            assert deg[kq.max(1) == lo].max(initial=1) == 1
            assert deg.max(initial=1) <= 2
            if not k5:
                dst = [k * a * c + (a0 + al) * c + col]
                if half:
                    dst.append(dst[0] + half * a * c)
            elif tl.wide:
                im = c + col < P
                dst = [lag * P + col, np.where(im, lag * P + c + col, -1)]
            else:
                # the sums' stage slots, then the output lanes
                width = rows * P
                staged = np.concatenate([
                    (k * width + al * P + col)[active],
                    (k * width + al * P + c + col)[active & (c + col < P)]])
                assert len(np.unique(staged)) == len(staged)
                ko, r = np.divmod(np.arange(n_out * width), width)
                live = ko * a + a0 + r // P < n_rows
                assert set(np.flatnonzero(live)) == set(staged)
                dst = [np.where(live, (ko * a + a0) * P + r, -1)]
                active = np.ones(len(r), dtype=bool)
            for d in dst:
                d = d[active & (d >= 0)]
                assert len(np.unique(d)) == len(d)
                if len(writes):
                    np.add.at(writes, d, 1)
                elif not k5:
                    # one pass's outputs: every (k, row, column) of it
                    assert len(d) * (2 if half else 1) == (
                        n * rows * min(tl.tc, c - t * tl.tc))
    if len(writes):
        np.testing.assert_array_equal(writes, 1)
    return tl


def replay_column_split(tl, full=None):
    """K1's column launch (cuda_fft.LevelTiles, ``columns``) as
    csrc/fft.cu runs it: blocks of ``tc`` threads (a multiple of 32, at
    most 256) over consecutive columns along grid x, rows of A along grid
    y, strided past its limit; thread (x, lane) of row a owns column
    c = x·tc + lane < C, reads in[a, j, c] for j < n and writes out[k, a,
    c] for k < n. Each output is written once; the lanes of a warp read
    one contiguous run of a row j; the last block holds a column."""
    a, n, c = tl.a, tl.n, tl.c
    assert tl.wide and n <= cuda_fft.COLUMN_LEVEL
    assert tl.tc == cuda_fft.column_block(c) and tl.tc % 32 == 0
    assert 64 <= tl.tc <= 256 and (tl.ra, tl.pitch, tl.smem) == (1, 0, 0)
    assert tl.tiles == -(-c // tl.tc) and tl.groups == a
    assert (tl.tiles - 1) * tl.tc < c
    gx, gy = tl.grid
    assert gx == tl.tiles
    g = np.arange(gy)[:, None] + gy * np.arange(-(-a // gy))
    np.testing.assert_array_equal(np.bincount(g[g < a], minlength=a), 1)
    cols = np.arange(gx * tl.tc)
    live = cols < c
    for warp in cols.reshape(-1, 32):
        run = warp[warp < c]
        if len(run):
            np.testing.assert_array_equal(run, np.arange(run[0],
                                                         run[0] + len(run)))
    every = full if full is not None else a * n * c <= 2 ** 20
    rows = range(a) if every else sorted({0, a - 1})
    writes = np.zeros(n * a * c if every else n * c, np.int64)
    for row in rows:
        k = np.arange(n)[:, None]
        dst = (k * a * c + row * c + cols[live][None, :]).ravel()
        if every:
            np.add.at(writes, dst, 1)
        else:
            assert len(np.unique(dst)) == n * c
    if every:
        np.testing.assert_array_equal(writes, 1)
    return tl


LEVEL_COLUMNS = [1, 2, 3, 4, 5, 16, 32, 40, 63, 64, 65, 120, 5520]


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 512])
@pytest.mark.parametrize("c", LEVEL_COLUMNS)
def test_level_split_replay(n, c):
    """K1 and K5 at C from 1 to the EC width, n = 2 … 512, A one row past
    two full groups (a short last group) and, for K5, odd and even P,
    every row formed and a ragged N."""
    ra = cuda_fft.LevelTiles(1 << 20, n, c).ra
    a = 2 * ra + 1
    tl = replay_level_split(a, n, c)
    assert tl.wide == (c > cuda_fft.tile_cols(n))
    for P in sorted({2 * c, 2 * c - 1}):
        for n_rows in sorted({a * n, max(1, a * n - 3)}):
            replay_level_split(a, n, c, P, n_rows)


LEVEL_CHIP_SHAPES = [  # (label, A, n, C): chip_smoke.py's narrow launches
    ("top forward 4", 65536, 16, 64), ("top forward 5", 2 ** 20, 16, 4),
    ("top inverse 3", 65536, 16, 32), ("past forward 5", 2 ** 19, 8, 32),
    ("past forward 6", 2 ** 22, 8, 4), ("past inverse 4", 2 ** 19, 8, 16)]
EPILOGUE_CHIP_SHAPES = [  # (label, A, n, ph, N, P)
    ("top", 2 ** 20, 16, 2, 2 ** 23, 4), ("past", 2 ** 22, 8, 2, 2 ** 24, 4),
    ("depth", 2 ** 18, 8, 40, 2 ** 20, 80)]


@pytest.mark.parametrize("label,a,n,c", LEVEL_CHIP_SHAPES)
def test_level_split_at_the_chip_shapes(label, a, n, c):
    """The narrow levels take whole rows, ra·C ≥ 64 outputs a k: no lane
    idles, where a 64-column tile left 60 of 64 idle at C = 4."""
    tl = replay_level_split(a, n, c)
    assert not tl.wide and tl.ra * c >= 64
    assert tl.ra * n * c == cuda_fft.LEVEL_SLAB


@pytest.mark.parametrize("label,a,n,ph,n_rows,P", EPILOGUE_CHIP_SHAPES)
def test_epilogue_split_at_the_chip_shapes(label, a, n, ph, n_rows, P):
    tl = replay_level_split(a, n, ph, P, n_rows)
    assert not tl.wide and tl.ra * P >= 64


@pytest.mark.parametrize("n,c,k5", [(16, 1, False), (8, 3, False),
                                    (2, 63, False), (512, 8, False),
                                    (16, 2, True), (8, 5, True)])
def test_level_split_past_grid_y(n, c, k5):
    """A past 65,535 groups of ra rows: grid y's blocks stride over the
    groups, each taken once."""
    ra = cuda_fft.LevelTiles(1 << 30, n, c, epilogue=k5).ra
    a = 65535 * ra + 5
    P = 2 * c - 1 if k5 else None
    tl = replay_level_split(a, n, c, P, a * n - 1 if k5 else None)
    assert tl.groups > tl.grid[1] == _build.MAX_GRID_Y


@pytest.mark.parametrize("n,c,k5", [(16, 4, False), (8, 40, False),
                                    (16, 130, False), (16, 2, True),
                                    (8, 3, True), (8, 70, True)])
def test_level_split_strided_element_by_element(monkeypatch, n, c, k5):
    """With grid y cut to 3 blocks, every block takes several groups; the
    writes and stages are counted over every block."""
    monkeypatch.setattr(_build, "MAX_GRID_Y", 3)
    ra = cuda_fft.LevelTiles(1 << 20, n, c, epilogue=k5).ra
    a = 7 * ra + 3
    P = 2 * c if k5 else None
    tl = replay_level_split(a, n, c, P, a * n - 5 if k5 else None, full=True)
    assert tl.grid[1] == 3 < tl.groups


def staged_slab(tl, x, a0, rows, tile):
    """The slab of one block pass, filled at the split's slots."""
    n, c = tl.n, tl.c
    slab = np.zeros(tl.ra * tl.pitch, dtype=complex)
    if tl.wide:
        cols = tile * tl.tc + np.arange(tl.tc)
        live = cols < c
        slab.reshape(n, tl.tc)[:, live] = x[a0][:, cols[live]]
    else:
        i = np.arange(rows * n * c)
        slab[i + (i // (n * c)) * (tl.pitch - n * c)] = x[
            a0:a0 + rows].reshape(-1)
    return slab


def dft_items(tl, slab, rts, addr, k):
    """Each item's sum over j of the slab value it reads at step j times
    rts[(j·k) mod n]."""
    j = np.arange(tl.n)
    return (slab[addr[:, None] + j[None, :] * tl.tc]
            * rts[(j[None, :] * k[:, None]) % tl.n]).sum(1)


def bit_reverse(k, bits):
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def dif_network(v, w):
    """csrc/fft.cu's dif_registers stage by stage: the n-point DFT of the
    list ``v`` (one array of columns per j) by radix-2 decimation in
    frequency, butterfly b of the stage of length ``length`` taking
    (lo, lo + half), j = b mod half, lo = (b // half)·length + j, to
    (x + y, (x − y)·w[j·n/length]), root index checked below n/2; returns
    the outputs in bit-reversed order."""
    n = len(v)
    v = list(v)
    length = n
    while length >= 2:
        half = length // 2
        for b in range(n // 2):
            j = b % half
            lo = (b // half) * length + j
            x, y = v[lo], v[lo + half]
            v[lo] = x + y
            t = j * (n // length)
            assert t < max(1, n // 2)
            v[lo + half] = x - y if j == 0 else (x - y) * w[t]
        length = half
    return v


def column_replay(x, m, sign, tw):
    """K1's column launch replayed in numpy block by block from
    cuda_fft.LevelTiles, in x's type: each block's live columns of row a
    (a thread each) read their n values, run the butterfly network of
    :func:`dif_network` on the level's roots W_n^(sign·t), t < n/2, from
    the order-m table, and output k, taken from register bitrev(k), times
    the twiddle W_m^(sign·k·(c // tw)) from the table."""
    a, n, c = x.shape
    tl = cuda_fft.LevelTiles(a, n, c, itemsize=x.itemsize)
    assert tl.columns
    roots = cuda_fft.unit_roots(m).astype(x.dtype)
    w = roots[np.arange(max(1, n // 2)) * (m // n)]
    if sign > 0:
        w, roots = np.conj(w), np.conj(roots)
    bits = n.bit_length() - 1
    out = np.full((n, a, c), np.nan, dtype=x.dtype)
    for row in range(a):
        for t in range(tl.tiles):
            cols = t * tl.tc + np.arange(tl.tc)
            cols = cols[cols < c]
            v = dif_network([x[row, j, cols] for j in range(n)], w)
            for k in range(n):
                y = v[bit_reverse(k, bits)]
                if tw and k:
                    f = cols // tw
                    y = np.where(f > 0, y * roots[(k * f) % m], y)
                out[k, row, cols] = y
    return out


def level_replay(x, m, sign, tw):
    """K1's arithmetic replayed in numpy pass by pass from
    cuda_fft.LevelTiles, as csrc/fft.cu runs it: the column launch by
    :func:`column_replay`; else the slab staged at the split's slots,
    each item's outputs k (and, narrow, k + n/2) the sum over j of the
    slab value it reads times the root, then the twiddle
    W_m^(sign·k·(c // tw)) from the order-m table."""
    a, n, c = x.shape
    tl = cuda_fft.LevelTiles(a, n, c, itemsize=x.itemsize)
    if tl.columns:
        return column_replay(x, m, sign, tw)
    roots = cuda_fft.unit_roots(m).astype(x.dtype)
    rts = roots[np.arange(n) * (m // n)]
    if sign > 0:
        rts, roots = np.conj(rts), np.conj(roots)
    out = np.full(n * a * c, np.nan, dtype=x.dtype)
    n_k = pair_count(tl)
    for g in range(tl.groups):
        a0, rows = tl.rows(g).start, len(tl.rows(g))
        for t in range(tl.tiles):
            slab = staged_slab(tl, x, a0, rows, t)
            k, al, col, addr, active = level_items(tl, rows, n_k, t)
            k, al, col, addr = (v[active] for v in (k, al, col, addr))
            for kk in ([k] if n_k == n else [k, k + n_k]):
                v = dft_items(tl, slab, rts, addr, kk)
                if tw:
                    f = col // tw
                    v = np.where((f > 0) & (kk > 0), v * roots[(kk * f) % m],
                                 v)
                out[kk * a * c + (a0 + al) * c + col] = v
    return out.reshape(n, a, c)


def epilogue_replay(t, n_rows, P, normalize):
    """K5's arithmetic replayed likewise: each (k, a_l, q)'s complex sum
    times the reciprocal of N − lag, its real part at column q and its
    imaginary part at ph + q (narrow: through the (k, a_l, p) stage that
    the output lanes copy out)."""
    a, n, ph = t.shape
    tl = cuda_fft.LevelTiles(a, n, ph, epilogue=True)
    n_out = min(n, -(-n_rows // a))
    rts = np.conj(cuda_fft.unit_roots(n))
    out = np.full(n_rows * P, np.nan)
    for g in range(tl.groups):
        a0, rows = tl.rows(g).start, len(tl.rows(g))
        for tile in range(tl.tiles):
            slab = staged_slab(tl, t, a0, rows, tile)
            k, al, col, addr, active = level_items(tl, rows, n_out, tile)
            lag = k * a + a0 + al
            keep = active & (lag < n_rows)
            k, al, col, addr, lag = (v[keep] for v in (k, al, col, addr,
                                                       lag))
            v = dft_items(tl, slab, rts, addr, k)
            if normalize:
                v = v * (1.0 / (n_rows - lag))
            im = ph + col < P
            if tl.wide:
                out[lag * P + col] = v.real
                out[(lag * P + ph + col)[im]] = v.imag[im]
                continue
            width = rows * P
            stage = np.full(n_out * width, np.nan)
            row = k * width + al * P
            stage[row + col] = v.real
            stage[(row + ph + col)[im]] = v.imag[im]
            ko, r = np.divmod(np.arange(n_out * width), width)
            live = ko * a + a0 + r // P < n_rows
            out[((ko * a + a0) * P + r)[live]] = stage[live]
    return out.reshape(n_rows, P)


LEVEL_REPLAY_CASES = [
    (33, 16, 4, 16 * 64, 1), (17, 8, 3, 8, 0), (5, 16, 63, 256, 9),
    (9, 16, 65, 1024, 5), (3, 512, 8, 512, 0), (131, 2, 1, 64, 1),
    (4, 16, 40, 2 ** 12, 8), (2, 8, 120, 2 ** 10, 3), (7, 1, 3, 8, 0),
    # column launches, ragged C, with and without the twiddle
    (3, 2, 70, 64, 7), (2, 4, 99, 4, 0), (5, 4, 130, 256, 13),
    (3, 8, 65, 8, 0), (4, 8, 161, 512, 23), (2, 16, 67, 16, 0),
    (3, 16, 300, 2 ** 12, 30), (2, 1, 97, 2, 0),
    # the slab launch: wide levels past COLUMN_LEVEL
    (3, 32, 130, 64, 0), (2, 32, 130, 2 ** 10, 13)]


def check_level_replay(a, n, c, m, tw, sign, dtype, tol):
    x = crandn(np.random.RandomState(a + n + c), a, n, c).astype(dtype)
    tl = cuda_fft.LevelTiles(a, n, c)
    assert tl.columns == (c > cuda_fft.tile_cols(n) and n <= 16)
    got = level_replay(x, m, sign, tw)
    ref = cuda_fft.fft_level_plain(torch.from_numpy(x), m, sign, tw).numpy()
    assert got.dtype == ref.dtype == dtype
    assert rel(got, ref) <= tol


@pytest.mark.parametrize("a,n,c,m,tw", LEVEL_REPLAY_CASES)
@pytest.mark.parametrize("sign", [-1, +1])
def test_level_replay_matches_the_plain_version(a, n, c, m, tw, sign):
    """K1's arithmetic at narrow, column and slab splits, short last
    groups and ragged last blocks, with and without the twiddle, n = 1 …
    512: within 1e-12 of fft_level_plain."""
    check_level_replay(a, n, c, m, tw, sign, np.complex128, TOL)


@pytest.mark.parametrize("a,n,c,m,tw", LEVEL_REPLAY_CASES)
@pytest.mark.parametrize("sign", [-1, +1])
def test_level_replay_f32_matches_the_plain_version(a, n, c, m, tw, sign):
    """The same in complex64 (the float32 work mode: float32 roots and
    arithmetic): within 1e-5 of fft_level_plain, a few float32 roundings
    of each output."""
    check_level_replay(a, n, c, m, tw, sign, np.complex64, F32_TOL)


@pytest.mark.parametrize("a,n,ph,n_rows", [
    (65, 16, 2, 65 * 8), (33, 8, 3, 33 * 8 - 5), (9, 16, 5, 40),
    (3, 8, 63, 3 * 8), (5, 16, 65, 77), (129, 2, 1, 200), (6, 8, 40, 47)])
@pytest.mark.parametrize("normalize", [False, True])
def test_epilogue_replay_matches_the_plain_version(a, n, ph, n_rows,
                                                   normalize):
    """K5's arithmetic, odd P and even, normalize both ways, rows past N
    skipped: within 1e-12 of inverse_last_level_plain."""
    t = crandn(np.random.RandomState(a * ph + n), a, n, ph)
    for P in sorted({2 * ph, max(1, 2 * ph - 1)}):
        got = epilogue_replay(t, n_rows, P, normalize)
        ref = cuda_fft.inverse_last_level_plain(
            torch.from_numpy(t), n_rows, P, normalize).numpy()
        assert rel(got, ref) <= TOL, P


# ---------------------------------------------------------------------
# (f) the epilogue
# ---------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("a,n,P,n_rows", [(16, 8, 5, 100), (4, 32, 6, 128),
                                          (2, 1, 1, 1), (8, 16, 7, 65)])
def test_epilogue_plain_is_the_cat_and_multiply_form(normalize, a, n, P,
                                                     n_rows):
    """inverse_last_level_plain equals, bit for bit, the form it replaces:
    the level, its rows < N, real and imaginary halves side by side, times
    1/(N − lag) formed as ops/acf.py formed it."""
    ph = (P + 1) // 2
    t = torch.from_numpy(crandn(np.random.RandomState(n_rows), a, n, ph))
    got = cuda_fft.inverse_last_level(t, n_rows, P, normalize)
    rows = -(-n_rows // a)
    r = cuda_fft.fft_level(t, 4 * n, +1)[:rows].reshape(rows * a, ph)
    r = r[:n_rows]
    want = torch.cat([r.real, r.imag[:, : P - ph]], dim=1)
    if normalize:
        inv = 1.0 / (n_rows - torch.arange(n_rows, dtype=torch.float64))
        want = want * inv[:, None]
    assert got.dtype == torch.float64 and got.shape == (n_rows, P)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [100, 5000, 40000])
def test_acf_fft_is_raw_times_reciprocal(n):
    """The normalizing epilogue gives acf_fft bit for bit what the raw
    autocorrelation times 1/(N − lag) gave before it."""
    x = torch.from_numpy(np.random.RandomState(n).normal(0, 2.0, (n, 2, 3)))
    got = acf.acf_fft(x)
    inv = 1.0 / (n - torch.arange(n, dtype=torch.float64))
    assert torch.equal(got, acf.raw_autocorr_sumlast(x) * inv[:, None])


def test_epilogue_rejects_mismatched_columns():
    t = torch.zeros((4, 8, 3), dtype=torch.complex128)
    with pytest.raises(ValueError):
        cuda_fft.inverse_last_level(t, 10, 7)
    with pytest.raises(ValueError):
        cuda_fft.inverse_last_level(t, 33, 6)


# ---------------------------------------------------------------------
# the Helfand feed
# ---------------------------------------------------------------------

def test_in_place_einstein_matches_the_copying_form():
    a = np.random.RandomState(3).normal(5.0, 2.0, (300, 4, 3))
    want = einstein.einstein_difference_fft(a, device="cpu")
    owned = torch.from_numpy(a.copy())
    got = einstein.einstein_difference_fft_(owned)
    assert torch.equal(got, want)
    assert float(owned.mean(0).abs().max()) <= 1e-12 * float(np.abs(a).max())
    with pytest.raises(TypeError):
        einstein.einstein_difference_fft_(torch.from_numpy(a).transpose(0, 1))


# ---------------------------------------------------------------------
# (g) the models at N = 40,000 against the JAX package
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def deep_systems():
    """A 5-atom system of 40,000 frames (M = 2^17) in both packages."""
    rng = np.random.RandomState(40000)
    n, n_atoms = 40000, 5
    vel = rng.normal(0, 10, (n, n_atoms, 3)).astype(np.float32)
    pos = (rng.uniform(0, 20, (1, n_atoms, 3))
           + np.cumsum(vel, axis=0) * 0.01).astype(np.float32)
    box = np.array([20.0, 20.0, 20.0, 90.0, 90.0, 90.0])
    masses = np.array([12.011, 15.999, 1.008, 1.008, 15.999])
    ju = jta.Universe.empty(n_atoms, n_residues=n_atoms,
                            atom_resindex=np.arange(n_atoms))
    ju.add_TopologyAttr("masses", masses)
    ju.load_new(JaxReader(pos, velocities=vel,
                          dimensions=np.tile(box, (n, 1))))
    pu = convert.universe_from_arrays(n_atoms, {"masses": masses}, pos,
                                      velocities=vel, dimensions=box)
    return ju, pu


def test_vacf_deep_vs_jax(deep_systems):
    ju, pu = deep_systems
    ref = jta.VelocityAutocorr(ju.atoms).run()
    got = ta.VelocityAutocorr(pu.atoms, device="cpu").run()
    assert got.results.timeseries.shape == (40000,)
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.vacf_by_particle,
               ref.results.vacf_by_particle) <= TOL
    assert got.self_diffusivity_gk() == pytest.approx(
        ref.self_diffusivity_gk(), rel=1e-10)


def test_helfand_deep_vs_jax(deep_systems):
    ju, pu = deep_systems
    ref = jta.ViscosityHelfand(ju.atoms, linear_fit_window=(10, 400)).run()
    got = ta.ViscosityHelfand(pu.atoms, linear_fit_window=(10, 400),
                              device="cpu").run()
    assert got.results.timeseries.shape == (40000,)
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    # per particle, the last lags divide by N − lag → 1 and carry the
    # absolute error floor of both packages (each 1e-12 off host f64
    # there), so the bound holds on lags < N/2
    head = slice(0, 20000)
    assert rel(got.results.visc_by_particle[head],
               ref.results.visc_by_particle[head]) <= TOL
    assert got.results.viscosity == pytest.approx(ref.results.viscosity,
                                                  rel=1e-10)

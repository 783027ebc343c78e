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
    launches = [(-(-c // cuda_fft.tile_cols(n)), a)
                for a, n, c, _, _ in cuda_fft.level_shapes(plan, w)]
    k2 = cuda_fft.UnpackTiles(m, plan[-1], w, P, d)
    launches.append((k2.tiles, k2.runs))
    launches += [(-(-c // cuda_fft.tile_cols(n)), a)
                 for a, n, c, _, _ in cuda_fft.level_shapes(
                     plan[:-1], ph, a0=plan[-1])]
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
# (e) the epilogue
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
# (f) the models at N = 40,000 against the JAX package
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

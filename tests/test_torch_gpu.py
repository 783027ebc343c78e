"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA Hopper card and skips without one; the
file imports no jax, so on a machine with the card and no jax run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bound: 1e-12 of the maximum, as in the CPU tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from transport_analysis_tpu_torch.models import VelocityAutocorr  # noqa: E402
from transport_analysis_tpu_torch.ops import (  # noqa: E402
    acf, cuda_fft, cuda_kneller, cuda_lag)
from transport_analysis_tpu_torch import convert  # noqa: E402

TOL = 1e-12
pytestmark = pytest.mark.gpu


def rel(got, ref) -> float:
    got, ref = got.cpu(), ref.cpu()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA Hopper card: run on the H100 with "
                    "python -m pytest tests/test_torch_gpu.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def crandn(rng, device, *shape):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.from_numpy(z).to(device)


@pytest.mark.parametrize("m,b", [(2, 3), (16, 5), (4096, 7), (2 ** 16, 3),
                                 (2 ** 17, 3), (2 ** 21, 2), (2 ** 24, 2),
                                 (2 ** 25, 2)])
def test_fft_kernels_vs_plain(cuda_device, m, b):
    """K1 (every forward level of the plan, and the inverse levels), K2
    and the K5 epilogue against their plain versions from M = 2 to 2^25,
    past the old cap of 2^24; there the last levels have A > 65,535 rows
    and K2 more than 65,535 runs of k_low, so the grid fold runs."""
    rng = np.random.RandomState(m % 1000)
    z = crandn(rng, cuda_device, m, b)
    got = cuda_fft.fft_forward(z)
    assert rel(got, torch.fft.fft(z, dim=0)) <= TOL
    del z, got
    plan = cuda_fft.plan_levels(m)
    P, d = b, 2
    w = (P * d + 1) // 2
    ph = (P + 1) // 2
    spec = crandn(rng, cuda_device, m, w)
    got = cuda_fft.unpack_power_inva(spec, P, d)
    ref = cuda_fft.unpack_power_inva_plain(spec, P, d)
    assert got.shape == (plan[-1], m // plan[-1], ph)
    assert rel(got, ref) <= TOL
    del spec
    *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
    for a, n, c, order, tw in levels:
        got = cuda_fft.fft_level(got.reshape(a, n, c), order, +1,
                                 twiddle_cols=tw)
        ref = cuda_fft.fft_level_plain(ref.reshape(a, n, c), order, +1,
                                       twiddle_cols=tw)
        assert rel(got, ref) <= TOL
    a, n, c, _, _ = last
    n_rows = max(1, m // 2 - 3)
    for normalize in (False, True):
        out = cuda_fft.inverse_last_level(got.reshape(a, n, c), n_rows, P,
                                          normalize)
        want = cuda_fft.inverse_last_level_plain(ref.reshape(a, n, c),
                                                 n_rows, P, normalize)
        assert out.shape == (n_rows, P)
        assert rel(out, want) <= TOL


# K1's and K5's narrow launches (cuda_fft.LevelTiles: ra rows of A a
# block) at chip_smoke.py's shapes: (A, n, C) of the top (M = 2^24) and
# past (M = 2^25) forward and inverse levels on 8 series, and the depth
# epilogue's (80 atoms, M = 2^21).
NARROW_LEVELS = [(2 ** 20, 16, 4), (65536, 16, 64), (65536, 16, 32),
                 (2 ** 22, 8, 4), (2 ** 19, 8, 32), (2 ** 19, 8, 16)]
NARROW_EPILOGUES = [(2 ** 20, 16, 2), (2 ** 22, 8, 2), (2 ** 18, 8, 40)]


def level_cases(n, c, sign):
    """The level's twiddle of sub-order 64·n over columns of 1 (every
    column its own factor) and none."""
    return [(64 * n, 1), (n, 0)] if sign < 0 else [(64 * n, 1)]


@pytest.mark.parametrize("a,n,c", NARROW_LEVELS)
def test_level_kernel_at_the_narrow_launches(cuda_device, a, n, c):
    rng = np.random.RandomState(a % 997 + c)
    x = crandn(rng, cuda_device, a, n, c)
    tl = cuda_fft.LevelTiles(a, n, c)
    assert not tl.wide and tl.ra * n * c <= cuda_fft.LEVEL_SLAB
    for sign in (-1, +1):
        for m, tw in level_cases(n, c, sign):
            before = cuda_fft.fft_level.launches
            got = cuda_fft.fft_level(x, m, sign, twiddle_cols=tw)
            assert cuda_fft.fft_level.launches == before + 1
            ref = cuda_fft.fft_level_plain(x, m, sign, twiddle_cols=tw)
            assert rel(got, ref) <= TOL, (sign, tw)


@pytest.mark.parametrize("n", [2, 8, 16])
@pytest.mark.parametrize("c", [1, 2, 3, 5, 63, 65])
def test_level_kernel_narrow_ragged(cuda_device, n, c):
    """C below, at and past the tile (65 is wide at n ≤ 64), A one row
    past a multiple of ra (a short last group), both signs, a twiddle of
    sub-order 64·n."""
    ra = cuda_fft.LevelTiles(1 << 20, n, c).ra
    a = 3 * ra + 1
    x = crandn(np.random.RandomState(n * c), cuda_device, a, n, c)
    for sign in (-1, +1):
        for m, tw in level_cases(n, c, sign):
            got = cuda_fft.fft_level(x, m, sign, twiddle_cols=tw)
            ref = cuda_fft.fft_level_plain(x, m, sign, twiddle_cols=tw)
            assert rel(got, ref) <= TOL, (sign, tw)


@pytest.mark.parametrize("n,c", [(16, 1), (8, 3), (2, 63)])
def test_level_kernel_past_grid_y(cuda_device, n, c):
    """More than 65,535 groups of ra rows: blocks stride over them."""
    tl = cuda_fft.LevelTiles(1 << 30, n, c)
    a = 65535 * tl.ra + 5
    tl = cuda_fft.LevelTiles(a, n, c)
    assert tl.groups > tl.grid[1] == 65535
    x = crandn(np.random.RandomState(c), cuda_device, a, n, c)
    got = cuda_fft.fft_level(x, 64 * n, +1, twiddle_cols=1)
    assert rel(got, cuda_fft.fft_level_plain(x, 64 * n, +1, 1)) <= TOL


def epilogue_check(t, n_rows, P):
    for normalize in (False, True):
        before = cuda_fft.inverse_last_level.launches
        got = cuda_fft.inverse_last_level(t, n_rows, P, normalize)
        assert cuda_fft.inverse_last_level.launches == before + 1
        want = cuda_fft.inverse_last_level_plain(t, n_rows, P, normalize)
        assert got.shape == (n_rows, P)
        assert rel(got, want) <= TOL, normalize


@pytest.mark.parametrize("a,n,ph", NARROW_EPILOGUES)
def test_epilogue_kernel_at_the_narrow_launches(cuda_device, a, n, ph):
    """N of chip_smoke.py's runs (A·n/2: half the rows formed) and one
    row past a multiple of A, odd P and even."""
    t = crandn(np.random.RandomState(a % 991 + ph), cuda_device, a, n, ph)
    for P in (2 * ph, 2 * ph - 1):
        for n_rows in (a * n // 2, 3 * a + 1):
            epilogue_check(t, n_rows, P)


@pytest.mark.parametrize("n", [2, 8, 16])
@pytest.mark.parametrize("ph", [1, 2, 3, 5, 63, 65])
def test_epilogue_kernel_narrow_ragged(cuda_device, n, ph):
    """A one row past a multiple of ra, odd and even P, N at every row,
    at a ragged row count and within the first k."""
    ra = cuda_fft.LevelTiles(1 << 20, n, ph, epilogue=True).ra
    a = 3 * ra + 1
    t = crandn(np.random.RandomState(n + ph), cuda_device, a, n, ph)
    for P in sorted({2 * ph, max(1, 2 * ph - 1)}):
        for n_rows in sorted({a * n, a * n - 3, a + 2, 1}):
            epilogue_check(t, n_rows, P)


@pytest.mark.parametrize("n,ph", [(16, 2), (8, 5)])
def test_epilogue_kernel_past_grid_y(cuda_device, n, ph):
    tl = cuda_fft.LevelTiles(1 << 30, n, ph, epilogue=True)
    a = 65535 * tl.ra + 3
    tl = cuda_fft.LevelTiles(a, n, ph, epilogue=True)
    assert tl.groups > tl.grid[1] == 65535
    t = crandn(np.random.RandomState(n), cuda_device, a, n, ph)
    epilogue_check(t, a * n - 1, 2 * ph - 1)


@pytest.mark.parametrize("n,P,d", [(1, 1, 1), (100, 3, 3), (4097, 5, 2)])
def test_autocorrelation_vs_host(cuda_device, n, P, d):
    x = np.random.RandomState(n).normal(0.5, 2.0, (n, P, d))
    got = acf.acf_fft(torch.from_numpy(x).to(cuda_device))
    ref = torch.from_numpy(acf.acf_fft_numpy(x))
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("n,P,d", [(40000, 3, 3), (2 ** 20, 2, 3),
                                   (2 ** 23, 1, 3), (2 ** 20 + 1, 4, 2),
                                   (2 ** 17 + 1, 80, 3), (2 ** 23, 4, 2)])
def test_deep_autocorrelation_vs_host(cuda_device, n, P, d):
    """The deep range, M = 2^17 … 2^24, 8 series and 80 atoms (narrow
    levels and epilogues), on lags < N/2: past them
    the division by N − lag → 1 lifts both sides' absolute error floor,
    about eps·N of the maximum, into view."""
    x = np.random.RandomState(n % 1000).normal(0.5, 2.0, (n, P, d))
    got = acf.acf_fft(torch.from_numpy(x).to(cuda_device))
    ref = torch.from_numpy(acf.acf_fft_numpy(x))
    assert got.shape == (n, P)
    assert rel(got[: n // 2], ref[: n // 2]) <= TOL


@pytest.mark.parametrize("n,p,d", [(1024, 37, 3), (1000, 5, 3), (7, 2, 1),
                                   (8192, 300, 3), (2 ** 23, 3, 3),
                                   (2 ** 20 + 1, 4, 2), (131, 1, 3),
                                   (8193, 33, 3), (2 ** 23, 4, 2),
                                   (2 ** 23 + 1, 33, 1)])
def test_kneller_kernels_vs_plain(cuda_device, n, p, d):
    """K6a and K6b, narrow and wide, ragged N, one column, and past grid
    y's 65,535 tiles (2^23 + 1 frames at 33 columns); K6b counts its
    three launches (the scan's two and the windows)."""
    rng = np.random.RandomState(n)
    sq = torch.from_numpy(rng.uniform(0, 2, (n, p))).to(cuda_device)
    corr = torch.from_numpy(rng.normal(size=(n, p))).to(cuda_device)
    tot = cuda_kneller.kneller_totals(sq)
    assert rel(tot, cuda_kneller.kneller_totals_plain(sq)) <= TOL
    before = cuda_kneller.kneller_windows.launches
    got = cuda_kneller.kneller_windows(sq, corr, tot, d)
    assert cuda_kneller.kneller_windows.launches == before + 3
    assert rel(got, cuda_kneller.kneller_windows_plain(sq, corr, d)) <= TOL
    assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("n,p", [(4096, 1), (2 ** 20 + 3, 4), (70000, 33)])
def test_windows_deep_lags_without_cancellation_on_card(cuda_device, n, p):
    """The card's window sums at the deepest lags come out at the grade
    of the few squares they hold, not at eps·total: every part of K6b's
    sums (offsets, later row lanes, own rows) is a sum of later terms."""
    sq = torch.ones((n, p), dtype=torch.float64, device=cuda_device)
    sq[0] = sq[-1] = 1e-6
    corr = torch.zeros_like(sq)
    out = cuda_kneller.kneller_windows(
        sq, corr, cuda_kneller.kneller_totals(sq), 1)
    assert torch.allclose(out[n - 1], torch.full_like(out[n - 1], 2e-6),
                          rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("n,p", [
    *[(n, p) for n in (1, 127, 128, 129, 1000, 8192) for p in (1, 37, 300)],
    (2 ** 23, 1), (2 ** 23, 37)])
def test_kneller_totals_one_read_vs_plain(cuda_device, n, p):
    """K6a's lo/hi split at r = 0, 1, R − 1 and N < R, and past grid y's
    limit in runs (2^23 frames; at 300 columns the plain version would
    need about 60 GB)."""
    sq = torch.rand((n, p), dtype=torch.float64, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(n + p))
    tot = cuda_kneller.kneller_totals(sq)
    assert rel(tot, cuda_kneller.kneller_totals_plain(sq)) <= TOL


@pytest.mark.parametrize("n,p", [(1000, 45), (300, 32), (9, 33), (16, 3),
                                 (143, 64)])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lag_einstein_tiles_vs_plain(cuda_device, n, p, d, dtype):
    """K8's einstein mode around its CTA's lag span (span − 1, span,
    span + 1), at 1 and N lags, with N below one frame tile and P not a
    multiple of the particle tile."""
    rng = np.random.RandomState(n * d + p)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (n, p, d))).to(
        cuda_device, dtype)
    span = cuda_lag.SPAN
    for n_lags in sorted({1, span - 1, span, span + 1, n} & set(
            range(1, n + 1))):
        for reduce_mode in ("mean", "sum"):
            got = cuda_lag.lag_sums(x, n_lags, "einstein", reduce_mode,
                                    out_dtype=torch.float64)
            ref = cuda_lag.lag_sums_plain(x, n_lags, "einstein", reduce_mode,
                                          out_dtype=torch.float64)
            assert got.shape == (n_lags, p) and torch.all(got[0] == 0.0)
            if n_lags > 1:
                assert rel(got, ref) <= TOL, (n_lags, reduce_mode)


@pytest.mark.parametrize("n,p,d", [(1, 1, 1), (37, 5, 3), (1000, 130, 1),
                                   (2053, 257, 3), (300, 129, 2), (5, 3, 1),
                                   (5, 3, 2), (45, 3, 3), (45, 2, 2),
                                   (1100, 3, 1), (1100, 3, 2), (1100, 3, 3),
                                   (2100, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lag_kernel_vs_plain(cuda_device, n, p, d, dtype):
    """K8 at ragged shapes, both modes, float64 sums (of float32 samples,
    the float64 work mode's, or of float64 ones): N below the acf mode's
    16 frame phases, not a multiple of them, of its 1,024-frame chunk or
    of the einstein lag block; n_lags of 1, 17, the acf CTA's most lags
    and one either side of it (spans of unequal work), and N."""
    rng = np.random.RandomState(n + p)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (n, p, d))).to(
        cuda_device, dtype)
    span = cuda_lag.ACF_SPAN
    for n_lags in sorted({1, 17, span - 1, span, span + 1, n}
                         & set(range(1, n + 1))):
        for mode, reduce_mode in (("acf", "sum"), ("einstein", "mean"),
                                  ("einstein", "sum")):
            got = cuda_lag.lag_sums(x, n_lags, mode, reduce_mode,
                                    out_dtype=torch.float64)
            ref = cuda_lag.lag_sums_plain(x, n_lags, mode, reduce_mode,
                                          out_dtype=torch.float64)
            assert got.shape == (n_lags, p) and got.dtype == torch.float64
            if mode == "einstein":
                assert torch.all(got[0] == 0.0)
            if n_lags > 1 or mode == "acf":
                assert rel(got, ref) <= TOL, (n_lags, mode, reduce_mode)


def test_model_on_card_vs_cpu(cuda_device):
    rng = np.random.RandomState(0)
    vel = rng.normal(0, 10, (300, 4, 3))
    u = convert.universe_from_arrays(4, {"masses": np.ones(4)},
                                     rng.normal(size=(300, 4, 3)),
                                     velocities=vel)
    gpu = VelocityAutocorr(u.atoms, device=cuda_device).run()
    cpu = VelocityAutocorr(u.atoms, device="cpu").run()
    ts_gpu = torch.from_numpy(gpu.results.timeseries)
    assert rel(ts_gpu, torch.from_numpy(cpu.results.timeseries)) <= TOL


def test_vacf_past_the_old_plan_range(cuda_device):
    """VelocityAutocorr(fft=True) at 2^23 + 1 frames (M = 2^25, once past
    the plan's range) against the card's own rfft/irfft autocorrelation
    of the same velocities, within 1e-11 on lags < N/2."""
    n, n_atoms = 2 ** 23 + 1, 2
    rng = np.random.RandomState(25)
    vel = rng.normal(0, 10, (n, n_atoms, 3)).astype(np.float32)
    u = convert.universe_from_arrays(n_atoms, {"masses": np.ones(n_atoms)},
                                     np.zeros_like(vel), velocities=vel)
    got = VelocityAutocorr(u.atoms, device=cuda_device).run()
    assert got.results.vacf_by_particle.shape == (n, n_atoms)
    v = torch.from_numpy(vel).to(cuda_device, torch.float64)
    m = 2 ** 25
    f = torch.fft.rfft(v, n=m, dim=0)
    ref = torch.fft.irfft(f.abs().square().sum(-1), n=m, dim=0)[:n]
    ref = ref / (n - torch.arange(n, device=cuda_device,
                                  dtype=torch.float64))[:, None]
    head = slice(0, n // 2)
    by_particle = torch.from_numpy(got.results.vacf_by_particle)
    assert rel(by_particle[head], ref[head]) <= 1e-11
    assert rel(torch.from_numpy(got.results.timeseries)[head],
               ref[head].mean(1)) <= 1e-11


@pytest.mark.parametrize("m,n_top,P,d", [
    (2 ** 12, 16, 1, 1), (2 ** 12, 16, 2, 7), (2 ** 14, 8, 3, 1),
    (2 ** 14, 8, 4, 7), (2 ** 14, 8, 5, 7), (2 ** 13, 16, 6, 1),
    (2 ** 13, 16, 131, 7), (2 ** 14, 8, 3680, 3), (64, 64, 3, 2),
    (2 ** 12, 2, 9, 3)])
@pytest.mark.parametrize("pairs,stage", [(32, 2048), (2, 48)])
def test_unpack_kernel_vs_plain(cuda_device, monkeypatch, m, n_top, P, d,
                                pairs, stage):
    """K2 at ph = 1, 2 and 3 and wide, odd P (its partners' shifted
    imaginary halves and the wrap), d = 1 and 7, R = 1, on the default
    split and on one of small column tiles, runs and staging passes."""
    monkeypatch.setattr(cuda_fft, "UNPACK_PAIRS", pairs)
    monkeypatch.setattr(cuda_fft, "UNPACK_STAGE", stage)
    w = (P * d + 1) // 2
    z = crandn(np.random.RandomState(m + P * d), cuda_device, m, w)
    before = cuda_fft.unpack_power_inva.launches
    got = cuda_fft.unpack_power_inva(z, P, d, n_top)
    assert cuda_fft.unpack_power_inva.launches == before + 1
    ref = cuda_fft.unpack_power_inva_plain(z, P, d, n_top)
    assert got.shape == (n_top, m // n_top, (P + 1) // 2)
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("n,p,d", [(1100, 5, 4), (300, 33, 6), (45, 3, 7),
                                   (2100, 7, 7), (37, 2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lag_kernel_past_three_components(cuda_device, n, p, d, dtype):
    """K8 at d = 4, 6 and 7: one launch per group of at most three
    components, both modes, float64 sums, against the plain version over
    all d."""
    rng = np.random.RandomState(n + p + d)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (n, p, d))).to(
        cuda_device, dtype)
    groups = len(cuda_lag.component_groups(d))
    for n_lags in sorted({1, 17, cuda_lag.ACF_SPAN + 1, n}
                         & set(range(1, n + 1))):
        for mode, reduce_mode in (("acf", "sum"), ("acf", "mean"),
                                  ("einstein", "mean"),
                                  ("einstein", "sum")):
            before = cuda_lag.lag_sums.launches
            got = cuda_lag.lag_sums(x, n_lags, mode, reduce_mode,
                                    out_dtype=torch.float64)
            assert cuda_lag.lag_sums.launches == before + groups
            ref = cuda_lag.lag_sums_plain(x, n_lags, mode, reduce_mode,
                                          out_dtype=torch.float64)
            assert got.shape == (n_lags, p) and got.dtype == torch.float64
            if mode == "einstein":
                assert torch.all(got[0] == 0.0)
            if n_lags > 1 or mode == "acf":
                assert rel(got, ref) <= TOL, (n_lags, mode, reduce_mode)


# --- file-backed runs (io/) -------------------------------------------------


def write_trajectory(path, n_frames, n_atoms, seed):
    """A TRR (positions and velocities) or an XTC (positions) of random
    frames, written by the port's writers."""
    from transport_analysis_tpu_torch import io

    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 30, (n_frames, n_atoms, 3)).astype(np.float32)
    vel = rng.normal(0, 5, (n_frames, n_atoms, 3)).astype(np.float32)
    with io.Writer(path, n_atoms) as w:
        for i in range(n_frames):
            if str(path).endswith(".trr"):
                w.write(positions=pos[i], velocities=vel[i],
                        dimensions=[30, 30, 30, 90, 90, 90], time=float(i))
            else:
                w.write(pos[i], dimensions=[30, 30, 30, 90, 90, 90],
                        time=float(i))


def in_memory_twin(u):
    """A Universe on a MemoryReader that holds ``u``'s decoded arrays."""
    from transport_analysis_tpu_torch import Universe
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader

    batch = u.trajectory.read_frames_batch(range(u.trajectory.n_frames))
    return Universe(u._topology, MemoryReader(
        batch["positions"], velocities=batch.get("velocities"),
        dimensions=u.trajectory.ts.dimensions, dt=u.trajectory.ts.dt))


@pytest.mark.parametrize("fft", [True, False])
def test_trr_vacf_on_card_equals_in_memory(cuda_device, tmp_path, fft):
    """A TRR-backed VelocityAutocorr on the card equals the in-memory run
    of the same decoded arrays (1e-15), and the CPU run (1e-12); the
    batch went through the native decoder."""
    from transport_analysis_tpu_torch import Universe
    from transport_analysis_tpu_torch.core.topology import Topology
    from transport_analysis_tpu_torch.io import _native

    path = tmp_path / "t.trr"
    write_trajectory(path, 3000, 37, 3)
    u = Universe(Topology(37), str(path))
    calls = _native.decode_trr_batch.calls
    got = VelocityAutocorr(u.atoms, fft=fft, device=cuda_device).run()
    assert _native.decode_trr_batch.calls == calls + 1
    twin = VelocityAutocorr(in_memory_twin(u).atoms, fft=fft,
                            device=cuda_device).run()
    cpu = VelocityAutocorr(u.atoms, fft=fft, device="cpu").run()
    got = torch.from_numpy(got.results.vacf_by_particle)
    assert rel(got, torch.from_numpy(twin.results.vacf_by_particle)) <= 1e-15
    assert rel(got, torch.from_numpy(cpu.results.vacf_by_particle)) <= TOL


@pytest.mark.parametrize("fft", [True, False])
def test_xtc_msd_on_card_equals_in_memory(cuda_device, tmp_path, fft):
    """An XTC-backed EinsteinMSD on the card equals the in-memory run of
    the same decoded arrays (1e-15), and the CPU run (1e-12)."""
    from transport_analysis_tpu_torch import EinsteinMSD, Universe
    from transport_analysis_tpu_torch.core.topology import Topology

    path = tmp_path / "t.xtc"
    write_trajectory(path, 2000, 45, 4)
    u = Universe(Topology(45), str(path))
    got = EinsteinMSD(u, fft=fft, device=cuda_device).run()
    twin = EinsteinMSD(in_memory_twin(u), fft=fft, device=cuda_device).run()
    cpu = EinsteinMSD(u, fft=fft, device="cpu").run()
    got = torch.from_numpy(got.results.msds_by_particle)
    assert rel(got, torch.from_numpy(twin.results.msds_by_particle)) <= 1e-15
    assert rel(got, torch.from_numpy(cpu.results.msds_by_particle)) <= TOL


@pytest.mark.parametrize("how", ["missing", "broken"])
def test_failed_native_build_raises(cuda_device, tmp_path, monkeypatch, how):
    """On the card's machine too, a decoder that does not build raises
    and the TRR batch never falls back to the plain decode."""
    from transport_analysis_tpu_torch.io import _native
    from transport_analysis_tpu_torch.io.trr import TRRReader

    path = tmp_path / "t.trr"
    write_trajectory(path, 4, 5, 6)
    r = TRRReader(path)
    src = tmp_path / "src"
    src.mkdir()
    if how == "broken":
        for name in _native.SOURCES.values():
            (src / name).write_text("this is not C++ {\n")
    monkeypatch.setattr(_native, "SOURCE_DIR", src)
    monkeypatch.setattr(_native, "_loaded", {})

    def plain(*args):
        raise AssertionError("fell back to the plain decode")

    monkeypatch.setattr(r, "_read_frames_batch_py", plain)
    with pytest.raises(FileNotFoundError if how == "missing"
                       else RuntimeError):
        r.read_frames_batch(range(4))


# --- streaming on the card -------------------------------------------------

def streamed_system(n, n_atoms, seed):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 30, (n, n_atoms, 3)).astype(np.float32)
    vel = rng.normal(0, 8, (n, n_atoms, 3)).astype(np.float32)
    return convert.universe_from_arrays(
        n_atoms, {"masses": np.linspace(1.0, 16.0, n_atoms)}, pos,
        velocities=vel, dimensions=[30.0] * 3 + [90.0] * 3)


def streamed_model(name, u, **kwargs):
    from transport_analysis_tpu_torch import models

    if name == "vacf":
        return models.VelocityAutocorr(u.atoms, **kwargs), "vacf_by_particle"
    if name == "helfand":
        return models.ViscosityHelfand(u.atoms, **kwargs), "visc_by_particle"
    return models.EinsteinMSD(u, **kwargs), "msds_by_particle"


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("fft", [True, False])
def test_streamed_runs_on_card_equal_the_batch_run(cuda_device, name, fft):
    """On the card: the frame-blocked feed (blocks of 64 into the device
    buffer) is bit-equal to the batch run of the same bytes; atom chunks
    of 7 (odd d·chunk), alone and on the frame-blocked feed, agree with it
    within 1e-12."""
    u = streamed_system(500, 40, 3)
    runs = {}
    for label, kwargs in (("batch", {}), ("blocked", {"frame_block": 64}),
                          ("chunked", {"atom_chunk": 7}),
                          ("both", {"frame_block": 64, "atom_chunk": 7})):
        analysis, key = streamed_model(name, u, fft=fft, max_lag=300,
                                       device=cuda_device, **kwargs)
        runs[label] = torch.from_numpy(analysis.run().results[key])
    assert torch.equal(runs["blocked"], runs["batch"])
    for label in ("chunked", "both"):
        assert rel(runs[label], runs["batch"]) <= TOL, label


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
def test_chunked_peak_under_its_budget(cuda_device, name):
    """A chunked run at 16,384 frames holds at most ``chunk_peak_bytes``
    of device memory beyond what was allocated before it, and so stays
    inside the budget its ``auto_atom_chunk`` was chosen for (the MSD's
    peak is the one the model reckons)."""
    n, budget = 16384, 0.3
    chunk = acf.auto_atom_chunk(n, d=3, hbm_budget_gb=budget)
    u = streamed_system(n, 4 * chunk + 5, 4)
    cuda_fft.roots_tensor.cache_clear()
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    analysis, _ = streamed_model(name, u, atom_chunk=chunk,
                                 device=cuda_device)
    analysis.run()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= acf.chunk_peak_bytes(n, chunk, 3) <= budget * 1e9


@pytest.mark.parametrize("fn", ["vacf_out_of_core", "helfand_out_of_core",
                                "msd_out_of_core"])
def test_spools_on_card_equal_the_cpu(cuda_device, tmp_path, fn):
    """``correlate_spools`` feeding the card equals the same spools
    correlated on the CPU, within 1e-12, with a read, stall and kernel
    wall per spool."""
    from transport_analysis_tpu_torch.parallel import out_of_core

    u = streamed_system(700, 50, 5)
    out = {}
    for dev in (cuda_device, "cpu"):
        stats = {}
        got = getattr(out_of_core, fn)(u, str(tmp_path / "spool"),
                                       atom_chunk=16, device=dev,
                                       stats=stats)
        out[str(dev)] = torch.from_numpy(np.asarray(
            got[0] if isinstance(got, tuple) else got))
        assert [len(stats[k]) for k in ("read_s", "kernel_s")] == [4, 4]
    assert rel(out["cuda"], out["cpu"]) <= TOL


# --- the float32 work mode's instantiations --------------------------------
#
# Each complex64 / float32 kernel against its plain version in the same
# type on the card. Bound: 1e-5 of the maximum, a few float32 roundings of
# each output's sum (the DFT levels' n-term sums, K8's einstein tile
# partials; K6 and K8's acf sums are float64 and rounded once).

F32_TOL = 1e-5


def crandn64(rng, device, *shape):
    return crandn(rng, device, *shape).to(torch.complex64)


@pytest.mark.parametrize("m,P,d", [(2, 1, 1), (4096, 3, 2), (2 ** 14, 37, 3),
                                   (2 ** 17, 5, 3), (2 ** 17, 200, 3),
                                   (2 ** 21, 2, 5), (2 ** 24, 4, 2)])
def test_f32_fft_kernels_vs_plain(cuda_device, m, P, d):
    """K1's forward and inverse levels, K2 and the K5 epilogue on
    complex64 at narrow (a few columns) and wide (hundreds) widths, d =
    1, 2, 3 and 5, M = 2 to 2^24: the float2 instantiations, their
    outputs complex64 and the epilogue's float32."""
    rng = np.random.RandomState(m % 997 + P)
    w, ph = (P * d + 1) // 2, (P + 1) // 2
    plan = cuda_fft.plan_levels(m)
    z = crandn64(rng, cuda_device, m, w)
    for a, n, c, order, tw in cuda_fft.level_shapes(plan, w):
        x = z.reshape(a, n, c)
        got = cuda_fft.fft_level(x, order, -1, twiddle_cols=tw)
        ref = cuda_fft.fft_level_plain(x, order, -1, twiddle_cols=tw)
        assert got.dtype == torch.complex64
        assert rel(got, ref) <= F32_TOL
        z = ref
    got = cuda_fft.unpack_power_inva(z.reshape(m, w), P, d)
    ref = cuda_fft.unpack_power_inva_plain(z.reshape(m, w), P, d)
    assert got.dtype == torch.complex64 and rel(got, ref) <= F32_TOL
    *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
    for a, n, c, order, tw in levels:
        got = cuda_fft.fft_level(ref.reshape(a, n, c), order, +1,
                                 twiddle_cols=tw)
        ref = cuda_fft.fft_level_plain(ref.reshape(a, n, c), order, +1,
                                       twiddle_cols=tw)
        assert rel(got, ref) <= F32_TOL
    a, n, c, _, _ = last
    n_rows = max(1, m // 2 - 3)
    t = ref.reshape(a, n, c)
    got = cuda_fft.inverse_last_level(t, n_rows, P, True)
    ref = cuda_fft.inverse_last_level_plain(t, n_rows, P, True)
    assert got.dtype == torch.float32 and got.shape == (n_rows, P)
    assert rel(got, ref) <= F32_TOL


@pytest.mark.parametrize("n,P,d", [(1, 1, 1), (100, 3, 3), (4097, 5, 2),
                                   (40000, 3, 5), (8192, 130, 3)])
def test_f32_autocorrelation_vs_host(cuda_device, n, P, d):
    """The float32 work mode's whole autocorrelation (acf_fft of a float32
    operand: K1, K2, K5 on complex64) against host float64 within 1e-5 of
    the maximum on lags < N/2, float32 out."""
    x = np.random.RandomState(n + P).normal(0, 2.0, (n, P, d)).astype(
        np.float32)
    got = acf.acf_fft(torch.from_numpy(x).to(cuda_device))
    assert got.dtype == torch.float32
    ref = torch.from_numpy(acf.acf_fft_numpy(x))
    head = slice(0, max(1, n // 2))
    assert rel(got[head].double(), ref[head]) <= F32_TOL


@pytest.mark.parametrize("n,p", [(1024, 37), (7, 2), (8193, 33),
                                 (2 ** 20 + 1, 4), (65536, 300)])
def test_f32_kneller_kernels_vs_plain(cuda_device, n, p):
    """K6a and K6b on float32 sq and corr: float64 totals, float32
    windows, against their plain versions (which also sum in float64)."""
    rng = np.random.RandomState(n + p)
    sq = torch.from_numpy(rng.uniform(0, 2, (n, p))).to(cuda_device,
                                                        torch.float32)
    corr = torch.from_numpy(rng.normal(size=(n, p))).to(cuda_device,
                                                        torch.float32)
    tot = cuda_kneller.kneller_totals(sq)
    assert tot.dtype == torch.float64
    assert rel(tot, cuda_kneller.kneller_totals_plain(sq)) <= TOL
    got = cuda_kneller.kneller_windows(sq, corr, tot, 3)
    assert got.dtype == torch.float32 and torch.all(got[0] == 0.0)
    assert rel(got, cuda_kneller.kneller_windows_plain(sq, corr, 3)) <= \
        F32_TOL


@pytest.mark.parametrize("n,p,d", [(37, 5, 1), (1100, 3, 2), (2100, 7, 3),
                                   (300, 130, 3), (1100, 33, 5)])
def test_f32_lag_kernel_vs_plain(cuda_device, n, p, d):
    """K8's float32 instantiations at d = 1, 2, 3 and 5 (two launches),
    narrow and wide: the acf mode's float64 Gram rounded to float32, the
    einstein mode's float32 differences and squares."""
    x = torch.from_numpy(np.random.RandomState(n + p + d).normal(
        0.5, 2.0, (n, p, d))).to(cuda_device, torch.float32)
    for n_lags in sorted({1, 17, cuda_lag.SPAN + 1, n}
                         & set(range(1, n + 1))):
        for mode, reduce_mode in (("acf", "sum"), ("einstein", "mean"),
                                  ("einstein", "sum")):
            got = cuda_lag.lag_sums(x, n_lags, mode, reduce_mode)
            ref = cuda_lag.lag_sums_plain(x, n_lags, mode, reduce_mode)
            assert got.shape == (n_lags, p) and got.dtype == torch.float32
            if mode == "einstein":
                assert torch.all(got[0] == 0.0)
            if n_lags > 1 or mode == "acf":
                assert rel(got, ref) <= F32_TOL, (n_lags, mode, reduce_mode)


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("fft", [True, False])
def test_f32_models_on_card_vs_cpu(cuda_device, name, fft):
    """dtype=np.float32 on the card: float32 results within 1e-5 of the
    CPU's float32 run (the plain versions) and 1e-4 of the card's float64
    run; an atom-chunked run's float64 accumulators within 1e-5 of the
    batch run."""
    u = streamed_system(700, 20, 6)
    out = {}
    for label, kwargs in (("card", {"device": cuda_device}),
                          ("cpu", {"device": "cpu"}),
                          ("chunked", {"device": cuda_device,
                                       "atom_chunk": 7}),
                          ("f64", {"device": cuda_device,
                                   "dtype": np.float64})):
        kwargs.setdefault("dtype", np.float32)
        analysis, key = streamed_model(name, u, fft=fft, max_lag=400,
                                       **kwargs)
        out[label] = analysis.run().results[key]
    assert out["card"].dtype == np.float32
    assert out["chunked"].dtype == np.float64
    got = torch.from_numpy(out["card"]).double()
    assert rel(got, torch.from_numpy(out["cpu"]).double()) <= F32_TOL
    assert rel(got, torch.from_numpy(out["f64"])) <= 1e-4
    assert rel(torch.from_numpy(out["chunked"]), got) <= F32_TOL


def test_f32_chunked_peak_under_its_budget(cuda_device):
    """A float32 MSD chunked for a budget by ``auto_atom_chunk(...,
    dtype=np.float32)`` holds at most its ``chunk_peak_bytes(...,
    dtype=np.float32)``, which fits more atoms than the float64 model."""
    n, budget = 16384, 0.3
    chunk = acf.auto_atom_chunk(n, d=3, hbm_budget_gb=budget,
                                dtype=np.float32)
    assert chunk > acf.auto_atom_chunk(n, d=3, hbm_budget_gb=budget)
    u = streamed_system(n, 4 * chunk + 5, 4)
    cuda_fft.roots_tensor.cache_clear()
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    analysis, _ = streamed_model("msd", u, atom_chunk=chunk,
                                 dtype=np.float32, device=cuda_device)
    analysis.run()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= acf.chunk_peak_bytes(n, chunk, 3, np.float32) <= \
        budget * 1e9


# ---------------------------------------------------------------------
# K1's wide launches and K8's float32 einstein launch
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 512])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_level_kernel_wide_ragged(cuda_device, n, dtype):
    """K1's wide launches, the column launch at n ≤ 16 and the slab launch
    at 32 and 512, at C ≡ 1 … 31 and 0 (mod 32) (C = 65 … 96), a short
    last block or tile, both signs, with a twiddle of sub-order 64·n over
    columns of 1 and without: within 1e-12 of the plain version in
    complex128, 1e-5 in complex64."""
    rng = np.random.RandomState(n)
    tol = TOL if dtype == torch.complex128 else F32_TOL
    for c in range(65, 97):
        x = crandn(rng, cuda_device, 3, n, c).to(dtype)
        tl = cuda_fft.LevelTiles(3, n, c, itemsize=x.element_size())
        assert tl.wide and tl.columns == (n <= cuda_fft.COLUMN_LEVEL)
        for sign in (-1, +1):
            for m, tw in level_cases(n, c, sign):
                got = cuda_fft.fft_level(x, m, sign, twiddle_cols=tw)
                ref = cuda_fft.fft_level_plain(x, m, sign, twiddle_cols=tw)
                assert got.dtype == dtype
                assert rel(got, ref) <= tol, (c, sign, tw)


@pytest.mark.parametrize("n", [2, 16])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_level_kernel_wide_past_grid_y(cuda_device, n, dtype):
    """The column launch over more than 65,535 rows of A: blocks stride
    over the rows by grid y."""
    a, c = 65535 + 3, 70
    tl = cuda_fft.LevelTiles(a, n, c)
    assert tl.columns and tl.groups > tl.grid[1] == 65535
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((a, n, c), dtype=dtype, device=cuda_device, generator=g)
    got = cuda_fft.fft_level(x, 64 * n, +1, twiddle_cols=1)
    ref = cuda_fft.fft_level_plain(x, 64 * n, +1, 1)
    assert rel(got, ref) <= (TOL if dtype == torch.complex128 else F32_TOL)


EINSTEIN_TYPES = [  # (operand, sums): the float32 work mode's launch
    # (einstein_rows_kernel), and the float64 sums of float32 and float64
    # operands (einstein_tile_kernel)
    (torch.float32, torch.float32), (torch.float32, torch.float64),
    (torch.float64, torch.float64)]


def einstein_check(x, n_lags, out_dtype):
    tol = TOL if out_dtype == torch.float64 else F32_TOL
    for reduce_mode in ("mean", "sum"):
        got = cuda_lag.lag_sums(x, n_lags, "einstein", reduce_mode,
                                out_dtype=out_dtype)
        ref = cuda_lag.lag_sums_plain(x, n_lags, "einstein", reduce_mode,
                                      out_dtype=out_dtype)
        assert got.shape == (n_lags, x.shape[1]) and got.dtype == out_dtype
        assert torch.all(got[0] == 0.0)
        if n_lags > 1:
            assert rel(got, ref) <= tol, (n_lags, reduce_mode)


@pytest.mark.parametrize("p", [33, 45, 70])
@pytest.mark.parametrize("d", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype,out_dtype", EINSTEIN_TYPES)
def test_einstein_launch_at_span_and_tile_edges(cuda_device, p, d, dtype,
                                                out_dtype):
    """K8's einstein launches at P not a multiple of the particle tile,
    d = 1, 2, 3 and 5 (two launches): N shorter than one frame tile of
    every span (100, 143) and one float32 tile long (159, 160), n_lags at
    the span's edges (127, 128, 129) at N = 1000, and the operand one
    value into its storage, so that frame rows start off 16-byte
    chunks."""
    rng = np.random.RandomState(p * d)
    for n, lags in ((100, (1, 99, 100)), (143, (143,)), (159, (31, 159)),
                    (160, (160,)), (1000, (127, 128, 129, 1000))):
        flat = torch.from_numpy(rng.normal(0.5, 2.0, n * p * d + 1)).to(
            cuda_device, dtype)
        for x in (flat[:-1].view(n, p, d), flat[1:].view(n, p, d)):
            for n_lags in lags:
                einstein_check(x, n_lags, out_dtype)


@pytest.mark.parametrize("dtype,out_dtype", EINSTEIN_TYPES)
def test_einstein_launch_all_lags_long(cuda_device, dtype, out_dtype):
    """K8's einstein launches over all lags of 8,192 frames, 37 particles
    of 3 components: every span from the full ones to the last, whose
    frames are all tail."""
    x = torch.from_numpy(np.random.RandomState(8192).normal(
        0.5, 2.0, (8192, 37, 3))).to(cuda_device, dtype)
    einstein_check(x, 8192, out_dtype)


# --- K8's two-block launch (the exact ring's pair sums) ----------------------

def pair_check(xa, xb, offset, lag_lo, n_lags):
    """lag_sums_pair against its plain version, both modes and reduce
    modes, sums of the blocks' type; the kernel's lags with no pair must
    be 0."""
    tol = TOL if xa.dtype == torch.float64 else F32_TOL
    for mode in ("acf", "einstein"):
        for reduce_mode in ("sum", "mean"):
            got = cuda_lag.lag_sums_pair(xa, xb, offset, lag_lo, n_lags, mode,
                                         reduce_mode)
            ref = cuda_lag.lag_sums_pair_plain(xa, xb, offset, lag_lo, n_lags,
                                               mode, reduce_mode)
            assert got.shape == (n_lags, xa.shape[1])
            assert got.dtype == xa.dtype
            assert torch.all(got[ref == 0] == 0)
            if torch.any(ref != 0):  # else all 0, as the line above holds
                assert rel(got, ref) <= tol, (offset, lag_lo, n_lags, mode,
                                              reduce_mode)


@pytest.mark.parametrize("p", [33, 70])
@pytest.mark.parametrize("d", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_launch_vs_plain(cuda_device, p, d, dtype):
    """K8's two-block launch (``lag_sums_pair``) at P not a multiple of
    the particle tile, d = 1, 2, 3 and 5 (two launches), blocks of 1 and
    31 frames (under one tile or acf chunk), 160 (about a span), 257, 1,000,
    1,100 and 2,049 (several 256-frame acf chunks, the ring of partner
    groups turning, none a multiple of a chunk or tile): round 0 (xa = xb,
    offset 0), the ring's rounds 1 and 3 of four blocks (offset k·L, lags
    kL − L + 1 … kL + L − 1), an offset off the block grid whose lags run
    past the pairs at both ends, and windows that start and end inside the
    band of pairs; the first block one value into its storage, so frame
    rows start off 16-byte chunks."""
    rng = np.random.RandomState(p * d)
    for n in (1, 31, 160, 257, 1000, 1100, 2049):
        size = n * p * d
        flat = torch.from_numpy(rng.normal(0.5, 2.0, 2 * size + 1)).to(
            cuda_device, dtype)
        xa = flat[1:size + 1].view(n, p, d)
        xb = flat[size + 1:].view(n, p, d)
        pair_check(xa, xa, 0, 0, n)
        pair_check(xa, xb, n, 1, 2 * n - 1)
        pair_check(xa, xb, 3 * n, 2 * n + 1, 2 * n - 1)
        pair_check(xa, xb, n + 7, 0, 3 * n)
        pair_check(xa, xb, n, n // 2 + 1, max(1, n - n // 3))
        pair_check(xa, xa, 0, n // 3, max(1, n // 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_launch_no_pair_lags_are_zero(cuda_device, dtype):
    """Lags with no frame pair in the two blocks give exactly 0: a window
    wholly past the pairs (every partner before the first frame or after
    the last), and one that runs past them at both ends, whose rows with
    |lag − offset| ≥ L must be 0 while the others meet the plain
    version."""
    n, p, d = 300, 37, 3
    rng = np.random.RandomState(300)
    xa = torch.from_numpy(rng.normal(0.5, 2.0, (n, p, d))).to(cuda_device,
                                                               dtype)
    xb = torch.from_numpy(rng.normal(0.5, 2.0, (n, p, d))).to(cuda_device,
                                                               dtype)
    for mode in ("acf", "einstein"):
        for offset, lag_lo, n_lags in ((3 * n, 0, 2 * n), (0, n, 700)):
            got = cuda_lag.lag_sums_pair(xa, xb, offset, lag_lo, n_lags,
                                         mode)
            assert torch.all(got == 0), (mode, offset, lag_lo)
        got = cuda_lag.lag_sums_pair(xa, xb, n, 0, 3 * n, mode)
        lag = torch.arange(3 * n, device=cuda_device)
        none = (lag - n).abs() >= n
        assert torch.all(got[none] == 0) and torch.all(got[~none] != 0)
        pair_check(xa, xb, n, 0, 3 * n)


def test_pair_launch_counts(cuda_device):
    """Each two-block launch adds one to the wrapper's count (two at
    d = 5), the float32 work mode's (float32 blocks) also to
    ``launches_f32``."""
    x = torch.ones((64, 3, 5), dtype=torch.float32, device=cuda_device)
    before = (cuda_lag.lag_sums_pair.launches,
              cuda_lag.lag_sums_pair.launches_f32)
    cuda_lag.lag_sums_pair(x, x, 0, 0, 64, "acf")
    x64 = x[:, :, :3].double()
    cuda_lag.lag_sums_pair(x64, x64, 0, 0, 64, "einstein")
    assert (cuda_lag.lag_sums_pair.launches - before[0],
            cuda_lag.lag_sums_pair.launches_f32 - before[1]) == (3, 2)


# --- several devices: the mesh, the ring, the sharded FFT ---------------------

def _mesh_modules():
    from transport_analysis_tpu_torch import parallel
    from transport_analysis_tpu_torch.parallel import ring, sharded_fft
    from transport_analysis_tpu_torch.parallel.mesh import Mesh
    return parallel, ring, sharded_fft, Mesh


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode,sum_d", [("acf", True), ("einstein", True),
                                        ("einstein", False)])
def test_ring_in_four_blocks_of_one_card(cuda_device, dtype, mode, sum_d):
    """The ring over ["cuda"] * 4 (ten two-block launches) against K8 on
    the whole series, 1,000 frames of 37 particles."""
    _, ring, _, Mesh = _mesh_modules()
    x = torch.from_numpy(np.random.RandomState(4).normal(
        0.5, 2.0, (1000, 37, 3))).to(cuda_device, dtype)
    before = cuda_lag.lag_sums_pair.launches
    got = ring.windowed_correlation_ring(x, Mesh(["cuda"] * 4, ("frames",)),
                                         mode=mode, sum_d=sum_d)
    assert cuda_lag.lag_sums_pair.launches - before == 10
    want = cuda_lag.lag_sums(x, 1000, mode, "mean" if mode == "einstein"
                             and not sum_d else "sum")
    assert got.dtype == dtype and got.device.type == "cuda"
    assert rel(got, want) <= (TOL if dtype == torch.float64 else F32_TOL)


def test_sharded_fft_in_four_shards_of_one_card(cuda_device):
    """``sharded_fft`` over ["cuda"] * 4 against torch.fft.fft in the
    transposed order and back, and the sharded autocorrelations against
    the one-device ops."""
    from transport_analysis_tpu_torch import ops

    _, _, sf, Mesh = _mesh_modules()
    mesh = Mesh(["cuda"] * 4, ("frames",))
    rng = np.random.RandomState(5)
    m = 2 ** 14
    re, im = (torch.from_numpy(rng.normal(size=(m, 9))).to(cuda_device)
              for _ in range(2))
    zr, zi = sf.sharded_fft(re, im, mesh)
    n2 = m // sf._pick_n1(m, 4)
    k = torch.arange(m, device=cuda_device)
    want = torch.fft.fft(torch.complex(re, im), dim=0)[
        (k % n2) * (m // n2) + k // n2]
    assert rel(torch.complex(zr.gather(), zi.gather()), want) <= TOL
    xr, xi = sf.sharded_fft(zr, zi, mesh, inverse=True)
    assert rel(xr.gather(), re) <= TOL and rel(xi.gather(), im) <= TOL
    x = rng.normal(size=(3000, 5, 3))
    got = sf.sharded_acf_fft(x, mesh)
    ref = ops.acf_fft(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    a = np.cumsum(x, axis=0)
    got = sf.sharded_msd_fft(a, mesh)
    ref = ops.msd_fft(torch.from_numpy(a).to(cuda_device)).cpu().numpy()
    assert np.abs(got - ref)[:1500].max() <= TOL * np.abs(ref).max()
    xp = np.zeros((8192, 6), np.float32)
    xp[:3000] = rng.normal(size=(3000, 6))
    assert sf.sharded_raw_autocorr(xp, mesh).gather().dtype == torch.float32


@pytest.mark.parametrize("name", ["vacf", "helfand", "msd"])
@pytest.mark.parametrize("fft", [True, False])
def test_models_in_four_shards_of_one_card(cuda_device, name, fft):
    """The models under ``use_mesh(analysis_mesh(["cuda"] * 4))`` against
    their unsharded runs on the card, with 4 x the kernel launches."""
    parallel, *_ = _mesh_modules()
    u, cls, key = _card_system(name)
    counted = [cuda_fft.fft_level, cuda_lag.lag_sums]

    def run():
        before = [f.launches for f in counted]
        out = cls(u.atoms, fft=fft).run()
        return out, [f.launches - b for f, b in zip(counted, before)]

    base, n_base = run()
    with parallel.use_mesh(parallel.analysis_mesh(["cuda"] * 4)):
        got, n_got = run()
    assert n_got == [4 * n for n in n_base]
    for field in (key, "timeseries"):
        ref = base.results[field]
        assert np.abs(got.results[field] - ref).max() <= \
            1e-13 * np.abs(ref).max(), field


def _card_system(name):
    """A 45-atom, 600-frame system with masses and a box, and the model
    class and per-particle key of ``name``."""
    from transport_analysis_tpu_torch.models import (EinsteinMSD,
                                                     ViscosityHelfand)

    rng = np.random.RandomState(45)
    n, p = 600, 45
    vel = rng.normal(size=(n, p, 3))
    pos = np.cumsum(vel, axis=0)
    dims = np.tile([20.0, 20.0, 20.0, 90.0, 90.0, 90.0], (n, 1))
    u = convert.universe_from_arrays(
        p, {"masses": np.linspace(1.0, 16.0, p)}, pos, velocities=vel,
        dimensions=dims, dt=1.0)
    return u, {"vacf": VelocityAutocorr, "helfand": ViscosityHelfand,
               "msd": EinsteinMSD}[name], {
        "vacf": "vacf_by_particle", "helfand": "visc_by_particle",
        "msd": "msds_by_particle"}[name]


def test_two_card_mesh(cuda_device):
    """A mesh of two cards: each shard launches on its own card (the
    wrappers' ``torch.cuda.device``), and the results equal one card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    parallel, ring, sf, Mesh = _mesh_modules()
    two = ["cuda:0", "cuda:1"]
    u, cls, key = _card_system("vacf")
    base = cls(u.atoms, fft=True).run()
    with parallel.use_mesh(parallel.analysis_mesh(two)):
        got = cls(u.atoms, fft=True).run()
    assert np.abs(got.results[key] - base.results[key]).max() <= \
        1e-13 * np.abs(base.results[key]).max()
    x = torch.from_numpy(np.random.RandomState(2).normal(
        size=(512, 33, 3))).to(cuda_device)
    got = ring.windowed_correlation_ring(x, Mesh(two, ("frames",)))
    assert rel(got, cuda_lag.lag_sums(x, 512, "acf")) <= TOL
    xa = np.random.RandomState(3).normal(size=(1000, 4, 3))
    got = sf.sharded_acf_fft(xa, Mesh(two, ("frames",)))
    ref = sf.sharded_acf_fft(xa, Mesh(["cuda:0"] * 2, ("frames",)))
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_nccl_feed_one_process(cuda_device, tmp_path):
    """The multi-process feed through a one-process NCCL group: its sum
    and gather go through NCCL and equal the local ones; the group is
    destroyed after."""
    import torch.distributed as dist

    from transport_analysis_tpu_torch.parallel import multihost

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = multihost.global_mesh(["cuda"] * 4)
        full = np.random.RandomState(6).normal(size=(64, 40, 3))
        block = multihost.distribute_atom_block(
            full[:, multihost.atom_shard_for_process(40, mesh)], 40, mesh)
        assert block.distributed and len(block.shards) == 4
        total = block.psum(lambda s: (s * s).sum(dim=(1, 2)))
        assert np.allclose(total.cpu().numpy(),
                           (full * full).sum(axis=(1, 2)), rtol=1e-13)
        assert np.array_equal(block.gather().cpu().numpy(), full)
    finally:
        dist.destroy_process_group()


def test_nccl_ring_and_fft_world_one(cuda_device, tmp_path):
    """The ring and the sharded FFT on ``global_mesh(["cuda"] * 4,
    "frames")`` of a one-process NCCL group take the one-process path:
    bit-equal to the same mesh without a group, nothing sent."""
    import torch.distributed as dist

    from transport_analysis_tpu_torch.parallel import multihost

    _, ring, sf, Mesh = _mesh_modules()
    local = Mesh(["cuda"] * 4, ("frames",))
    x = torch.from_numpy(np.random.RandomState(8).normal(
        size=(512, 21, 3))).to(cuda_device)
    xa = np.random.RandomState(9).normal(size=(1000, 5, 3))
    want = [ring.windowed_correlation_ring(x, local, mode=mode)
            for mode in ("acf", "einstein")]
    want_fft = sf.sharded_acf_fft(xa, local)
    sent = multihost.traffic.sent
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = multihost.global_mesh(["cuda"] * 4, "frames")
        assert mesh.processes == 1 and mesh.shape["frames"] == 4
        for mode, ref in zip(("acf", "einstein"), want):
            got = ring.windowed_correlation_ring(x, mesh, mode=mode)
            assert torch.equal(got, ref), mode
        assert np.array_equal(sf.sharded_acf_fft(xa, mesh), want_fft)
    finally:
        dist.destroy_process_group()
    assert multihost.traffic.sent == sent


def test_timing_compute_covers_the_card(cuda_device):
    """``analysis.timing``'s "compute" is no shorter than the card's own
    time of ``_conclude`` (CUDA events around it): the stage synchronises
    the card before it reads the clock."""
    u, cls, _ = _card_system("helfand")
    analysis = cls(u.atoms, fft=False)
    conclude = analysis._conclude
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed():
        start.record()
        conclude()
        end.record()

    analysis._conclude = timed
    analysis.run()
    torch.cuda.synchronize()
    timing = analysis.timing.as_dict()
    assert set(timing) == {"io", "compute", "total", "frames_per_s",
                           "atom_frame_lags_per_s"}
    assert 1e3 * timing["compute"] >= start.elapsed_time(end) > 0


def test_trace_holds_the_kernels(cuda_device, tmp_path):
    """``utils.profiling.trace`` writes a Chrome trace whose CUDA kernel
    events name the port's kernels."""
    import glob
    import json

    from transport_analysis_tpu_torch.utils.profiling import trace

    u, cls, _ = _card_system("helfand")
    with trace(tmp_path):
        cls(u.atoms, fft=True).run()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = " ".join(e["name"] for e in events
                       if e.get("cat") == "kernel")
    for name in ("fft_level", "unpack_power_inva_kernel",
                 "inverse_last_level", "kneller_totals_kernel",
                 "kneller_windows_kernel"):
        assert name in kernels, name


def test_analysis_step_and_dryrun_on_card(cuda_device):
    """The fused step on the card against its CPU run (K1, K2, K5, K6a
    and K6b each launched), and the mesh dry run over four shards of the
    card."""
    from transport_analysis_tpu_torch import entry
    from transport_analysis_tpu_torch.ops import cuda_kneller

    counted = [cuda_fft.fft_level, cuda_fft.unpack_power_inva,
               cuda_fft.inverse_last_level, cuda_kneller.kneller_totals,
               cuda_kneller.kneller_windows]
    before = [f.launches for f in counted]
    got = entry.analysis_step(*entry.example_args(cuda_device))
    assert all(f.launches > b for f, b in zip(counted, before))
    want = entry.analysis_step(*entry.example_args("cpu"))
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-12)
    entry.dryrun_multichip(4)

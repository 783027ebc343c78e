"""The port's windowed (fft=False) path and EinsteinMSD against the JAX
package's, on the same inputs.

* ``cuda_lag.windowed_lag`` / ``lag_sums_plain`` (K8's plain version)
  against the TPU kernels themselves, ``windowed_lag_pallas`` in
  interpret mode (lag block 8, as ``tests/test_pallas_lag.py`` runs it):
  the float64 pair kernel (K8b) within 1e-12 of the maximum (it is
  ~2^-45 of row scale), the float32 kernel (K8a) within 1e-5 (its f32
  arithmetic; a float32 operand gives float32 results, as the JAX op's;
  the float64 work mode's entry, ``lag_sums(..., out_dtype=float64)``,
  upcasts f32 samples exactly, so it meets the JAX float64 windowed op on
  the upcast within 1e-12).
* ``acf_windowed`` / ``einstein_difference_windowed`` against the JAX
  XLA windowed kernels, within 1e-12 of the maximum.
* The models with ``fft=False`` against JAX ``fft=False`` on the systems
  of tests/test_torch_models.py (timeseries and per-particle values
  within 1e-12 of the maximum, Green–Kubo and fitted slopes within 1e-10
  relative), and the step trajectory's closed-form VACF oracle.
* ``EinsteinMSD`` with both algorithms against JAX ``EinsteinMSD`` and
  tests/test_msd.py's brute-force random-walk oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu import ops as jops  # noqa: E402
from transport_analysis_tpu.ops.pallas_lag import windowed_lag_pallas  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch.ops import cuda_lag  # noqa: E402
from transport_analysis_tpu_torch.utils.errors import NoDataError  # noqa: E402

from test_msd import brute_force_msd  # noqa: E402
from test_torch_models import port_universe, rel  # noqa: E402
from test_velocityautocorr import ALL_DIMS, characteristic_poly  # noqa: E402

TOL = 1e-12
F32_TOL = 1e-5
SCALAR_TOL = 1e-10


def port(x, max_lag, mode, reduce_mode):
    return cuda_lag.windowed_lag(torch.from_numpy(x), max_lag, mode,
                                 reduce_mode).numpy()


# --- K8 against the TPU kernels (interpret mode) ---------------------------

LAG_CASES = [  # (shape, max_lag, mode, reduce_mode)
    ((40, 3, 3), None, "acf", "sum"),
    ((40, 3, 3), 10, "acf", "sum"),
    ((40, 3, 3), 1, "acf", "sum"),
    ((40, 3, 3), None, "einstein", "mean"),
    ((40, 3, 3), 17, "einstein", "sum"),
    ((33, 5), None, "acf", "sum"),
    ((33, 5), 9, "einstein", "mean"),
    ((64, 8, 2), 64, "einstein", "sum"),
    ((50, 4, 3), 20, "acf", "mean"),
]


@pytest.mark.parametrize("shape,max_lag,mode,reduce_mode", LAG_CASES)
def test_windowed_lag_vs_pair_kernel(shape, max_lag, mode, reduce_mode):
    """float64 operand: K8b's function within 1e-12 of the maximum."""
    x = np.random.RandomState(sum(shape)).normal(0.3, 1.5, shape)
    ref = np.asarray(windowed_lag_pallas(x, max_lag=max_lag, mode=mode,
                                         reduce_mode=reduce_mode))
    got = port(x, max_lag, mode, reduce_mode)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL
    if mode == "einstein":
        assert np.all(got[0] == 0.0)


@pytest.mark.parametrize("shape,max_lag,mode,reduce_mode", [
    LAG_CASES[0], LAG_CASES[4], LAG_CASES[5], LAG_CASES[7]])
def test_windowed_lag_vs_f32_kernel(shape, max_lag, mode, reduce_mode):
    """float32 operand: float32 results, as K8a's, within its f32 grade;
    the float64 work mode's entry on the same samples meets the JAX
    float64 windowed op on the exact upcast within 1e-12."""
    x32 = np.random.RandomState(7 + sum(shape)).normal(
        0.3, 1.5, shape).astype(np.float32)
    got32 = port(x32, max_lag, mode, reduce_mode)
    assert got32.dtype == np.float32
    ref32 = np.asarray(windowed_lag_pallas(x32, max_lag=max_lag, mode=mode,
                                           reduce_mode=reduce_mode))
    assert ref32.dtype == np.float32
    assert rel(got32, ref32) <= F32_TOL
    x3 = torch.from_numpy(x32 if x32.ndim == 3 else x32[:, :, None])
    got = cuda_lag.lag_sums(x3, ref32.shape[0], mode, reduce_mode,
                            out_dtype=torch.float64).numpy()
    assert got.dtype == np.float64
    assert rel(got, ref32) <= F32_TOL
    x64 = x32.astype(np.float64)
    if mode == "acf":
        ref = jops.acf_windowed(x64, max_lag=max_lag)
    else:
        ref = jops.einstein_difference_windowed(x64, reduce_mode, max_lag)
    assert rel(got, np.asarray(ref)) <= TOL


@pytest.mark.parametrize("n,p,d,n_lags", [(1, 1, 1, 1), (17, 2, 3, 17),
                                          (100, 3, 2, 37)])
def test_lag_sums_plain_blocks_agree(monkeypatch, n, p, d, n_lags):
    """The plain version's lag blocks change nothing but the grouping:
    one lag at a time gives the same sums within 1e-12."""
    x = torch.from_numpy(np.random.RandomState(n).normal(size=(n, p, d)))
    for mode in ("acf", "einstein"):
        whole = cuda_lag.lag_sums_plain(x, n_lags, mode, "mean")
        monkeypatch.setattr(cuda_lag, "PLAIN_BLOCK_VALUES", 1)
        single = cuda_lag.lag_sums_plain(x, n_lags, mode, "mean")
        monkeypatch.undo()
        assert torch.allclose(whole, single, rtol=0,
                              atol=TOL * float(single.abs().max() + 1e-300))


@pytest.mark.parametrize("call,err", [
    (lambda: cuda_lag.lag_sums(torch.zeros((4, 1, 1), dtype=torch.int64),
                               2), TypeError),
    (lambda: cuda_lag.lag_sums(torch.zeros((4, 1, 1)), 5), ValueError),
    (lambda: cuda_lag.lag_sums(torch.zeros((4, 1, 1)), 0), ValueError),
    (lambda: cuda_lag.lag_sums(torch.zeros((4, 1, 1)), 2, "msd"), ValueError),
    (lambda: cuda_lag.lag_sums(torch.zeros((4, 1, 1)), 2, "acf", "max"),
     ValueError),
    (lambda: ta.ops.acf_windowed(np.zeros((4, 2), np.int32), device="cpu"),
     TypeError),
    (lambda: ta.ops.einstein_difference_windowed(
        np.zeros((4, 2), np.complex128), device="cpu"), TypeError),
])
def test_lag_sums_rejects_bad_operands(call, err):
    with pytest.raises(err):
        call()


@pytest.mark.parametrize("d,groups", [(1, [(0, 1)]), (3, [(0, 3)]),
                                      (4, [(0, 2), (2, 4)]),
                                      (5, [(0, 2), (2, 5)]),
                                      (6, [(0, 3), (3, 6)]),
                                      (7, [(0, 2), (2, 4), (4, 7)])])
def test_component_groups(d, groups):
    """K8 takes at most three components a launch: one group up to
    three, past it as few groups as cover d, evenly."""
    assert cuda_lag.component_groups(d) == groups
    assert all(c1 - c0 <= cuda_lag.MAX_D for c0, c1 in groups)


@pytest.mark.parametrize("d", [4, 5, 6, 7])
@pytest.mark.parametrize("mode,reduce_mode", [("acf", "sum"),
                                              ("acf", "mean"),
                                              ("einstein", "mean"),
                                              ("einstein", "sum")])
def test_grouped_components_match_one_sum(d, mode, reduce_mode):
    """The card's route past three components, replayed with the plain
    version: each group's 'sum' sums added, then divided once by dfac,
    equal the sums over all d components within 1e-15 of the maximum;
    einstein's lag 0 stays exactly 0."""
    x = torch.from_numpy(np.random.RandomState(d).normal(0.3, 1.5,
                                                         (70, 3, d)))
    got = cuda_lag.sum_component_groups(cuda_lag.lag_sums_plain, x, 50,
                                        mode, reduce_mode)
    ref = cuda_lag.lag_sums_plain(x, 50, mode, reduce_mode)
    assert got.shape == ref.shape == (50, 3)
    assert rel(got.numpy(), ref.numpy()) <= 1e-15
    if mode == "einstein":
        assert torch.all(got[0] == 0.0)


def test_lag_kernel_takes_cuda_tensors_only():
    """A tensor off the CPU goes to the kernel path, which raises for
    anything but a CUDA tensor and counts no launch."""
    before = cuda_lag.lag_sums.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lag.lag_sums(torch.zeros((8, 2, 3), device="meta"), 4)
    cuda_lag.lag_sums(torch.zeros((8, 2, 3)), 4)      # the plain version
    assert cuda_lag.lag_sums.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,n_lags", [(1, 1), (15, 15), (16, 16), (143, 1),
                                      (159, 159), (160, 160), (191, 40),
                                      (200, 127), (200, 128), (200, 129),
                                      (300, 300), (1000, 257)])
def test_einstein_tiles_cover_each_pair_once(n, n_lags, dtype):
    """K8's einstein work split as csrc/lag.cu runs it, for each operand
    type's tile with float64 sums (einstein_tile_kernel): the
    shared-memory tiles and the masked tails cover every (frame i, lag)
    with i + lag < N exactly once; every partner row a warp reads from
    the ring is there (copied by an earlier group, not overwritten by the
    group in flight) and lies inside the operand."""
    einstein_tile_replay(n, n_lags, cuda_lag.tile_frames(dtype))


@pytest.mark.parametrize("n,n_lags", [(1, 1), (15, 15), (16, 16), (143, 1),
                                      (159, 159), (160, 160), (191, 40),
                                      (200, 127), (200, 128), (200, 129),
                                      (300, 300), (1000, 257), (8192, 129)])
def test_einstein_f32_tiles_cover_each_pair_once(n, n_lags):
    """The same for the float32 work mode's launch (einstein_rows_kernel,
    float32 sums, its tile of two lag blocks): every pair once, every
    ring row there when read, no copy of a frame past N."""
    tile_f = cuda_lag.tile_frames(torch.float32, torch.float32)
    assert tile_f == 2 * cuda_lag.LAG_BLOCK
    einstein_tile_replay(n, n_lags, tile_f)


def einstein_tile_replay(n, n_lags, tile_f):
    """The tiles, ring slots and tails of the einstein launch of tile
    ``tile_f`` frames: checks each row read and counts each pair."""
    block = cuda_lag.LAG_BLOCK
    count = np.zeros((n_lags, n), dtype=np.int64)
    for l0 in range(0, n_lags, cuda_lag.SPAN):
        n_tiles = cuda_lag.einstein_tiles(n, l0, tile_f)
        held = {}
        for r in (cuda_lag.ring_loads(0, tile_f) if n_tiles else ()):
            held[cuda_lag.ring_slot(r, tile_f)] = r
        for t in range(n_tiles):
            nxt = (cuda_lag.ring_loads(t + 1, tile_f) if t + 1 < n_tiles
                   else range(0))
            in_flight = {cuda_lag.ring_slot(r, tile_f) for r in nxt}
            assert (t + 1) * tile_f <= n
            for warp in range(cuda_lag.TILE_WARPS):
                lw = l0 + warp * block
                if lw >= n_lags:
                    continue
                prime, new = cuda_lag.window_rows(t, warp, tile_f)
                for r in [*prime, *new]:
                    assert l0 + r < n
                    slot = cuda_lag.ring_slot(r, tile_f)
                    assert slot not in in_flight and held[slot] == r
                for k in range(0, tile_f, block):
                    chunk = new[k:k + block]
                    assert (cuda_lag.ring_slot(chunk[-1], tile_f)
                            - cuda_lag.ring_slot(chunk[0], tile_f)
                            == block - 1)
                frames = slice(t * tile_f, (t + 1) * tile_f)
                lags = slice(lw, min(lw + block, n_lags))
                assert frames.stop - 1 + lags.stop - 1 < n
                count[lags, frames] += 1
            for r in nxt:
                assert l0 + r < n
                held[cuda_lag.ring_slot(r, tile_f)] = r
        for warp in range(cuda_lag.TILE_WARPS):
            lw = l0 + warp * block
            for i in cuda_lag.tail_frames(n, l0, warp, tile_f):
                for lag in range(lw, min(lw + block, n_lags)):
                    if i + lag < n:
                        count[lag, i] += 1
    lag, i = np.indices((n_lags, n))
    np.testing.assert_array_equal(count, (i + lag < n).astype(np.int64))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 31, 32, 33, 100, 3679, 3680])
def test_einstein_row_copies(p, d):
    """The float32 einstein launch's copy of each frame row: 16-byte
    aligned chunks, at most a row slot (TILE_P·d + 4 values), covering the
    row's values and only the 16-byte chunks that hold some of them (no
    byte outside a chunk of the operand), landing at the delta that lanes
    compute from the frame mod 4; lanes past P are never stored, so the
    chunks' edges they may read stay unused."""
    pitch = cuda_lag.row_pitch(d)
    for addr in (0, 4, 8, 12, 4096 + 4, 512 + 8):
        for p0 in range(0, p, cuda_lag.TILE_P):
            v = min(cuda_lag.TILE_P, p - p0) * d
            for f in range(9):
                a0, nbytes, delta = cuda_lag.row_copy(addr, f, p, p0, d)
                start = addr + 4 * (f * p + p0) * d
                assert a0 % 16 == 0 and nbytes % 16 == 0
                assert a0 <= start and start + 4 * v <= a0 + nbytes
                assert a0 > start - 16 and a0 + nbytes < start + 4 * v + 16
                assert nbytes <= 4 * pitch and delta + v <= pitch
                assert delta == cuda_lag.row_delta(addr, f, p, p0, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_einstein_ring_holds_a_tile_and_the_next(dtype):
    """The ring's size: the rows one tile reads, those the next tile adds
    while it is summed, and the rows the warps prime with; the shared
    memory of a CTA at d = 3 within Hopper's 227 KB."""
    tile_f = cuda_lag.tile_frames(dtype)
    ring = cuda_lag.ring_rows(tile_f)
    assert ring % cuda_lag.LAG_BLOCK == 0 and tile_f % cuda_lag.LAG_BLOCK == 0
    assert cuda_lag.SPAN == cuda_lag.TILE_WARPS * cuda_lag.LAG_BLOCK
    assert len(cuda_lag.ring_loads(0, tile_f)) <= ring
    row = cuda_lag.TILE_P * 3 * torch.tensor([], dtype=dtype).element_size()
    assert (ring + 2 * tile_f) * row <= 232_448


def test_einstein_f32_ring_fits_two_ctas():
    """The float32 work mode's ring of particle-major row slots: tiles
    start at frames ≡ 0 mod 4 (a row's delta follows from its frame), and
    a CTA's shared memory at d = 3 is within half the SM's 228 KB (1 KB
    reserved a CTA), so that two CTAs share an SM."""
    tile_f = cuda_lag.tile_frames(torch.float32, torch.float32)
    ring = cuda_lag.ring_rows(tile_f)
    assert ring % cuda_lag.LAG_BLOCK == 0 and tile_f % 4 == 0
    assert len(cuda_lag.ring_loads(0, tile_f)) <= ring
    smem = (ring + 2 * tile_f) * cuda_lag.row_pitch(3) * 4
    assert smem == 102_400 and 2 * (smem + 1024) <= 233_472


def acf_gram_replay(x, n_lags):
    """K8's acf launch replayed in numpy from cuda_lag's work split, as
    csrc/lag.cu runs it: for each span, chunk, warp and step, the A and B
    fragments' frame rows (B through the warp's register ring, whose slots
    it checks), the tile products into the Gram matrix C, then each lag's
    diagonal sum / (N − lag). Returns the (n_lags, P) sums and the count of
    each (lag, frame) pair that a nonzero product added to a stored lag."""
    n, p, _ = x.shape
    chunk, cols = cuda_lag.ACF_CHUNK, cuda_lag.ACF_COLS
    xpad = np.concatenate([x, np.zeros((chunk + cols,) + x.shape[1:])])
    spans, span = cuda_lag.acf_spans(n_lags)
    assert span <= cuda_lag.ACF_SPAN and spans * span >= n_lags
    tiles = cuda_lag.acf_tiles(span)
    out = np.zeros((n_lags, p))
    count = np.zeros((n_lags, n), dtype=np.int64)
    for b in range(spans):
        l0 = b * span
        gram = np.zeros((p, cuda_lag.ACF_ROWS, cols))
        for f0 in cuda_lag.acf_chunks(n, l0):
            for warp in range(cuda_lag.ACF_WARPS):
                held = {}
                for v in cuda_lag.acf_ring_loads(-1):
                    held[v % cuda_lag.ACF_RING] = v
                for s in range(cuda_lag.ACF_STEPS):
                    for v in cuda_lag.acf_ring_loads(s):
                        held[v % cuda_lag.ACF_RING] = v
                    rows = cuda_lag.acf_frame_rows(s)
                    assert rows.min() >= 0 and rows.max() < chunk
                    a = xpad[f0 + rows]                       # (K, 16, P, d)
                    for e, i, m in cuda_lag.acf_tile_columns(warp, tiles):
                        v = held[(s + i) % cuda_lag.ACF_RING]
                        assert v == s + i
                        partner = cuda_lag.acf_partner_rows(v, warp, e)
                        assert partner.max() < chunk + cols
                        gram[:, :, m:m + 8] += np.einsum(
                            "kaqc,knqc->qan", a, xpad[f0 + l0 + partner])
                        t = f0 + rows[:, :, None]              # (K, 16, 1)
                        u = f0 + l0 + partner[:, None, :]      # (K, 1, 8)
                        ell = cuda_lag.acf_column_lag(
                            m + np.arange(8)[None, None, :],
                            np.arange(cuda_lag.ACF_ROWS)[None, :, None])
                        assert np.all(u - t == l0 + ell)
                        live = ((t < n) & (u < n) & (ell >= 0) & (ell < span)
                                & (l0 + ell < n_lags))
                        lags, frames = np.broadcast_arrays(l0 + ell, t)
                        np.add.at(count, (lags[live], frames[live]), 1)
        for ell in range(min(span, n_lags - l0)):
            lag = l0 + ell
            assert ell + cuda_lag.ACF_ROWS - 1 < 8 * tiles
            diag = gram[:, np.arange(cuda_lag.ACF_ROWS),
                        ell + np.arange(cuda_lag.ACF_ROWS)]
            out[lag] = diag.sum(1) / (n - lag)
    return out, count


ACF_SPLIT_CASES = [  # (N, n_lags): N below the 16 frame phases, not a
    # multiple of them, not a multiple of the chunk; n_lags 1, a CTA's most
    # lags and one either side of it, all N
    (n, n_lags) for n in (5, 45, 1100) for n_lags in sorted(
        {1, cuda_lag.ACF_SPAN - 1, cuda_lag.ACF_SPAN, cuda_lag.ACF_SPAN + 1,
         n} & set(range(1, n + 1)))]


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n,n_lags", ACF_SPLIT_CASES)
def test_acf_gram_split_sums_each_pair_once(n, n_lags, d):
    """K8's acf work split: every (frame t, lag) pair with t + lag < N is
    summed exactly once, and no other; the diagonal sums of the replayed
    Gram matrices meet the plain version within 1e-12 and the TPU's float32
    kernel (K8a, interpret mode) within its 1e-5."""
    x32 = np.random.RandomState(n + d + n_lags).normal(
        0.3, 1.5, (n, 3, d)).astype(np.float32)
    x = x32.astype(np.float64)
    got, count = acf_gram_replay(x, n_lags)
    lag, i = np.indices((n_lags, n))
    np.testing.assert_array_equal(count, (i + lag < n).astype(np.int64))
    ref = cuda_lag.lag_sums_plain(torch.from_numpy(x), n_lags).numpy()
    assert rel(got, ref) <= TOL
    ref32 = np.asarray(windowed_lag_pallas(x32, max_lag=n_lags, mode="acf"))
    assert rel(got, ref32) <= F32_TOL


@pytest.mark.parametrize("n_lags,spans,span", [
    (1, 1, 1), (497, 1, 497), (498, 2, 249), (2048, 5, 410),
    (8192, 17, 482)])
def test_acf_spans_spread_the_lags(n_lags, spans, span):
    """As few spans as a CTA's lags allow, the lags spread evenly: the
    deep windowed VACF's 2,048 lags and the model's 8,192."""
    assert cuda_lag.acf_spans(n_lags) == (spans, span)
    assert (spans - 1) * span < n_lags <= spans * span


def test_acf_fragment_reads_avoid_bank_conflicts():
    """Every fragment register a warp reads from shared memory: the 16
    lanes of each half-warp (lane = 4g + t) fall on 16 distinct bank pairs
    of 8-byte words, and every row lies inside its component's stride;
    the CTA's shared memory within Hopper's 227 KB."""
    rows, k, steps = cuda_lag.ACF_ROWS, cuda_lag.ACF_MMA_K, cuda_lag.ACF_STEPS
    chunk, cols = cuda_lag.ACF_CHUNK, cuda_lag.ACF_COLS
    g, t = np.arange(32) // 4, np.arange(32) % 4
    reads = []
    for s in range(steps):
        a = cuda_lag.acf_frame_rows(s)
        for i in range(k // 4):
            for h in range(2):
                reads.append((a[t + 4 * i, g + 8 * h], chunk))
    for v in range(steps + cuda_lag.ACF_RING - 1):
        for warp in range(cuda_lag.ACF_WARPS):
            for e in range(2):
                b = cuda_lag.acf_partner_rows(v, warp, e)
                for i in range(k // 4):
                    reads.append((b[t + 4 * i, g], chunk + cols))
    for lane_rows, limit in reads:
        assert lane_rows.max() < limit
        slots = cuda_lag.acf_smem_row(lane_rows)
        assert slots.max() < cuda_lag.acf_smem_row(limit)
        for half in (slice(0, 16), slice(16, 32)):
            assert len(set(slots[half] % 16)) == 16
    stage = 3 * (cuda_lag.acf_smem_row(chunk) + cuda_lag.acf_smem_row(
        chunk + cols)) * (8 + 8)
    assert max(stage, rows * (cols + 8) * 8) <= 232_448


# --- the ops against the JAX XLA windowed kernels --------------------------


@pytest.mark.parametrize("shape,max_lag", [((200, 7, 3), None),
                                           ((200, 7, 3), 31),
                                           ((97, 4), None),
                                           ((150, 5, 2), 150),
                                           ((120, 4, 5), None),
                                           ((90, 3, 7), 40)])
def test_acf_windowed_vs_jax(shape, max_lag):
    x = np.random.RandomState(len(shape) + shape[0]).normal(0.0, 3.0, shape)
    ref = np.asarray(jops.acf_windowed(x, max_lag=max_lag))
    got = ta.ops.acf_windowed(x, max_lag=max_lag, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("shape,max_lag", [((200, 7, 3), None),
                                           ((200, 7, 3), 31),
                                           ((97, 4), None),
                                           ((120, 4, 5), 60),
                                           ((90, 3, 7), None)])
def test_einstein_windowed_vs_jax(shape, max_lag, reduce_mode):
    """A large offset on every series: the windowed path differences the
    raw series, with no centering, as the reference does."""
    rng = np.random.RandomState(shape[0])
    a = rng.normal(size=shape).cumsum(0) + 1e3
    ref = np.asarray(jops.einstein_difference_windowed(a, reduce_mode,
                                                       max_lag))
    got = ta.ops.einstein_difference_windowed(a, reduce_mode, max_lag,
                                              device="cpu")
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref) <= TOL
    assert np.all(got.numpy()[0] == 0.0)


def test_msd_fft_and_from_f32_vs_jax():
    r = np.random.RandomState(3).normal(size=(120, 6, 3)).cumsum(0)
    ref = np.asarray(jops.msd_fft(r))
    assert rel(ta.ops.msd_fft(r, device="cpu").numpy(), ref) <= TOL
    r32 = r.astype(np.float32)
    ref = np.asarray(jops.einstein_difference_fft_from_f32(r32, "sum"))
    got = ta.ops.einstein_difference_fft_from_f32(r32, "sum", device="cpu")
    assert got.dtype == torch.float64
    assert rel(got.numpy(), ref) <= TOL
    with pytest.raises(TypeError):
        ta.ops.einstein_difference_fft_from_f32(r, device="cpu")


# --- the models with fft=False against JAX fft=False ------------------------


@pytest.fixture(scope="module")
def systems(u_random, step_vtraj, step_vtraj_full):
    """name -> (JAX universe, port universe)."""
    return {name: (u, port_universe(u)) for name, u in
            (("random", u_random), ("step", step_vtraj),
             ("step_full", step_vtraj_full))}


def assert_vacf_matches(got, ref):
    assert got.results.vacf_by_particle.shape == \
        ref.results.vacf_by_particle.shape
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.vacf_by_particle,
               ref.results.vacf_by_particle) <= TOL
    for fn in ("self_diffusivity_gk", "self_diffusivity_gk_odd"):
        assert getattr(got, fn)() == pytest.approx(getattr(ref, fn)(),
                                                   rel=SCALAR_TOL)


@pytest.mark.parametrize("engine", [None, "frame"])
@pytest.mark.parametrize("dim_type", [dim for dim, _ in ALL_DIMS])
def test_vacf_windowed_vs_jax(systems, dim_type, engine):
    ju, pu = systems["random"]
    ref = jta.VelocityAutocorr(ju.atoms, dim_type=dim_type, fft=False,
                               max_lag=8).run()
    got = ta.VelocityAutocorr(pu.atoms, dim_type=dim_type, fft=False,
                              max_lag=8, engine=engine, device="cpu").run()
    assert got.results.timeseries.shape == (8,)
    assert_vacf_matches(got, ref)


@pytest.mark.parametrize("dim_type,max_lag", [("xyz", None), ("yz", 1000)])
def test_vacf_windowed_step_vs_jax(systems, dim_type, max_lag):
    ju, pu = systems["step"]
    ref = jta.VelocityAutocorr(ju.atoms, dim_type=dim_type, fft=False,
                               max_lag=max_lag).run()
    got = ta.VelocityAutocorr(pu.atoms, dim_type=dim_type, fft=False,
                              max_lag=max_lag, device="cpu").run()
    assert_vacf_matches(got, ref)


@pytest.mark.parametrize("system,dim_type,window,max_lag", [
    ("random", "xyz", (2, 9), None), ("random", "xz", (2, 9), None),
    ("random", "x", (1, 6), 7), ("step_full", "xyz", (10, 100), None),
    ("step_full", "xy", (10, 100), 400),
])
def test_viscosity_windowed_vs_jax(systems, system, dim_type, window,
                                   max_lag):
    ju, pu = systems[system]
    ref = jta.ViscosityHelfand(ju.atoms, dim_type=dim_type, fft=False,
                               linear_fit_window=window,
                               max_lag=max_lag).run()
    got = ta.ViscosityHelfand(pu.atoms, dim_type=dim_type, fft=False,
                              linear_fit_window=window, max_lag=max_lag,
                              device="cpu").run()
    assert got.results.visc_by_particle.shape == \
        ref.results.visc_by_particle.shape
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    assert rel(got.results.visc_by_particle,
               ref.results.visc_by_particle) <= TOL
    assert got.results.timeseries[0] == 0.0
    assert got.results.viscosity == pytest.approx(ref.results.viscosity,
                                                  rel=SCALAR_TOL)


def test_windowed_engines_and_algorithms_agree(systems):
    """fft=False against fft=True in the port (the reference's decimal=4
    cross-check, here far tighter), and the frame engine against the
    batch engine."""
    _, pu = systems["random"]
    for model in (ta.VelocityAutocorr, ta.ViscosityHelfand):
        win = model(pu.atoms, fft=False, device="cpu").run()
        fft = model(pu.atoms, device="cpu").run()
        frame = model(pu.atoms, fft=False, engine="frame",
                      device="cpu").run()
        assert rel(win.results.timeseries, fft.results.timeseries) <= 1e-11
        assert rel(frame.results.timeseries, win.results.timeseries) <= TOL


@pytest.mark.parametrize("tdim,tdim_factor", ALL_DIMS)
def test_windowed_step_oracle(systems, NSTEP, tdim, tdim_factor):
    """The closed-form VACF of the unit-step trajectory
    (tests/test_velocityautocorr.py TestAllDims with fft=False), over the
    whole run and a start/stop/step selection."""
    _, pu = systems["step"]
    v = ta.VelocityAutocorr(pu.atoms, dim_type=tdim, fft=False,
                            device="cpu").run()
    poly = characteristic_poly(NSTEP, tdim_factor)
    assert rel(v.results.timeseries, poly) <= TOL
    v = ta.VelocityAutocorr(pu.atoms, dim_type=tdim, fft=False,
                            device="cpu").run(start=10, stop=1000, step=10)
    poly = characteristic_poly(1000, tdim_factor, first=10, step=10)
    assert rel(v.results.timeseries, poly) <= TOL


# --- EinsteinMSD ---------------------------------------------------------------


@pytest.fixture(scope="module")
def walk():
    """tests/test_msd.py's random walk: (JAX universe, port universe)."""
    rng = np.random.RandomState(11)
    pos = np.cumsum(rng.normal(size=(64, 5, 3)), axis=0)
    ju = jta.Universe.empty(5)
    ju.load_new(pos.astype(np.float32))
    pu = ta.Universe.empty(5)
    pu.load_new(pos.astype(np.float32))
    return ju, pu


@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("msd_type,dims", [
    ("xyz", [0, 1, 2]), ("xy", [0, 1]), ("xz", [0, 2]), ("yz", [1, 2]),
    ("x", [0]), ("y", [1]), ("z", [2])])
def test_msd_vs_jax_and_brute_force(walk, msd_type, dims, fft):
    ju, pu = walk
    ref = jta.EinsteinMSD(ju.atoms, msd_type=msd_type, fft=fft).run()
    got = ta.EinsteinMSD(pu.atoms, msd_type=msd_type, fft=fft,
                         device="cpu").run()
    assert got.results.msds_by_particle.shape == (64, 5)
    assert rel(got.results.msds_by_particle,
               ref.results.msds_by_particle) <= TOL
    assert rel(got.results.timeseries, ref.results.timeseries) <= TOL
    brute = brute_force_msd(pu.trajectory.get_array("positions"), dims)
    assert rel(got.results.msds_by_particle, brute) <= TOL


@pytest.mark.parametrize("engine,max_lag", [(None, 20), ("frame", None)])
def test_msd_select_and_engines_vs_jax(systems, engine, max_lag):
    """``select=`` on a Universe and on an AtomGroup, ``max_lag``, both
    engines and both algorithms."""
    ju, pu = systems["random"]
    for fft in (True, False):
        ref = jta.EinsteinMSD(ju, select="resid 1-5", fft=fft,
                              max_lag=max_lag).run()
        got = ta.EinsteinMSD(pu, select="resid 1-5", fft=fft,
                             max_lag=max_lag, engine=engine,
                             device="cpu").run()
        assert got.n_particles == 5
        assert rel(got.results.msds_by_particle,
                   ref.results.msds_by_particle) <= TOL
        sub = ta.EinsteinMSD(pu.atoms, select="resid 1-5", fft=fft,
                             max_lag=max_lag, device="cpu").run()
        assert rel(sub.results.timeseries, got.results.timeseries) <= TOL
        whole = ta.EinsteinMSD(pu.select_atoms("resid 1-5"), fft=fft,
                               max_lag=max_lag, device="cpu").run()
        assert rel(whole.results.timeseries, got.results.timeseries) <= TOL


@pytest.mark.parametrize("engine", [None, "frame"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_msd_fft_leaves_its_feed_alone(engine, dtype):
    """The FFT path centers its operand in place; the model hands it a
    copy of its own, never its feed (the float32 samples as read), in
    either work dtype: under float32 on the CPU the operand's ``.to``
    makes no copy by itself."""
    u = ta.Universe.empty(4)
    u.load_new(np.cumsum(np.random.RandomState(5).normal(size=(40, 4, 3)),
                         axis=0).astype(np.float32))
    pos = u.trajectory.get_array("positions").copy()
    first = ta.EinsteinMSD(u, engine=engine, dtype=dtype,
                           device="cpu").run()
    np.testing.assert_array_equal(u.trajectory.get_array("positions"), pos)
    if engine is None:
        assert first._positions.dtype == np.float32
        np.testing.assert_array_equal(first._positions, pos)
    again = ta.EinsteinMSD(u, engine=engine, dtype=dtype,
                           device="cpu").run()
    np.testing.assert_array_equal(again.results.msds_by_particle,
                                  first.results.msds_by_particle)
    brute = brute_force_msd(pos.astype(np.float64), [0, 1, 2])
    tol = F32_TOL if dtype == np.float32 else TOL
    assert rel(first.results.msds_by_particle, brute) <= tol


@pytest.mark.parametrize("engine", [None, "frame"])
def test_msd_requires_positions(engine):
    u = ta.Universe.empty(3, n_frames=4, velocities=True)
    u.trajectory._pos = None
    u.trajectory.ts._positions = None
    with pytest.raises(NoDataError, match="requires positions"):
        ta.EinsteinMSD(u.atoms, engine=engine, device="cpu").run()


def test_msd_not_ported_options(systems):
    """Work dtypes other than float64 and float32 raise, as a bad
    msd_type does."""
    _, pu = systems["random"]
    with pytest.raises(ValueError, match="float64 or float32"):
        ta.EinsteinMSD(pu, dtype=np.float16)
    with pytest.raises(ValueError, match="invalid dim_type"):
        ta.EinsteinMSD(pu, msd_type="xyzt")


def test_reference_import_paths():
    from transport_analysis_tpu_torch.velocityautocorr import (
        VelocityAutocorr)
    from transport_analysis_tpu_torch.viscosity import ViscosityHelfand

    assert VelocityAutocorr is ta.VelocityAutocorr
    assert ViscosityHelfand is ta.ViscosityHelfand

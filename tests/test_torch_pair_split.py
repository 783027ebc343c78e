"""K8's two-block launch (``ops.cuda_lag.lag_sums_pair``, the exact ring's
pair sums) replayed in numpy from the work split that ``cuda_lag`` lists,
as ``csrc/lag.cu`` runs it (``acf_pair_kernel``, ``einstein_pair_kernel``,
``einstein_pair_rows_kernel``): every (base frame, partner frame) pair
whose lag lies in the window is summed exactly once and no other pair,
each shared-memory row a warp reads is there when it reads it, and the
replayed sums meet the plain version (and so the JAX package's
``_pair_accumulate``, ``tests/test_torch_ring.py``). The acf split's MMA
work against the band's pair-components and the shared memory of its CTA
are checked from the listed constants.

Bound: 1e-12 of the maximum for float64 sums, 1e-5 for float32 ones.
"""

import numpy as np
import pytest
import torch

from transport_analysis_tpu_torch.ops import cuda_lag
from transport_analysis_tpu_torch.parallel import ring

TOL = 1e-12
F32_TOL = 1e-5
BLOCKS = 4  # the ring's blocks


def windows(n):
    """(offset, lag_lo, n_lags) of rounds 0, 1 and 3 of a ring of BLOCKS
    blocks of ``n`` frames, a window past the pairs at both ends, and two
    that start and end inside the band of pairs."""
    out = []
    for k in (0, 1, 3):
        lo, count = ring.round_window(k, n, BLOCKS * n)
        out.append((k * n, lo, count))
    out += [(n + 7, 0, 3 * n), (n, n // 2 + 1, max(1, n - n // 3)),
            (0, n // 3, max(1, n // 2))]
    return out


CASES = [(n, *w) for n in (1, 31, 257, 1000, 2049) for w in windows(n)]


def expected_pairs(n, shift, n_lags):
    """(n_lags, n): 1 where base frame a pairs at relative lag j."""
    j, a = np.indices((n_lags, n))
    return ((a + j + shift >= 0) & (a + j + shift < n)).astype(np.int64)


def rel(got, ref):
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / (scale if scale else 1.0)


def band_pairs(n, a, b):
    """Σ_{a ≤ x < b} max(0, L − |x|), in closed form: the frame pairs of
    two L-frame blocks at partner offsets [a, b)."""
    total = 0
    lo, hi = max(a, 0), min(b, n)
    if hi > lo:
        total += (hi - lo) * n - (lo + hi - 1) * (hi - lo) // 2
    lo, hi = max(a, 1 - n), min(b, 0)
    if hi > lo:
        total += (hi - lo) * n + (lo + hi - 1) * (hi - lo) // 2
    return total


def whole_tile(n, i0, dw, tile_f):
    """Whether every lag of a warp (offsets dw + l) has its partner at
    every frame of the tile at ``i0``."""
    return (i0 + dw >= 0 and i0 + tile_f + dw + cuda_lag.LAG_BLOCK - 1 <= n
            and i0 + tile_f <= n)


def take(x, frames):
    """x[frames] with zeros for the frames outside the block."""
    n = x.shape[0]
    inside = (frames >= 0) & (frames < n)
    vals = x[np.clip(frames, 0, n - 1)]
    return np.where(inside.reshape(inside.shape + (1,) * (x.ndim - 1)),
                    vals, 0.0)


def acf_pair_replay(xa, xb, shift, n_lags):
    """The two-block acf launch: for each span in grid y's order, chunk,
    warp and step, the A and B fragments' rows (B through the ring of
    partner groups, whose slots it checks), the products of the warp's
    live tiles into the Gram matrix C, then each lag's diagonal sum.
    Returns the raw sums (n_lags, P) and the count of each (lag, base
    frame) pair a product added to a stored lag."""
    n, p, _ = xa.shape
    chunk, groups = cuda_lag.ACF_PAIR_CHUNK, cuda_lag.ACF_PAIR_GROUPS
    spans, span = cuda_lag.acf_pair_spans(n_lags)
    order = cuda_lag.pair_span_order(n_lags, shift, span)
    assert sorted(order) == list(range(spans))
    ring_slots = groups * cuda_lag.acf_pair_row(chunk)
    out = np.zeros((n_lags, p))
    count = np.zeros((n_lags, n), dtype=np.int64)
    phase = np.arange(cuda_lag.ACF_ROWS)
    for b in order:
        l0 = b * span
        d0 = l0 + shift
        tiles = cuda_lag.acf_tiles(min(span, n_lags - l0))
        starts = cuda_lag.acf_pair_chunks(n, d0, span)
        fb = starts.start + d0          # frame of partner row 0 of the span
        gram = np.zeros((p, cuda_lag.ACF_ROWS, cuda_lag.ACF_COLS))
        held = {}
        for g in (cuda_lag.acf_pair_groups(0) if len(starts) else ()):
            held[g % groups] = g
        for c, f0 in enumerate(starts):
            nxt = (cuda_lag.acf_pair_groups(c + 1) if c + 1 < len(starts)
                   else range(0))
            in_flight = {g % groups for g in nxt}
            for warp in range(cuda_lag.ACF_WARPS):
                live = cuda_lag.acf_pair_live(n, f0, d0, warp, tiles)
                for s in range(cuda_lag.ACF_PAIR_STEPS):
                    rows = cuda_lag.acf_pair_frame_rows(s)    # (K, 16)
                    assert rows.min() >= 0 and rows.max() < chunk
                    base = f0 + rows
                    a = take(xa, base)                        # (K, 16, P, d)
                    for e, i, m in live:
                        partner_rows = c * chunk + cuda_lag.acf_pair_partner_rows(
                            s + i, warp, e)                   # (K, 8)
                        for r in np.unique(partner_rows):
                            slot = (r // chunk) % groups
                            assert slot not in in_flight
                            assert held[slot] == r // chunk
                            assert cuda_lag.acf_pair_slot(r) < ring_slots
                        partner = fb + partner_rows
                        gram[:, :, m:m + 8] += np.einsum(
                            "kaqc,knqc->qan", a, take(xb, partner))
                        ell = cuda_lag.acf_column_lag(
                            m + np.arange(8)[None, None, :],
                            phase[None, :, None])
                        t = base[:, :, None]
                        u = partner[:, None, :]
                        assert np.all(u - t == d0 + ell)
                        ok = ((t < n) & (u >= 0) & (u < n) & (ell >= 0)
                              & (ell < span) & (l0 + ell < n_lags))
                        lags, frames = np.broadcast_arrays(l0 + ell, t)
                        np.add.at(count, (lags[ok], frames[ok]), 1)
            for g in nxt:
                held[g % groups] = g
        for ell in range(min(span, n_lags - l0)):
            assert ell + cuda_lag.ACF_ROWS - 1 < 8 * tiles
            out[l0 + ell] = gram[:, phase, ell + phase].sum(1)
    return out, count


def einstein_pair_replay(xa, xb, shift, n_lags, tile_f, f32):
    """The two-block einstein launch of tile ``tile_f``: for each span in
    grid y's order, tile and warp, the partner rows the warp reads from
    the ring (checked there and not in flight), the frames and lags its
    whole or masked inner loop sums, each term (xa − xb)² of the work
    type, partials joined to float64 running sums (float32 ones at most
    two of the warp's tiles). Returns the raw sums and the pair count."""
    n, p, _ = xa.shape
    wt = np.float32 if f32 else np.float64
    block = cuda_lag.LAG_BLOCK
    order = cuda_lag.pair_span_order(n_lags, shift, cuda_lag.SPAN)
    assert sorted(order) == list(range(-(-n_lags // cuda_lag.SPAN)))
    out = np.zeros((n_lags, p))
    count = np.zeros((n_lags, n), dtype=np.int64)
    a32, b32 = xa.astype(wt), xb.astype(wt)
    lanes = np.arange(block)
    for b in order:
        l0 = b * cuda_lag.SPAN
        d0 = l0 + shift
        i_lo, n_tiles = cuda_lag.einstein_pair_tiles(n, d0, tile_f)
        held = {}
        for r in (cuda_lag.ring_loads(0, tile_f) if n_tiles else ()):
            held[cuda_lag.ring_slot(r, tile_f)] = r
        acc = np.zeros((cuda_lag.TILE_WARPS, block, p))
        part = np.zeros((cuda_lag.TILE_WARPS, block, p), dtype=wt)
        for t in range(n_tiles):
            nxt = (cuda_lag.ring_loads(t + 1, tile_f) if t + 1 < n_tiles
                   else range(0))
            in_flight = {cuda_lag.ring_slot(r, tile_f) for r in nxt}
            i0 = i_lo + t * tile_f
            frames = i0 + np.arange(tile_f)
            for warp in range(cuda_lag.TILE_WARPS):
                lw = l0 + warp * block
                mine = cuda_lag.einstein_pair_warp_tiles(n, d0, warp, tile_f)
                if lw >= n_lags or t not in mine:
                    continue
                prime, new = cuda_lag.pair_window_rows(t, mine.start, warp,
                                                       tile_f)
                for r in [*prime, *new]:
                    slot = cuda_lag.ring_slot(r, tile_f)
                    assert slot not in in_flight and held[slot] == r
                dw = d0 + warp * block
                # the window's value for lag l at frame k: partner row
                # t·tile_f + k + warp·LAG_BLOCK + l, frame d0 + i_lo + row
                partner = (d0 + i_lo + t * tile_f + np.arange(tile_f)[:, None]
                           + warp * block + lanes[None, :])
                assert np.all(partner == frames[:, None] + dw + lanes)
                whole = whole_tile(n, i0, dw, tile_f)
                assert whole == (t in cuda_lag.einstein_pair_whole_tiles(
                    n, d0, warp, tile_f))
                if whole:
                    keep = np.ones((tile_f, block), dtype=bool)
                    assert np.all((partner >= 0) & (partner < n))
                    assert frames[-1] < n
                else:
                    keep = np.zeros((tile_f, block), dtype=bool)
                    for k, i in enumerate(frames):
                        keep[k, list(cuda_lag.einstein_pair_mask(n, i, dw))] = True
                ok = (frames[:, None] < n) & (partner >= 0) & (partner < n)
                assert np.array_equal(keep, ok)
                stored = keep & (lw + lanes[None, :] < n_lags)
                lags, fr = np.broadcast_arrays(lw + lanes[None, :],
                                               frames[:, None])
                np.add.at(count, (lags[stored], fr[stored]), 1)
                diff = (take(a32, frames)[:, None] - take(b32, partner)
                        ).astype(wt)                       # (F, 16, P, d)
                terms = np.where(keep[:, :, None],
                                 (diff * diff).sum(-1, dtype=wt), 0)
                part[warp] += terms.sum(0, dtype=wt)
                if not f32 or (t - mine.start) % 2 or t + 1 == mine.stop:
                    acc[warp] += part[warp]
                    part[warp] = 0
            for r in nxt:
                held[cuda_lag.ring_slot(r, tile_f)] = r
        for warp in range(cuda_lag.TILE_WARPS):
            lw = l0 + warp * block
            for ell in range(block):
                if lw + ell < n_lags:
                    out[lw + ell] = acc[warp, ell]
    return out, count


@pytest.mark.parametrize("n,offset,lag_lo,n_lags", CASES)
def test_acf_pair_split_sums_each_pair_once(n, offset, lag_lo, n_lags):
    """The acf split: each pair in the window summed exactly once, no
    other; the replayed sums meet the plain version."""
    rng = np.random.RandomState(n + lag_lo + n_lags)
    xa, xb = rng.normal(0.3, 1.5, (2, n, 2, 1))
    if offset == 0:
        xb = xa
    shift = lag_lo - offset
    got, count = acf_pair_replay(xa, xb, shift, n_lags)
    np.testing.assert_array_equal(count, expected_pairs(n, shift, n_lags))
    ref = cuda_lag.lag_sums_pair_plain(torch.from_numpy(xa),
                                       torch.from_numpy(xb), offset, lag_lo,
                                       n_lags).numpy()
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,offset,lag_lo,n_lags", CASES)
def test_einstein_pair_split_sums_each_pair_once(n, offset, lag_lo, n_lags,
                                                 dtype):
    """The einstein split, for the float64 sums' tile
    (einstein_pair_kernel) and the float32 ones' (einstein_pair_rows_
    kernel): the whole tiles and the masked ones sum each pair in the
    window exactly once, no other, and read only ring rows that are
    there; the replayed sums meet the plain version."""
    f32 = dtype == torch.float32
    tile_f = cuda_lag.tile_frames(dtype, dtype)
    rng = np.random.RandomState(n + lag_lo + n_lags + 1)
    xa, xb = rng.normal(0.3, 1.5, (2, n, 2, 1)).astype(
        np.float32 if f32 else np.float64)
    if offset == 0:
        xb = xa
    shift = lag_lo - offset
    got, count = einstein_pair_replay(xa, xb, shift, n_lags, tile_f, f32)
    np.testing.assert_array_equal(count, expected_pairs(n, shift, n_lags))
    ref = cuda_lag.lag_sums_pair_plain(torch.from_numpy(xa),
                                       torch.from_numpy(xb), offset, lag_lo,
                                       n_lags, "einstein").numpy()
    assert rel(got, ref) <= (F32_TOL if f32 else TOL)


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("n,k", [(257, 1), (31, 0), (300, 3)])
def test_pair_split_components(n, k, d):
    """Both replays over d = 1, 2, 3 components at a ring round, float64
    and float32 blocks, against the plain version's sums."""
    rng = np.random.RandomState(10 * n + d)
    xa, xb = rng.normal(0.5, 2.0, (2, n, 3, d))
    offset = k * n
    if k == 0:
        xb = xa
    lo, count = ring.round_window(k, n, BLOCKS * n)
    shift = lo - offset
    for f32 in (False, True):
        dt = np.float32 if f32 else np.float64
        a, b = xa.astype(dt), xb.astype(dt)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got, _ = acf_pair_replay(a.astype(np.float64), b.astype(np.float64),
                                 shift, count)
        ref = cuda_lag.lag_sums_pair_plain(ta, tb, offset, lo, count).numpy()
        assert rel(got, ref) <= (F32_TOL if f32 else TOL)
        tile_f = cuda_lag.tile_frames(ta.dtype, ta.dtype)
        got, _ = einstein_pair_replay(a, b, shift, count, tile_f, f32)
        ref = cuda_lag.lag_sums_pair_plain(ta, tb, offset, lo, count,
                                           "einstein").numpy()
        assert rel(got, ref) <= (F32_TOL if f32 else TOL)


@pytest.mark.parametrize("k,limit", [(0, 1.25), (1, 1.25), (3, 1.25)])
def test_acf_pair_work_follows_the_band(k, limit):
    """At the EC model system's ring (four blocks of 2,048 frames) the acf
    split's MMAs do at most 1.25x the pair-components of rounds 0, 1 and 3
    (1,024-frame chunks over each span's whole frame range did 1.69x,
    1.61x and 1.61x)."""
    block = 2048
    lo, count = ring.round_window(k, block, BLOCKS * block)
    work, pairs = cuda_lag.acf_pair_work(block, lo - k * block, count)
    assert pairs == sum(max(0, block - abs(lo - k * block + j))
                        for j in range(count))
    assert work <= limit * pairs


@pytest.mark.parametrize("n,n_lags,shift", [
    (2048, 4095, -2047), (2048, 2048, 0), (2048, 4095, -4096), (31, 10, -3),
    (1000, 1000, -999), (2049, 4097, -2048), (16384, 32767, -16383),
    (1, 1, 0), (300, 700, 300), (300, 900, -600), (257, 513, -256)])
@pytest.mark.parametrize("span", ["acf", "einstein"])
def test_pair_spans_run_from_the_most_pairs(n, n_lags, shift, span):
    """Grid x's spans of both launches: a permutation whose whole spans
    come in order of their pairs (the closed form ``band_pairs`` against a
    count over the lags), most first, and a shorter last span last."""
    width = (cuda_lag.acf_pair_spans(n_lags)[1] if span == "acf"
             else cuda_lag.SPAN)
    order = cuda_lag.pair_span_order(n_lags, shift, width)
    spans, whole = -(-n_lags // width), n_lags // width
    assert sorted(order) == list(range(spans))
    assert order[whole:] == list(range(whole, spans))
    pairs = []
    for b in order[:whole]:
        lags = range(b * width, (b + 1) * width)
        count = sum(max(0, n - abs(shift + j)) for j in lags)
        assert count == band_pairs(n, lags.start + shift, lags.stop + shift)
        pairs.append(count)
    assert all(x >= y for x, y in zip(pairs, pairs[1:]))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_acf_pair_shared_memory_fits_two_ctas(dtype, d):
    """The two-block acf CTA's shared memory under 113 KB for both block
    types at d <= 3, so that two CTAs share an SM (228 KB, 1 KB reserved a
    CTA): a block is copied straight into the buffers the fragments read,
    in its own type, with no landing buffer. The ring holds the three
    partner groups a chunk reads and the one in flight, and each fragment
    read falls on distinct banks: a half-warp's 16 8-byte words, or a
    warp's 32 4-byte ones."""
    smem = cuda_lag.acf_pair_smem_bytes(dtype, d)
    assert smem < 113 * 1024 and 2 * (smem + 1024) <= 233_472
    itemsize = torch.tensor([], dtype=dtype).element_size()
    banks, lanes = (16, (slice(0, 16), slice(16, 32))) if itemsize == 8 \
        else (32, (slice(0, 32),))
    chunk = cuda_lag.ACF_PAIR_CHUNK
    g, t = np.arange(32) // 4, np.arange(32) % 4
    top = 0
    for v in range(cuda_lag.ACF_PAIR_STEPS + cuda_lag.ACF_RING - 1):
        for warp in range(cuda_lag.ACF_WARPS):
            for e in range(2):
                rows = cuda_lag.acf_pair_partner_rows(v, warp, e)
                top = max(top, rows.max())
                for c in range(cuda_lag.ACF_PAIR_GROUPS):  # the ring turns
                    slots = cuda_lag.acf_pair_slot(c * chunk + rows[t, g],
                                                   itemsize)
                    for half in lanes:
                        assert len(set(slots[half] % banks)) == len(
                            range(32)[half])
    assert top < (cuda_lag.ACF_PAIR_GROUPS - 1) * chunk
    for s in range(cuda_lag.ACF_PAIR_STEPS):
        a = cuda_lag.acf_pair_frame_rows(s)
        for h in range(2):
            slots = cuda_lag.acf_pair_row(a[t, g + 8 * h], itemsize)
            for half in lanes:
                assert len(set(slots[half] % banks)) == len(range(32)[half])

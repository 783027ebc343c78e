"""Windowed lag sums: the exact (``fft=False``) path's kernel.

Counterpart of ``transport_analysis_tpu/ops/pallas_lag.py``. For the
series of an (N, P, d) operand and each lag < n_lags,

    acf:      out[lag, p] = Σ_{i<N-lag} Σ_c x[i,p,c]·x[i+lag,p,c] / ((N-lag)·dfac)
    einstein: out[lag, p] = Σ_{i<N-lag} Σ_c (x[i,p,c] − x[i+lag,p,c])²
                            / ((N-lag)·dfac),   out[0, p] = 0

with dfac = d for ``reduce_mode='mean'`` and 1 for ``'sum'``: the
reference's windowed summation (``_acf_windowed_impl``,
``_einstein_windowed_impl``), O(N·n_lags) per series. One CUDA kernel
(K8, ``csrc/lag.cu``) serves both modes, both operand types and both
work modes. The result's type follows the operand's, as the JAX
package's does (:func:`windowed_lag`): a float64 operand gives float64
sums (the TPU's double-float pair kernel K8b, whose N ≤ 2^17 cap does
not apply here), a float32 one float32 results at about 1e-6 grade (the
float32 work mode, the TPU's float32 kernel K8a): the acf mode keeps its
float64 Gram and rounds the result, the einstein mode takes float32
differences and squares and adds each frame tile's float32 partials to
a float64 running sum. The float64 work mode hands the kernel its
float32 samples with ``out_dtype=torch.float64`` (:func:`lag_sums`): they
are read at 4 bytes and upcast exactly, and the sums are the float64
sums of the float64 values. A launch takes d ≤ 3 components;
past that :func:`lag_sums` launches it once per group of
:func:`component_groups` and adds the groups' sums, so d is unbounded
as in the reference. The acf mode is a Gram product of
frame tiles on the FP64 tensor cores for a CTA of one particle × a span
of lags, whose work split :func:`acf_spans`, :func:`acf_tiles`,
:func:`acf_chunks`, :func:`acf_tile_columns`, :func:`acf_ring_loads`,
:func:`acf_frame_rows`, :func:`acf_partner_rows`, :func:`acf_column_lag`
and :func:`acf_smem_row` list; the einstein mode streams frame tiles
through shared memory for a CTA of particles × a span of lags, whose work
split :func:`einstein_tiles`, :func:`ring_slot`, :func:`ring_loads`,
:func:`window_rows` and :func:`tail_frames` list for the tile of
:func:`tile_frames`, as ``csrc/lag.cu`` runs them; the float32 work
mode's launch copies whole particle-major frame rows (:func:`row_copy`,
:func:`row_delta`, :func:`row_pitch`). The TPU routing switches
(``TRANSPORT_ANALYSIS_TPU_NO_PALLAS_LAG``, ``..._PALLAS_LAG_F64``, the
cap ≤ N/4 gate) have no counterpart: a CUDA tensor always takes the
kernel, a CPU tensor its plain version. :func:`lag_sums_pair` is K8's
two-block launch, the raw sums of frame pairs across two blocks of one
series: the exact ring's device work (``parallel.ring``). Its kernels
(``csrc/lag.cu`` ``acf_pair_kernel``, ``einstein_pair_kernel``,
``einstein_pair_rows_kernel``) follow the band of frame pairs: the spans
in :func:`pair_span_order`; the acf Gram product over spans of
:func:`acf_pair_spans` and chunks of ``ACF_PAIR_CHUNK`` base frames
(:func:`acf_pair_chunks`), a warp's tiles only where their partner rows
meet the block (:func:`acf_pair_live`), partner rows in a ring of
``ACF_PAIR_GROUPS`` groups (:func:`acf_pair_groups`,
:func:`acf_pair_slot`), rows in the operand's type
(:func:`acf_pair_row`, :func:`acf_pair_smem_bytes`); the einstein tiles over
each span's whole frame range (:func:`einstein_pair_tiles`), a warp's
tiles where it has a pair (:func:`einstein_pair_warp_tiles`), whole or
masked (:func:`einstein_pair_whole_tiles`, :func:`einstein_pair_mask`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.profiling import span

# acf mode, csrc/lag.cu's constants: kRows, kMmaK, kSteps, kChunk,
# kAcfWarps, kWarpTiles, kRing, kWarpCols, kAcfCols, kAcfSpan, kPadEvery,
# kPad
ACF_ROWS = 16            # frame phases p: the MMA's m
ACF_MMA_K = 4            # the MMA's k (m16n8k4)
ACF_STEPS = 16           # steps of a chunk; k-slice j of step s is row
                         # u = s + j·ACF_STEPS
ACF_CHUNK = ACF_ROWS * ACF_MMA_K * ACF_STEPS     # frames of a chunk
ACF_WARPS = 8
ACF_THREADS = 32 * ACF_WARPS
ACF_WARP_TILES = 8       # n8 tiles of a warp
ACF_RING = ACF_WARP_TILES // 2   # B fragments of a residue a warp holds
ACF_WARP_COLS = 8 * ACF_WARP_TILES
ACF_COLS = ACF_WARPS * ACF_WARP_COLS             # columns m of a CTA
ACF_SPAN = ACF_COLS - (ACF_ROWS - 1)             # most lags of a CTA
ACF_PAD_EVERY = ACF_ROWS * ACF_STEPS   # shared-memory rows between pads
ACF_PAD = 4                            # doubles of padding
# einstein mode, csrc/lag.cu's constants of the same names
LAG_BLOCK = 16           # kLagBlock: lags of a warp's register ring
TILE_P = 32              # kTileP: particles of a CTA, one per lane
TILE_WARPS = 8           # kWarps: warps of a CTA, LAG_BLOCK lags each
TILE_THREADS = 32 * TILE_WARPS
SPAN = TILE_WARPS * LAG_BLOCK    # kSpan: lags of a CTA
MAX_D = 3                # components one launch takes (lag_sums groups more)
# the two-block launch's acf layout, csrc/lag.cu's kPairSteps, kPairChunk,
# kPairPadEvery, kPairGroups, kPairReach
ACF_PAIR_STEPS = ACF_RING    # the fewest steps the Hankel ring allows
ACF_PAIR_CHUNK = ACF_ROWS * ACF_MMA_K * ACF_PAIR_STEPS   # base frames: 256
ACF_PAIR_PAD_EVERY = ACF_ROWS * ACF_PAIR_STEPS           # 64
ACF_PAIR_GROUPS = 4          # partner groups of ACF_PAIR_CHUNK rows held
# a tile's partner rows in a chunk past its first column: 16u + n, u < 16,
# n < 8
ACF_PAIR_REACH = ACF_PAIR_CHUNK - ACF_ROWS + 7
# lags the plain version takes at once: at most this many frame-lag-series
# values per block, so CPU tests and the card's checks stay small
PLAIN_BLOCK_VALUES = 1 << 22


def _check(x: torch.Tensor, n_lags: int, mode: str, reduce_mode: str,
           out_dtype: torch.dtype) -> None:
    if x.dtype not in (torch.float32, torch.float64) or x.ndim != 3:
        raise TypeError(f"lag_sums takes an (N, P, d) float32 or float64 "
                        f"tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if out_dtype not in (x.dtype, torch.float64):
        raise TypeError(f"lag_sums: a {x.dtype} operand gives {x.dtype} "
                        f"or float64 sums, not {out_dtype}")
    n, p, d = x.shape
    if n < 1 or p < 1 or d < 1:
        raise ValueError(f"lag_sums: empty operand {tuple(x.shape)}")
    if not 1 <= n_lags <= n:
        raise ValueError(f"lag_sums: n_lags = {n_lags} must lie in "
                         f"[1, N = {n}]")
    if mode not in ("acf", "einstein"):
        raise ValueError(f"mode must be 'acf' or 'einstein', got {mode!r}")
    if reduce_mode not in ("mean", "sum"):
        raise ValueError(f"reduce_mode must be 'mean' or 'sum', got "
                         f"{reduce_mode!r}")


def tile_frames(dtype: torch.dtype,
                out_dtype: torch.dtype = torch.float64) -> int:
    """Frames of the einstein mode's shared-memory tile for an operand of
    ``dtype`` and sums of ``out_dtype``: for float64 sums
    (``csrc/lag.cu`` einstein_tile_kernel, tile_frames) what the shared
    memory holds at d = 3; for float32 sums (einstein_rows_kernel,
    kRowsF) two lag blocks, so that two CTAs share an SM."""
    if out_dtype == torch.float32:
        return 2 * LAG_BLOCK
    return 4 * LAG_BLOCK if dtype == torch.float32 else 2 * LAG_BLOCK


def ring_rows(tile_f: int) -> int:
    """The partner-row slots of the ring (``csrc/lag.cu`` ring_rows)."""
    return 2 * tile_f + SPAN


def acf_spans(n_lags: int) -> tuple[int, int]:
    """(spans, lags of a span) of the acf launch: as few spans of at most
    ACF_SPAN lags as cover ``n_lags``, the lags spread evenly over them;
    span b takes lags [b·span, (b+1)·span) (grid y)."""
    spans = -(-n_lags // ACF_SPAN)
    return spans, -(-n_lags // spans)


def acf_tiles(span: int) -> int:
    """The n8 column tiles of a CTA that the span's lags need: lag l0 + ℓ
    sums C[p, ℓ + p] over p < ACF_ROWS, so columns ℓ + p < span + 15."""
    return -(-(span + ACF_ROWS - 1) // 8)


def acf_chunks(n: int, l0: int) -> range:
    """The first frames f0 of the chunks of a span at first lag ``l0``:
    frames t < N − l0, the only ones with a partner t + lag < N."""
    return range(0, n - l0, ACF_CHUNK)


def acf_tile_columns(warp: int, tiles: int) -> list[tuple[int, int, int]]:
    """(residue e, ring offset i, first column m) of each tile of ``warp``
    that the CTA's ``tiles`` include: m = ACF_WARP_COLS·warp + 8e + 16i,
    tile index m / 8 < tiles."""
    out = []
    for e in range(2):
        for i in range(ACF_RING):
            m = ACF_WARP_COLS * warp + 8 * e + 16 * i
            if m // 8 < tiles:
                out.append((e, i, m))
    return out


def acf_ring_loads(s: int) -> range:
    """The steps v whose B fragment a warp reads at step ``s`` into ring
    slot v mod ACF_RING: the first ACF_RING − 1 before step 0, then one a
    step; tile (e, i) at step s uses slot (s + i) mod ACF_RING, which holds
    v = s + i."""
    if s < 0:
        return range(0, ACF_RING - 1)
    return range(s + ACF_RING - 1, s + ACF_RING)


def acf_frame_rows(s: int) -> np.ndarray:
    """(ACF_MMA_K, ACF_ROWS) frame rows, from the chunk's first frame, of
    the A fragment at step ``s``: k-slice j, phase p → 16(s + j·ACF_STEPS)
    + p."""
    j = np.arange(ACF_MMA_K)[:, None]
    return ACF_ROWS * (s + j * ACF_STEPS) + np.arange(ACF_ROWS)[None, :]


def acf_partner_rows(v: int, warp: int, e: int) -> np.ndarray:
    """(ACF_MMA_K, 8) partner rows, from frame f0 + l0, of the B fragment
    that ring slot v mod ACF_RING holds for residue ``e``: the fragment of
    column tile ACF_WARP_COLS·warp + 8e at step v, k-slice j, column n →
    16(v + j·ACF_STEPS) + ACF_WARP_COLS·warp + 8e + n. Under the Hankel
    shift it is tile m + 16i's fragment at step v − i."""
    j = np.arange(ACF_MMA_K)[:, None]
    return (ACF_ROWS * (v + j * ACF_STEPS) + ACF_WARP_COLS * warp + 8 * e
            + np.arange(8)[None, :])


def acf_column_lag(m, p):
    """The lag, from the span's first, that C[p, m] adds to: m − p."""
    return m - p


def acf_smem_row(r):
    """The shared-memory slot of frame row ``r`` of a component: ACF_PAD
    doubles of padding every ACF_PAD_EVERY rows, so a half-warp's 16 reads
    of a fragment fall on 16 distinct bank pairs."""
    return r + ACF_PAD * (r // ACF_PAD_EVERY)


def einstein_tiles(n: int, l0: int, tile_f: int) -> int:
    """The whole frame tiles of the einstein CTA at first lag ``l0``:
    tile t covers frames [t·tile_f, (t+1)·tile_f), at which every lag of
    the span has its partner (i + l0 + SPAN − 1 < N)."""
    return max(0, n - l0 - (SPAN - 1)) // tile_f


def ring_slot(r: int, tile_f: int) -> int:
    """The ring slot of partner row l0 + r."""
    return (r + 1) % ring_rows(tile_f)


def ring_loads(t: int, tile_f: int) -> range:
    """The partner rows r (row l0 + r) of tile t's copies: t = 0 the first
    tile_f + SPAN − 1, copied before the tiles, else the tile_f rows that
    tile t adds, issued just after the barrier that opens tile t − 1 and
    landing while tile t − 1 is summed."""
    if t == 0:
        return range(0, tile_f + SPAN - 1)
    return range(t * tile_f + SPAN - 1, (t + 1) * tile_f + SPAN - 1)


def window_rows(t: int, warp: int, tile_f: int) -> tuple[range, range]:
    """The partner rows r a warp reads from the ring in tile t: the rows
    it primes its register window with (tile 0 only), and the new row of
    each frame k, r = t·tile_f + k + warp·LAG_BLOCK + LAG_BLOCK − 1."""
    first = warp * LAG_BLOCK
    prime = range(first, first + LAG_BLOCK - 1) if t == 0 else range(0)
    start = t * tile_f + first + LAG_BLOCK - 1
    return prime, range(start, start + tile_f)


def tail_frames(n: int, l0: int, warp: int, tile_f: int) -> range:
    """The frames a warp sums past the tiles, from global memory in
    chunks of LAG_BLOCK, each of its lags masked by i + lag < N."""
    return range(einstein_tiles(n, l0, tile_f) * tile_f,
                 max(0, n - l0 - warp * LAG_BLOCK))


def row_pitch(d: int) -> int:
    """Floats of a row slot of the float32 einstein launch (``csrc/lag.cu``
    row_pitch): a tile row's TILE_P·d values and its 16-byte chunks'
    edges."""
    return TILE_P * d + 4


def row_copy(addr: int, f: int, p: int, p0: int, d: int
             ) -> tuple[int, int, int]:
    """(first byte, bytes, delta) of the 16-byte copies of frame row f of
    particles [p0, p0 + TILE_P) of a float32 operand at byte address
    ``addr`` in the float32 einstein launch (``csrc/lag.cu`` copy_rows):
    the chunks that hold its min(TILE_P, P − p0)·d values, so the row
    lands delta values into its slot."""
    start = addr + 4 * (f * p + p0) * d
    v = min(TILE_P, p - p0) * d
    a0 = start & ~15
    return a0, ((start + 4 * v + 15) & ~15) - a0, (start - a0) // 4


def row_delta(addr: int, f: int, p: int, p0: int, d: int) -> int:
    """The delta a lane reads frame row f at, from f mod 4 alone (tiles
    start at frames ≡ 0 mod 4): ((addr / 4) + p0·d + (f mod 4)·P·d) mod 4."""
    return ((addr >> 2) + p0 * d + (f % 4) * p * d) % 4


def pair_lo(reach: int) -> int:
    """The first frame of a block that pairs at some partner offset of
    at most ``reach`` (frame i pairs at offset δ iff 0 ≤ i + δ < L)."""
    return max(0, -reach)


def pair_hi(n: int, d0: int) -> int:
    """The end of the frames of an ``n``-frame block that pair at some
    partner offset of at least ``d0``."""
    return n - d0 if d0 > 0 else n


def pair_span_order(n_lags: int, shift: int, span: int) -> list[int]:
    """The spans of a two-block launch in launch order (``csrc/lag.cu``
    pair_span: grid x of the acf launch, grid y of the einstein ones), in
    order of their pairs, most first: relative lag j pairs
    L − |j + shift| base frames, a tent about j0 = −shift, so a whole
    span's pairs fall with the distance of its centre from j0. The order
    starts at the whole span whose centre lies nearest j0 and takes the
    whole spans outward, the nearer side first; a last span shorter than
    the others comes last."""
    spans, whole = -(-n_lags // span), n_lags // span
    twice = span - 1 + 2 * shift    # twice span 0's centre less j0
    first = min(max((span - twice) // (2 * span), 0), max(whole - 1, 0))
    right = 2 * first * span + twice <= 0
    m = min(first, whole - 1 - first)
    order = []
    for y in range(spans):
        if y >= whole:
            order.append(y)
        elif y == 0:
            order.append(first)
        elif y <= 2 * m:
            k = (y + 1) // 2
            order.append(first + k if (y % 2 == 1) == right else first - k)
        else:
            order.append(first + (y - m) if whole - 1 - first > first
                         else first - (y - m))
    return order


def acf_pair_spans(n_lags: int) -> tuple[int, int]:
    """(spans, lags of a span) of the two-block acf launch: spans of
    ACF_SPAN lags, the last one shorter, so that every span but the last
    fills a CTA's ACF_COLS columns and the four sub-partitions (warps w
    and w + 4) get the same tiles."""
    span = min(n_lags, ACF_SPAN)
    return -(-n_lags // span), span


def acf_pair_chunks(n: int, d0: int, span: int) -> range:
    """The first base frames of the chunks of a two-block acf span at
    partner offset ``d0`` (relative lag j pairs frame t with partner frame
    t + d0 + j − l0): the frames [f_lo, f_end) that pair with some lag of
    the span, in chunks of ACF_PAIR_CHUNK."""
    return range(pair_lo(d0 + span - 1), pair_hi(n, d0), ACF_PAIR_CHUNK)


def acf_pair_live(n: int, f0: int, d0: int, warp: int, tiles: int
                  ) -> list[tuple[int, int, int]]:
    """The tiles (e, i, m) of ``warp`` (:func:`acf_tile_columns`) that
    run in the chunk at base frame ``f0``: those whose partner frames in
    the chunk, f0 + d0 + m + [0, ACF_PAIR_REACH], meet the block."""
    return [(e, i, m) for e, i, m in acf_tile_columns(warp, tiles)
            if f0 + d0 + m + ACF_PAIR_REACH >= 0 and f0 + d0 + m < n]


def acf_pair_frame_rows(s: int) -> np.ndarray:
    """(ACF_MMA_K, ACF_ROWS) base rows, from the chunk's first frame, of
    the A fragment at step ``s``: k-slice j, phase p → 16(s +
    j·ACF_PAIR_STEPS) + p."""
    j = np.arange(ACF_MMA_K)[:, None]
    return ACF_ROWS * (s + j * ACF_PAIR_STEPS) + np.arange(ACF_ROWS)[None, :]


def acf_pair_partner_rows(v: int, warp: int, e: int) -> np.ndarray:
    """(ACF_MMA_K, 8) partner rows, from the chunk's first (row
    c·ACF_PAIR_CHUNK of the span for chunk c), of the B fragment of tile
    ACF_WARP_COLS·warp + 8e at step v: 16(v + j·ACF_PAIR_STEPS) +
    ACF_WARP_COLS·warp + 8e + n; tile m + 16i uses it at step v − i."""
    j = np.arange(ACF_MMA_K)[:, None]
    return (ACF_ROWS * (v + j * ACF_PAIR_STEPS) + ACF_WARP_COLS * warp
            + 8 * e + np.arange(8)[None, :])


def acf_pair_groups(c: int) -> range:
    """The partner groups (rows [g·ACF_PAIR_CHUNK, (g + 1)·ACF_PAIR_CHUNK)
    of the span) copied for chunk ``c``: 0, 1, 2 with chunk 0, then group
    c + 2, issued while chunk c − 1 is summed; chunk c reads groups c,
    c + 1, c + 2."""
    return range(0, 3) if c == 0 else range(c + 2, c + 3)


def acf_pair_pad(itemsize: int = 8) -> int:
    """Values of padding every ACF_PAIR_PAD_EVERY rows of a two-block acf
    buffer of ``itemsize``-byte values (``csrc/lag.cu`` pair_pad): rows
    stay in the operand's type in shared memory, and the lanes of a
    fragment read distinct banks, a half-warp's 16 8-byte words or a
    warp's 32 4-byte ones."""
    return 4 if itemsize == 8 else 8


def acf_pair_row(r, itemsize: int = 8):
    """The shared-memory slot of row ``r`` of a two-block acf buffer of
    ``itemsize``-byte values (``csrc/lag.cu`` pair_row)."""
    return r + acf_pair_pad(itemsize) * (r // ACF_PAIR_PAD_EVERY)


def acf_pair_slot(r, itemsize: int = 8):
    """The ring slot of partner row ``r`` of a span: group r //
    ACF_PAIR_CHUNK in slot group (r // ACF_PAIR_CHUNK) mod
    ACF_PAIR_GROUPS."""
    group_slots = acf_pair_row(ACF_PAIR_CHUNK, itemsize)
    return ((r // ACF_PAIR_CHUNK) % ACF_PAIR_GROUPS * group_slots
            + acf_pair_row(r % ACF_PAIR_CHUNK, itemsize))


def acf_pair_smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory of a two-block acf CTA (``csrc/lag.cu``
    acf_pair_smem_bytes): the ring of partner rows and two buffers of base
    rows, in the operand's type, copied straight in; the Gram rows take
    the same memory after the frame loop."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    rows = (d * (ACF_PAIR_GROUPS + 2) * acf_pair_row(ACF_PAIR_CHUNK, itemsize)
            * itemsize)
    return max(rows, ACF_ROWS * (ACF_COLS + 8) * 8)


def acf_pair_work(n: int, shift: int, n_lags: int) -> tuple[int, int]:
    """(frame-columns of the MMAs, pair-components) of one particle and
    component of a two-block acf launch: each live tile of a chunk costs
    ACF_PAIR_CHUNK frames × 8 columns; the block's pairs in the window
    number Σ_j max(0, L − |j + shift|)."""
    spans, span = acf_pair_spans(n_lags)
    work = 0
    for b in range(spans):
        d0 = b * span + shift
        tiles = acf_tiles(min(span, n_lags - b * span))
        for f0 in acf_pair_chunks(n, d0, span):
            for warp in range(ACF_WARPS):
                work += len(acf_pair_live(n, f0, d0, warp, tiles))
    pairs = sum(max(0, n - abs(j + shift)) for j in range(n_lags))
    return work * ACF_PAIR_CHUNK * 8, pairs


def einstein_pair_tiles(n: int, d0: int, tile_f: int) -> tuple[int, int]:
    """(i_lo, tiles) of a two-block einstein span at partner offset
    ``d0``: tiles of ``tile_f`` frames from i_lo cover [i_lo, i_hi), every
    frame that pairs with some lag of the span; partner row r of the span
    is frame d0 + i_lo + r of the partner block, zero outside it."""
    i_lo, i_hi = pair_lo(d0 + SPAN - 1), pair_hi(n, d0)
    return i_lo, max(0, -(-(i_hi - i_lo) // tile_f))


def einstein_pair_warp_tiles(n: int, d0: int, warp: int, tile_f: int
                             ) -> range:
    """The tiles in which the warp's lags (partner offsets dw + l, dw =
    d0 + warp·LAG_BLOCK, l < LAG_BLOCK) have some pair."""
    i_lo, _ = einstein_pair_tiles(n, d0, tile_f)
    dw = d0 + warp * LAG_BLOCK
    w_lo, w_hi = pair_lo(dw + LAG_BLOCK - 1), pair_hi(n, dw)
    t_lo = (w_lo - i_lo) // tile_f
    return range(t_lo, -(-(w_hi - i_lo) // tile_f) if w_hi > w_lo else t_lo)


def einstein_pair_whole_tiles(n: int, d0: int, warp: int, tile_f: int
                              ) -> range:
    """The tiles of :func:`einstein_pair_warp_tiles` that are whole,
    every lag of the warp (partner offsets dw + l) with its partner at
    every frame of the tile, as the kernel reckons them once a span
    (``csrc/lag.cu`` PairTiles w_lo, w_hi); the others run the masked
    loop (:func:`einstein_pair_mask`)."""
    i_lo, _ = einstein_pair_tiles(n, d0, tile_f)
    mine = einstein_pair_warp_tiles(n, d0, warp, tile_f)
    dw = d0 + warp * LAG_BLOCK
    first = -((dw + i_lo) // tile_f)        # ceil((−dw − i_lo) / tile_f)
    end = (n - dw - (LAG_BLOCK - 1) if dw + LAG_BLOCK - 1 > 0 else n) - i_lo
    lo = max(first, mine.start)
    hi = lo if end < tile_f else min(end // tile_f, mine.stop)
    return range(lo, max(lo, hi))


def einstein_pair_mask(n: int, i: int, dw: int) -> range:
    """The lags l < LAG_BLOCK of a warp whose term the masked inner loop
    keeps at base frame ``i``: i < L and 0 ≤ i + dw + l < L."""
    f = i + dw
    lo = min(max(-f, 0), LAG_BLOCK)
    hi = 0 if i >= n else min(max(n - f, 0), LAG_BLOCK)
    return range(lo, max(lo, hi))


def pair_window_rows(t: int, t_lo: int, warp: int, tile_f: int
                     ) -> tuple[range, range]:
    """The partner rows r a warp reads from the ring in tile t of a
    two-block einstein span: the rows it primes its window with (at its
    first tile t_lo), and the new row of each frame k, r = t·tile_f + k +
    warp·LAG_BLOCK + LAG_BLOCK − 1 (:func:`window_rows` from tile t_lo)."""
    first = t * tile_f + warp * LAG_BLOCK
    prime = range(first, first + LAG_BLOCK - 1) if t == t_lo else range(0)
    start = first + LAG_BLOCK - 1
    return prime, range(start, start + tile_f)


def lag_sums_plain(x: torch.Tensor, n_lags: int, mode: str = "acf",
                   reduce_mode: str = "sum",
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of :func:`lag_sums`: for each block of lags, the
    products x[i]·x[i+lag] or squared differences (x[i] − x[i+lag])² of
    the float64 values, reduced over the components and then summed over
    the frames i < N − lag, as the JAX package's windowed kernels do.
    For float32 results (the float32 work mode) the acf sums are the
    float64 ones rounded, and the einstein terms, differences, squares
    and their component sum, are float32, summed over the frames in
    float64, as the kernel does."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check(x, n_lags, mode, reduce_mode, out_dtype)
    n, p, d = x.shape
    s = p * d
    # the terms' type: float32 only for the float32 einstein sums
    f32_terms = mode == "einstein" and out_dtype == torch.float32
    xf = x.to(torch.float32 if f32_terms else torch.float64).reshape(n, s)
    dfac = d if reduce_mode == "mean" else 1
    out = torch.zeros((n_lags, p), dtype=torch.float64, device=x.device)
    block = max(1, min(n_lags, PLAIN_BLOCK_VALUES // (n * s)))
    xp = torch.cat([xf, xf.new_zeros((block, s))])
    lag0 = 1 if mode == "einstein" else 0   # lag 0 of einstein stays 0
    for l0 in range(lag0, n_lags, block):
        l1 = min(l0 + block, n_lags)
        lags = torch.arange(l0, l1, device=x.device)
        m = n - l0                      # frames the block's first lag uses
        # partner windows x[i + lag] for i < m, zero past N: (B, m, S)
        win = xp.unfold(0, m, 1)[l0:l1].transpose(1, 2)
        base = xf[:m]
        if mode == "acf":
            terms = base * win          # zero partners add nothing
        else:
            terms = (base - win).square()
        terms = terms.reshape(l1 - l0, m, p, d).sum(-1)
        frames = torch.arange(m, device=x.device)
        valid = frames[None, :] < (n - lags)[:, None]
        sums = torch.where(valid[:, :, None], terms, 0.0).sum(
            1, dtype=torch.float64)
        out[l0:l1] = sums / ((n - lags).to(torch.float64) * dfac)[:, None]
    return out.to(out_dtype)


def component_groups(d: int) -> list[tuple[int, int]]:
    """The component ranges [c0, c1) of K8's launches on an operand of d
    components: one range for d ≤ ``MAX_D``, else as few ranges of at
    most ``MAX_D`` components as cover d, their sizes differing by at
    most one."""
    groups = -(-d // MAX_D)
    bounds = [g * d // groups for g in range(groups + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def sum_component_groups(fn, x: torch.Tensor, n_lags: int, mode: str,
                         reduce_mode: str,
                         out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """The windowed lag sums of an operand of any d from ``fn`` (K8 or
    its plain version) over :func:`component_groups`: each group's
    ``'sum'`` result, in ``out_dtype`` (default the operand's type),
    added in order, divided once by dfac. Both modes sum over the
    components, so the grouping changes only the order of the additions;
    einstein's lag 0 stays exactly 0."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    total = None
    for c0, c1 in component_groups(x.shape[2]):
        part = fn(x[:, :, c0:c1].contiguous(), n_lags, mode, "sum",
                  out_dtype)
        total = part if total is None else total.add_(part)
    return total / x.shape[2] if reduce_mode == "mean" else total


def lag_sums(x: torch.Tensor, n_lags: int, mode: str = "acf",
             reduce_mode: str = "sum",
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K8: the windowed lag sums of the module docstring for lags
    < ``n_lags`` of an (N, P, d) float32 or float64 tensor → (n_lags, P)
    on its device, of ``out_dtype``: by default the operand's type (a
    float32 operand runs the float32 work mode's instantiation);
    float64 for a float32 operand gives the float64 sums of its exact
    upcast (the float64 work mode's float32 samples). A CUDA tensor
    launches the kernel or raises: once for d ≤ ``MAX_D``, past it once
    per :func:`component_groups` range (:func:`sum_component_groups`).
    A CPU tensor runs :func:`lag_sums_plain`. In a ``ta.lag`` span."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check(x, n_lags, mode, reduce_mode, out_dtype)
    with span("ta.lag"):
        if x.device.type == "cpu":
            return lag_sums_plain(x, n_lags, mode, reduce_mode, out_dtype)
        _build.kernel_operand(x, "lag_sums")
        if x.shape[2] > MAX_D:
            return sum_component_groups(_launch, x, n_lags, mode,
                                        reduce_mode, out_dtype)
        return _launch(x, n_lags, mode, reduce_mode, out_dtype)


def _launch(x: torch.Tensor, n_lags: int, mode: str, reduce_mode: str,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One K8 launch on a contiguous CUDA operand of d ≤ ``MAX_D``."""
    n, p, d = x.shape
    if mode == "einstein":
        lags, cols = SPAN, TILE_THREADS
        grid = _build.launch_grid(-(-p // TILE_P), -(-n_lags // SPAN))
    else:
        spans, lags = acf_spans(n_lags)
        cols = ACF_THREADS
        grid = _build.launch_grid(p, spans)
    out = torch.empty((n_lags, p), dtype=out_dtype, device=x.device)
    dfac = d if reduce_mode == "mean" else 1
    with torch.cuda.device(x.device):
        err = _build.entry("ta_lag_sums", out_dtype)(
            x.data_ptr(), out.data_ptr(), n, p, d, n_lags,
            int(x.dtype == torch.float64), int(mode == "einstein"),
            float(dfac), lags, cols, *grid, _build.stream(x))
    _build.check(err, "lag_sums")
    _build.count_launch(lag_sums, out_dtype)
    return out


lag_sums.launches = lag_sums.launches_f32 = 0


# ---------------------------------------------------------------------
# the two-block launch: the exact ring's device work (parallel/ring.py)
# ---------------------------------------------------------------------

def _check_pair(xa: torch.Tensor, xb: torch.Tensor, n_lags: int, mode: str,
                reduce_mode: str) -> None:
    if xb.shape != xa.shape or xb.dtype != xa.dtype or xb.device != xa.device:
        raise ValueError(f"lag_sums_pair: the blocks differ: {xa.dtype} "
                         f"{tuple(xa.shape)} on {xa.device} and {xb.dtype} "
                         f"{tuple(xb.shape)} on {xb.device}")
    _check(xa, 1, mode, reduce_mode, xa.dtype)
    if n_lags < 1:
        raise ValueError(f"lag_sums_pair: n_lags = {n_lags} must be >= 1")


def lag_sums_pair_plain(xa: torch.Tensor, xb: torch.Tensor, offset: int,
                        lag_lo: int, n_lags: int, mode: str = "acf",
                        reduce_mode: str = "sum") -> torch.Tensor:
    """Plain version of :func:`lag_sums_pair`: the JAX package's
    ``ring._pair_accumulate`` arithmetic (``ring.py:35-76``) in blocks of
    lags, as :func:`lag_sums_plain` takes them: for each lag, the partner
    window of ``xb`` shifted by δ = lag − offset (zero outside the block),
    the products or squared differences with ``xa`` reduced over the
    components, the pairs whose partner lies outside the block masked,
    then summed over the base frames in float64. Float32 einstein sums
    take float32 terms, as :func:`lag_sums_plain` does."""
    _check_pair(xa, xb, n_lags, mode, reduce_mode)
    n, p, d = xa.shape
    s = p * d
    f32_terms = mode == "einstein" and xa.dtype == torch.float32
    wt = torch.float32 if f32_terms else torch.float64
    a = xa.to(wt).reshape(n, s)
    zeros = a.new_zeros((n, s))
    # window i of the padded partner block holds xb[i - n …]: δ ↔ n + δ
    windows = torch.cat([zeros, xb.to(wt).reshape(n, s), zeros]).unfold(
        0, n, 1)
    dfac = d if reduce_mode == "mean" else 1
    out = torch.zeros((n_lags, p), dtype=torch.float64, device=xa.device)
    block = max(1, min(n_lags, PLAIN_BLOCK_VALUES // (n * s)))
    frames = torch.arange(n, device=xa.device)
    for j0 in range(0, n_lags, block):
        j1 = min(j0 + block, n_lags)
        delta = torch.arange(j0, j1, device=xa.device) + (lag_lo - offset)
        win = windows[n + delta.clamp(-n, n)].transpose(1, 2)  # (B, n, S)
        if mode == "acf":
            terms = a * win
        else:
            terms = (a - win).square()
        terms = terms.reshape(j1 - j0, n, p, d).sum(-1)
        partner = frames[None, :] + delta[:, None]
        valid = (partner >= 0) & (partner < n)
        out[j0:j1] = torch.where(valid[:, :, None], terms, 0.0).sum(
            1, dtype=torch.float64) / dfac
    return out.to(xa.dtype)


def lag_sums_pair(xa: torch.Tensor, xb: torch.Tensor, offset: int,
                  lag_lo: int, n_lags: int, mode: str = "acf",
                  reduce_mode: str = "sum") -> torch.Tensor:
    """K8's two-block launch: for two (L, P, d) blocks of one series, xa
    at frames [0, L) and xb at frames [offset, offset + L), the raw sums
    (not divided by N − lag) over every frame pair a, b < L with lag =
    offset + b − a in [lag_lo, lag_lo + n_lags) of

        acf:      Σ_c xa[a, p, c]·xb[b, p, c]
        einstein: Σ_c (xa[a, p, c] − xb[b, p, c])²

    divided by d for ``reduce_mode='mean'`` → (n_lags, P) of the blocks'
    type (float32 blocks run the float32 work mode's instantiation), row j
    holding lag lag_lo + j; lags with no pair give 0. Round 0 of the ring
    is xa = xb, offset 0, lag_lo 0: the pairs b ≥ a. A CUDA pair launches
    the two-block kernels (``csrc/lag.cu`` ``ta_lag_pair``:
    ``acf_pair_kernel``, ``einstein_pair_kernel``,
    ``einstein_pair_rows_kernel``) or raises, once per
    :func:`component_groups` range; a CPU pair runs
    :func:`lag_sums_pair_plain`."""
    _check_pair(xa, xb, n_lags, mode, reduce_mode)
    if xa.device.type == "cpu":
        return lag_sums_pair_plain(xa, xb, offset, lag_lo, n_lags, mode,
                                   reduce_mode)
    _build.kernel_operand(xa, "lag_sums_pair")
    _build.kernel_operand(xb, "lag_sums_pair")
    total = None
    for c0, c1 in component_groups(xa.shape[2]):
        part = _launch_pair(xa[:, :, c0:c1].contiguous(),
                            xb[:, :, c0:c1].contiguous(), lag_lo - offset,
                            n_lags, mode)
        total = part if total is None else total.add_(part)
    return total / xa.shape[2] if reduce_mode == "mean" else total


def _launch_pair(xa: torch.Tensor, xb: torch.Tensor, shift: int, n_lags: int,
                 mode: str) -> torch.Tensor:
    """One two-block launch on contiguous CUDA blocks of d ≤ ``MAX_D``:
    relative lag j pairs xa[a] with xb[a + j + shift]; raw sums. The acf
    launch takes the spans along grid x (:func:`pair_span_order`) and the
    particles along y; the einstein launch tiles of TILE_P particles along
    x and the spans along y."""
    n, p, d = xa.shape
    if mode == "einstein":
        lags, cols = SPAN, TILE_THREADS
        grid = _build.launch_grid(-(-p // TILE_P), -(-n_lags // SPAN))
    else:
        spans, lags = acf_pair_spans(n_lags)
        cols = ACF_THREADS
        grid = _build.launch_grid(spans, p)
    out = torch.empty((n_lags, p), dtype=xa.dtype, device=xa.device)
    with torch.cuda.device(xa.device):
        err = _build.entry("ta_lag_pair", xa.dtype)(
            xa.data_ptr(), xb.data_ptr(), out.data_ptr(), n, p, d, n_lags,
            shift, int(xa.dtype == torch.float64), int(mode == "einstein"),
            1.0, lags, cols, *grid, _build.stream(xa))
    _build.check(err, "lag_sums_pair")
    _build.count_launch(lag_sums_pair, xa.dtype)
    return out


lag_sums_pair.launches = lag_sums_pair.launches_f32 = 0


def windowed_lag(x, max_lag=None, mode: str = "acf",
                 reduce_mode: str = "sum") -> torch.Tensor:
    """Windowed lag correlation, the counterpart of the JAX package's
    ``windowed_lag_pallas`` (``pallas_lag.py:317``) under a name that
    does not say TPU: ``x`` (N, P, d) or (N, P) float32 or float64
    tensor, lags [0, max_lag) (default all N) → (n_lags, P) per-lag
    means of the operand's type, as the JAX function returns them
    (float32 in, float32 out: the float32 work mode), sums / (N − lag)
    (and / d for ``reduce_mode='mean'``), row 0 = 0 in ``'einstein'``
    mode."""
    if x.ndim == 2:
        x = x[:, :, None]
    n = x.shape[0]
    n_lags = n if max_lag is None else min(int(max_lag), n)
    return lag_sums(x.contiguous(), n_lags, mode, reduce_mode)

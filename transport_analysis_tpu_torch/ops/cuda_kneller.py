"""Kneller/Calandrini assembly of the Einstein lag differences.

Counterpart of ``transport_analysis_tpu/ops/pallas_kneller.py``: from the
per-frame squares ``sq`` (N, P) of the centered operand and its raw
component-summed autocorrelation ``corr`` (N, P),

    out[lag] = (css[N-1-lag] + total - css[lag-1] - 2·corr[lag]) / denom

with css the inclusive prefix sum of sq over frames, denom =
(N - lag)·(d if reduce_mode == "mean" else 1), and out[0] = 0.

K6a and K6b (``csrc/kneller.cu``), any N ≥ 1 and P ≥ 1 (the row blocks
fold over the grid, so N is not bounded by its y limit):
K6a :func:`kneller_totals` sums each block of ``KNELLER_ROWS`` frames,
forwards and in reverse frame order, from one read of ``sq`` (its work
split is :func:`totals_split` and :func:`totals_run`); K6b
:func:`kneller_windows` scans those totals once into each tile's suffix
offsets, adds in-tile suffix sums of ``sq`` to form the window sums and
applies the combine above (the TPU module's ``_finish``) in the same pass
(its work split is :func:`windows_split`, :func:`windows_tile`,
:func:`windows_lags` and :func:`scan_tiles`). On CPU tensors both run
their plain PyTorch versions.

``sq``, ``corr`` and the result are float64, or float32 in the float32
work mode (``dtype=np.float32``; the kernels' ``_f32`` entries). The
block totals, the scan and every running sum stay float64 in both: the
window sums meet 2·corr in a difference that cancels at small lags, which
the TPU kernel guards with compensated float32 pairs
(``pallas_kneller.py:27``). Only the result is rounded to float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build
from .._device import REAL_TYPES

KNELLER_ROWS = 128       # frames per block of both kernels
TOTALS_TILE = 32         # K6a: columns of a block, one a lane
TOTALS_MIN_RUN = 8       # K6a's row blocks a run where it reads a halo
WINDOWS_THREADS = 256    # K6b and its scan: threads a block (kThreads)
WINDOWS_RUN = 16         # K6b: consecutive lags of a thread (kRun)
WINDOWS_SEGMENT = 64     # K6b's scan: tiles a segment, at least


def totals_split(n: int) -> tuple[int, int, int]:
    """K6a's work split: ``(run, runs, r)``. A block of threads walks a
    run of ``run`` consecutive row blocks of ``TOTALS_TILE`` columns,
    ``runs`` runs cover the nb = ceil(N/R) row blocks, and every row
    block splits at its r-th row, r = N mod R. Where r > 0 a run first
    reads the hi of the row block before it, so runs are
    ``TOTALS_MIN_RUN`` blocks and that halo at most 1/8 of ``sq``;
    otherwise a run is one block."""
    nb = -(-n // KNELLER_ROWS)
    r = n % KNELLER_ROWS
    run = min(TOTALS_MIN_RUN if r else 1, nb)
    return run, -(-nb // run), r


def totals_run(n: int, j: int, run: int):
    """What K6a's run ``j`` of ``run`` blocks sums, as in
    ``csrc/kneller.cu``: ``(halo, blocks)``, ``halo`` the rows of the hi
    of the block before the run (``None`` where r = 0 or the run starts
    at block 0), ``blocks`` one ``(k, lo, hi, rev)`` per block k: its lo
    and hi row ranges, and the reversed block its lo completes (with the
    carried hi of block k − 1 where r > 0; where r = 0 the reversed block
    is block k's whole sum, hi alone)."""
    rows = KNELLER_ROWS
    nb, q, r = -(-n // rows), n // rows, n % rows
    k0, k1 = j * run, min((j + 1) * run, nb)
    halo = (range((k0 - 1) * rows + r, k0 * rows)
            if r and k0 > 0 else None)
    blocks = []
    for k in range(k0, k1):
        split = min(k * rows + r, n)
        lo = range(k * rows, split)
        hi = range(split, min((k + 1) * rows, n))
        blocks.append((k, lo, hi, q - 1 - k if r == 0 else q - k))
    return halo, blocks


class WindowsSplit(NamedTuple):
    """K6b's work split (``csrc/kneller.cu``). A block is ``cols``
    columns (32, or P rounded up to a power of two where P < 32) by
    ``lanes`` = WINDOWS_THREADS / cols row lanes; it takes a tile of
    ``tile_rows`` = lanes · WINDOWS_RUN lags, ``g`` of K6a's row blocks;
    ``tiles`` tiles cover the N lags and ``col_tiles`` the P columns. The
    scan of the totals takes ``segs`` segments of ``segt`` tiles, a row
    lane ``chunk`` consecutive tiles of its segment."""
    cols: int
    log2c: int
    lanes: int
    tile_rows: int
    g: int
    tiles: int
    col_tiles: int
    segt: int
    segs: int
    chunk: int


def windows_split(n: int, p: int) -> WindowsSplit:
    """K6b's split for ``sq`` of (n, p). Segments are WINDOWS_SEGMENT
    tiles, or ceil(sqrt(tiles)) where that is more, so that no segment
    sums more than ``segt`` later segments' totals."""
    cols = min(32, 1 << (p - 1).bit_length())
    log2c = cols.bit_length() - 1
    lanes = WINDOWS_THREADS // cols
    tile_rows = lanes * WINDOWS_RUN
    tiles = -(-n // tile_rows)
    segt = max(WINDOWS_SEGMENT, math.isqrt(tiles - 1) + 1)
    return WindowsSplit(cols, log2c, lanes, tile_rows,
                        tile_rows // KNELLER_ROWS, tiles, -(-p // cols), segt,
                        -(-tiles // segt), -(-segt // lanes))


def windows_lags(n: int, sp: WindowsSplit, tile: int, j: int) -> range:
    """The lags that row lane ``j`` of ``tile`` writes (and whose forward
    rows and reversed rows N − 1 − lag it reads), as in K6b."""
    l0 = tile * sp.tile_rows + j * WINDOWS_RUN
    return range(min(l0, n), min(l0 + WINDOWS_RUN, n))


def windows_tile(sp: WindowsSplit, y: int) -> int:
    """The tile that K6b's ``y``-th block row takes: tiles in mirror
    order, tile k then tile tiles − 1 − k, so a tile's reversed rows are
    read beside the tile that reads them forwards."""
    return sp.tiles - 1 - y // 2 if y % 2 else y // 2


def scan_tiles(sp: WindowsSplit, s: int, j: int) -> range:
    """The tiles whose offsets row lane ``j`` of the scan's segment ``s``
    writes, the last first (each the sum of the totals past it)."""
    end = min((s + 1) * sp.segt, sp.tiles)
    t0 = s * sp.segt + j * sp.chunk
    return range(min(t0, end), min(t0 + sp.chunk, end))


def _check_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype not in REAL_TYPES or t.ndim != 2:
        raise TypeError(f"{name} takes (N, P) float64 or float32, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")


def kneller_totals_plain(sq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`kneller_totals` (float64 totals of float64
    or float32 ``sq``)."""
    sq = sq.to(torch.float64)
    n, p = sq.shape
    nb = -(-n // KNELLER_ROWS)
    both = torch.stack([sq, sq.flip(0)])
    pad = torch.zeros((2, nb * KNELLER_ROWS - n, p), dtype=sq.dtype,
                      device=sq.device)
    return torch.cat([both, pad], dim=1).reshape(
        2, nb, KNELLER_ROWS, p).sum(2)


def kneller_totals(sq: torch.Tensor) -> torch.Tensor:
    """K6a: block totals of ``sq`` (N, P) float64 or float32 → (2, nb, P)
    float64: [0, b]
    sums frames [b·R, (b+1)·R), [1, b] the same positions of the frames
    read in reverse order (R = ``KNELLER_ROWS``, nb = ceil(N/R)). The
    kernel reads ``sq`` once: each block is summed as its lo and hi
    parts (:func:`totals_run`), which make both legs."""
    _check_operand(sq, "kneller_totals")
    if sq.device.type == "cpu":
        return kneller_totals_plain(sq)
    _build.kernel_operand(sq, "kneller_totals")
    n, p = sq.shape
    nb = -(-n // KNELLER_ROWS)
    run, runs, _ = totals_split(n)
    grid = _build.launch_grid(-(-p // TOTALS_TILE), runs)
    tot = torch.empty((2, nb, p), dtype=torch.float64, device=sq.device)
    with torch.cuda.device(sq.device):
        err = _build.entry("ta_kneller_totals", sq.dtype)(
            sq.data_ptr(), tot.data_ptr(), n, p, KNELLER_ROWS, nb, run, runs,
            *grid, _build.stream(sq))
    _build.check(err, "kneller_totals")
    _build.count_launch(kneller_totals, sq.dtype)
    return tot


kneller_totals.launches = kneller_totals.launches_f32 = 0


def kneller_windows_plain(sq: torch.Tensor, corr: torch.Tensor,
                          dfac: float) -> torch.Tensor:
    """Plain version of :func:`kneller_windows`; it needs no block
    totals. Like the kernel it takes total - css[lag-1] as the suffix
    sum Σ_{i >= lag} sq[i], not as a difference of prefixes, which at
    the deepest lags would cancel down to eps·total, and, like the
    kernel, it sums float32 operands in float64 and rounds the result."""
    out_dtype = sq.dtype
    sq, corr = sq.to(torch.float64), corr.to(torch.float64)
    n = sq.shape[0]
    css = torch.cumsum(sq, dim=0)
    suffix = torch.cumsum(sq.flip(0), dim=0).flip(0)
    w = css.flip(0) + suffix
    denom = (n - torch.arange(n, dtype=torch.float64, device=sq.device))
    out = (w - 2.0 * corr) / (denom * dfac)[:, None]
    out[0] = 0.0
    return out.to(out_dtype)


def kneller_windows(sq: torch.Tensor, corr: torch.Tensor, tot: torch.Tensor,
                    dfac: float) -> torch.Tensor:
    """K6b: the window sums from :func:`kneller_totals`' ``tot`` and
    in-tile suffix sums of ``sq``, combined with ``corr``:
    out[lag] = (w[lag] - 2·corr[lag]) / ((N - lag)·dfac), out[0] = 0,
    in the type of ``sq`` and ``corr`` (float64, or float32), the sums in
    float64. Three launches (the scan's two, then the windows), each
    counted."""
    _check_operand(sq, "kneller_windows")
    _check_operand(corr, "kneller_windows")
    n, p = sq.shape
    nb = -(-n // KNELLER_ROWS)
    if (corr.shape != sq.shape or corr.dtype != sq.dtype
            or tot.dtype != torch.float64
            or tot.shape != (2, nb, p)):
        raise ValueError("kneller_windows: sq, corr and tot disagree")
    if sq.device.type == "cpu":
        return kneller_windows_plain(sq, corr, dfac)
    for t, name in ((sq, "sq"), (corr, "corr"), (tot, "tot")):
        _build.kernel_operand(t, f"kneller_windows {name}")
    sp = windows_split(n, p)
    grid_x, grid_segs = _build.launch_grid(sp.col_tiles, sp.segs)
    grid_tiles = _build.launch_grid(sp.col_tiles, sp.tiles)[1]
    seg = torch.empty((2, sp.segs, p), dtype=torch.float64, device=sq.device)
    off = torch.empty((2, sp.tiles, p), dtype=torch.float64,
                      device=sq.device)
    out = torch.empty((n, p), dtype=sq.dtype, device=sq.device)
    with torch.cuda.device(sq.device):
        err = _build.entry("ta_kneller_windows", sq.dtype)(
            sq.data_ptr(), corr.data_ptr(), tot.data_ptr(), seg.data_ptr(),
            off.data_ptr(), out.data_ptr(), n, p, KNELLER_ROWS, nb,
            float(dfac), sp.log2c, sp.g, sp.tiles, sp.segt, sp.segs,
            sp.chunk, grid_x, grid_segs, grid_tiles, _build.stream(sq))
    _build.check(err, "kneller_windows")
    _build.count_launch(kneller_windows, sq.dtype, 3)
    return out


kneller_windows.launches = kneller_windows.launches_f32 = 0


def einstein_assembly(sq: torch.Tensor, corr: torch.Tensor,
                      reduce_mode: str, d: int) -> torch.Tensor:
    """The Kneller/Calandrini assembly (module docstring): K6a then K6b,
    each its plain version on CPU tensors."""
    if reduce_mode not in ("mean", "sum"):
        raise ValueError(f"reduce_mode must be 'mean' or 'sum', got "
                         f"{reduce_mode!r}")
    dfac = d if reduce_mode == "mean" else 1
    return kneller_windows(sq, corr, kneller_totals(sq), dfac)

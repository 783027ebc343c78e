"""Kneller/Calandrini assembly of the Einstein lag differences.

Counterpart of ``transport_analysis_tpu/ops/pallas_kneller.py``: from the
per-frame squares ``sq`` (N, P) of the centered operand and its raw
component-summed autocorrelation ``corr`` (N, P),

    out[lag] = (css[N-1-lag] + total - css[lag-1] - 2·corr[lag]) / denom

with css the inclusive prefix sum of sq over frames, denom =
(N - lag)·(d if reduce_mode == "mean" else 1), and out[0] = 0.

Two kernels (``csrc/kneller.cu``), native float64, any N ≥ 1 and P ≥ 1
(the row blocks fold over the grid, so N is not bounded by its y limit):
K6a :func:`kneller_totals` sums each block of ``KNELLER_ROWS`` frames,
forwards and in reverse frame order, from one read of ``sq`` (its work
split is :func:`totals_split` and :func:`totals_run`); K6b
:func:`kneller_windows` turns those totals and in-block suffix sums into
the window sums and applies
the combine above (the TPU module's ``_finish``) in the same pass. On CPU
tensors both run their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from .. import _build

KNELLER_ROWS = 128       # frames per block of both kernels
KNELLER_COLS = 128       # K6b: threads per block, one column each
TOTALS_TILE = 32         # K6a: columns of a block, one a lane
TOTALS_MIN_RUN = 8       # K6a's row blocks a run where it reads a halo


def _grid(n: int, p: int) -> tuple[int, int]:
    """K6b's grid: column tiles of ``KNELLER_COLS`` along x (the block
    size the C entries launch with), the row blocks along y (strided past
    CUDA's y limit, ``csrc/kneller.cu``)."""
    return _build.launch_grid(-(-p // KNELLER_COLS), -(-n // KNELLER_ROWS))


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


def _check_operand(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float64 or t.ndim != 2:
        raise TypeError(f"{name} takes (N, P) float64, got {t.dtype} "
                        f"of shape {tuple(t.shape)}")


def kneller_totals_plain(sq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`kneller_totals`."""
    n, p = sq.shape
    nb = -(-n // KNELLER_ROWS)
    both = torch.stack([sq, sq.flip(0)])
    pad = torch.zeros((2, nb * KNELLER_ROWS - n, p), dtype=sq.dtype,
                      device=sq.device)
    return torch.cat([both, pad], dim=1).reshape(
        2, nb, KNELLER_ROWS, p).sum(2)


def kneller_totals(sq: torch.Tensor) -> torch.Tensor:
    """K6a: block totals of ``sq`` (N, P) float64 → (2, nb, P): [0, b]
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
        err = _build.library().ta_kneller_totals(
            sq.data_ptr(), tot.data_ptr(), n, p, KNELLER_ROWS, nb, run, runs,
            *grid, _build.stream(sq))
    _build.check(err, "kneller_totals")
    kneller_totals.launches += 1
    return tot


kneller_totals.launches = 0


def kneller_windows_plain(sq: torch.Tensor, corr: torch.Tensor,
                          dfac: float) -> torch.Tensor:
    """Plain version of :func:`kneller_windows`; it needs no block
    totals. Like the kernel it takes total - css[lag-1] as the suffix
    sum Σ_{i >= lag} sq[i], not as a difference of prefixes, which at
    the deepest lags would cancel down to eps·total."""
    n = sq.shape[0]
    css = torch.cumsum(sq, dim=0)
    suffix = torch.cumsum(sq.flip(0), dim=0).flip(0)
    w = css.flip(0) + suffix
    denom = (n - torch.arange(n, dtype=torch.float64, device=sq.device))
    out = (w - 2.0 * corr) / (denom * dfac)[:, None]
    out[0] = 0.0
    return out


def kneller_windows(sq: torch.Tensor, corr: torch.Tensor, tot: torch.Tensor,
                    dfac: float) -> torch.Tensor:
    """K6b: the window sums from :func:`kneller_totals`' ``tot`` and
    in-block suffix sums of ``sq``, combined with ``corr``:
    out[lag] = (w[lag] - 2·corr[lag]) / ((N - lag)·dfac), out[0] = 0."""
    _check_operand(sq, "kneller_windows")
    _check_operand(corr, "kneller_windows")
    n, p = sq.shape
    if (corr.shape != sq.shape or tot.dtype != torch.float64
            or tot.shape != (2, -(-n // KNELLER_ROWS), p)):
        raise ValueError("kneller_windows: sq, corr and tot disagree")
    if sq.device.type == "cpu":
        return kneller_windows_plain(sq, corr, dfac)
    for t, name in ((sq, "sq"), (corr, "corr"), (tot, "tot")):
        _build.kernel_operand(t, f"kneller_windows {name}")
    out = torch.empty((n, p), dtype=torch.float64, device=sq.device)
    with torch.cuda.device(sq.device):
        err = _build.library().ta_kneller_windows(
            sq.data_ptr(), corr.data_ptr(), tot.data_ptr(), out.data_ptr(),
            n, p, KNELLER_ROWS, tot.shape[1], float(dfac), KNELLER_COLS,
            *_grid(n, p), _build.stream(sq))
    _build.check(err, "kneller_windows")
    kneller_windows.launches += 1
    return out


kneller_windows.launches = 0


def einstein_assembly(sq: torch.Tensor, corr: torch.Tensor,
                      reduce_mode: str, d: int) -> torch.Tensor:
    """The Kneller/Calandrini assembly (module docstring): K6a then K6b,
    each its plain version on CPU tensors."""
    if reduce_mode not in ("mean", "sum"):
        raise ValueError(f"reduce_mode must be 'mean' or 'sum', got "
                         f"{reduce_mode!r}")
    dfac = d if reduce_mode == "mean" else 1
    return kneller_windows(sq, corr, kneller_totals(sq), dfac)

"""The work of one analysis and the least time the card needs for it,
counted from the problem's shapes alone (frames N, selected particles P,
components d, lags L, work dtype), never from the program's launches.

The peaks are a frozen copy of ``PEAK_BYTES``, ``PEAK_FP64_MMA``,
``PEAK_FP32`` and ``PEAK_FP64`` in ``chip_smoke.py`` at commit
9de1e251565c3cb324bee311820446c2df28e3a3: NVIDIA's H100 SXM data sheet,
dense rates at the full 700 W power limit.
"""

from __future__ import annotations

import math

PEAK_BYTES = 3.35e12     # bytes/s, HBM3
PEAK_MMA = 67e12         # flop/s, FP64 matrix products on the tensor cores
PEAK_FP32 = 67e12        # flop/s, FP32 outside the tensor cores
PEAK_FP64 = 34e12        # flop/s, FP64 outside the tensor cores

FEED_ITEM = 4            # the trajectory's float32 samples
# float32 arrays each analysis reads: velocities; velocities and positions
FEED_ARRAYS = {"vacf": 1, "helfand": 2}


def request_shape(max_lag, start: int, stop: int) -> tuple[int, int]:
    """(N, L) of an analysis over frames [start, stop): L = N where it
    takes every lag (``max_lag`` None), else min(max_lag, N)."""
    n = stop - start
    return n, n if max_lag is None else min(max_lag, n)


def lag_pairs(n: int, n_lags: int) -> int:
    """Σ_{lag < n_lags} (N − lag): the frame pairs of one series."""
    return n_lags * n - n_lags * (n_lags - 1) // 2


def atom_frame_lags(n: int, p: int, n_lags: int) -> int:
    """One analysis's work in atom-frame-lags: P · Σ_{lag<L} (N − lag),
    with L = N on the FFT path (``bench.py``'s unit)."""
    return p * lag_pairs(n, n_lags)


def least_times(kind: str, fft: bool, n: int, p: int, d: int, n_lags: int,
                itemsize: int = 8) -> tuple[float, float]:
    """(seconds for the bytes, seconds for the flop) the card needs at
    least for one analysis: its float32 feed read once and its
    (n_lags, P) per-particle result written once, over PEAK_BYTES; and

    * FFT path: a real transform of length 2N of each of the P·d series
      and an inverse one of each of the P component sums, 2.5·M·log2(M)
      flop each, at PEAK_MMA (PEAK_FP32 for float32 work);
    * windowed VACF: the acf Gram sums, 2 flop (a multiply-add) a
      component a frame pair, at PEAK_MMA (PEAK_FP32);
    * windowed Helfand: the einstein sums, 3 flop (a subtract, then a
      square added) a component a frame pair, at PEAK_FP64 (PEAK_FP32).
    """
    nbytes = (FEED_ARRAYS[kind] * FEED_ITEM * n * p * d
              + itemsize * n_lags * p)
    f64 = itemsize == 8
    if fft:
        m = 2 * n
        flop = 2.5 * m * math.log2(m) * (p * d + p)
        peak = PEAK_MMA if f64 else PEAK_FP32
    elif kind == "vacf":
        flop = 2.0 * d * p * lag_pairs(n, n_lags)
        peak = PEAK_MMA if f64 else PEAK_FP32
    else:
        flop = 3.0 * d * p * lag_pairs(n, n_lags)
        peak = PEAK_FP64 if f64 else PEAK_FP32
    return nbytes / PEAK_BYTES, flop / peak


def least_time(*args, **kwargs) -> float:
    """The larger of :func:`least_times`' two times."""
    return max(least_times(*args, **kwargs))

"""Einstein lag differences: the Helfand viscosity accumulator's kernel.

Counterpart of ``transport_analysis_tpu/ops/einstein.py``'s FFT path. The
mean squared lag difference of a per-particle series A(t),

    E(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d (A[i,p,d] - A[i+lag,p,d])²

(components averaged for Helfand, ``reduce_mode='mean'``; summed for the
MSD, ``'sum'``), by the Kneller/Calandrini decomposition

    Σ_i (A_i − A_{i+lag})² = S(0, N-lag-1) + S(lag, N-1) − 2·C(lag)

with S prefix-sum windows of |A|² and C the raw autocorrelation. The
operand is centered per series first: the identity then does not cancel
a large mean offset at small lags. The windowed path is not ported yet.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..utils.errors import not_ported
from .acf import raw_autocorr_sumlast_flat
from .cuda_kneller import einstein_assembly


def _center_and_sq_flat(a: torch.Tensor, d: int):
    """Per-series centering of (N, P, d) float64 into the flat (N, P·d)
    layout the autocorrelation takes, and the component-summed squares
    (N, P) the assembly takes."""
    n = a.shape[0]
    flat = a.reshape(n, -1)
    c = flat - flat.mean(dim=0, keepdim=True)
    sq = (c * c).reshape(n, -1, d).sum(-1)
    return c, sq


def einstein_difference_fft(a, reduce_mode: str = "mean", corr=None,
                            device=None) -> torch.Tensor:
    """FFT-accelerated mean-squared lag difference, (N, P, d) float64 →
    (N, P) float64 on the operand's device.

    Advanced: ``corr`` supplies a precomputed raw component-summed
    autocorrelation of ``a``; ``a`` must then already be centered per
    series (``a - a.mean(axis=0)``), since the identity needs corr and
    the prefix sums to agree. Callers use it to batch several analyses'
    correlation passes into one ``raw_autocorr_sumlast_flat`` call."""
    a = as_tensor(a, device)
    if a.dtype != torch.float64:
        raise TypeError(f"einstein_difference_fft expects float64, got "
                        f"{a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    P, d = a.shape[1], a.shape[2]
    if corr is None:
        flat, sq = _center_and_sq_flat(a, d)
        del a
        corr = raw_autocorr_sumlast_flat(flat, P, d)
    else:
        corr = as_tensor(corr, a.device)
        sq = (a * a).sum(-1)
    # the K6 kernels on a CUDA tensor, their plain versions on a CPU one
    return einstein_assembly(sq, corr, reduce_mode, d)


def einstein_difference_windowed(a, reduce_mode: str = "mean",
                                 max_lag=None):
    """Exact windowed mean-squared lag difference (not ported yet)."""
    raise not_ported(
        "einstein_difference_windowed (the fft=False path)", "windowed")

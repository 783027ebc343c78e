"""Einstein lag differences: the Helfand viscosity accumulator's kernel.

Counterpart of ``transport_analysis_tpu/ops/einstein.py``'s FFT path. The
mean squared lag difference of a per-particle series A(t),

    E(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d (A[i,p,d] - A[i+lag,p,d])²

(components averaged for Helfand, ``reduce_mode='mean'``; summed for the
MSD, ``'sum'``), by the Kneller/Calandrini decomposition

    Σ_i (A_i − A_{i+lag})² = S(0, N-lag-1) + S(lag, N-1) − 2·C(lag)

with S prefix-sum windows of |A|² and C the raw autocorrelation. The
operand is centered per series first: the identity then does not cancel
a large mean offset at small lags. :func:`einstein_difference_fft_`
centers an operand its caller hands over in place, so a model's
accumulator is the only full-size float64 copy (the role of the JAX
package's ``einstein_difference_fft_from_f32``, ``einstein.py:439``, which
keeps the deep path's operand in f32 pairs). The windowed path is not
ported yet.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..utils.errors import not_ported
from .acf import raw_autocorr_sumlast_flat
from .cuda_kneller import einstein_assembly


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
    if corr is None:
        owned = a.clone(memory_format=torch.contiguous_format)
        return einstein_difference_fft_(owned, reduce_mode)
    corr = as_tensor(corr, a.device)
    # the K6 kernels on a CUDA tensor, their plain versions on a CPU one
    return einstein_assembly((a * a).sum(-1), corr, reduce_mode, a.shape[2])


def einstein_difference_fft_(a: torch.Tensor,
                             reduce_mode: str = "mean") -> torch.Tensor:
    """:func:`einstein_difference_fft` of a contiguous (N, P, d) float64
    tensor that the caller hands over: ``a`` is centered in place (its
    values are lost), and no other full-size copy of it is made."""
    if a.dtype != torch.float64 or a.ndim != 3 or not a.is_contiguous():
        raise TypeError(f"einstein_difference_fft_ takes a contiguous "
                        f"(N, P, d) float64 tensor, got {a.dtype} of shape "
                        f"{tuple(a.shape)}")
    n, P, d = a.shape
    # per-series centering in the flat (N, P·d) layout the
    # autocorrelation takes, and the component-summed squares (N, P)
    flat = a.view(n, P * d)
    flat.sub_(flat.mean(dim=0, keepdim=True))
    sq = (flat * flat).view(n, P, d).sum(-1)
    corr = raw_autocorr_sumlast_flat(flat, P, d)
    return einstein_assembly(sq, corr, reduce_mode, d)


def einstein_difference_windowed(a, reduce_mode: str = "mean",
                                 max_lag=None):
    """Exact windowed mean-squared lag difference (not ported yet)."""
    raise not_ported(
        "einstein_difference_windowed (the fft=False path)", "windowed")

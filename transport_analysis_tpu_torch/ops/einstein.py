"""Einstein lag differences: the Helfand viscosity and MSD kernels.

Counterpart of ``transport_analysis_tpu/ops/einstein.py``. The mean
squared lag difference of a per-particle series A(t),

    E(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d (A[i,p,d] - A[i+lag,p,d])²

(components averaged for Helfand, ``reduce_mode='mean'``; summed for the
MSD, ``'sum'``). The FFT path computes it by the Kneller/Calandrini
decomposition

    Σ_i (A_i − A_{i+lag})² = S(0, N-lag-1) + S(lag, N-1) − 2·C(lag)

with S prefix-sum windows of |A|² and C the raw autocorrelation. The
operand is centered per series first: the identity then does not cancel
a large mean offset at small lags. :func:`einstein_difference_fft_`
centers an operand its caller hands over in place, so a model's
accumulator is the only full-size float64 copy (the role of the JAX
package's f32-pair deep path). :func:`einstein_difference_windowed` sums
the squared differences directly, lag by lag (the reference's ``fft=False``
path), through the lag-sum kernel of ``cuda_lag``.

A float32 operand runs the float32 work mode (``dtype=np.float32``), as
the JAX ops do: centering and |c|² in float32 (JAX ``einstein.py:218-
238``), the complex64 autocorrelation, the float32 Kneller assembly (its
window sums kept in float64) or the float32 windowed sums, and float32
results. :func:`einstein_difference_fft_from_f32` stays the
float64-grade entry for float32 samples.
"""

from __future__ import annotations

import torch

from .._device import REAL_TYPES, as_tensor
from ..utils.profiling import span
from .acf import raw_autocorr_sumlast_flat
from .cuda_kneller import einstein_assembly
from .cuda_lag import windowed_lag


def einstein_difference_fft(a, reduce_mode: str = "mean", corr=None,
                            device=None) -> torch.Tensor:
    """FFT-accelerated mean-squared lag difference, (N, P, d) float64 or
    float32 → (N, P) of the operand's type on its device (float32: the
    float32 work mode).

    Advanced: ``corr`` supplies a precomputed raw component-summed
    autocorrelation of ``a``; ``a`` must then already be centered per
    series (``a - a.mean(axis=0)``), since the identity needs corr and
    the prefix sums to agree. Callers use it to batch several analyses'
    correlation passes into one ``raw_autocorr_sumlast_flat`` call."""
    a = as_tensor(a, device)
    if a.dtype not in REAL_TYPES:
        raise TypeError(f"einstein_difference_fft expects float64 or "
                        f"float32, got {a.dtype}")
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
    or float32 tensor that the caller hands over: ``a`` is centered in
    place (its values are lost), and no other full-size copy of it is
    made. The work type is ``a``'s. In a ``ta.fft`` span."""
    if a.dtype not in REAL_TYPES or a.ndim != 3 or not a.is_contiguous():
        raise TypeError(f"einstein_difference_fft_ takes a contiguous "
                        f"(N, P, d) float64 or float32 tensor, got "
                        f"{a.dtype} of shape {tuple(a.shape)}")
    n, P, d = a.shape
    with span("ta.fft"):
        # per-series centering in the flat (N, P·d) layout the
        # autocorrelation takes, and the component-summed squares (N, P)
        flat = a.view(n, P * d)
        flat.sub_(flat.mean(dim=0, keepdim=True))
        sq = (flat * flat).view(n, P, d).sum(-1)
        corr = raw_autocorr_sumlast_flat(flat, P, d, a.dtype)
        return einstein_assembly(sq, corr, reduce_mode, d)


def einstein_difference_fft_from_f32(a32, reduce_mode: str = "mean",
                                     device=None) -> torch.Tensor:
    """:func:`einstein_difference_fft` of float32 samples (JAX
    ``einstein.py:439``): the operand crosses to the device at 4 bytes a
    value and is upcast there, exactly, into the one float64 copy that
    :func:`einstein_difference_fft_` centers in place."""
    a32 = as_tensor(a32, device)
    if a32.dtype != torch.float32:
        raise TypeError(f"einstein_difference_fft_from_f32 expects float32 "
                        f"samples, got {a32.dtype}")
    if a32.ndim == 2:
        a32 = a32[:, :, None]
    owned = a32.to(torch.float64, memory_format=torch.contiguous_format)
    return einstein_difference_fft_(owned, reduce_mode)


def msd_fft(r, device=None) -> torch.Tensor:
    """Mean squared displacement per particle, (N, P, d) float64 or
    float32 → (N, P) of its type (JAX ``einstein.py:483``): the Einstein
    difference with
    the components summed, ``tidynamics.msd`` / MDAnalysis
    ``EinsteinMSD`` semantics."""
    return einstein_difference_fft(r, reduce_mode="sum", device=device)


def einstein_difference_windowed(a, reduce_mode: str = "mean",
                                 max_lag=None, device=None) -> torch.Tensor:
    """Exact windowed mean-squared lag difference (JAX ``einstein.py:36``),
    (N, P, d) or (N, P) float64 or float32 → (n_lags, P) of the operand's
    type on its device, as the JAX op returns it (float32: the float32
    work mode), lags [0, max_lag) (default all N), row 0 = 0.

    ``reduce_mode='mean'`` averages over the components (Helfand),
    ``'sum'`` sums them (MSD). The raw series is differenced as it is,
    with no centering, as the reference does. In a ``ta.lag`` span."""
    with span("ta.lag"):
        return windowed_lag(as_tensor(a, device), max_lag,
                            mode="einstein", reduce_mode=reduce_mode)

"""Autocorrelation by the Wiener–Khinchin theorem, float64 on the device.

Counterpart of ``transport_analysis_tpu/ops/acf.py``'s FFT path:

    C(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d x[i,p,d] · x[i+lag,p,d]

zero-padded to M = 2·next_pow_2(N), with the component sum taken on the
power spectra so the inverse transform carries one column per particle
(the JAX CPU path's ``_raw_autocorr_native_sumlast``). The transform is
the multi-level four-step plan of ``cuda_fft``: hand-written kernels on a
CUDA tensor, their plain PyTorch versions on a CPU tensor. One plan
serves every M up to 2^53 (``cuda_fft.plan_levels``; device memory ends
a run long before), so the JAX dispatch's routes, the Pallas engine for
M ≤ 65,536 (``acf.py:307-349``, ``:533-577``), the deep composition up to
2^24 (``deep_acf.py``) and native ``jnp.fft`` past it, are one route
here. The exact windowed :func:`acf_windowed` (``fft=False``) runs
the lag-sum kernel of ``cuda_lag``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from . import cuda_fft
from .cuda_lag import windowed_lag


def next_pow_2(n: int) -> int:
    """Smallest power of two >= n."""
    m = 1
    while m < n:
        m *= 2
    return m


def raw_autocorr_sumlast_flat(x: torch.Tensor, P: int, d: int
                              ) -> torch.Tensor:
    """Component-summed raw autocorrelation of a flat (N, P·d) operand
    (float32 or float64; series of particle p in columns p·d … p·d+d-1)
    → (N, P) float64, unnormalized."""
    n = x.shape[0]
    return cuda_fft.autocorr_power_sum(x, 2 * next_pow_2(n), P, d)


def raw_autocorr_sumlast(x: torch.Tensor) -> torch.Tensor:
    """(N, P, d) → (N, P): per-particle raw autocorrelation summed over
    components."""
    n, p, d = x.shape
    return raw_autocorr_sumlast_flat(x.reshape(n, p * d), p, d)


def _normalized(x: torch.Tensor) -> torch.Tensor:
    """The raw autocorrelation divided by N − lag in the transform's
    epilogue."""
    if x.ndim == 2:
        x = x[:, :, None]
    n, p, d = x.shape
    return cuda_fft.autocorr_power_sum(x.reshape(n, p * d),
                                       2 * next_pow_2(n), p, d,
                                       normalize=True)


def acf_fft(x, device=None) -> torch.Tensor:
    """Batched FFT autocorrelation.

    Parameters
    ----------
    x : (N, P, d) or (N, P) float64 tensor or array — N frames, P
        particles, d components. Arrays go to ``device`` (default: the
        CUDA card; the CPU only as ``"cpu"``).

    Returns
    -------
    (N, P) float64 tensor on the operand's device.
    """
    x = as_tensor(x, device)
    if x.dtype != torch.float64:
        raise TypeError(f"acf_fft expects float64, got {x.dtype} (use "
                        "acf_fft_from_f32 for float32 samples)")
    return _normalized(x)


def acf_fft_from_f32(x32, device=None) -> torch.Tensor:
    """float64-grade batched FFT autocorrelation from float32 samples.

    Trajectory formats store float32, which float64 holds exactly, so the
    operand crosses to the device at 4 bytes a value and is upcast there,
    while it is packed for the first transform level. Output as
    :func:`acf_fft` of the upcast operand, (N, P) float64.
    """
    x32 = as_tensor(x32, device)
    if x32.dtype != torch.float32:
        raise TypeError(
            f"acf_fft_from_f32 expects float32 samples, got {x32.dtype} "
            "(use acf_fft for float64 operands)")
    return _normalized(x32)


def acf_windowed(x, max_lag=None, device=None) -> torch.Tensor:
    """Exact per-lag windowed autocorrelation, the reference's direct
    per-lag sums (``transport_analysis_tpu/ops/acf.py:474``), O(N·n_lags):

        C(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d x[i,p,d] · x[i+lag,p,d]

    Parameters
    ----------
    x : (N, P, d) or (N, P) float64, or float32 samples, tensor or array.
        Arrays go to ``device`` (default: the CUDA card; the CPU only as
        ``"cpu"``).
        float32 samples are read at 4 bytes and upcast exactly inside the
        kernel, so the result is that of the float64 values (the JAX op
        returns float32 for them; here the float32 work mode is not
        ported, see ``ROADMAP.md``).
    max_lag : lags [0, max_lag) only (default all N).

    Returns
    -------
    (n_lags, P) float64 tensor on the operand's device.
    """
    return windowed_lag(as_tensor(x, device), max_lag, mode="acf",
                        reduce_mode="sum")


def acf_fft_numpy(x: np.ndarray) -> np.ndarray:
    """Host float64 Wiener–Khinchin autocorrelation (tidynamics.acf
    parity, an independent oracle for tests and chip_smoke.py)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, :, None]
    N = x.shape[0]
    M = 2 * next_pow_2(N)
    f = np.fft.rfft(x, n=M, axis=0)
    raw = np.fft.irfft(f * np.conj(f), n=M, axis=0)[:N].real
    raw = raw.sum(axis=-1)
    return raw / (N - np.arange(N))[:, None]

"""Autocorrelation by the Wiener–Khinchin theorem on the device, float64,
or float32 in the float32 work mode.

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
the lag-sum kernel of ``cuda_lag``. :func:`auto_atom_chunk` sizes the
atom chunks of a streamed run (``parallel.streaming``) from the port's
own device-memory model, :func:`chunk_peak_bytes`.

A float32 operand of :func:`acf_fft` or :func:`acf_windowed` runs the
float32 work mode (``dtype=np.float32``), as the JAX ops do: float32
results at about 1e-6 grade, through the complex64/float32 instantiations
of the same kernels. :func:`acf_fft_from_f32` stays the float64-grade
entry for float32 samples.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import REAL_TYPES, as_tensor, resolve_device
from ..utils.profiling import span
from . import cuda_fft
from .cuda_lag import windowed_lag


def next_pow_2(n: int) -> int:
    """Smallest power of two >= n."""
    m = 1
    while m < n:
        m *= 2
    return m


HBM_BUDGET_ENV = "TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB"
# share of the card's memory a chunk may reckon with: the rest is left to
# the CUDA context, the caching allocator's cached and split blocks, a
# frame-blocked feed held on the card and the caller's own tensors
CARD_HEADROOM = 0.8
# the budget on a CPU device: a constant, so the chunk chosen there (the
# tests) does not depend on the machine
CPU_BUDGET_GB = 16.0
# PyTorch's caching allocator splits a cached block only when more than
# 1 MiB would be left over, so each tensor may hold up to 1 MiB more than
# it asks for: 8 MiB for the eight or fewer alive at a chunk's peak
ALLOCATOR_SLACK = 8 * 2 ** 20


def chunk_peak_bytes(n_frames: int, chunk: int, d: int = 3,
                     dtype=np.float64) -> int:
    """Device bytes the FFT analyses of one chunk of ``chunk`` atoms over
    ``n_frames`` frames (``d`` components) hold at their peak under the
    work ``dtype``: the MSD's, the largest of the three (s = d·chunk
    series, M = 2·next_pow_2(N), w = ceil(s/2) packed columns).

    float64: its kernel is handed the float32 chunk of the feed, which
    the caller holds through the call (4·N·s), and centers a float64 copy
    of it in place (8·N·s); beside these two:

    * its squares: the elementwise square and the (N, chunk) component
      sums, 8·N·s + 8·N·chunk;
    * the first forward FFT level: the sums beside two packed complex128
      spectra of M rows, 8·N·chunk + 2·16·M·w;

    plus the cached roots tables, 16·M bytes of order M and under a
    fifteenth of that for the plan's sub-orders (counted as 32·M), plus
    :data:`ALLOCATOR_SLACK`. Helfand holds the same stages without the
    float32 chunk (its m·v·x is formed from float32 factors it frees,
    16·N·s at most), the VACF a float32 chunk beside the same spectra,
    and the windowed runs less.

    float32 (the float32 work mode): every stage at half the bytes, and
    no copy of the chunk: the MSD centers the float32 chunk itself in
    place (4·N·s; Helfand forms m·v·x from two float32 factors, 8·N·s at
    most, within the squares' stage), float32 squares and sums, complex64
    spectra (2·8·M·w) and complex64 roots tables (16·M)."""
    size = np.dtype(dtype).itemsize
    if size not in (4, 8):
        raise ValueError(f"dtype must be float64 or float32, got "
                         f"{np.dtype(dtype)}")
    s = d * chunk
    m = 2 * next_pow_2(n_frames)
    spectra = 2 * 2 * size * m * ((s + 1) // 2)
    # the float32 chunk, and the float64 work mode's copy of it
    operands = (4 + (size if size == 8 else 0)) * n_frames * s
    stages = max(size * n_frames * s + size * n_frames * chunk,
                 size * n_frames * chunk + spectra)
    return operands + stages + 4 * size * m + ALLOCATOR_SLACK


def device_budget_gb(device=None) -> float:
    """The device-memory budget of an analysis's FFT work, in GB (1e9
    bytes): the ``TRANSPORT_ANALYSIS_TPU_HBM_BUDGET_GB`` environment
    variable, else :data:`CARD_HEADROOM` of the card's total memory
    (``torch.cuda.mem_get_info``) on a CUDA ``device`` (the default), else
    :data:`CPU_BUDGET_GB` on the CPU. The total and not the free memory,
    so that the same shapes always take the same path."""
    env = os.environ.get(HBM_BUDGET_ENV)
    if env is not None:
        return float(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] * CARD_HEADROOM / 1e9
    return CPU_BUDGET_GB


def auto_atom_chunk(n_frames: int, d: int = 3, hbm_budget_gb=None,
                    dtype=np.float64, device=None) -> int:
    """The largest atom chunk whose :func:`chunk_peak_bytes` under the
    work ``dtype`` (float64, or float32 for the float32 work mode; the
    JAX function's signature) fits the device-memory budget, in GB (1e9
    bytes): ``hbm_budget_gb``, else :func:`device_budget_gb` of
    ``device``. Raises ``ValueError`` when not even one atom fits."""
    if hbm_budget_gb is None:
        hbm_budget_gb = device_budget_gb(device)
    budget = float(hbm_budget_gb) * 1e9
    if chunk_peak_bytes(n_frames, 1, d, dtype) > budget:
        raise ValueError(
            f"one atom of {n_frames} frames needs "
            f"{chunk_peak_bytes(n_frames, 1, d, dtype) / 1e9:.3f} GB of "
            f"device memory, past the budget of {hbm_budget_gb} GB")
    lo, hi = 1, 2
    while chunk_peak_bytes(n_frames, hi, d, dtype) <= budget:
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # peak(lo) fits, peak(hi) does not
        mid = (lo + hi) // 2
        if chunk_peak_bytes(n_frames, mid, d, dtype) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def raw_autocorr_sumlast_flat(x: torch.Tensor, P: int, d: int,
                              work_dtype: torch.dtype = torch.float64
                              ) -> torch.Tensor:
    """Component-summed raw autocorrelation of a flat (N, P·d) operand
    (series of particle p in columns p·d … p·d+d-1) → (N, P) of
    ``work_dtype``, unnormalized: float64 from float32 or float64
    samples, or float32 from a float32 operand (the float32 work
    mode)."""
    n = x.shape[0]
    return cuda_fft.autocorr_power_sum(x, 2 * next_pow_2(n), P, d,
                                       work_dtype=work_dtype)


def raw_autocorr_sumlast(x: torch.Tensor) -> torch.Tensor:
    """(N, P, d) → (N, P): per-particle raw autocorrelation summed over
    components."""
    n, p, d = x.shape
    return raw_autocorr_sumlast_flat(x.reshape(n, p * d), p, d)


def _normalized(x: torch.Tensor,
                work_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The raw autocorrelation divided by N − lag in the transform's
    epilogue, in ``work_dtype``."""
    if x.ndim == 2:
        x = x[:, :, None]
    n, p, d = x.shape
    return cuda_fft.autocorr_power_sum(x.reshape(n, p * d),
                                       2 * next_pow_2(n), p, d,
                                       normalize=True, work_dtype=work_dtype)


def acf_fft(x, device=None) -> torch.Tensor:
    """Batched FFT autocorrelation.

    Parameters
    ----------
    x : (N, P, d) or (N, P) float64 or float32 tensor or array — N
        frames, P particles, d components. Arrays go to ``device``
        (default: the CUDA card; the CPU only as ``"cpu"``).

    Returns
    -------
    (N, P) tensor of the operand's type on its device: float64, or
    float32 at about 1e-6 grade for a float32 operand (the float32 work
    mode, as the JAX op returns it; :func:`acf_fft_from_f32` is the
    float64-grade entry for float32 samples). In a ``ta.fft`` span.
    """
    with span("ta.fft"):
        x = as_tensor(x, device)
        if x.dtype not in REAL_TYPES:
            raise TypeError(f"acf_fft expects float64 or float32, got "
                            f"{x.dtype}")
        return _normalized(x, x.dtype)


def acf_fft_from_f32(x32, device=None) -> torch.Tensor:
    """float64-grade batched FFT autocorrelation from float32 samples.

    Trajectory formats store float32, which float64 holds exactly, so the
    operand crosses to the device at 4 bytes a value and is upcast there,
    while it is packed for the first transform level. Output as
    :func:`acf_fft` of the upcast operand, (N, P) float64. In a
    ``ta.fft`` span.
    """
    with span("ta.fft"):
        x32 = as_tensor(x32, device)
        if x32.dtype != torch.float32:
            raise TypeError(
                f"acf_fft_from_f32 expects float32 samples, got "
                f"{x32.dtype} (use acf_fft for float64 operands)")
        return _normalized(x32)


def acf_windowed(x, max_lag=None, device=None) -> torch.Tensor:
    """Exact per-lag windowed autocorrelation, the reference's direct
    per-lag sums (``transport_analysis_tpu/ops/acf.py:474``), O(N·n_lags):

        C(lag, p) = 1/(N-lag) · Σ_{i<N-lag} Σ_d x[i,p,d] · x[i+lag,p,d]

    Parameters
    ----------
    x : (N, P, d) or (N, P) float64 or float32 tensor or array.
        Arrays go to ``device`` (default: the CUDA card; the CPU only as
        ``"cpu"``).
    max_lag : lags [0, max_lag) only (default all N).

    Returns
    -------
    (n_lags, P) tensor of the operand's type on its device, as the JAX
    op returns it: float64, or float32 for a float32 operand (the float32
    work mode).
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

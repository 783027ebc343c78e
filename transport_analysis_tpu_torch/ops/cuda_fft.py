"""Four-step complex128 FFT for the Wiener–Khinchin autocorrelation.

Counterpart of ``transport_analysis_tpu/ops/pallas_fft.py``: the same
function (the raw autocorrelation of S real series, zero-padded to
M = 2·next_pow_2(N)), computed in native float64 on the card.

Decomposition. M = n1·n2 (n1, n2 powers of two, ≤ 512; n1 = n2 or 2·n2),
input index j = j1·n2 + j2, frequency k = k2·n1 + k1, lag l = c·n2 + dd:

* forward L1 (K1): Y[k1, j2] = W_M^(k1·j2) Σ_j1 x[j1·n2 + j2] W_n1^(j1·k1)
* forward L2 (K1): X[k2·n1 + k1] = Σ_j2 Y[k1, j2] W_n2^(j2·k2)
* K2: the Hermitian unpack of the two-for-one packing, the power spectra
  summed over each particle's d components, and inverse level A,
  T[dd, k1] = W_M^(-k1·dd) Σ_k2 P[k2·n1 + k1] W_n2^(-k2·dd)
* inverse B (K1): r[c·n2 + dd] = Σ_k1 T[dd, k1] W_n1^(-k1·c), for the
  lag rows c·n2 + dd < N only.

Every level reads (A, n, C) and writes (n_out, A, C), the layout the next
level reads, so no permute sits between levels. Packing: series s < w of
the flat (N, S) operand is the real part of complex column s and series
w + s the imaginary part (w = ceil(S/2)). K2 then packs the component-
summed spectra of particles q and q + ph (ph = ceil(P/2)) into column q,
so the inverse levels carry ph columns instead of w, d times fewer.

:func:`fft_level` and :func:`unpack_power_inva` launch their CUDA kernels
(``csrc/fft.cu``) on CUDA tensors and run their plain PyTorch versions on
CPU tensors; :func:`autocorr_power_sum` is the one orchestration both
devices run, so the CPU tests exercise the same index maps as the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..utils.errors import not_ported

MAX_LEVEL = 512          # largest DFT a level kernel takes
MAX_M = 2 ** 16          # M range of the two-level kernels (N ≤ 32,768)


def split_m(m: int) -> tuple[int, int]:
    """M → (n1, n2), n1·n2 = M, n1 = 2^ceil(log2(M)/2)."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"M must be a power of two, got {m}")
    n1 = 1 << (m.bit_length() // 2)
    return n1, m // n1


def unit_roots(m: int) -> np.ndarray:
    """exp(-2πi·t/M) for t < M in float64, each value computed from an
    angle in the first octant [0, π/4] and placed by symmetry, so the
    table is as exact as cos/sin of a reduced angle."""
    mm = max(m, 8)
    t = np.arange(mm // 8 + 1)
    c = np.cos(2.0 * np.pi * t / mm)
    s = np.sin(2.0 * np.pi * t / mm)
    q = np.arange(mm // 4)
    low, high = q[q <= mm // 8], q[q > mm // 8]
    qc, qs = np.empty(mm // 4), np.empty(mm // 4)
    qc[low], qs[low] = c[low], s[low]
    # cos θ = sin(π/2 - θ) and sin θ = cos(π/2 - θ) above the octant
    qc[high], qs[high] = s[mm // 4 - high], c[mm // 4 - high]
    cos_full = np.concatenate([qc, -qs, -qc, qs])
    sin_full = np.concatenate([qs, qc, -qs, -qc])
    return (cos_full - 1j * sin_full)[:: mm // m]


@functools.lru_cache(maxsize=None)
def roots_tensor(m: int, device: torch.device) -> torch.Tensor:
    """:func:`unit_roots` as a complex128 tensor, cached per (M, device)."""
    return torch.as_tensor(unit_roots(m), dtype=torch.complex128,
                           device=device)


# ---------------------------------------------------------------------
# K1: one four-step level
# ---------------------------------------------------------------------

def fft_level_plain(x: torch.Tensor, m: int, sign: int = -1,
                    n_out: int | None = None,
                    twiddle_cols: int = 0) -> torch.Tensor:
    """Plain version of :func:`fft_level`: ``torch.fft`` along axis 1,
    moved to the front, times the twiddle."""
    a, n, c = x.shape
    n_out = n if n_out is None else n_out
    if sign < 0:
        y = torch.fft.fft(x, dim=1)
    else:
        y = torch.fft.ifft(x, dim=1, norm="forward")  # unscaled inverse
    y = y[:, :n_out].transpose(0, 1)
    if twiddle_cols:
        k = torch.arange(n_out, device=x.device)
        j = torch.arange(c // twiddle_cols, device=x.device)
        tw = roots_tensor(m, x.device)[(k[:, None] * j[None, :]) % m]
        if sign > 0:
            tw = tw.conj()
        y = (y.reshape(n_out, a, c // twiddle_cols, twiddle_cols)
             * tw[:, None, :, None]).reshape(n_out, a, c)
    return y.contiguous()


def fft_level(x: torch.Tensor, m: int, sign: int = -1,
              n_out: int | None = None,
              twiddle_cols: int = 0) -> torch.Tensor:
    """One four-step level: a batched DFT of length n along axis 1 of a
    complex128 (A, n, C) tensor, written as (n_out, A, C):

        out[k, a, c] = tw(k, c) · Σ_j x[a, j, c] · exp(sign·2πi·j·k/n)

    with tw = exp(sign·2πi·k·(c // twiddle_cols)/m) when ``twiddle_cols``
    is non-zero, else 1. Only the first ``n_out`` outputs are formed.
    """
    a, n, c = x.shape
    n_out = n if n_out is None else n_out
    if x.dtype != torch.complex128:
        raise TypeError(f"fft_level takes complex128, got {x.dtype}")
    if n < 1 or n & (n - 1) or m % n or not 1 <= n_out <= n:
        raise ValueError(
            f"fft_level: need n a power of two dividing m and "
            f"1 <= n_out <= n (n={n}, m={m}, n_out={n_out})")
    if twiddle_cols and c % twiddle_cols:
        raise ValueError("fft_level: twiddle_cols must divide C")
    if x.device.type == "cpu":
        return fft_level_plain(x, m, sign, n_out, twiddle_cols)
    _build.kernel_operand(x, "fft_level")
    if n > MAX_LEVEL or m > MAX_M:
        raise not_ported(f"an FFT level of length {n} for M = {m}", "deep")
    if a > _build.MAX_GRID_Y:
        raise ValueError(f"fft_level: A = {a} exceeds the kernel's grid "
                         f"limit of {_build.MAX_GRID_Y}")
    out = torch.empty((n_out, a, c), dtype=torch.complex128,
                      device=x.device)
    roots = roots_tensor(m, x.device)
    with torch.cuda.device(x.device):
        err = _build.library().ta_fft_level(
            x.data_ptr(), out.data_ptr(), roots.data_ptr(), a, n, c, n_out,
            sign, twiddle_cols, m, _build.stream(x))
    _build.check(err, "fft_level")
    fft_level.launches += 1
    return out


fft_level.launches = 0


def fft_forward(z: torch.Tensor) -> torch.Tensor:
    """Forward DFT along axis 0 of a complex128 (M, B) tensor, natural
    frequency order: levels L1 and L2 of the four-step composition."""
    m, b = z.shape
    n1, n2 = split_m(m)
    y = fft_level(z.reshape(1, n1, n2 * b), m, -1, twiddle_cols=b)
    return fft_level(y.reshape(n1, n2, b), m, -1).reshape(m, b)


# ---------------------------------------------------------------------
# K2: Hermitian unpack + component-summed power + inverse level A
# ---------------------------------------------------------------------

def _check_unpack_args(z: torch.Tensor, P: int, d: int) -> None:
    m, w = z.shape
    if z.dtype != torch.complex128:
        raise TypeError(f"unpack_power_inva takes complex128, got {z.dtype}")
    if P < 1 or d < 1 or w != (P * d + 1) // 2:
        raise ValueError(
            f"unpack_power_inva: {w} packed columns do not hold P={P} "
            f"particles of d={d} components")


def unpack_power_inva_plain(z: torch.Tensor, P: int, d: int) -> torch.Tensor:
    """Plain version of :func:`unpack_power_inva`."""
    m, w = z.shape
    n1, n2 = split_m(m)
    ph = (P + 1) // 2
    zm = z[(-torch.arange(m, device=z.device)) % m].conj()  # conj Z[M-k]
    power = torch.cat([torch.view_as_real(z + zm).square().sum(-1),
                       torch.view_as_real(z - zm).square().sum(-1)], dim=1)
    psum = power[:, : P * d].reshape(m, P, d).sum(-1) * (0.25 / m)
    packed = torch.zeros((m, ph), dtype=torch.complex128, device=z.device)
    pr = torch.view_as_real(packed)
    pr[:, :, 0] = psum[:, :ph]
    pr[:, : P - ph, 1] = psum[:, ph:]
    out = fft_level_plain(packed.reshape(1, n2, n1 * ph), m, +1,
                          twiddle_cols=ph)
    return out.reshape(n2, n1, ph)


def unpack_power_inva(z: torch.Tensor, P: int, d: int) -> torch.Tensor:
    """From the forward spectrum ``z`` (M, w) of the two-for-one packed
    series (natural order), form for each particle pair (q, q + ph)

        P[k, q] = (Σ_c |F_{q·d+c}[k]|² + i·Σ_c |F_{(q+ph)·d+c}[k]|²) / M

    with F1 = (Z[k] + conj Z[M-k])/2 and F2 = (Z[k] - conj Z[M-k])/2i the
    spectra of a column's real and imaginary series, and run inverse
    level A on it: out (n2, n1, ph) = (dd, k1, q)."""
    _check_unpack_args(z, P, d)
    m, w = z.shape
    n1, n2 = split_m(m)
    ph = (P + 1) // 2
    if z.device.type == "cpu":
        return unpack_power_inva_plain(z, P, d)
    _build.kernel_operand(z, "unpack_power_inva")
    if m > MAX_M:
        raise not_ported(f"the spectrum unpack for M = {m}", "deep")
    out = torch.empty((n2, n1, ph), dtype=torch.complex128, device=z.device)
    roots = roots_tensor(m, z.device)
    with torch.cuda.device(z.device):
        err = _build.library().ta_unpack_power_inva(
            z.data_ptr(), out.data_ptr(), roots.data_ptr(), m, n1, n2, w, P,
            d, ph, _build.stream(z))
    _build.check(err, "unpack_power_inva")
    unpack_power_inva.launches += 1
    return out


unpack_power_inva.launches = 0


# ---------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------

def pack_pairs(x: torch.Tensor, m: int) -> torch.Tensor:
    """(N, S) real series (float32 or float64) → (M, ceil(S/2)) complex128
    two-for-one packing, zero rows from N on. A float32 operand is
    upcast here, on its own device."""
    n, s = x.shape
    w = (s + 1) // 2
    z = torch.zeros((m, w), dtype=torch.complex128, device=x.device)
    zr = torch.view_as_real(z)
    zr[:n, :, 0] = x[:, :w]
    zr[:n, : s - w, 1] = x[:, w:]
    return z


def autocorr_power_sum(x: torch.Tensor, m: int, P: int,
                       d: int) -> torch.Tensor:
    """Raw component-summed autocorrelation of the flat (N, P·d) operand
    zero-padded to M: out[lag, p] = Σ_c Σ_i x[i, p·d+c]·x[i+lag, p·d+c],
    (N, P) float64, for lags < N."""
    n, s = x.shape
    if s != P * d:
        raise ValueError(f"operand has {s} columns, expected P·d = {P * d}")
    if m < 2 * n or m & (m - 1):
        raise ValueError(f"M = {m} must be a power of two >= 2N = {2 * n}")
    if x.device.type == "cuda" and m > MAX_M:
        raise not_ported(
            f"the autocorrelation of {n} frames (M = {m})", "deep")
    n1, n2 = split_m(m)
    ph = (P + 1) // 2
    spec = fft_forward(pack_pairs(x, m))
    t = unpack_power_inva(spec, P, d)
    del spec
    rows = -(-n // n2)
    r = fft_level(t, m, +1, n_out=rows).reshape(rows * n2, ph)[:n]
    return torch.cat([r.real, r.imag[:, : P - ph]], dim=1)

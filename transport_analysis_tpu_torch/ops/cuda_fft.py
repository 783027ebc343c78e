"""Multi-level four-step complex128 FFT for the Wiener–Khinchin
autocorrelation.

Counterpart of ``transport_analysis_tpu/ops/pallas_fft.py`` (the engine,
M ≤ 65,536) and ``ops/deep_acf.py`` (the deep composition, an outer level
wrapped around the engine, M ≤ 2^24): the same function, the raw
autocorrelation of S real series zero-padded to M = 2·next_pow_2(N),
computed in native float64 on the card by one plan for every M.

Plan. :func:`plan_levels` factors M into levels n0·n1·…·n_{L-1}, powers
of two of at most ``PLAN_LEVEL`` = 16 points (on the card short levels
measured fastest at every M). A transform of length R = n·R' along an
axis splits its index j = j0·R' + j' and its frequency k = k'·n + k0:

    X[k'·n + k0] = Σ_j' W_R'^(j'·k') · [W_R^(j'·k0) · Σ_j0 x[j0·R' + j'] W_n^(j0·k0)]

so a level (K1, :func:`fft_level`) is a batched DFT of its own length n
times the twiddle of its own sub-order R, and the bracket's sub-transforms
of length R' recurse over the rest of the plan (:func:`level_shapes`).
Every level reads (A, n, C) and writes (n, A, C), the layout the next
level reads, so no permute sits between levels, and the last level leaves
the spectrum in natural frequency order.

Autocorrelation (:func:`autocorr_power_sum`): the forward transform of
the two-for-one packed series (series s < w of the flat (N, S) operand is
the real part of complex column s and series w + s the imaginary part,
w = ceil(S/2)); K2 (:func:`unpack_power_inva`), the Hermitian unpack
reading Z[k] and Z[(M − k) mod M], the power spectra summed over each
particle's d components with particles q and q + ph (ph = ceil(P/2))
packed into column q, and inverse level A over the top frequency digit
(k = k_top·R + k_low, lag = c·n_top + dd),

    T[dd, k_low] = W_M^(-k_low·dd) Σ_k_top P[k_top·R + k_low] W_n_top^(-k_top·dd);

then the inverse of length R over k_low by the rest of the plan, whose
last level is the epilogue K5 (:func:`inverse_last_level`) that writes the
(N, P) float64 result for the lags < N only, times 1/(N − lag) on request.

:func:`fft_level`, :func:`unpack_power_inva` and
:func:`inverse_last_level` launch their CUDA kernels (``csrc/fft.cu``) on
CUDA tensors and run their plain PyTorch versions on CPU tensors;
:func:`autocorr_power_sum` is the one orchestration both devices run, so
the CPU tests exercise the same plans and index maps as the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build

# Largest DFT the level kernels take (their shared-memory slab): plans stay
# at PLAN_LEVEL, and K2's explicit ``n_top`` and scripts/fft_plan_sweep.py
# reach the rest.
MAX_LEVEL = 512
MAX_M = 2 ** 24          # the plan's range, as the JAX deep composition's
PLAN_LEVEL = 16          # the longest level a plan takes (measured fastest)


def plan_levels(m: int) -> tuple[int, ...]:
    """The level lengths of the transform of length M, in forward order:
    at least two powers of two, as even as the bits of M allow and longer
    first, each ≤ ``PLAN_LEVEL``, whose product is M. A level costs n
    complex multiply-adds per point and one pass over the tensor, and on
    the card the pass dominates above n ≈ 16 (``scripts/fft_plan_sweep.py``).
    M past ``MAX_M`` raises."""
    if m < 2 or m & (m - 1):
        raise ValueError(f"M must be a power of two >= 2, got {m}")
    if m > MAX_M:
        raise ValueError(f"M = {m} is past the FFT plan's range M <= {MAX_M} "
                         f"(N <= {MAX_M // 2} frames)")
    bits = m.bit_length() - 1
    per = PLAN_LEVEL.bit_length() - 1
    n_levels = max(2, -(-bits // per))
    q, r = divmod(bits, n_levels)
    return tuple(1 << (q + (i < r)) for i in range(n_levels))


def level_shapes(plan, b: int, a0: int = 1) -> list[tuple[int, ...]]:
    """The K1 launches of the recursive four-step transform of length
    prod(plan) along the middle axis of an (a0, prod(plan), b) tensor:
    for each level (A, n, C, order, twiddle_cols), its input read as
    (A, n, C) and its twiddle of the sub-order ``order`` (none on the
    last level)."""
    shapes = []
    a, rest = a0, math.prod(plan)
    for n in plan:
        order, rest = rest, rest // n
        shapes.append((a, n, rest * b, order, b if rest > 1 else 0))
        a *= n
    return shapes


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


@functools.lru_cache(maxsize=16)
def roots_tensor(m: int, device: torch.device) -> torch.Tensor:
    """:func:`unit_roots` as a complex128 tensor, cached per (M, device).
    The order-M table of M = 2^24 is 256 MiB; a plan's other levels use
    the much smaller tables of their sub-orders."""
    return torch.as_tensor(unit_roots(m), dtype=torch.complex128,
                           device=device)


def tile_cols(n: int) -> int:
    """Columns per block of a level kernel: the n x tc slab of 16-byte
    values stays at 64 KB or less."""
    return min(64, max(8, 4096 // n))


# ---------------------------------------------------------------------
# K1: one four-step level
# ---------------------------------------------------------------------

def fft_level_plain(x: torch.Tensor, m: int, sign: int = -1,
                    twiddle_cols: int = 0) -> torch.Tensor:
    """Plain version of :func:`fft_level`: ``torch.fft`` along axis 1,
    moved to the front, times the twiddle."""
    a, n, c = x.shape
    if sign < 0:
        y = torch.fft.fft(x, dim=1)
    else:
        y = torch.fft.ifft(x, dim=1, norm="forward")  # unscaled inverse
    y = y.transpose(0, 1)
    if twiddle_cols:
        k = torch.arange(n, device=x.device)
        j = torch.arange(c // twiddle_cols, device=x.device)
        tw = roots_tensor(m, x.device)[(k[:, None] * j[None, :]) % m]
        if sign > 0:
            tw = tw.conj()
        y = (y.reshape(n, a, c // twiddle_cols, twiddle_cols)
             * tw[:, None, :, None]).reshape(n, a, c)
    return y.contiguous()


def fft_level(x: torch.Tensor, m: int, sign: int = -1,
              twiddle_cols: int = 0) -> torch.Tensor:
    """One four-step level: a batched DFT of length n along axis 1 of a
    complex128 (A, n, C) tensor, written as (n, A, C):

        out[k, a, c] = tw(k, c) · Σ_j x[a, j, c] · exp(sign·2πi·j·k/n)

    with tw = exp(sign·2πi·k·(c // twiddle_cols)/m) when ``twiddle_cols``
    is non-zero, else 1; m is the order of the sub-transform the level
    belongs to.
    """
    a, n, c = x.shape
    if x.dtype != torch.complex128:
        raise TypeError(f"fft_level takes complex128, got {x.dtype}")
    if n < 1 or n & (n - 1) or m % n:
        raise ValueError(f"fft_level: need n a power of two dividing m "
                         f"(n={n}, m={m})")
    if twiddle_cols and c % twiddle_cols:
        raise ValueError("fft_level: twiddle_cols must divide C")
    if x.device.type == "cpu":
        return fft_level_plain(x, m, sign, twiddle_cols)
    _build.kernel_operand(x, "fft_level")
    if n > MAX_LEVEL:
        raise ValueError(f"fft_level: the kernel takes levels of length "
                         f"<= {MAX_LEVEL}, got {n}")
    tc = tile_cols(n)
    grid = _build.launch_grid(-(-c // tc), a)
    out = torch.empty((n, a, c), dtype=torch.complex128, device=x.device)
    roots = roots_tensor(m, x.device)
    with torch.cuda.device(x.device):
        err = _build.library().ta_fft_level(
            x.data_ptr(), out.data_ptr(), roots.data_ptr(), a, n, c, sign,
            twiddle_cols, m, tc, *grid, _build.stream(x))
    _build.check(err, "fft_level")
    fft_level.launches += 1
    return out


fft_level.launches = 0


def fft_forward(z: torch.Tensor) -> torch.Tensor:
    """Forward DFT along axis 0 of a complex128 (M, B) tensor, natural
    frequency order: the levels of :func:`plan_levels`. Each level's
    input is dropped once the next exists, so a caller that hands over
    a temporary holds at most two spectra at once."""
    m, b = z.shape
    for a, n, c, order, tw in level_shapes(plan_levels(m), b):
        z = fft_level(z.reshape(a, n, c), order, -1, twiddle_cols=tw)
    return z.reshape(m, b)


# ---------------------------------------------------------------------
# K2: Hermitian unpack + component-summed power + inverse level A
# ---------------------------------------------------------------------

def _unpack_args(z: torch.Tensor, P: int, d: int,
                 n_top: int | None) -> int:
    """Check K2's operands; the top level's length, by default the
    plan's last level."""
    m, w = z.shape
    if z.dtype != torch.complex128:
        raise TypeError(f"unpack_power_inva takes complex128, got {z.dtype}")
    if P < 1 or d < 1 or w != (P * d + 1) // 2:
        raise ValueError(
            f"unpack_power_inva: {w} packed columns do not hold P={P} "
            f"particles of d={d} components")
    n_top = plan_levels(m)[-1] if n_top is None else n_top
    if n_top < 1 or n_top & (n_top - 1) or m % n_top:
        raise ValueError(f"unpack_power_inva: n_top = {n_top} must be a "
                         f"power of two dividing M = {m}")
    return n_top


def unpack_power_inva_plain(z: torch.Tensor, P: int, d: int,
                            n_top: int | None = None) -> torch.Tensor:
    """Plain version of :func:`unpack_power_inva`."""
    n_top = _unpack_args(z, P, d, n_top)
    m, w = z.shape
    ph = (P + 1) // 2
    zm = z[(-torch.arange(m, device=z.device)) % m].conj()  # conj Z[M-k]
    power = torch.cat([torch.view_as_real(z + zm).square().sum(-1),
                       torch.view_as_real(z - zm).square().sum(-1)], dim=1)
    psum = power[:, : P * d].reshape(m, P, d).sum(-1) * (0.25 / m)
    packed = torch.zeros((m, ph), dtype=torch.complex128, device=z.device)
    pr = torch.view_as_real(packed)
    pr[:, :, 0] = psum[:, :ph]
    pr[:, : P - ph, 1] = psum[:, ph:]
    out = fft_level_plain(packed.reshape(1, n_top, (m // n_top) * ph), m, +1,
                          twiddle_cols=ph)
    return out.reshape(n_top, m // n_top, ph)


def unpack_power_inva(z: torch.Tensor, P: int, d: int,
                      n_top: int | None = None) -> torch.Tensor:
    """From the forward spectrum ``z`` (M, w) of the two-for-one packed
    series (natural order), form for each particle pair (q, q + ph)

        P[k, q] = (Σ_c |F_{q·d+c}[k]|² + i·Σ_c |F_{(q+ph)·d+c}[k]|²) / M

    with F1 = (Z[k] + conj Z[M-k])/2 and F2 = (Z[k] - conj Z[M-k])/2i the
    spectra of a column's real and imaginary series, and run inverse
    level A over the top digit of k = k_top·R + k_low (length ``n_top``,
    R = M/n_top): out (n_top, R, ph) = (dd, k_low, q)."""
    n_top = _unpack_args(z, P, d, n_top)
    if z.device.type == "cpu":
        return unpack_power_inva_plain(z, P, d, n_top)
    _build.kernel_operand(z, "unpack_power_inva")
    m, w = z.shape
    if n_top > MAX_LEVEL:
        raise ValueError(f"unpack_power_inva: the kernel takes a top level "
                         f"of length <= {MAX_LEVEL}, got {n_top}")
    r = m // n_top
    ph = (P + 1) // 2
    tc = tile_cols(n_top)
    grid = _build.launch_grid(-(-ph // tc), r)
    out = torch.empty((n_top, r, ph), dtype=torch.complex128,
                      device=z.device)
    roots = roots_tensor(m, z.device)
    with torch.cuda.device(z.device):
        err = _build.library().ta_unpack_power_inva(
            z.data_ptr(), out.data_ptr(), roots.data_ptr(), m, n_top, r, w, P,
            d, ph, tc, *grid, _build.stream(z))
    _build.check(err, "unpack_power_inva")
    unpack_power_inva.launches += 1
    return out


unpack_power_inva.launches = 0


# ---------------------------------------------------------------------
# K5: the last inverse level and the epilogue
# ---------------------------------------------------------------------

def _epilogue_args(t: torch.Tensor, n_rows: int, P: int) -> int:
    """Check K5's operands; the outputs formed per column, n_out."""
    a, n, ph = t.shape
    if t.dtype != torch.complex128:
        raise TypeError(f"inverse_last_level takes complex128, got {t.dtype}")
    if P < 1 or ph != (P + 1) // 2:
        raise ValueError(f"inverse_last_level: {ph} columns do not hold "
                         f"P={P} particles in pairs")
    if n < 1 or n & (n - 1) or not 1 <= n_rows <= a * n:
        raise ValueError(f"inverse_last_level: need n a power of two and "
                         f"1 <= N <= A·n (A={a}, n={n}, N={n_rows})")
    return min(n, -(-n_rows // a))


def inverse_last_level_plain(t: torch.Tensor, n_rows: int, P: int,
                             normalize: bool = False) -> torch.Tensor:
    """Plain version of :func:`inverse_last_level`: the level, then the
    real and imaginary halves side by side, times 1/(N − lag)."""
    n_out = _epilogue_args(t, n_rows, P)
    a, n, ph = t.shape
    r = fft_level_plain(t, n, +1)[:n_out].reshape(n_out * a, ph)
    out = torch.cat([r[:n_rows].real, r[:n_rows].imag[:, : P - ph]], dim=1)
    if normalize:
        # the reciprocal first, then the product, as the kernel forms it
        out = out * (1.0 / (n_rows - torch.arange(
            n_rows, dtype=torch.float64, device=t.device)))[:, None]
    return out


def inverse_last_level(t: torch.Tensor, n_rows: int, P: int,
                       normalize: bool = False) -> torch.Tensor:
    """The last inverse level (an unscaled inverse DFT of length n along
    axis 1 of ``t`` (A, n, ph), no twiddle) written as the (N, P) float64
    result: row lag = k·A + a < N holds particle q's value in column q
    (the real part) and particle ph + q's in column ph + q (the imaginary
    part), times 1/(N − lag) when ``normalize``."""
    n_out = _epilogue_args(t, n_rows, P)
    if t.device.type == "cpu":
        return inverse_last_level_plain(t, n_rows, P, normalize)
    _build.kernel_operand(t, "inverse_last_level")
    a, n, ph = t.shape
    if n > MAX_LEVEL:
        raise ValueError(f"inverse_last_level: the kernel takes levels of "
                         f"length <= {MAX_LEVEL}, got {n}")
    tc = tile_cols(n)
    grid = _build.launch_grid(-(-ph // tc), a)
    out = torch.empty((n_rows, P), dtype=torch.float64, device=t.device)
    roots = roots_tensor(n, t.device)
    with torch.cuda.device(t.device):
        err = _build.library().ta_inverse_last_level(
            t.data_ptr(), out.data_ptr(), roots.data_ptr(), a, n, ph, n_out,
            n_rows, P, int(normalize), tc, *grid, _build.stream(t))
    _build.check(err, "inverse_last_level")
    inverse_last_level.launches += 1
    return out


inverse_last_level.launches = 0


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


def autocorr_power_sum(x: torch.Tensor, m: int, P: int, d: int,
                       normalize: bool = False) -> torch.Tensor:
    """Raw component-summed autocorrelation of the flat (N, P·d) operand
    zero-padded to M: out[lag, p] = Σ_c Σ_i x[i, p·d+c]·x[i+lag, p·d+c],
    (N, P) float64, for lags < N; divided by N − lag when
    ``normalize``."""
    n, s = x.shape
    if s != P * d:
        raise ValueError(f"operand has {s} columns, expected P·d = {P * d}")
    if m < 2 * n or m & (m - 1):
        raise ValueError(f"M = {m} must be a power of two >= 2N = {2 * n}")
    plan = plan_levels(m)
    ph = (P + 1) // 2
    t = unpack_power_inva(fft_forward(pack_pairs(x, m)), P, d, plan[-1])
    *levels, last = level_shapes(plan[:-1], ph, a0=plan[-1])
    for a, n_level, c, order, tw in levels:
        t = fft_level(t.reshape(a, n_level, c), order, +1, twiddle_cols=tw)
    a, n_level, c, _, _ = last
    return inverse_last_level(t.reshape(a, n_level, c), n, P, normalize)

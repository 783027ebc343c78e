"""Multi-level four-step FFT, complex128 or complex64, for the
Wiener–Khinchin autocorrelation.

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
from Z[k] and Z[(M − k) mod M], each row read once with its mirror
(:class:`UnpackTiles`), the power spectra summed over each
particle's d components with particles q and q + ph (ph = ceil(P/2))
packed into column q, and inverse level A over the top frequency digit
(k = k_top·R + k_low, lag = c·n_top + dd),

    T[dd, k_low] = W_M^(-k_low·dd) Σ_k_top P[k_top·R + k_low] W_n_top^(-k_top·dd);

then the inverse of length R over k_low by the rest of the plan, whose
last level is the epilogue K5 (:func:`inverse_last_level`) that writes the
(N, P) float64 result for the lags < N only, times 1/(N − lag) on request.

:func:`fft_level`, :func:`unpack_power_inva` and
:func:`inverse_last_level` launch their CUDA kernels (``csrc/fft.cu``) on
CUDA tensors, with K1's and K5's work split from :class:`LevelTiles`
(at wide levels K1's column launch, a column a thread in registers, at
n ≤ 16, else column tiles of a shared-memory slab; groups of whole rows
of A at narrow ones) and K2's from :class:`UnpackTiles`, and run their
plain PyTorch versions on CPU tensors;
:func:`autocorr_power_sum` is the one orchestration both devices run, so
the CPU tests exercise the same plans and index maps as the card.

Two work types. complex128 with float64 results is the float64 work
mode. complex64 with float32 results is the float32 work mode
(``dtype=np.float32``, the JAX package's 4-band "fast" profile of its
engine and deep chain): the same plans, tiles and index maps, each kernel
instantiated on ``float2`` (``csrc/fft.cu``'s ``_f32`` entries), the
roots the float64 table rounded once (:func:`roots_tensor`), and each
plain version run in the operand's type. A complex64 operand never goes
through the complex128 kernels and a cast.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from .._device import COMPLEX_TYPES, REAL_TYPES, work_types

# Largest DFT the level kernels take (their shared-memory slab): plans stay
# at PLAN_LEVEL, and K2's explicit ``n_top`` and scripts/fft_plan_sweep.py
# reach the rest.
MAX_LEVEL = 512
MAX_M = 2 ** 53          # the plan's range: see plan_levels
PLAN_LEVEL = 16          # the longest level a plan takes (measured fastest)


def plan_levels(m: int) -> tuple[int, ...]:
    """The level lengths of the transform of length M, in forward order:
    at least two powers of two, as even as the bits of M allow and longer
    first, each ≤ ``PLAN_LEVEL``, whose product is M. A level costs n
    complex multiply-adds per point and one pass over the tensor, and on
    the card the pass dominates above n ≈ 16 (``scripts/fft_plan_sweep.py``).

    M past ``MAX_M`` = 2^53 raises. That is where the arithmetic ends:
    :func:`unit_roots` forms each root's angle 2π·t/M from t and M in
    float64, exact for integers up to 2^53. Every index and offset in
    ``csrc/fft.cu`` is 64-bit (the largest, an element offset below M·w,
    and the twiddle exponents k·f and k_low·dd, below M, all fit), the
    loop counters that are 32-bit run over one block's shared-memory
    tile, and every grid strides over its rows past CUDA's y limit, so
    no kernel limit comes first. Device memory does, long before: at
    M = 2^25 the order-M roots table takes 512 MiB and each packed
    spectrum 16·M·w bytes (512 MiB a packed column, two of them at the
    forward levels); torch's out-of-memory error reports a shape that
    does not fit, and the grid's x limit a width that does not
    (:func:`_build.launch_grid`)."""
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
def roots_tensor(m: int, device: torch.device,
                 dtype: torch.dtype = torch.complex128) -> torch.Tensor:
    """:func:`unit_roots` as a tensor of ``dtype``, cached per (M, device,
    dtype): complex128, or complex64 for the float32 work mode, the
    float64 table rounded once (never computed in float32). The order-M
    table is 16·M bytes in complex128 (512 MiB at M = 2^25), 8·M in
    complex64; a plan's other levels use the much smaller tables of their
    sub-orders."""
    table = unit_roots(m).astype(
        np.complex64 if dtype == torch.complex64 else np.complex128)
    return torch.as_tensor(table, device=device)


def _check_complex(x: torch.Tensor, name: str) -> None:
    if x.dtype not in COMPLEX_TYPES:
        raise TypeError(f"{name} takes complex128 or complex64, got "
                        f"{x.dtype}")


def tile_cols(n: int) -> int:
    """Columns per block of a slab launch: the n x tc slab of 16-byte
    values stays at 64 KB or less (32 KB for complex64, on the same
    split); a level of more columns is wide."""
    return min(64, max(8, 4096 // n))


# K1's and K5's work split (csrc/fft.cu). A level of C > tile_cols(n)
# columns is wide. K1 takes a wide level of n ≤ COLUMN_LEVEL points a
# column a thread, its n values in registers (the column launch); K5 and
# longer K1 levels take a column tile and one row of A a block, staged in
# shared memory (the slab launch). A narrower level leaves most of such a
# tile idle (60 of 64 lanes at C = 4), so its block takes whole rows, ra
# of them: rows a0 … a0 + ra − 1 are one contiguous run of the (A, n, C)
# input. LEVEL_SLAB was chosen from scripts/kernel_times.py --only k1
# times of 512 … 8,192 at the top, past and depth shapes: fastest for K5
# at top and past, within 4 % of the fastest (2,048) at K1's narrow
# levels; 4,096 and more lose occupancy.
LEVEL_SLAB = 1024       # most complex values a narrow level's block stages
COLUMN_LEVEL = 16       # the longest level of K1's column launch
COLUMN_BLOCKS = range(256, 63, -32)  # its block widths, in threads


def column_block(c: int) -> int:
    """Threads of a block of K1's column launch over C columns: of
    ``COLUMN_BLOCKS``, the width whose last block leaves the fewest lanes
    idle, the widest of equals."""
    return min(COLUMN_BLOCKS, key=lambda t: -(-c // t) * t)


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


class LevelTiles:
    """The work split of K1, or of K5 (``epilogue``), over an (A, n, C)
    level.

    Wide, C > tile_cols(n). K1 at n ≤ ``COLUMN_LEVEL`` (``columns``): a
    thread owns column (a, c) and forms its n outputs in registers;
    ``tc`` = :func:`column_block` threads a block over consecutive
    columns (grid x), one row of A a block (grid y), no shared memory
    (``smem`` 0, ``pitch`` 0, which tells the C entry this launch).
    Otherwise (K5, longer K1 levels): column tiles of ``tc`` =
    tile_cols(n) (grid x), one row of A at a time (``ra`` = 1), an n × tc
    slab zero past C; an item is an output (k, c).
    Narrow, C ≤ tile_cols(n): ``tc`` = C, one column tile, and groups of
    ``ra`` rows of A (grid y), ra the largest power of two with
    ra·n·C ≤ ``LEVEL_SLAB`` (at least 1, at most A rounded up to a power
    of two); the last group may be short. Row a_l of a group lies at
    a_l·``pitch`` in the slab, pitch ≡ C (mod 8) 16-byte values when
    ra > 1, so that a quarter-warp's lanes, on consecutive (a_l, c) of one
    slab row j, fall in distinct 16-byte bank groups. K1's item (k, a_l, c)
    forms outputs k and k + n/2 (k alone at n = 1); K5's (k, a_l, q) forms
    a complex sum into a shared (k, a_l, p) stage of n·ra·C 16-byte
    values, which its output lanes, over (k, a_l, p), write out.
    Grid y strides over the rows or groups past its limit. ``smem``: the
    kernel's shared-memory bytes for complex values of ``itemsize`` bytes
    (16, complex128; 8, complex64: the same split)."""

    def __init__(self, a: int, n: int, c: int, epilogue: bool = False,
                 itemsize: int = 16):
        self.a, self.n, self.c = a, n, c
        tc = tile_cols(n)
        self.wide = c > tc
        self.columns = self.wide and not epilogue and n <= COLUMN_LEVEL
        if self.columns:
            self.tc, self.ra, self.pitch, self.smem = column_block(c), 1, 0, 0
        elif self.wide:
            self.tc, self.ra, self.pitch = tc, 1, n * tc
            self.smem = itemsize * (n + n * tc)
        else:
            self.tc = c
            self.ra = min(_pow2_floor(LEVEL_SLAB // (n * c)),
                          1 << (a - 1).bit_length())
            self.pitch = n * c + ((c - n * c) % 8 if self.ra > 1 else 0)
            self.smem = itemsize * (n + self.ra * self.pitch
                                    + (n * self.ra * c if epilogue else 0))
        self.tiles = -(-c // self.tc)
        self.groups = -(-a // self.ra)
        self.grid = _build.launch_grid(self.tiles, self.groups)

    def rows(self, g: int) -> range:
        """The rows of A that group g takes."""
        return range(g * self.ra, min((g + 1) * self.ra, self.a))


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
        tw = roots_tensor(m, x.device, x.dtype)[
            (k[:, None] * j[None, :]) % m]
        if sign > 0:
            tw = tw.conj()
        y = (y.reshape(n, a, c // twiddle_cols, twiddle_cols)
             * tw[:, None, :, None]).reshape(n, a, c)
    return y.contiguous()


def fft_level(x: torch.Tensor, m: int, sign: int = -1,
              twiddle_cols: int = 0) -> torch.Tensor:
    """One four-step level: a batched DFT of length n along axis 1 of a
    complex128 or complex64 (A, n, C) tensor, written as (n, A, C) of its
    type:

        out[k, a, c] = tw(k, c) · Σ_j x[a, j, c] · exp(sign·2πi·j·k/n)

    with tw = exp(sign·2πi·k·(c // twiddle_cols)/m) when ``twiddle_cols``
    is non-zero, else 1; m is the order of the sub-transform the level
    belongs to.
    """
    a, n, c = x.shape
    _check_complex(x, "fft_level")
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
    tl = LevelTiles(a, n, c, itemsize=x.element_size())
    out = torch.empty((n, a, c), dtype=x.dtype, device=x.device)
    roots = roots_tensor(m, x.device, x.dtype)
    with torch.cuda.device(x.device):
        err = _build.entry("ta_fft_level", x.dtype)(
            x.data_ptr(), out.data_ptr(), roots.data_ptr(), a, n, c, sign,
            twiddle_cols, m, tl.tc, tl.ra, tl.pitch, *tl.grid,
            _build.stream(x))
    _build.check(err, "fft_level")
    _build.count_launch(fft_level, x.dtype)
    return out


fft_level.launches = fft_level.launches_f32 = 0


def fft_forward(z: torch.Tensor, sign: int = -1) -> torch.Tensor:
    """Forward DFT along axis 0 of a complex (M, B) tensor, natural
    frequency order: the levels of :func:`plan_levels`. Each level's
    input is dropped once the next exists, so a caller that hands over
    a temporary holds at most two spectra at once. ``sign`` +1 gives the
    unscaled inverse, Σ_k z[k]·exp(+2πi·j·k/M) with no 1/M."""
    m, b = z.shape
    for a, n, c, order, tw in level_shapes(plan_levels(m), b):
        z = fft_level(z.reshape(a, n, c), order, sign, twiddle_cols=tw)
    return z.reshape(m, b)



# ---------------------------------------------------------------------
# K2: Hermitian unpack + component-summed power + inverse level A
# ---------------------------------------------------------------------

def _unpack_args(z: torch.Tensor, P: int, d: int,
                 n_top: int | None) -> int:
    """Check K2's operands; the top level's length, by default the
    plan's last level."""
    m, w = z.shape
    _check_complex(z, "unpack_power_inva")
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
    packed = torch.zeros((m, ph), dtype=z.dtype, device=z.device)
    pr = torch.view_as_real(packed)
    pr[:, :, 0] = psum[:, :ph]
    pr[:, : P - ph, 1] = psum[:, ph:]
    out = fft_level_plain(packed.reshape(1, n_top, (m // n_top) * ph), m, +1,
                          twiddle_cols=ph)
    return out.reshape(n_top, m // n_top, ph)


# K2's work split (csrc/fft.cu unpack_power_inva_kernel). A block takes a
# column tile of particle pairs [q0, q0 + tq) and a run of nj k_low values
# [kl0, kl0 + nj) ⊂ [0, R/2] together with their mirrors R − k_low: the
# rows k_top·R + k_low and their mirrors (M − k) mod M = (n_top − 1 −
# k_top)·R + (R − k_low) hold the same power spectrum, so one load of the
# two rows gives both, and the block reads each row it needs once.
# The constants gave the fastest splits of those scripts/kernel_times.py
# --only k2 times, at the EC and the narrow shapes alike.
UNPACK_PAIRS = 32       # most particle pairs of a column tile
UNPACK_SLAB = 1024      # most power values (k_top, k_low, q) a block holds
UNPACK_STAGE = 1536     # most (row, column) element pairs staged a pass
SMEM_LIMIT = 232_448    # Hopper's dynamic shared memory a block


class UnpackTiles:
    """K2's work split for an (M, w) spectrum of P particles of d components
    and a top level of ``n_top``: ``tq`` particle pairs a column tile,
    ``nj`` k_low values a block (a power of two), ``ktc`` k_top rows a
    staging pass (a power of two dividing n_top), ``cols`` columns of the
    staging rows (the tile's span plus the wrap), and the grid (x: column
    tiles, y: runs of k_low, strided past the y limit). ``shift`` = ph·d
    − w: 0 for even P; for odd P the imaginary halves of the partner
    particles q + ph lie that many columns right of particle q's, and the
    last particle's upper components are the imaginary halves of columns
    [0, shift) (the wrap). ``smem``: the kernel's shared-memory bytes for
    complex values of ``itemsize`` bytes (16, complex128; 8, complex64:
    the same split)."""

    def __init__(self, m: int, n_top: int, w: int, P: int, d: int,
                 itemsize: int = 16):
        self.m, self.n_top, self.w, self.P, self.d = m, n_top, w, P, d
        self.r = m // n_top
        self.ph = (P + 1) // 2
        self.shift = self.ph * d - w
        self.pairs = self.r // 2 + 1            # k_low in [0, R/2]
        tq = min(self.ph, UNPACK_PAIRS, max(1, UNPACK_SLAB // n_top),
                 max(1, (UNPACK_STAGE - 2 * self.shift) // d))
        self.tiles = -(-self.ph // tq)
        self.tq = -(-self.ph // self.tiles)     # the pairs spread evenly
        self.cols = self.tq * d + 2 * self.shift
        nj = min(UNPACK_SLAB // (n_top * self.tq), UNPACK_STAGE // self.cols)
        self.nj = min(_pow2_floor(nj), 1 << (self.pairs - 1).bit_length())
        self.ktc = min(_pow2_floor(UNPACK_STAGE // (self.nj * self.cols)),
                       n_top)
        self.runs = -(-self.pairs // self.nj)
        self.fine_bits = ((m.bit_length() - 1) + 1) // 2
        self.smem = itemsize * (n_top * (1 + self.nj * (1 + self.tq))
                                + self.ktc * self.nj * self.cols)

    def columns(self, t: int) -> tuple[int, int, int]:
        """(first column, span, wrap) of column tile t's staging rows:
        columns [c_lo, c_lo + span), then the wrap columns [0, wrap)."""
        q0 = t * self.tq
        q1 = min(q0 + self.tq, self.ph)
        c_lo = q0 * self.d
        span = min(self.w, q1 * self.d + self.shift) - c_lo
        wrap = self.shift if q1 == self.ph and c_lo > 0 else 0
        return c_lo, span, wrap

    def pairs_of(self, t: int) -> range:
        """The particle pairs q of column tile t."""
        return range(t * self.tq, min((t + 1) * self.tq, self.ph))

    def klows(self, b: int) -> range:
        """The k_low values of run b whose rows the block loads with
        their mirrors."""
        return range(b * self.nj, min((b + 1) * self.nj, self.pairs))

    def slot(self, t: int, s: int) -> tuple[int, int]:
        """(staging column, half: 0 real, 1 imaginary) of series s in
        column tile t."""
        col, half = (s, 0) if s < self.w else (s - self.w, 1)
        c_lo, span, _ = self.columns(t)
        return (col - c_lo if col >= c_lo else span + col), half


def mirror_klow(kl: int, r: int) -> int:
    """The k_low of the mirrors (M − k) mod M of the rows k_top·R + kl:
    R − kl, and kl itself for kl = 0 and kl = R/2."""
    return (r - kl) % r


def unpack_power_inva(z: torch.Tensor, P: int, d: int,
                      n_top: int | None = None) -> torch.Tensor:
    """From the forward spectrum ``z`` (M, w) of the two-for-one packed
    series (natural order), form for each particle pair (q, q + ph)

        P[k, q] = (Σ_c |F_{q·d+c}[k]|² + i·Σ_c |F_{(q+ph)·d+c}[k]|²) / M

    with F1 = (Z[k] + conj Z[M-k])/2 and F2 = (Z[k] - conj Z[M-k])/2i the
    spectra of a column's real and imaginary series, and run inverse
    level A over the top digit of k = k_top·R + k_low (length ``n_top``,
    R = M/n_top): out (n_top, R, ph) = (dd, k_low, q) of z's type. The
    kernel's work split is :class:`UnpackTiles`."""
    n_top = _unpack_args(z, P, d, n_top)
    if z.device.type == "cpu":
        return unpack_power_inva_plain(z, P, d, n_top)
    _build.kernel_operand(z, "unpack_power_inva")
    m, w = z.shape
    if n_top > MAX_LEVEL:
        raise ValueError(f"unpack_power_inva: the kernel takes a top level "
                         f"of length <= {MAX_LEVEL}, got {n_top}")
    tl = UnpackTiles(m, n_top, w, P, d, itemsize=z.element_size())
    if tl.smem > SMEM_LIMIT:
        raise ValueError(f"unpack_power_inva: d = {d} needs {tl.smem} bytes "
                         f"of shared memory a block, past {SMEM_LIMIT}")
    grid = _build.launch_grid(tl.tiles, tl.runs)
    out = torch.empty((n_top, tl.r, tl.ph), dtype=z.dtype, device=z.device)
    roots = roots_tensor(m, z.device, z.dtype)
    with torch.cuda.device(z.device):
        err = _build.entry("ta_unpack_power_inva", z.dtype)(
            z.data_ptr(), out.data_ptr(), roots.data_ptr(), m, n_top, tl.r,
            w, P, d, tl.ph, tl.shift, tl.tq, tl.nj, tl.ktc, tl.cols,
            tl.fine_bits, *grid, _build.stream(z))
    _build.check(err, "unpack_power_inva")
    _build.count_launch(unpack_power_inva, z.dtype)
    return out


unpack_power_inva.launches = unpack_power_inva.launches_f32 = 0


# ---------------------------------------------------------------------
# K5: the last inverse level and the epilogue
# ---------------------------------------------------------------------

def _epilogue_args(t: torch.Tensor, n_rows: int, P: int) -> int:
    """Check K5's operands; the outputs formed per column, n_out."""
    a, n, ph = t.shape
    _check_complex(t, "inverse_last_level")
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
        # the reciprocal first, then the product, as the kernel forms it,
        # in the result's type
        out = out * (1.0 / (n_rows - torch.arange(
            n_rows, dtype=out.dtype, device=t.device)))[:, None]
    return out


def inverse_last_level(t: torch.Tensor, n_rows: int, P: int,
                       normalize: bool = False) -> torch.Tensor:
    """The last inverse level (an unscaled inverse DFT of length n along
    axis 1 of ``t`` (A, n, ph), no twiddle) written as the (N, P) real
    result, float64 for complex128 and float32 for complex64: row
    lag = k·A + a < N holds particle q's value in column q (the real
    part) and particle ph + q's in column ph + q (the imaginary part),
    times 1/(N − lag) when ``normalize``."""
    n_out = _epilogue_args(t, n_rows, P)
    if t.device.type == "cpu":
        return inverse_last_level_plain(t, n_rows, P, normalize)
    _build.kernel_operand(t, "inverse_last_level")
    a, n, ph = t.shape
    if n > MAX_LEVEL:
        raise ValueError(f"inverse_last_level: the kernel takes levels of "
                         f"length <= {MAX_LEVEL}, got {n}")
    tl = LevelTiles(a, n, ph, epilogue=True, itemsize=t.element_size())
    out = torch.empty((n_rows, P), dtype=work_types(t.dtype)[0], device=t.device)
    roots = roots_tensor(n, t.device, t.dtype)
    with torch.cuda.device(t.device):
        err = _build.entry("ta_inverse_last_level", t.dtype)(
            t.data_ptr(), out.data_ptr(), roots.data_ptr(), a, n, ph, n_out,
            n_rows, P, int(normalize), tl.tc, tl.ra, tl.pitch, *tl.grid,
            _build.stream(t))
    _build.check(err, "inverse_last_level")
    _build.count_launch(inverse_last_level, t.dtype)
    return out


inverse_last_level.launches = inverse_last_level.launches_f32 = 0


# ---------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------

def pack_pairs(x: torch.Tensor, m: int,
               work_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(N, S) real series (float32 or float64) → (M, ceil(S/2)) two-for-
    one packing, zero rows from N on: complex128 for the float64
    ``work_dtype``, where float32 samples are upcast here, exactly, on
    their own device; complex64 for the float32 work mode."""
    n, s = x.shape
    w = (s + 1) // 2
    z = torch.zeros((m, w), dtype=work_types(work_dtype)[1], device=x.device)
    zr = torch.view_as_real(z)
    zr[:n, :, 0] = x[:, :w]
    zr[:n, : s - w, 1] = x[:, w:]
    return z


def autocorr_power_sum(x: torch.Tensor, m: int, P: int, d: int,
                       normalize: bool = False,
                       work_dtype: torch.dtype = torch.float64
                       ) -> torch.Tensor:
    """Raw component-summed autocorrelation of the flat (N, P·d) operand
    zero-padded to M: out[lag, p] = Σ_c Σ_i x[i, p·d+c]·x[i+lag, p·d+c],
    (N, P) of ``work_dtype``, for lags < N; divided by N − lag when
    ``normalize``. ``work_dtype`` float64 (the default) takes float64 or
    float32 samples through complex128; float32, the float32 work mode,
    takes a float32 operand through complex64."""
    n, s = x.shape
    if work_dtype not in REAL_TYPES:
        raise TypeError(f"work_dtype must be float64 or float32, got "
                        f"{work_dtype}")
    if work_dtype == torch.float32 and x.dtype != torch.float32:
        raise TypeError(f"the float32 work mode takes a float32 operand, "
                        f"got {x.dtype}")
    if s != P * d:
        raise ValueError(f"operand has {s} columns, expected P·d = {P * d}")
    if m < 2 * n or m & (m - 1):
        raise ValueError(f"M = {m} must be a power of two >= 2N = {2 * n}")
    plan = plan_levels(m)
    ph = (P + 1) // 2
    t = unpack_power_inva(fft_forward(pack_pairs(x, m, work_dtype)), P, d,
                          plan[-1])
    *levels, last = level_shapes(plan[:-1], ph, a0=plan[-1])
    for a, n_level, c, order, tw in levels:
        t = fft_level(t.reshape(a, n_level, c), order, +1, twiddle_cols=tw)
    a, n_level, c, _, _ = last
    return inverse_last_level(t.reshape(a, n_level, c), n, P, normalize)

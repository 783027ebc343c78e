#!/usr/bin/env python3
"""Time K6a (kneller_totals), K8 (lag_sums) and the FFT path (K1, K2 and
K5 apart and in one autocorrelation, and K6b) at the EC shapes, and the
FFT path also on narrow, very long series, on one CUDA Hopper card, K2,
K6a and K8 against their plain versions and beside their bounds; a quick
loop for tuning these kernels without the whole of chip_smoke.py.

    python3 scripts/kernel_times.py [--only k6a|k6b|k8|vacf|fft|k2|k1|pair]
                                    [--reps 5] [--package DIR]

``--only fft`` times each K1 level beside its bound and its ``torch.fft``
call, in complex128 and in complex64 (the float32 work mode), K2, K5,
K1 + K2 + K5 against the library's autocorrelation, and K6b, at the EC
model, deep and depth shapes and the narrow top and past ones.
``--only k1`` times K1's wide levels (``LevelTiles`` column launches) in
complex128 and complex64 at those shapes, then its narrow levels and K5
(those whose block takes whole rows of A) under each ``LEVEL_SLAB`` of
``LEVEL_SLABS``, the default first.
``--only k8`` times K8 at the EC model and deep shapes: the einstein
launches with float64 sums (float64 and float32 operands) and with
float32 sums (the float32 work mode, ``out_dtype=torch.float32``), and
the acf launches.

``--only pair`` times K8's two-block launch (``lag_sums_pair``, the
exact ring's pair sums) at rounds 0, 1 and 3 of the EC model system's
ring of four 2,048-frame blocks and round 1 of a ring of four
16,384-frame blocks over 368 atoms, both modes and both types, beside
its bound and, for the acf launch, its split's MMA work.

``--only k6b`` times K6b (kneller_windows, its scan's launches included)
at the EC model, deep and depth shapes and the narrow top and past ones,
beside its bound and against its plain version, and splits its device
time by kernel under ``torch.profiler``.
``--only k2`` times K2 alone at each FFT shape under each work split of
``K2_SPLITS`` (``cuda_fft``'s ``UNPACK_*`` constants, the default first).
``--package DIR`` times the package in the checkout DIR instead (for
example an earlier commit unpacked with ``git archive``), so that two
versions are compared in one call on one card: parent, change, change,
parent.

Prints one line per case: kernel ms (CUDA events, warm, median), the
bound (bytes over 3.35 TB/s, flop over the peak of their kind: FP64's
34 TFLOP/s, FP64 matrix products' 67, FP32's 67), the issue-slot
ceiling of the einstein sums (two instructions a pair-component at
17e12/s in FP64, 33.5e12/s in FP32) or the FMA-pipe floor of the acf
sums (one multiply-add a pair-component at 17e12/s, what the sums would
need off the tensor cores), the library call where there is one, and
the kernel's max relative error against its plain version.
"""

from __future__ import annotations

import argparse
import inspect
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PEAK_FP64 = 34e12        # flop/s outside the tensor cores (H100 SXM)
PEAK_FP64_MMA = 67e12    # flop/s on the tensor cores
ISSUE_FP64 = 17e12       # FP64 instructions/s, DADD and DFMA alike
PEAK_FP32 = 67e12        # flop/s, FP32 outside the tensor cores
ISSUE_FP32 = 33.5e12     # FP32 lane-instructions/s, FADD and FFMA alike
PEAK_BYTES = 3.35e12     # bytes/s, HBM3
EC_ATOMS = 3680


def time_ms(fn, reps):
    """Median milliseconds of one ``fn`` over ``reps`` timings. Each timing
    runs ``fn`` back to back for at least about 5 ms, so that a short
    kernel is timed on the card and not the host's time to launch it."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    inner = max(1, min(200, int(5.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel(got, ref):
    """max|got − ref| / max|ref|, over chunks of rows, so that no full-size
    difference of two spectra of many GB is formed."""
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    step = max(1, (1 << 26) // max(1, g.shape[1]))
    diff = scale = 0.0
    for i in range(0, g.shape[0], step):
        diff = max(diff, float((g[i:i + step] - r[i:i + step]).abs().max()))
        scale = max(scale, float(r[i:i + step].abs().max()))
    return diff / scale


def k6a(cuda_kneller, g, reps):
    """K6a at the model and deep shapes."""
    for n in (8192, 65536):
        p = EC_ATOMS
        sq = torch.rand((n, p), dtype=torch.float64, device="cuda",
                        generator=g)
        rows = cuda_kneller.KNELLER_ROWS
        nb = n // rows
        lib = time_ms(lambda: sq.view(nb, rows, p).sum(1), reps)
        bound = 1e3 * (8 * n * p + 16 * nb * p) / PEAK_BYTES
        err = rel(cuda_kneller.kneller_totals(sq),
                  cuda_kneller.kneller_totals_plain(sq))
        k = time_ms(lambda: cuda_kneller.kneller_totals(sq), reps)
        print(f"K6a ({n}, {p}): kernel {k:.3f} ms, bound {bound:.3f} ms "
              f"(bytes), library (forward leg only) {lib:.3f} ms, err "
              f"{err:.2e}", flush=True)
        del sq


def k8(cuda_lag, g, reps, acf_only=False):
    """K8 at the EC shapes: each case's kernel ms, bound, issue ceiling or
    FMA floor, and error against its plain version on every 21st atom.
    ``out`` float64 is the float64 work mode's sums (of float32 samples
    too), float32 the float32 work mode's einstein launch."""
    f64, f32 = torch.float64, torch.float32
    cases = [  # (label, N, n_lags, operand, mode, reduce, sums)
        ("model MSD", 8192, 8192, f32, "einstein", "sum", f64),
        ("model Helfand", 8192, 8192, f64, "einstein", "mean", f64),
        ("deep Helfand", 65536, 2048, f64, "einstein", "mean", f64),
        ("model MSD", 8192, 8192, f32, "einstein", "sum", f32),
        ("model Helfand", 8192, 8192, f32, "einstein", "mean", f32),
        ("deep Helfand", 65536, 2048, f32, "einstein", "mean", f32),
        ("model VACF", 8192, 8192, f32, "acf", "sum", f64),
        ("deep VACF", 65536, 2048, f32, "acf", "sum", f64),
    ]
    for label, n, n_lags, dtype, mode, reduce_mode, out in cases:
        if acf_only and mode != "acf":
            continue
        p, d = EC_ATOMS, 3
        x = torch.randn((n, p, d), dtype=dtype, device="cuda", generator=g)
        sub = x[:, ::21].contiguous()
        kw = {"out_dtype": out}

        def call():
            return cuda_lag.lag_sums(x, n_lags, mode, reduce_mode, **kw)

        got = call()[:, ::21]
        err = rel(got, cuda_lag.lag_sums_plain(sub, n_lags, mode,
                                               reduce_mode, **kw))
        k = time_ms(call, reps)
        for _ in range(3):
            call()
        busy = smi("clocks.sm,power.draw")  # read while the card works
        torch.cuda.synchronize()
        lag0 = 1 if mode == "einstein" else 0
        count = n_lags - lag0
        pairs = p * d * (count * n - (n_lags * (n_lags - 1)
                                      - lag0 * (lag0 - 1)) // 2)
        nbytes = (x.element_size() * n * p * d
                  + torch.tensor([], dtype=out).element_size() * n_lags * p)
        if mode == "einstein" and out == f32:
            bound = 1e3 * max(nbytes / PEAK_BYTES, 3 * pairs / PEAK_FP32)
            ceiling = (f", FP32 issue ceiling "
                       f"{1e3 * 2 * pairs / ISSUE_FP32:.3f} ms")
        elif mode == "einstein":
            bound = 1e3 * max(nbytes / PEAK_BYTES, 3 * pairs / PEAK_FP64)
            ceiling = (f", FP64 issue ceiling "
                       f"{1e3 * 2 * pairs / ISSUE_FP64:.3f} ms")
        else:
            bound = 1e3 * max(nbytes / PEAK_BYTES,
                              2 * pairs / PEAK_FP64_MMA)
            ceiling = f", FMA-pipe floor {1e3 * pairs / ISSUE_FP64:.3f} ms"
        print(f"K8 {label} {str(dtype)[6:]} -> {str(out)[6:]} ({n}, {p}, "
              f"{d}) {mode}, {n_lags} lags: kernel {k:.3f} ms, bound "
              f"{bound:.3f} ms{ceiling}, {100 * bound / k:.1f} % of bound, "
              f"err {err:.2e}; SM clock, power under load: {busy}",
              flush=True)
        del x, sub, got


PAIR_SHAPES = [  # (label, N, blocks, P, round): the exact ring's rounds 0,
    # 1 and 3 over the EC model system in four blocks, and round 1 of a
    # long ring, 65,536 frames in four blocks over every 10th atom
    ("model", 8192, 4, EC_ATOMS, 0), ("model", 8192, 4, EC_ATOMS, 1),
    ("model", 8192, 4, EC_ATOMS, 3), ("long", 65536, 4, 368, 1)]


def pair(cuda_lag, g, reps):
    """K8's two-block launch (``lag_sums_pair``) at the ring's rounds of
    PAIR_SHAPES, both modes, float64 and float32 blocks: kernel ms beside
    the bound, the pair-components counted from the band of pairs as
    chip_smoke.py counts them, the acf split's MMA work against them
    (where the package lists it) and the error against the plain version
    on every 21st atom."""
    f64, f32 = torch.float64, torch.float32
    for label, n, blocks, p, k in PAIR_SHAPES:
        block, d = n // blocks, 3
        lo = max(0, k * block - block + 1)
        count = min(n - 1, k * block + block - 1) - lo + 1
        offset = k * block
        shift = lo - offset
        pairs = d * p * sum(max(0, block - abs(delta))
                            for delta in range(shift, shift + count))
        for dtype in (f64, f32):
            xa = torch.randn((block, p, d), dtype=dtype, device="cuda",
                             generator=g)
            xb = xa if k == 0 else torch.randn(
                (block, p, d), dtype=dtype, device="cuda", generator=g)
            sa, sb = xa[:, ::21].contiguous(), xb[:, ::21].contiguous()
            size = xa.element_size()
            nbytes = ((1 if k == 0 else 2) * size * block * p * d
                      + size * count * p)
            for mode in ("acf", "einstein"):
                def call():
                    return cuda_lag.lag_sums_pair(xa, xb, offset, lo, count,
                                                  mode)

                err = rel(call()[:, ::21], cuda_lag.lag_sums_pair_plain(
                    sa, sb, offset, lo, count, mode))
                ms = time_ms(call, reps)
                if mode == "acf":
                    bound = 1e3 * max(nbytes / PEAK_BYTES,
                                      2 * pairs / PEAK_FP64_MMA)
                    extra = ""
                    if hasattr(cuda_lag, "acf_pair_work"):
                        work, one = cuda_lag.acf_pair_work(block, shift,
                                                           count)
                        extra = f", MMA work {work / one:.3f}x the pairs"
                else:
                    peak = PEAK_FP32 if dtype == f32 else PEAK_FP64
                    issue = ISSUE_FP32 if dtype == f32 else ISSUE_FP64
                    bound = 1e3 * max(nbytes / PEAK_BYTES, 3 * pairs / peak)
                    extra = (f", issue ceiling {1e3 * 2 * pairs / issue:.3f}"
                             " ms")
                print(f"pair {label} round {k} {str(dtype)[6:]} {mode} "
                      f"(blocks of {block}, {p}, {d}; lags {lo} .. "
                      f"{lo + count - 1}): kernel {ms:.3f} ms, bound "
                      f"{bound:.3f} ms ({pairs:.4g} pair-components){extra}, "
                      f"{100 * bound / ms:.1f} % of bound, err {err:.2e}",
                      flush=True)
            del xa, xb, sa, sb


FFT_SHAPES = [  # (label, N, P, d): the EC model and deep widths, 80 atoms
    # at 2^20 frames, and the narrow, very long series at the plan's old
    # cap and past it
    ("model", 8192, EC_ATOMS, 3), ("deep", 65536, EC_ATOMS, 3),
    ("depth", 2 ** 20, 80, 3), ("top", 2 ** 23, 4, 2),
    ("past", 2 ** 24, 4, 2)]


K2_SPLITS = [  # (UNPACK_PAIRS, UNPACK_SLAB, UNPACK_STAGE)
    (32, 1024, 2048), (32, 512, 2048), (32, 512, 1024), (32, 256, 1024),
    (32, 2048, 4096), (16, 512, 1024), (32, 1024, 1024), (32, 1024, 4096)]


def crandn(g, *shape, dtype=torch.complex128):
    return torch.randn(shape, dtype=dtype, device="cuda", generator=g)


def k2_bound(m, w, ph, n_top):
    """K2's least milliseconds, as chip_smoke.py reckons them: the
    spectrum, the output and the order-M table moved once, or its flop."""
    return 1e3 * max(16 * m * (w + ph + 1) / PEAK_BYTES,
                     (8 * m * w + 6 * m * ph) / PEAK_FP64
                     + 8 * n_top * m * ph / PEAK_FP64_MMA)


def k2_splits(cuda_fft, g, reps):
    """K2 alone at FFT_SHAPES under the default split and each of
    K2_SPLITS, against its plain version and beside its bound."""
    default = (cuda_fft.UNPACK_PAIRS, cuda_fft.UNPACK_SLAB,
               cuda_fft.UNPACK_STAGE)
    for label, n, p, d in FFT_SHAPES:
        m = 2 * n
        n_top = cuda_fft.plan_levels(m)[-1]
        w, ph = (p * d + 1) // 2, (p + 1) // 2
        z = crandn(g, m, w)
        ref = cuda_fft.unpack_power_inva_plain(z, p, d)
        bound = k2_bound(m, w, ph, n_top)
        for split in [default] + K2_SPLITS:
            (cuda_fft.UNPACK_PAIRS, cuda_fft.UNPACK_SLAB,
             cuda_fft.UNPACK_STAGE) = split
            tl = cuda_fft.UnpackTiles(m, n_top, w, p, d)
            k2 = time_ms(lambda: cuda_fft.unpack_power_inva(z, p, d), reps)
            err = rel(cuda_fft.unpack_power_inva(z, p, d), ref)
            tag = " (default)" if split == default else ""
            print(f"K2 {label} M = {m}, split {split}{tag}: {tl.tq} pairs "
                  f"x {tl.nj} k_lows, {tl.ktc} k_top rows a pass, "
                  f"{tl.smem} B: {k2:.3f} ms, {100 * bound / k2:.1f} % of "
                  f"{bound:.3f} ms, err {err:.2e}", flush=True)
        (cuda_fft.UNPACK_PAIRS, cuda_fft.UNPACK_SLAB,
         cuda_fft.UNPACK_STAGE) = default
        del z, ref
        torch.cuda.empty_cache()


def level_bound(a, nl, c, order, tw, itemsize=16):
    """A K1 level's least milliseconds, as chip_smoke.py reckons them:
    complex128 at the FP64 peaks, complex64 (``itemsize`` 8) at FP32's."""
    if itemsize == 8:
        return 1e3 * max((16 * a * nl * c + 8 * order) / PEAK_BYTES,
                         (8 * nl * a * nl * c + (6 * a * nl * c if tw else 0))
                         / PEAK_FP32)
    return 1e3 * max((32 * a * nl * c + 16 * order) / PEAK_BYTES,
                     8 * nl * a * nl * c / PEAK_FP64_MMA
                     + (6 * a * nl * c if tw else 0) / PEAK_FP64)


def k5_bound(a, nl, c, n, p):
    n_out = min(nl, -(-n // a))
    return 1e3 * max((16 * a * nl * c + 16 * nl + 8 * n * p) / PEAK_BYTES,
                     8 * nl * a * n_out * c / PEAK_FP64_MMA
                     + n * p / PEAK_FP64)


def split_of(cuda_fft, a, nl, c, epilogue=False, itemsize=16):
    """K1's or K5's split, where the package has LevelTiles."""
    if not hasattr(cuda_fft, "LevelTiles"):
        return "one row of A a block"
    tl = cuda_fft.LevelTiles(a, nl, c, epilogue, itemsize=itemsize)
    if getattr(tl, "columns", False):
        return f"wide, a column a thread, {tl.tc} a block, grid {tl.grid}"
    return (f"wide, slab tiles of {tl.tc}" if tl.wide else
            f"ra {tl.ra}, pitch {tl.pitch}")


def fft_launches(cuda_fft, n, p, d):
    """The K1 launches of one autocorrelation ((shape, sign) each) and
    K5's shape."""
    m = 2 * n
    plan = cuda_fft.plan_levels(m)
    w, ph = (p * d + 1) // 2, (p + 1) // 2
    levels = [(shape, -1) for shape in cuda_fft.level_shapes(plan, w)]
    *inverse, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
    return levels + [(shape, +1) for shape in inverse], last


def k1_levels(cuda_fft, g, reps, label, n, p, d, dtype, wide_only=False):
    """Each K1 level of one autocorrelation at (n, p, d) on ``dtype``
    operands (complex128, or complex64 for the float32 work mode) beside
    its bound and its ``torch.fft`` call, and their sums over the levels
    (only the wide ones with ``wide_only``): returns (kernel, bound,
    library) ms and the count of levels timed."""
    k1 = k1_bound = k1_lib = 0.0
    levels, _ = fft_launches(cuda_fft, n, p, d)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    kind = str(dtype)[6:]
    timed = 0
    for i, ((a, nl, c, order, tw), sign) in enumerate(levels):
        split = split_of(cuda_fft, a, nl, c, itemsize=itemsize)
        if wide_only and not split.startswith("wide"):
            continue
        x = crandn(g, a, nl, c, dtype=dtype)
        err = rel(cuda_fft.fft_level(x, order, sign, twiddle_cols=tw),
                  cuda_fft.fft_level_plain(x, order, sign, twiddle_cols=tw))
        ms = time_ms(lambda: cuda_fft.fft_level(x, order, sign,
                                                twiddle_cols=tw), reps)
        lib = time_ms((lambda: torch.fft.fft(x, dim=1)) if sign < 0
                      else (lambda: torch.fft.ifft(x, dim=1,
                                                   norm="forward")),
                      reps)
        b = level_bound(a, nl, c, order, tw, itemsize)
        k1, k1_bound, k1_lib = k1 + ms, k1_bound + b, k1_lib + lib
        timed += 1
        print(f"K1 {label} {kind} level {i} ({a}, {nl}, {c}) sign "
              f"{sign:+d}, {split}: {ms:.3f} ms, bound {b:.3f} ms "
              f"({100 * b / ms:.1f} %), library {lib:.3f} ms, err "
              f"{err:.2e}", flush=True)
        del x
    if timed:
        print(f"K1 {label} {kind}: {k1:.3f} ms over {timed} "
              f"{'wide ' if wide_only else ''}levels (bound {k1_bound:.3f}, "
              f"{100 * k1_bound / k1:.1f} %; library {k1_lib:.3f})",
              flush=True)
    return k1, k1_bound, k1_lib, timed


def fft(cuda_fft, cuda_kneller, g, reps):
    """The FFT path's kernels at FFT_SHAPES: each K1 level beside its
    bound and its ``torch.fft`` call, K1 summed over the levels of one
    autocorrelation, K2 alone (beside its bound, as chip_smoke.py reckons
    it, and against its plain version), K5 beside its bound, the whole
    autocorrelation of the (N, P·d) float64 series (K1 + K2 + K5) beside
    the library's (rfft, |·|², component sum, irfft), and K6b. A package
    whose plan does not reach a shape says so."""
    for label, n, p, d in FFT_SHAPES:
        m = 2 * n
        try:
            plan = cuda_fft.plan_levels(m)
        except ValueError as err:
            print(f"FFT {label} ({n}, {p}, {d}): {err}", flush=True)
            continue
        w, ph = (p * d + 1) // 2, (p + 1) // 2
        z = crandn(g, m, w)
        k2 = time_ms(lambda: cuda_fft.unpack_power_inva(z, p, d), reps)
        err = rel(cuda_fft.unpack_power_inva(z, p, d),
                  cuda_fft.unpack_power_inva_plain(z, p, d))
        del z
        bound = k2_bound(m, w, ph, plan[-1])
        levels, last = fft_launches(cuda_fft, n, p, d)
        k1, k1_bound, k1_lib, _ = k1_levels(cuda_fft, g, reps, label, n, p,
                                            d, torch.complex128)
        k1_levels(cuda_fft, g, reps, label, n, p, d, torch.complex64)
        a, nl, c, _, _ = last
        t = crandn(g, a, nl, c)
        k5 = time_ms(lambda: cuda_fft.inverse_last_level(t, n, p, True),
                     reps)
        b5 = k5_bound(a, nl, c, n, p)
        print(f"K5 {label} ({a}, {nl}, {c}) -> ({n}, {p}), "
              f"{split_of(cuda_fft, a, nl, c, True)}: {k5:.3f} ms, bound "
              f"{b5:.3f} ms ({100 * b5 / k5:.1f} %)", flush=True)
        del t
        x = torch.randn((n, p * d), dtype=torch.float64, device="cuda",
                        generator=g)
        k = time_ms(lambda: cuda_fft.autocorr_power_sum(x, m, p, d), reps)

        def library():
            f = torch.fft.rfft(x, n=m, dim=0)
            power = f.abs().square().reshape(m // 2 + 1, p, d).sum(-1)
            return torch.fft.irfft(power, n=m, dim=0)[:n]

        lib_acf = time_ms(library, reps)
        del x
        sq = torch.rand((n, p), dtype=torch.float64, device="cuda",
                        generator=g)
        corr = torch.randn((n, p), dtype=torch.float64, device="cuda",
                           generator=g)
        tot = cuda_kneller.kneller_totals(sq)
        k6b = time_ms(lambda: cuda_kneller.kneller_windows(sq, corr, tot, d),
                      reps)
        print(f"FFT {label} ({n}, {p}, {d}), M = {m}: K2 {k2:.3f} ms, "
              f"{100 * bound / k2:.1f} % of its {bound:.3f} ms bound, err "
              f"{err:.2e}; K1 {k1:.3f} ms over {len(levels)} levels "
              f"(bound {k1_bound:.3f}, {100 * k1_bound / k1:.1f} %; library "
              f"{k1_lib:.3f}), K5 {k5:.3f} ms ({100 * b5 / k5:.1f} % of "
              f"{b5:.3f}); K1 + K2 + K5 {k1 + k2 + k5:.3f} ms; "
              f"autocorrelation {k:.3f} ms against the library's "
              f"{lib_acf:.3f}; K6b {k6b:.3f} ms", flush=True)
        del sq, corr, tot
        torch.cuda.empty_cache()


LEVEL_SLABS = [512, 1024, 2048, 4096, 8192]  # LEVEL_SLAB values to sweep


def k1_splits(cuda_fft, g, reps):
    """K1's wide levels in complex128 and complex64 at FFT_SHAPES, then its
    narrow levels and K5 under the default LEVEL_SLAB and each other of
    LEVEL_SLABS, beside their bounds and against their plain versions."""
    for label, n, p, d in FFT_SHAPES:
        for dtype in (torch.complex128, torch.complex64):
            k1_levels(cuda_fft, g, reps, label, n, p, d, dtype,
                      wide_only=True)
            torch.cuda.empty_cache()
    default = cuda_fft.LEVEL_SLAB
    for label, n, p, d in FFT_SHAPES:
        levels, last = fft_launches(cuda_fft, n, p, d)
        cases = [(shape, sign) for shape, sign in levels
                 if not cuda_fft.LevelTiles(*shape[:3]).wide]
        if not cuda_fft.LevelTiles(*last[:3], epilogue=True).wide:
            cases.append((last, None))
        for (a, nl, c, order, tw), sign in cases:
            x = crandn(g, a, nl, c)
            if sign is None:
                def call():
                    return cuda_fft.inverse_last_level(x, n, p, True)
                ref = cuda_fft.inverse_last_level_plain(x, n, p, True)
                b, what = k5_bound(a, nl, c, n, p), "K5"
            else:
                def call():
                    return cuda_fft.fft_level(x, order, sign,
                                              twiddle_cols=tw)
                ref = cuda_fft.fft_level_plain(x, order, sign, tw)
                b, what = level_bound(a, nl, c, order, tw), "K1"
            for slab in [default] + [s for s in LEVEL_SLABS if s != default]:
                cuda_fft.LEVEL_SLAB = slab
                tl = cuda_fft.LevelTiles(a, nl, c, sign is None)
                if tl.smem > cuda_fft.SMEM_LIMIT:
                    continue
                ms = time_ms(call, reps)
                err = rel(call(), ref)
                tag = " (default)" if slab == default else ""
                print(f"{what} {label} ({a}, {nl}, {c}) LEVEL_SLAB {slab}"
                      f"{tag}: ra {tl.ra}, {tl.smem} B: {ms:.3f} ms, "
                      f"{100 * b / ms:.1f} % of {b:.3f} ms, err {err:.2e}",
                      flush=True)
            cuda_fft.LEVEL_SLAB = default
            del x, ref
            torch.cuda.empty_cache()


K6B_SHAPES = [  # (label, N, P, d): the shapes chip_smoke.py gives K6b
    ("model", 8192, EC_ATOMS, 3), ("deep", 65536, EC_ATOMS, 3),
    ("depth", 2 ** 20, 80, 3), ("top", 2 ** 23, 4, 2),
    ("past", 2 ** 24, 4, 2)]


def k6b(cuda_kneller, g, reps):
    """K6b at K6B_SHAPES: ms (CUDA events), share of its bound (sq, corr,
    out and tot moved once), error against its plain version, and the
    device ms of each of its kernels a call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    times = {}
    for label, n, p, d in K6B_SHAPES:
        sq = torch.rand((n, p), dtype=torch.float64, device="cuda",
                        generator=g)
        corr = torch.randn((n, p), dtype=torch.float64, device="cuda",
                           generator=g)
        tot = cuda_kneller.kneller_totals(sq)
        nb = tot.shape[1]

        def call():
            return cuda_kneller.kneller_windows(sq, corr, tot, d)

        err = rel(call(), cuda_kneller.kneller_windows_plain(sq, corr, d))
        k = times[label] = time_ms(call, reps)
        bound = 1e3 * max(8 * (3 * n * p + 2 * nb * p) / PEAK_BYTES,
                          6 * n * p / PEAK_FP64)
        calls = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.events():
            found = re.search(r"kneller_\w+_kernel", e.name)
            if e.device_type == torch.autograd.DeviceType.CUDA and found:
                name = found.group(0)
                by_kernel[name] = by_kernel.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / calls
        split = ", ".join(f"{name} {ms:.4f} ms"
                          for name, ms in sorted(by_kernel.items()))
        print(f"K6b {label} ({n}, {p}): kernel {k:.3f} ms, bound "
              f"{bound:.3f} ms (bytes), {100 * bound / k:.1f} % of bound, "
              f"err {err:.2e}; device a call: {split}", flush=True)
        del sq, corr, tot
        torch.cuda.empty_cache()
    print(f"K6b past/top {times['past'] / times['top']:.3f}", flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only",
                    choices=["k6a", "k6b", "k8", "vacf", "fft", "k2",
                             "k1", "pair"],
                    help="time one group: vacf is K8's acf launches alone, "
                    "k2 K2 under each split of K2_SPLITS, k1 K1's narrow "
                    "levels and K5 under each LEVEL_SLAB of LEVEL_SLABS, "
                    "k6b K6b at the EC and narrow shapes, pair K8's two-block "
                    "launch at the ring's rounds")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--package", default=ROOT,
                    help="checkout whose transport_analysis_tpu_torch to "
                    "time (default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(args.package))
    from transport_analysis_tpu_torch.ops import (cuda_fft, cuda_kneller,
                                                  cuda_lag)
    print(f"{smi('name,power.limit')}; package {cuda_lag.__file__}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    if args.only in (None, "k6a"):
        k6a(cuda_kneller, g, args.reps)
    if args.only in (None, "k8", "vacf"):
        k8(cuda_lag, g, args.reps, acf_only=args.only == "vacf")
    if args.only in (None, "fft"):
        fft(cuda_fft, cuda_kneller, g, args.reps)
    if args.only == "k2":
        k2_splits(cuda_fft, g, args.reps)
    if args.only == "k1":
        k1_splits(cuda_fft, g, args.reps)
    if args.only == "k6b":
        k6b(cuda_kneller, g, args.reps)
    if args.only == "pair":
        pair(cuda_lag, g, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

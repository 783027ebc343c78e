#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 (compute
capability 9.0), ``nvcc`` and PyTorch built for CUDA. Phases, each line
tagged with its phase; any failure raises, so the exit code is non-zero:

1. device  — capability (9, 0); the card's name and power limit as
   ``nvidia-smi`` reports them.
2. build   — nvcc compiles ``transport_analysis_tpu_torch/csrc/*.cu``.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes each model phase below gives it (every
   level of its FFT plan, K2, the K5 epilogue, and K6a/K6b at its
   (frames, atoms)): M = 2^14 and 2^17 over the EC width (5,520 packed
   columns), M = 2^21 over 80 atoms (120 packed columns); and the same
   kernels at the top of the plan's range, M = 2^24 over 8 series. Max
   relative error <= 1e-12; kernel and plain milliseconds, warm, median
   of 5.
4. model   — the ethylene-carbonate system (368 molecules, 3,680 atoms;
   the recipe of ``transport_analysis_tpu/data/generate.py`` re-done in
   memory) at 8,192 frames (M = 2^14) through ``VelocityAutocorr(ag)
   .run()``, ``self_diffusivity_gk()`` and ``ViscosityHelfand(...).run()``:
   once warm, once timed with the kernels' launch counters reset just
   before and read just after. Every kernel must have launched; the VACF
   and the Helfand function per particle, and their particle means
   (``results.timeseries``), must agree with host float64 oracles within
   1e-11 of their maximum on lags < N/2. Then one run under
   ``torch.profiler`` (device activity only): milliseconds and launches
   per category, the device's busy time as the union of its intervals,
   and its idle share of that run's wall time.
5. deep    — the same at 65,536 frames (M = 2^17, the deep range; a
   five-level plan), all 3,680 atoms, with the oracles on every 21st atom
   (the results are per particle, so the check is exact for those; the
   sampled series lie 63 apart, so they reach every 64-column tile of
   the levels and both halves of the (q, q + ph) pairing), the reckoned
   and the measured peak device memory, and its profile. A host oracle of
   every atom would take about 20 GB, so here the particle means are a
   self-consistency check: ``results.timeseries`` against the mean of
   the program's own per-particle values.
6. depth   — the same over 8 molecules (80 atoms) at 1,048,576 frames
   (M = 2^21, a six-level plan), oracles on every 8th atom, particle
   means checked as in the deep phase.

Then one JSON line of per-kernel results (launches from the deep phase's
timed run; kernel and plain milliseconds at its shapes, M = 2^17 over the
EC width) and, last, the device line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816
HEAD_TOL = 1e-11         # model outputs vs host f64, lags < N/2
KERNEL_TOL = 1e-12       # kernel vs its plain version
TEMP = 300.0
FIT_WINDOW = (10, 40)
# (phase, frames, molecules, oracle atom stride)
MODEL_PHASES = [
    ("model", 8192, 368, 1),
    ("deep", 65536, 368, 21),
    ("depth", 2 ** 20, 8, 8),
]

# ethylene carbonate (transport_analysis_tpu/data/generate.py:21-38)
EC_ATOMS = [
    ("C1", 12.011), ("O1", 15.999), ("C2", 12.011), ("H1", 1.008),
    ("H2", 1.008), ("C3", 12.011), ("H3", 1.008), ("H4", 1.008),
    ("O2", 15.999), ("O3", 15.999),
]
EC_OFFSETS = np.array([
    [0.00, 0.00, 0.00], [1.20, 0.45, 0.00], [1.15, 1.85, 0.30],
    [1.60, 2.05, 1.28], [1.70, 2.45, -0.45], [-0.30, 1.95, 0.40],
    [-0.75, 2.15, 1.38], [-0.85, 2.55, -0.35], [-1.05, 0.65, 0.15],
    [-0.20, -1.20, -0.15],
])
BOX = 41.432             # Å, cubic
DT = 1.0                 # ps between saved frames
TAU = 0.35               # ps, velocity correlation time
KB_KJ = 0.008314462159   # kJ/(mol·K)

CSRC = "transport_analysis_tpu_torch/csrc/"
TPU = "transport_analysis_tpu/ops/"
KERNELS = {  # wrapper name -> (source, TPU kernels it replaces)
    "fft_level": (CSRC + "fft.cu", f"{TPU}pallas_fft.py:589 (K1), "
                  f"{TPU}deep_acf.py:919 (K3)"),
    "unpack_power_inva": (CSRC + "fft.cu", f"{TPU}pallas_fft.py:829 (K2), "
                          f"{TPU}deep_acf.py:671 (K4), "
                          f"{TPU}pallas_mirror.py:106 (K7a), "
                          f"{TPU}pallas_mirror.py:201 (K7b)"),
    "inverse_last_level": (CSRC + "fft.cu", f"{TPU}deep_acf.py:1136 (K5)"),
    "kneller_totals": (CSRC + "kneller.cu",
                       f"{TPU}pallas_kneller.py:187 (K6a)"),
    "kneller_windows": (CSRC + "kneller.cu",
                        f"{TPU}pallas_kneller.py:200 (K6b)"),
}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def device_phase(torch):
    cap = tuple(torch.cuda.get_device_capability(0))
    name = torch.cuda.get_device_name(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: {name} has capability {cap}; the "
                         "kernels are built for sm_90a (Hopper, (9, 0))")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{name}, capability {cap}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def build_phase(build):
    t0 = time.perf_counter()
    path = build.build()
    build.library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log")
    ptxas = []
    if log.exists():
        ptxas = [ln.split("ptxas info    : ")[-1] for ln in
                 log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
    phase("build", f"{len(build.sources())} sources -> {path.name} in "
          f"{secs:.1f} s")
    for ln in ptxas:
        phase("build", f"  ptxas: {ln}")


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` on the card, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_diff(got, ref):
    """(max|got - ref|, max|ref|) over chunks of rows, so that no
    full-size difference of two 11.6 GB spectra is formed; their ratio
    is bench.py's error form."""
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    step = max(1, (1 << 26) // max(1, g.shape[1]))
    diff = scale = 0.0
    for i in range(0, g.shape[0], step):
        diff = max(diff, float((g[i:i + step] - r[i:i + step]).abs().max()))
        scale = max(scale, float(r[i:i + step].abs().max()))
    return diff, scale


def kernels_phase(torch, cuda_fft, cuda_kneller):
    """Each kernel against its plain version at every model phase's
    shapes and at the top of the plan's range. The JSON numbers are the
    deep model's: M = 2^17 over the EC width, the fft_level times summed
    over the levels of one autocorrelation."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def crandn(*shape):
        return torch.randn(shape, dtype=torch.complex128, device=dev,
                           generator=g)

    def compare(shape_key, key, kernel, plain, label):
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        abs_err, scale = max_abs_diff(got, ref)
        err = abs_err / scale
        del got, ref
        k_ms = time_ms(torch, kernel)
        p_ms = time_ms(torch, plain)
        phase("kernels", f"{shape_key} {label}: max rel err {err:.3e} (abs "
              f"{abs_err:.3e}), kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{label}: kernel vs plain {err:.3e} > "
                                 f"{KERNEL_TOL}")
        r = results.setdefault(shape_key, {}).setdefault(
            key, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms

    lv, lvp = cuda_fft.fft_level, cuda_fft.fft_level_plain
    shapes = [(name, n, n_molecules * len(EC_ATOMS), 3)
              for name, n, n_molecules, _ in MODEL_PHASES]
    for shape_key, n, p, d in shapes + [("top", 2 ** 23, 4, 2)]:
        m = 2 * n
        plan = cuda_fft.plan_levels(m)
        w, ph = (p * d + 1) // 2, (p + 1) // 2
        phase("kernels", f"{shape_key}: N = {n}, M = {m}, plan {plan}, "
              f"w = {w}, P = {p}, d = {d}")
        for i, (a, nl, c, order, tw) in enumerate(
                cuda_fft.level_shapes(plan, w)):
            x = crandn(a, nl, c)
            compare(shape_key, "fft_level",
                    lambda: lv(x, order, -1, twiddle_cols=tw),
                    lambda: lvp(x, order, -1, twiddle_cols=tw),
                    f"K1 forward level {i} ({a}, {nl}, {c})")
            del x
        z = crandn(m, w)
        compare(shape_key, "unpack_power_inva",
                lambda: cuda_fft.unpack_power_inva(z, p, d),
                lambda: cuda_fft.unpack_power_inva_plain(z, p, d),
                f"K2 unpack_power_inva ({m}, {w}) -> ({plan[-1]}, "
                f"{m // plan[-1]}, {ph})")
        del z
        *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
        for i, (a, nl, c, order, tw) in enumerate(levels):
            x = crandn(a, nl, c)
            compare(shape_key, "fft_level",
                    lambda: lv(x, order, +1, twiddle_cols=tw),
                    lambda: lvp(x, order, +1, twiddle_cols=tw),
                    f"K1 inverse level {i} ({a}, {nl}, {c})")
            del x
        a, nl, c, _, _ = last
        t = crandn(a, nl, c)
        compare(shape_key, "inverse_last_level",
                lambda: cuda_fft.inverse_last_level(t, n, p, True),
                lambda: cuda_fft.inverse_last_level_plain(t, n, p, True),
                f"K5 inverse_last_level ({a}, {nl}, {c}) -> ({n}, {p}) "
                "normalized")
        del t
        v = torch.randn((n, p, d), dtype=torch.float64, device=dev,
                        generator=g)
        sq = (v * v).sum(-1)
        del v
        corr = torch.randn((n, p), dtype=torch.float64, device=dev,
                           generator=g)
        compare(shape_key, "kneller_totals",
                lambda: cuda_kneller.kneller_totals(sq),
                lambda: cuda_kneller.kneller_totals_plain(sq),
                f"K6a kneller_totals ({n}, {p})")
        tot = cuda_kneller.kneller_totals(sq)
        compare(shape_key, "kneller_windows",
                lambda: cuda_kneller.kneller_windows(sq, corr, tot, d),
                lambda: cuda_kneller.kneller_windows_plain(sq, corr, d),
                f"K6b kneller_windows ({n}, {p}) mean d={d}")
        del sq, corr, tot
        torch.cuda.empty_cache()
    for shape_key, by_kernel in results.items():
        for key, r in by_kernel.items():
            phase("kernels", f"{shape_key} total {key}: kernel "
                  f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    phase("kernels", "fft_level totals sum every forward and inverse "
          "level of one autocorrelation")
    return results["deep"]


def ec_system(n_frames: int, n_molecules: int):
    """The ethylene-carbonate recipe of transport_analysis_tpu/data/
    generate.py in memory: lattice-placed molecules in a cubic box,
    Ornstein–Uhlenbeck velocities at TEMP with correlation time TAU,
    positions integrated from them, all in float32 (the trajectory
    formats' precision). Returns (N, n_atoms, 3) positions and
    velocities plus the topology arrays."""
    rng = np.random.RandomState(SEED)
    n_side = int(np.ceil(n_molecules ** (1 / 3)))
    spacing = BOX / n_side
    origins = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                if len(origins) < n_molecules:
                    origins.append(np.array([ix, iy, iz]) * spacing
                                   + rng.uniform(0.5, spacing - 3.0, 3))
    pos0 = (np.asarray(origins)[:, None, :] + EC_OFFSETS[None]).reshape(
        -1, 3)
    n_atoms = len(pos0)
    masses = np.tile([mass for _, mass in EC_ATOMS], n_molecules)
    names = np.tile([name for name, _ in EC_ATOMS], n_molecules)

    rng = np.random.default_rng(SEED + 1)
    sigma_v = np.sqrt(100.0 * KB_KJ * TEMP / masses)[:, None]
    theta = np.exp(-DT / TAU)
    # v[f] = θ·v[f-1] + sqrt(1 - θ²)·σ·ξ[f], v[0] = σ·ξ[0]: the noise
    # drawn in bulk, the recursion one frame (all atoms) at a time
    vel = rng.standard_normal((n_frames, n_atoms, 3), dtype=np.float32)
    vel[0] *= sigma_v.astype(np.float32)
    vel[1:] *= (np.sqrt(1.0 - theta * theta) * sigma_v).astype(np.float32)
    theta = np.float32(theta)
    for f in range(1, n_frames):
        vel[f] += theta * vel[f - 1]
    pos = np.empty_like(vel)
    pos[0] = pos0
    for f in range(1, n_frames):
        np.add(pos[f - 1], vel[f - 1] * np.float32(DT), out=pos[f])
    attrs = {
        "names": names,
        "resnames": np.full(n_atoms, "ECA"),
        "resids": np.repeat(np.arange(1, n_molecules + 1), len(EC_ATOMS)),
        "masses": masses,
    }
    return pos, vel, attrs


def helfand_oracle(masses, vel, pos, d: int) -> np.ndarray:
    """Host float64 Kneller/Calandrini Helfand function per particle
    (before the 2·k_B·V·T normalization): np.fft correlation of the
    centered m·v·x plus cumsum window sums."""
    a = masses[None, :, None] * vel.astype(np.float64) * pos.astype(
        np.float64)
    a -= a.mean(axis=0, keepdims=True)
    n = a.shape[0]
    m = 2 ** (int(n - 1).bit_length() + 1)  # 2·next_pow_2(N)
    f = np.fft.rfft(a, n=m, axis=0)
    corr = np.fft.irfft((f * np.conj(f)).real.sum(-1), n=m, axis=0)[:n]
    del f
    sq = (a * a).sum(-1)
    del a
    css = np.cumsum(sq, axis=0)
    lags = np.arange(n)
    prev = np.concatenate([np.zeros((1, sq.shape[1])), css[:-1]])
    w = css[n - 1 - lags] + css[-1][None] - prev
    out = (w - 2.0 * corr) / ((n - lags) * d)[:, None]
    out[0] = 0.0
    return out


def reckoned_peak(n: int, n_atoms: int) -> int:
    """Device bytes the analyses hold at their peak, the first forward
    level: VACF the float32 feed, Helfand its float64 accumulator and the
    (N, P) squares, each beside two packed complex128 spectra of M rows
    and the order-M roots table."""
    s = 3 * n_atoms
    m = 2 ** (int(n - 1).bit_length() + 1)
    spectra = 2 * 16 * m * ((s + 1) // 2) + 16 * m
    return max(4 * n * s, 8 * n * s + 8 * n * n_atoms) + spectra


PROFILE_CATEGORIES = [      # (substring of the device event name, label)
    ("Memcpy HtoD", "copy host->device"),
    ("Memcpy DtoH", "copy device->host"),
    ("Memcpy", "copy on device"),
    ("Memset", "memset"),
    ("fft_level_kernel", "K1 fft_level"),
    ("unpack_power_inva_kernel", "K2 unpack_power_inva"),
    ("inverse_last_level_kernel", "K5 inverse_last_level"),
    ("kneller_totals_kernel", "K6a kneller_totals"),
    ("kneller_windows_kernel", "K6b kneller_windows"),
]


def profile_phase(torch, name, run, card) -> None:
    """One run of ``run`` under torch.profiler; device time by category,
    busy time as the union of the device intervals, idle share of wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    totals: dict = {}
    for ev, start, end in spans:
        label = next((lab for key, lab in PROFILE_CATEGORIES if key in ev),
                     "PyTorch kernels (elementwise, reductions)")
        ms, count = totals.get(label, (0.0, 0))
        totals[label] = (ms + (end - start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    wall_ms = wall * 1e3
    for label, (ms, count) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        phase(name, f"profile: {label}: {count} launches, {ms:.3f} ms "
              f"device, {100 * ms / wall_ms:.2f} % of wall")
    phase(name, f"profile: wall {wall_ms:.3f} ms profiled, device busy "
          f"{busy_us / 1e3:.3f} ms (union of device intervals), idle "
          f"{100 * (1 - busy_us / 1e3 / wall_ms):.2f} %, on {card}")


def head_errors(got, ref, n: int):
    """max|got - ref| / max|ref| (bench.py's error form) on lags < N/2
    and over all lags."""
    return [float(np.abs(got[s] - ref[s]).max() / np.abs(ref[s]).max())
            for s in (slice(0, n // 2), slice(None))]


def model_phase(torch, ta, acf_numpy, counters, card, name, n, n_molecules,
                stride):
    """VACF + Green–Kubo + Helfand over the EC system of ``n_molecules``
    at ``n`` frames: warm run, timed run with the launch counters reset
    just before and read just after; oracles on every ``stride``-th
    atom. Returns the timed run's launches."""
    t_phase = time.perf_counter()
    pos, vel, attrs = ec_system(n, n_molecules)
    n_atoms = pos.shape[1]
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader
    from transport_analysis_tpu_torch.utils.units import constants

    u = ta.Universe.empty(
        n_atoms, n_residues=n_molecules,
        atom_resindex=np.repeat(np.arange(n_molecules), len(EC_ATOMS)))
    for attr, values in attrs.items():
        u.add_TopologyAttr(attr, values)
    u.load_new(MemoryReader(pos, velocities=vel,
                            dimensions=[BOX, BOX, BOX, 90.0, 90.0, 90.0],
                            dt=DT))
    m = 2 ** (int(n - 1).bit_length() + 1)
    from transport_analysis_tpu_torch.ops.cuda_fft import plan_levels

    phase(name, f"EC system: {n_atoms} atoms x {n} frames, box {BOX} Å, "
          f"f32 feed {pos.nbytes / 2**20:.0f} MiB x 2, M = {m}, plan "
          f"{plan_levels(m)}; generated in "
          f"{time.perf_counter() - t_phase:.1f} s; reckoned peak device "
          f"memory {reckoned_peak(n, n_atoms) / 2**30:.3f} GiB")

    def run():
        ag = u.select_atoms("resname ECA")
        vacf = ta.VelocityAutocorr(ag).run()
        d_gk = vacf.self_diffusivity_gk()
        visc = ta.ViscosityHelfand(u.atoms, temp_avg=TEMP,
                                   linear_fit_window=FIT_WINDOW).run()
        return vacf, d_gk, visc

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vacf, d_gk, visc = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    phase(name, f"launches in the timed run: {launches}")
    missing = [key for key, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the {name} path: "
                             f"{missing}")

    atoms = slice(None, None, stride)
    head = slice(0, n // 2)

    def mean_error(timeseries, by_particle, ref):
        """The particle mean's error on lags < N/2: against the host
        oracle's mean over every atom, or, when the oracle covers only
        the sampled atoms, against the mean of the program's own
        per-particle values (a self-consistency check)."""
        target = (ref if stride == 1 else by_particle)[head].mean(axis=1)
        return float(np.abs(timeseries[head] - target).max()
                     / np.abs(target).max())

    ref = acf_numpy(vel[:, atoms])
    err_v = head_errors(vacf.results.vacf_by_particle[:, atoms], ref, n)
    ts_v = mean_error(vacf.results.timeseries,
                      vacf.results.vacf_by_particle, ref)
    del ref
    ref = helfand_oracle(attrs["masses"][atoms], vel[:, atoms],
                         pos[:, atoms], 3) / (
        2.0 * constants["Boltzmann_constant"] * BOX ** 3 * TEMP)
    by_particle = visc.results.visc_by_particle
    err_h = head_errors(by_particle[:, atoms], ref, n)
    ts_h = mean_error(visc.results.timeseries, by_particle, ref)
    del ref
    mean_of = ("host f64 over every atom" if stride == 1 else
               "the mean of its own per-particle values")
    phase(name, f"VACF vs host f64 on {len(range(n_atoms)[atoms])} atoms: "
          f"{err_v[0]:.3e} (lags < N/2), {err_v[1]:.3e} (all lags); "
          f"Helfand vs host f64: {err_h[0]:.3e} (lags < N/2), "
          f"{err_h[1]:.3e} (all lags); timeseries (lags < N/2) vs "
          f"{mean_of}: VACF {ts_v:.3e}, Helfand {ts_h:.3e}")
    finite = all(np.isfinite(v).all() for v in (
        vacf.results.timeseries, visc.results.timeseries,
        d_gk, visc.results.viscosity))
    shapes_ok = (vacf.results.vacf_by_particle.shape == (n, n_atoms)
                 and by_particle.shape == (n, n_atoms))
    phase(name, f"D_gk = {d_gk:.6e} Å²/ps, viscosity slope = "
          f"{visc.results.viscosity:.6e}, finite {finite}, shapes "
          f"{shapes_ok}")
    if not (finite and shapes_ok):
        raise AssertionError("model outputs are not finite or have the "
                             "wrong shape")
    if not max(err_v[0], err_h[0], ts_v, ts_h) <= HEAD_TOL:
        raise AssertionError(f"model outputs disagree with host f64 beyond "
                             f"{HEAD_TOL} on lags < N/2")
    lag_work = 2 * (n * (n + 1) // 2) * n_atoms
    phase(name, f"wall {wall:.4f} s timed (warm run {warm:.4f} s), "
          f"{lag_work / wall:.4e} atom-frame-lags/s, peak device memory "
          f"{peak / 2**30:.3f} GiB (reckoned "
          f"{reckoned_peak(n, n_atoms) / 2**30:.3f}), on {card}")
    del vacf, visc, by_particle
    profile_phase(torch, name, run, card)
    phase(name, f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    sys.path.insert(0, ROOT)
    import transport_analysis_tpu_torch as ta
    if not os.path.abspath(ta.__file__).startswith(ROOT + os.sep):
        raise SystemExit(f"chip_smoke: imported the port from {ta.__file__}, "
                         f"not from the checkout at {ROOT}")
    t_start = time.perf_counter()
    card_name, smi = device_phase(torch)
    from transport_analysis_tpu_torch import _build
    from transport_analysis_tpu_torch.ops import cuda_fft, cuda_kneller
    from transport_analysis_tpu_torch.ops.acf import acf_fft_numpy

    build_phase(_build)
    t0 = time.perf_counter()
    kernel_results = kernels_phase(torch, cuda_fft, cuda_kneller)
    phase("kernels", f"phase done in {time.perf_counter() - t0:.1f} s")
    counters = {
        "fft_level": cuda_fft.fft_level,
        "unpack_power_inva": cuda_fft.unpack_power_inva,
        "inverse_last_level": cuda_fft.inverse_last_level,
        "kneller_totals": cuda_kneller.kneller_totals,
        "kneller_windows": cuda_kneller.kneller_windows,
    }
    launches = {}
    for name, n, n_molecules, stride in MODEL_PHASES:
        launches[name] = model_phase(torch, ta, acf_fft_numpy, counters,
                                     smi, name, n, n_molecules, stride)
        torch.cuda.empty_cache()
    if any(mod == "jax" or mod.startswith("jax.") for mod in sys.modules):
        raise AssertionError("jax was imported")
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches["deep"][name], **kernel_results[name]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

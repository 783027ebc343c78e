#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 (compute
capability 9.0), ``nvcc`` and PyTorch built for CUDA. Phases, one line
each; any failure raises, so the exit code is non-zero:

1. device  — capability (9, 0); the card's name and power limit as
   ``nvidia-smi`` reports them.
2. build   — nvcc compiles ``transport_analysis_tpu_torch/csrc/*.cu``.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes the main path gives it (max relative error
   <= 1e-12; kernel and plain milliseconds, warm, median of 5).
4. model   — an ethylene-carbonate system (368 molecules, 3,680 atoms,
   8,192 frames; the recipe of ``transport_analysis_tpu/data/generate.py``
   re-done in memory) through ``VelocityAutocorr(ag).run()``,
   ``self_diffusivity_gk()`` and ``ViscosityHelfand(...).run()``: once
   warm, once timed with the kernels' launch counters reset just before.
   Every kernel must have launched; the VACF and the Helfand function
   must agree with host float64 oracles within 1e-11 of their maximum on
   lags < N/2.
5. profile — one more model run under ``torch.profiler`` (device activity
   only): milliseconds and launches per category (copies each way, each
   hand-written kernel, PyTorch's own kernels), the device's busy time as
   the union of its intervals, and its idle share of that run's wall time.

Then one JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
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
N_FRAMES = 8192
SEED = 20260816
HEAD_TOL = 1e-11         # model outputs vs host f64, lags < N/2
KERNEL_TOL = 1e-12       # kernel vs its plain version
TEMP = 300.0
FIT_WINDOW = (10, 40)

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
N_MOLECULES = 368
BOX = 41.432             # Å, cubic
DT = 1.0                 # ps between saved frames
TAU = 0.35               # ps, velocity correlation time
KB_KJ = 0.008314462159   # kJ/(mol·K)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| (bench.py's error form)."""
    return float((got - ref).abs().max() / ref.abs().max())


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


def kernels_phase(torch, cuda_fft, cuda_kneller, n_atoms: int):
    """Each kernel against its plain version at the main path's shapes:
    N frames, S = 3·n_atoms series, M = 2·next_pow_2(N)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    n, p, d = N_FRAMES, n_atoms, 3
    m = 2 * N_FRAMES
    n1, n2 = cuda_fft.split_m(m)
    w = (p * d + 1) // 2
    ph = (p + 1) // 2
    rows = -(-n // n2)

    def crandn(*shape):
        return torch.randn(shape, dtype=torch.complex128, device=dev,
                           generator=g)

    results = {}

    def compare(key, kernel, plain, label):
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        abs_err = float((got - ref).abs().max())
        del got, ref
        k_ms = time_ms(torch, kernel)
        p_ms = time_ms(torch, plain)
        phase("kernels", f"{label}: max rel err {err:.3e} (abs "
              f"{abs_err:.3e}), kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{label}: kernel vs plain {err:.3e} > "
                                 f"{KERNEL_TOL}")
        r = results.setdefault(key, {"max_abs_err": 0.0, "ms": 0.0,
                                     "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms

    lv, lvp = cuda_fft.fft_level, cuda_fft.fft_level_plain
    x = crandn(1, n1, n2 * w)
    compare("fft_level", lambda: lv(x, m, -1, twiddle_cols=w),
            lambda: lvp(x, m, -1, twiddle_cols=w),
            f"K1 fft_level L1 (1, {n1}, {n2}*{w}) twiddled")
    x = crandn(n1, n2, w)
    compare("fft_level", lambda: lv(x, m, -1), lambda: lvp(x, m, -1),
            f"K1 fft_level L2 ({n1}, {n2}, {w})")
    x = crandn(n2, n1, ph)
    compare("fft_level", lambda: lv(x, m, +1, n_out=rows),
            lambda: lvp(x, m, +1, n_out=rows),
            f"K1 fft_level inverse B ({n2}, {n1}, {ph}) -> {rows} rows")
    z = crandn(m, w)
    compare("unpack_power_inva",
            lambda: cuda_fft.unpack_power_inva(z, p, d),
            lambda: cuda_fft.unpack_power_inva_plain(z, p, d),
            f"K2 unpack_power_inva ({m}, {w}), P={p} d={d}")
    del x, z
    c = torch.randn((n, p, d), dtype=torch.float64, device=dev, generator=g)
    sq = (c * c).sum(-1)
    corr = torch.randn((n, p), dtype=torch.float64, device=dev,
                       generator=g)
    compare("kneller_totals", lambda: cuda_kneller.kneller_totals(sq),
            lambda: cuda_kneller.kneller_totals_plain(sq),
            f"K6a kneller_totals ({n}, {p})")
    tot = cuda_kneller.kneller_totals(sq)
    compare("kneller_windows",
            lambda: cuda_kneller.kneller_windows(sq, corr, tot, d),
            lambda: cuda_kneller.kneller_windows_plain(sq, corr, d),
            f"K6b kneller_windows ({n}, {p}) mean d={d}")
    phase("kernels", "K1 lines sum the three levels of one "
          "autocorrelation into the kernel's ms and plain ms")
    return results


def ec_system(n_frames: int):
    """The ethylene-carbonate recipe of transport_analysis_tpu/data/
    generate.py in memory: lattice-placed molecules in a cubic box,
    Ornstein–Uhlenbeck velocities at TEMP with correlation time TAU,
    positions integrated from them. Returns float32 (N, n_atoms, 3)
    positions and velocities plus the topology arrays."""
    rng = np.random.RandomState(SEED)
    n_side = int(np.ceil(N_MOLECULES ** (1 / 3)))
    spacing = BOX / n_side
    origins = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                if len(origins) < N_MOLECULES:
                    origins.append(np.array([ix, iy, iz]) * spacing
                                   + rng.uniform(0.5, spacing - 3.0, 3))
    pos0 = (np.asarray(origins)[:, None, :] + EC_OFFSETS[None]).reshape(
        -1, 3)
    n_atoms = len(pos0)
    masses = np.tile([mass for _, mass in EC_ATOMS], N_MOLECULES)
    names = np.tile([name for name, _ in EC_ATOMS], N_MOLECULES)

    rng = np.random.RandomState(SEED + 1)
    sigma_v = np.sqrt(100.0 * KB_KJ * TEMP / masses)[:, None]
    theta = np.exp(-DT / TAU)
    noise = np.sqrt(1.0 - theta * theta)
    vel = np.empty((n_frames, n_atoms, 3))
    vel[0] = rng.normal(0, 1, (n_atoms, 3)) * sigma_v
    for f in range(1, n_frames):
        vel[f] = theta * vel[f - 1] + noise * sigma_v * rng.normal(
            0, 1, (n_atoms, 3))
    pos = np.empty_like(vel)
    pos[0] = pos0
    np.cumsum(vel[:-1] * DT, axis=0, out=pos[1:])
    pos[1:] += pos0
    attrs = {
        "names": names,
        "resnames": np.full(n_atoms, "ECA"),
        "resids": np.repeat(np.arange(1, N_MOLECULES + 1), len(EC_ATOMS)),
        "masses": masses,
    }
    return pos.astype(np.float32), vel.astype(np.float32), attrs


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


PROFILE_CATEGORIES = [      # (substring of the device event name, label)
    ("Memcpy HtoD", "copy host->device"),
    ("Memcpy DtoH", "copy device->host"),
    ("Memcpy", "copy on device"),
    ("Memset", "memset"),
    ("fft_level_kernel", "K1 fft_level"),
    ("unpack_power_inva_kernel", "K2 unpack_power_inva"),
    ("kneller_totals_kernel", "K6a kneller_totals"),
    ("kneller_windows_kernel", "K6b kneller_windows"),
]


def profile_phase(torch, run, card) -> None:
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
    for name, start, end in spans:
        label = next((lab for key, lab in PROFILE_CATEGORIES if key in name),
                     "PyTorch kernels (elementwise, reductions)")
        ms, count = totals.get(label, (0.0, 0))
        totals[label] = (ms + (end - start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    wall_ms = wall * 1e3
    for label, (ms, count) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        phase("profile", f"{label}: {count} launches, {ms:.3f} ms device, "
              f"{100 * ms / wall_ms:.2f} % of wall")
    phase("profile", f"wall {wall_ms:.3f} ms profiled, device busy "
          f"{busy_us / 1e3:.3f} ms (union of device intervals), idle "
          f"{100 * (1 - busy_us / 1e3 / wall_ms):.2f} %, on {card}")


def model_phase(torch, ta, acf_numpy, counters, card):
    pos, vel, attrs = ec_system(N_FRAMES)
    n_atoms = pos.shape[1]
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader
    from transport_analysis_tpu_torch.utils.units import constants

    u = ta.Universe.empty(
        n_atoms, n_residues=N_MOLECULES,
        atom_resindex=np.repeat(np.arange(N_MOLECULES), len(EC_ATOMS)))
    for name, values in attrs.items():
        u.add_TopologyAttr(name, values)
    u.load_new(MemoryReader(pos, velocities=vel,
                            dimensions=[BOX, BOX, BOX, 90.0, 90.0, 90.0],
                            dt=DT))
    phase("model", f"EC system: {n_atoms} atoms x {N_FRAMES} frames, "
          f"box {BOX} Å, f32 feed {pos.nbytes / 2**20:.0f} MiB x 2")

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
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    phase("model", f"launches in the timed run: {launches}")
    missing = [name for name, count in launches.items() if count < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")

    n = N_FRAMES
    head = slice(0, n // 2)
    ref = acf_numpy(vel)
    got = vacf.results.vacf_by_particle
    err_v = [float(np.abs(got[s] - ref[s]).max() / np.abs(ref[s]).max())
             for s in (head, slice(None))]
    del ref
    ref = helfand_oracle(attrs["masses"], vel, pos, 3) / (
        2.0 * constants["Boltzmann_constant"] * BOX ** 3 * TEMP)
    got = visc.results.visc_by_particle
    err_h = [float(np.abs(got[s] - ref[s]).max() / np.abs(ref[s]).max())
             for s in (head, slice(None))]
    ts_ok = np.allclose(visc.results.timeseries[head],
                        ref[head].mean(axis=1), rtol=0,
                        atol=HEAD_TOL * np.abs(ref[head]).max())
    del ref
    phase("model", f"VACF vs host f64: {err_v[0]:.3e} (lags < N/2), "
          f"{err_v[1]:.3e} (all lags); Helfand vs host f64: "
          f"{err_h[0]:.3e} (lags < N/2), {err_h[1]:.3e} (all lags)")
    finite = all(np.isfinite(v).all() for v in (
        vacf.results.timeseries, visc.results.timeseries,
        d_gk, visc.results.viscosity))
    shapes_ok = (vacf.results.vacf_by_particle.shape == (n, n_atoms)
                 and visc.results.visc_by_particle.shape == (n, n_atoms))
    phase("model", f"D_gk = {d_gk:.6e} Å²/ps, viscosity slope = "
          f"{visc.results.viscosity:.6e}, finite {finite}, shapes "
          f"{shapes_ok}")
    if not (finite and shapes_ok):
        raise AssertionError("model outputs are not finite or have the "
                             "wrong shape")
    if not (err_v[0] <= HEAD_TOL and err_h[0] <= HEAD_TOL and ts_ok):
        raise AssertionError(f"model outputs disagree with host f64 beyond "
                             f"{HEAD_TOL} on lags < N/2")
    lag_work = 2 * (n * (n + 1) // 2) * n_atoms
    phase("model", f"wall {wall:.4f} s timed (warm run {warm:.4f} s), "
          f"{lag_work / wall:.4e} atom-frame-lags/s, peak device memory "
          f"{peak / 2**30:.3f} GiB, on {card}")
    profile_phase(torch, run, card)
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
    card_name, smi = device_phase(torch)
    from transport_analysis_tpu_torch import _build
    from transport_analysis_tpu_torch.ops import cuda_fft, cuda_kneller
    from transport_analysis_tpu_torch.ops.acf import acf_fft_numpy

    build_phase(_build)
    kernel_results = kernels_phase(torch, cuda_fft, cuda_kneller,
                                   n_atoms=len(EC_ATOMS) * N_MOLECULES)
    counters = {
        "fft_level": cuda_fft.fft_level,
        "unpack_power_inva": cuda_fft.unpack_power_inva,
        "kneller_totals": cuda_kneller.kneller_totals,
        "kneller_windows": cuda_kneller.kneller_windows,
    }
    launches = model_phase(torch, ta, acf_fft_numpy, counters, smi)
    if any(mod == "jax" or mod.startswith("jax.") for mod in sys.modules):
        raise AssertionError("jax was imported")

    csrc = "transport_analysis_tpu_torch/csrc/"
    tpu = "transport_analysis_tpu/ops/"
    meta = {
        "fft_level": (csrc + "fft.cu", tpu + "pallas_fft.py:589"),
        "unpack_power_inva": (csrc + "fft.cu", tpu + "pallas_fft.py:829"),
        "kneller_totals": (csrc + "kneller.cu", tpu + "pallas_kneller.py:187"),
        "kneller_windows": (csrc + "kneller.cu",
                            tpu + "pallas_kneller.py:200"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **kernel_results[name]}
        for name, (src, replaces) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

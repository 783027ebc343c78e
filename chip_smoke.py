#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA Hopper card.

    python3 chip_smoke.py

Run from the repository root on a machine with an H100 (compute
capability 9.0), ``nvcc`` and PyTorch built for CUDA. Phases, each line
tagged with its phase; any failure raises, so the exit code is non-zero:

1. device  — capability (9, 0); the card's name and power limit as
   ``nvidia-smi`` reports them.
2. build   — nvcc compiles ``transport_analysis_tpu_torch/csrc/*.cu``;
   ``cuobjdump -sass`` must show DMMA (FP64 tensor-core) instructions in
   each instantiation of K8's acf kernel.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes each model phase below gives it (every
   level of its FFT plan, K2, the K5 epilogue, and K6a/K6b at its
   (frames, atoms), K6b with its share of its bound and its split, and
   its past/top time ratio): M = 2^14 and 2^17 over the EC width (5,520
   packed columns), M = 2^21 over 80 atoms (120 packed columns); the same
   kernels on narrow, very long series, 4 particles of 2 components at
   M = 2^24 and at M = 2^25 (past the plan's old cap), with the share of
   its bound and the work split of each K1 level, of K2 and of K5 at
   every shape (K1's and K5's ``LevelTiles``: at wide levels K1's column
   launch, a column a thread, at n <= 16, else column tiles of a slab, at
   narrow widths ra rows of A a block at a slab pitch); K8 at each windowed
   run's shapes (the kernel over every atom, its plain version over
   every 21st atom's series) and at d = 5 (8,192 frames x 64 atoms, 512
   lags, both modes and operand types; one launch per group of at most
   three components). Max relative error
   <= 1e-12; kernel and library-call milliseconds, warm, median of 5
   timings of back-to-back calls (at least about 5 ms each, so a short
   kernel is timed on the card, not the host's launch), plain
   milliseconds median of 2; the bound, the larger of the bytes
   over 3.35 TB/s and the flop over the FP64 peak of their kind (H100
   SXM): 67 TFLOP/s on the tensor cores for matrix products (the DFT
   levels, K8's acf sums, a Gram product of frame tiles), 34 TFLOP/s
   for the rest (K6's sums and scans, K8's einstein sums, whose
   subtraction comes before the square; beside that bound, the FP64
   pipe's issue-slot ceiling, two instructions a pair-component at
   17e12/s; beside the acf bound, the kernel's share of it and the FMA
   pipe's floor, one multiply-add a pair-component at 17e12/s, what the
   sums would need off the tensor cores). The library call for K6a, the
   reshape-sum, forms only the forward leg of its totals (the kernel
   forms both from one read of sq); for K8 it is a grouped ``F.conv1d``
   of the float64 series, for its acf launches only (no one call forms
   the einstein sums).
   Then the float32 work mode's instantiations (``dtype=np.float32``):
   complex64 K1 (every level), K2 and K5, float32 K6a and K6b, and K8's
   float32 acf and einstein launches, at the shapes the f32 phase below
   gives them: 8,192 and 65,536 frames over the EC width (K8 at 8,192
   lags with the MSD's launch, and at 2,048 lags; plain on every 21st
   atom), and the FFT kernels and K6 at the deep shape over the widths of
   the chunked float32 MSD's atom chunks (1,904 and 1,776 atoms), each
   against its plain version in the same types within 1e-5
   (a few float32 roundings of each output's sum), each complex64 K1
   level with its split; bounds of float32
   bytes, and flop over 67 TFLOP/s (FP32 outside the tensor cores, and
   the FP64 tensor cores for K8's acf Gram; K6's float64 sums over FP64's
   34), beside the einstein bound the FP32 pipe's issue-slot ceiling, two
   instructions a pair-component at 33.5e12/s; library calls ``torch.fft`` in complex64 per K1 level, rfft,
   |.|², component sum and irfft of the float32 operand beside K1 + K2 +
   K5, and a grouped float32 ``F.conv1d`` (TF32 off) for K8's acf launch.
4. model   — the ethylene-carbonate system (368 molecules, 3,680 atoms;
   the recipe of ``transport_analysis_tpu/data/generate.py`` re-done in
   memory) at 8,192 frames (M = 2^14). Runs, each once warm, once timed
   with the kernels' launch counters reset just before and read just
   after, and once under ``torch.profiler`` (device activity only:
   milliseconds and launches per category, the device's busy time as
   the union of its intervals, its idle share of the wall):
   ``fft`` — ``VelocityAutocorr(ag).run()``, ``self_diffusivity_gk()``
   and ``ViscosityHelfand(...).run()``, which must launch K1, K2, K5,
   K6a and K6b; ``windowed`` — the same with ``fft=False``, which must
   launch K8; ``msd_fft`` and ``msd_windowed`` — ``EinsteinMSD(u,
   select="resname ECA")`` with ``fft=True`` (the FFT kernels) and
   ``fft=False`` (K8). The VACF, the Helfand function and the MSD per
   particle, and their particle means (``results.timeseries``), must
   agree with host float64 oracles within 1e-11 of their maximum on lags
   < N/2; each windowed result is also held against the FFT result of
   the card.
   After the model and the deep phases: f32 — the float32 work mode
   (``dtype=np.float32``) on the same system: ``fft`` and ``windowed``
   (``max_lag=2048`` at the deep shape), and at the model shape
   ``msd_fft`` and ``msd_windowed``, each driven as above (profiled: the
   ``fft`` runs), each launching the float32 instantiations and no
   float64 kernel, with float32 results; its wall beside the float64
   run's, the result bytes copied to the host, and its error against the
   host f64 oracles, within 1e-4 of their maximum on lags < N/2 (the JAX
   package's hardware bar) and printed over all lags. At the deep shape,
   a float32 MSD in the atom chunks ``auto_atom_chunk(65536, d=3,
   hbm_budget_gb=8.0, dtype=np.float32)`` chooses, its peak device memory
   within ``chunk_peak_bytes(..., dtype=np.float32)``.
5. files   — the model phase's system (3,680 atoms x 8,192 frames)
   through the port's writers into a temporary directory under
   ``build/``: a TRR of positions and velocities, an XTC of the positions
   at precision 1000, a DCD of the positions, with a PDB of the atoms
   (bytes and write seconds of each). Each is read back through
   ``Universe(pdb, traj)``: ``read_frames_batch`` over all frames, timed,
   in seconds and GB/s of decoded float32 (the TRR batch must go through
   the native decoder), and held against what was written (TRR within
   two float32 roundings, XTC within its quantum, DCD bit-equal). Then
   ``fft`` and ``windowed`` from the TRR, ``msd_fft`` and ``msd_windowed``
   from the XTC, timed and profiled as in the model phase (no warm run:
   the model phase just ran them) and printed beside the model phase's
   in-memory walls; each result equals the same analysis on a
   MemoryReader of the reader's own decoded arrays within 1e-15, and
   meets host f64 oracles of the decoded arrays within 1e-11 on lags
   < N/2. Last, the packaged regression: ``Universe(data.files.ec_top,
   data.files.ec_traj_trr)`` (100 frames, generated by the port) on the
   card, its viscosity within 1e-11 of the CPU's and 5e-5 of the pinned
   0.00098984, its VACF lag 0 within 1e-4 of 328.965.
6. deep    — the same at 65,536 frames (M = 2^17, the deep range; a
   five-level plan), all 3,680 atoms: ``fft``, and ``windowed`` with
   ``max_lag=2048``. Oracles on every 21st atom (the results are per
   particle, so the check is exact for those; the sampled series lie 63
   apart, so they reach every 64-column tile of the levels and both
   halves of the (q, q + ph) pairing), the windowed results against the
   FFT ones over every atom, the reckoned and the measured peak device
   memory. A host oracle of every atom would take about 20 GB, so here
   the particle means are a self-consistency check:
   ``results.timeseries`` against the mean of the program's own
   per-particle values.
7. stream  — the streaming layer. At the deep shape: the frame-blocked
   feed (``frame_block=4096``: 16 blocks through ``io.prefetch`` into
   device buffers) for ``fft``, timed and profiled, each result within
   1e-15 of the deep phase's batch run (bit-equal or not, said); atom
   chunks (``atom_chunk`` from ``ops.acf.auto_atom_chunk(65536, d=3,
   hbm_budget_gb=8.0)`` for the VACF and the MSD, one atom less for
   Helfand, so one of them has an odd d·chunk) for ``fft`` and
   ``windowed`` (``max_lag=2048``), each within 1e-12 of the unchunked
   run (the deep phase's, and an unchunked MSD run here, the MSD on
   lags < N/2) and 1e-11 of the host oracles (every 21st atom, lags <
   N/2), each chunk launching its
   kernels (the launch
   counters equal the unchunked run's per analysis times the chunks), its
   peak device memory (``max_memory_allocated``, the roots and FFT plan
   caches cleared first) past what was held before within its reckoned
   chunk peak (``ops.acf.chunk_peak_bytes``), which is within the budget;
   a chunked VACF interrupted after two chunks and resumed from its
   checkpoint under ``build/`` (only the other chunks run), equal to the
   uninterrupted run. From the files phase's TRR: the frame-blocked feed
   (8 blocks of 1,024 frames through the native decoder) beside the files
   phase's batch wall and equal to its results; ``vacf_out_of_core`` and
   ``msd_out_of_core`` (spools of 1,024 atoms under ``build/``, deleted
   after) within 1e-13 of the in-memory analyses of the file;
   ``helfand_out_of_core`` within 1e-11 of a host oracle of its float32
   m·v·x spools (lags < N/2), with its float32-grade distance from the
   in-memory ``ViscosityHelfand``; ``correlate_spools``' per-chunk
   read, stall and kernel seconds and the overlap 1 − Σstall/Σread.
8. mesh    — several devices on the one card: ``analysis_mesh()`` over
   every visible card (its count printed), then ``analysis_mesh(["cuda"]
   * 4)``, four particle shards of the card. Under ``use_mesh`` the model
   phase's runs (``fft``, ``windowed``, ``msd_fft``, ``msd_windowed``),
   each once warm and once timed, within 1e-13 of the model phase's
   unsharded run (bit-equal or not, said; the MSD on lags < N/2) and
   1e-11 of the host oracles, with 4 x its launches. The ring (``parallel.ring``) over four frame blocks
   of that system, all 8,192 lags, float64 acf and einstein (sum_d both
   ways) and float32 acf and einstein, against K8 ``lag_sums`` of the
   whole series within 1e-12 (1e-5), its wall beside its bound (pairs x
   d x 2 flop at 67 TFLOP/s for acf, x 3 at 34, or 67 in float32, for
   einstein; bytes over 3.35 TB/s) and K8's, ten two-block launches a
   ring; the two-block launch (``lag_sums_pair``, K8's two-block
   kernels) on the ring's rounds 0 (xa = xb, offset 0), 1 and 3
   (lags up to N - 1), blocks of 2,048 frames over every atom, against
   its plain version on every 21st atom, both modes, float64 and float32
   blocks (1e-12, 1e-5 in float32), each launch's share of its bound and
   the acf split's MMA work against the pair-components it sums
   (``cuda_lag.acf_pair_work``), round 1's acf launches beside the
   library's pair sums, a grouped ``F.conv1d`` (TF32 off) of the
   zero-padded partner series with the base series. The sharded FFT at
   65,536 frames (M = 2^17, four frame shards) over every 10th atom of
   the deep system: ``sharded_acf_fft`` and ``sharded_msd_fft`` within
   1e-12 of ``ops.acf_fft`` / ``ops.msd_fft`` on the card and 1e-11 of
   host f64 (lags < N/2), and ``sharded_fft`` forward against
   ``torch.fft.fft`` in transposed order and back. From the files
   phase's TRR, ``vacf_out_of_core_sharded`` and
   ``helfand_out_of_core_sharded`` within 1e-13 of the plain out-of-core
   runs on the same spools (under ``build/``, deleted after). Last, a
   one-process NCCL group (``init_method`` a file under ``build/``): the
   multi-process feed in four shards, its all_reduce equal to the local
   sum and its all_gather to the feed; the group is destroyed. Each run's
   wall and peak device memory.
9. multiprocess — the sequence-parallel paths over meshes of several
   processes, at the model shape (four blocks of 2,048 frames): (a) a
   one-process NCCL group, the ring on ``multihost.global_mesh(["cuda"] *
   4, "frames")`` in each of the mesh phase's cases and the sharded VACF
   of its 65,536-frame, every-10th-atom series, each bit-equal to (or
   within 1e-13 of) the mesh phase's one-process result and within
   1e-12 (float32 1e-5) of K8's serial sums or ``ops.acf_fft``, no byte
   sent; (b) the same runs in two child processes under gloo on the one
   card (NCCL refuses two ranks on one GPU), two blocks each, started
   after the build phase with a timeout: each child imports no jax, its
   messages staged through host copies; each run's wall and bytes sent
   per process, the children's launches (ten two-block launches a ring
   between them), their results bit-equal to each other and held as in
   (a); (c) ``entry.analysis_step`` on the card against its CPU run
   (1e-10; K1, K2, K5, K6a and K6b launched) and
   ``entry.dryrun_multichip(4)`` on the card; (d) a model VACF run's
   ``analysis.timing``, its "compute" no shorter than the CUDA-event time
   of its ``_conclude``, and ``utils.profiling.trace`` of that run, whose
   Chrome trace must hold the FFT kernels by their ``csrc`` names.
10. depth  — ``fft`` over 8 molecules (80 atoms) at 1,048,576 frames
   (M = 2^21, a six-level plan), oracles on every 8th atom, particle
   means checked as in the deep phase.

Then one JSON line of per-kernel results, one entry per instantiation
(``<wrapper>_f32`` for the float32 work mode's; launches from the deep
phase's timed runs, and the f32 phase's at the deep shape for the
float32 entries, ``fft`` for K1–K6b and ``windowed`` for K8, the mesh
phase's ring runs for ``lag_sums_pair``; kernel, plain,
bound and library milliseconds at its shapes: M = 2^17 over the EC width,
K8 over 65,536 frames and 2,048 lags, summed over the VACF and Helfand
launches, the two-block launch at the mesh phase's round 1 summed over
its acf and einstein launches, with ``plain_atoms`` beside ``atoms`` and
``library_kernel_ms``, the kernel's time on the launches its library call
covers: K8's acf launches) and, last,
the device line ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816
HEAD_TOL = 1e-11         # model outputs vs host f64, lags < N/2
KERNEL_TOL = 1e-12       # kernel vs its plain version
# the float32 work mode: its outputs vs host f64 on lags < N/2 (the JAX
# package's hardware bar, tests/test_tpu_equivalence.py:435-447), and each
# float32 / complex64 instantiation vs its plain version in the same type
# (a few float32 roundings of each output's sum)
F32_TOL = 1e-4
F32_KERNEL_TOL = 1e-5
TEMP = 300.0
FIT_WINDOW = (10, 40)
# (phase, frames, molecules, oracle atom stride)
MODEL_PHASES = [
    ("model", 8192, 368, 1),
    ("deep", 65536, 368, 21),
    ("depth", 2 ** 20, 8, 8),
]
# phases with a windowed (fft=False) run -> its max_lag (None: all lags)
WINDOWED = {"model": None, "deep": 2048}
MSD_PHASES = ("model",)  # phases that also run EinsteinMSD, both ways
XTC_PRECISION = 1000.0   # the files phase's XTC, counts per nm
TWIN_TOL = 1e-15         # file-backed run vs in-memory run of its arrays
# narrow, very long series: N, particles, d (the old cap of the plan, M =
# 2^24, and once past it)
NARROW_SHAPES = [("top", 2 ** 23, 4, 2), ("past", 2 ** 24, 4, 2)]
# K8 past three components, one launch a group: (key, frames, atoms, d)
# and its lags
GROUPED_SHAPE, GROUPED_LAGS = ("d5", 8192, 64, 5), 512
PLAIN_STRIDE = 21        # K8's plain version runs on every 21st atom
# the stream phase: frame blocks at the deep shape (16 blocks) and from
# the files phase's TRR (8 blocks), the atom chunks' device-memory budget
# at the deep shape, and the atom chunk of the out-of-core runs
STREAM_BLOCK, FILE_BLOCK = 4096, 1024
STREAM_BUDGET_GB = 8.0
SPOOL_CHUNK = 1024
BLOCKED_TOL = 1e-15      # frame-blocked run vs the batch run
CHUNKED_TOL = 1e-12      # atom-chunked run vs the unchunked run
SPOOL_TOL = 1e-13        # out-of-core VACF and MSD vs in memory
PLAIN_REPS = 2           # timed calls of a plain version (some take 4 s)
# the mesh phase: the model phase's system in four particle shards of the
# one card, the ring over four frame blocks, the sharded FFT over every
# 10th atom of the deep system
MESH_SHARDS = 4
MESH_TOL = 1e-13         # sharded run vs unsharded; sharded out of core vs plain
RING_CASES = [           # the ring's runs: (type, mode, sum_d)
    ("float64", "acf", True), ("float64", "einstein", True),
    ("float64", "einstein", False), ("float32", "acf", True),
    ("float32", "einstein", True)]
MP_RANKS = 2             # gloo processes on the one card, two blocks each
MP_TIMEOUT = 300         # seconds a gloo child may take
STEP_TOL = 1e-10         # the fused step on the card vs its CPU run
RING_TOL = 1e-12         # the ring vs K8 on the whole series
FFT_STRIDE = 10
# the card's peaks for the bounds (H100 SXM data sheet)
PEAK_FP64 = 34e12        # flop/s, FP64 outside the tensor cores
PEAK_FP64_MMA = 67e12    # flop/s, FP64 matrix products on the tensor cores
PEAK_FP32 = 67e12        # flop/s, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s, HBM3
ISSUE_FP64 = 17e12       # FP64 instructions/s outside the tensor cores
ISSUE_FP32 = 33.5e12     # FP32 lane-instructions/s (FADD and FFMA alike)

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
    "lag_sums": (CSRC + "lag.cu", f"{TPU}pallas_lag.py:111 (K8a), "
                 f"{TPU}pallas_lag.py:290 (K8b)"),
}
# the float32 work mode's instantiations, counted apart by each wrapper
# (``launches_f32``): the same wrappers and sources
KERNELS.update({f"{key}_f32": value for key, value in list(KERNELS.items())})
KERNELS["lag_sums_f32"] = (CSRC + "lag.cu", f"{TPU}pallas_lag.py:111 (K8a)")
# K8's two-block launch, the exact ring's pair sums (the JAX package's ring
# forms them in plain jnp, transport_analysis_tpu/parallel/ring.py:35)
RING = "transport_analysis_tpu/parallel/ring.py:35 (its pair sums)"
KERNELS["lag_sums_pair"] = (CSRC + "lag.cu", f"{TPU}pallas_lag.py:111 (K8a), "
                            f"{TPU}pallas_lag.py:290 (K8b), as {RING}")
KERNELS["lag_sums_pair_f32"] = KERNELS["lag_sums_pair"]
# what each kind of run must launch
FFT_KERNELS = ["fft_level", "unpack_power_inva", "inverse_last_level",
               "kneller_totals", "kneller_windows"]
WINDOWED_KERNELS = ["lag_sums"]
F32_PHASES = ("model", "deep")  # phases followed by the f32 phase


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
    # K8's acf kernel runs on the FP64 tensor cores: every instantiation's
    # SASS must hold DMMA instructions
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    dmma, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            if "acf_gram_kernel" in name or "acf_pair_kernel" in name:
                dmma[name] = 0
        elif name in dmma and "DMMA" in ln:
            dmma[name] += 1
    if len(dmma) != 15 or min(dmma.values()) == 0:
        raise RuntimeError(f"build: K8 acf kernels' SASS, DMMA instructions "
                           f"by instantiation: {dmma}")
    phase("build", f"K8 acf kernels: DMMA instructions in the SASS of their "
          f"15 instantiations (acf_gram_kernel: float -> double, double -> "
          f"double, float -> float; acf_pair_kernel, the two-block launch: "
          f"double -> double, float -> float; x d = 1, 2, 3): "
          f"{sorted(dmma.values())}")


def time_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of one ``fn`` on the card over ``reps``
    timings, after one warm call; each timing runs ``fn`` back to back
    for at least about 5 ms, so that a short kernel is timed on the card
    and not the host's time to launch it."""
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


def work(nbytes: float, flop: float, peak: float = PEAK_FP64):
    """(seconds, seconds) the card needs at least to move ``nbytes``
    (each input read once, each output written once) and to do ``flop``
    float64 operations at ``peak``."""
    return nbytes / PEAK_BYTES, flop / peak


def bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    """The least milliseconds for work of those two times, and which of
    the two bounds it."""
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def lag_pairs(n: int, n_lags: int, lag0: int = 0) -> int:
    """Σ_{lag0 <= lag < n_lags} (N − lag): the frame-lag pairs of one
    series in the windowed sums."""
    count = n_lags - lag0
    return count * n - (n_lags * (n_lags - 1) - lag0 * (lag0 - 1)) // 2


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


def compare_kernel(torch, results, shape_key, key, kernel, plain, label,
                   times, library=None, pick=None, tol=KERNEL_TOL):
    """A kernel against its plain version on the same inputs: ``times`` =
    :func:`work` of the kernel's function; ``pick`` selects the kernel's
    outputs that the plain version forms; the error relative to the
    plain version's maximum must be within ``tol``. Adds the kernel's
    numbers to ``results[shape_key][key]`` and returns its
    milliseconds."""
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    if pick is not None:
        got = pick(got)
    abs_err, scale = max_abs_diff(got, ref)
    err = abs_err / scale
    del got, ref
    k_ms = time_ms(torch, kernel)
    p_ms = time_ms(torch, plain, PLAIN_REPS)
    lib_ms = None if library is None else time_ms(torch, library)
    b_ms, by = bound(*times)
    lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
    phase("kernels", f"{shape_key} {label}: max rel err {err:.3e} (abs "
          f"{abs_err:.3e}), kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {b_ms:.3f} ms ({by}), library {lib}")
    if not err <= tol:
        raise AssertionError(f"{label}: kernel vs plain {err:.3e} > {tol}")
    r = results.setdefault(shape_key, {}).setdefault(key, {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "t_bytes": 0.0,
        "t_ops": 0.0, "library_ms": None, "library_kernel_ms": None})
    r["max_abs_err"] = max(r["max_abs_err"], abs_err)
    r["ms"] += k_ms
    r["plain_ms"] += p_ms
    r["t_bytes"] += times[0]
    r["t_ops"] += times[1]
    if lib_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        r["library_kernel_ms"] = (r["library_kernel_ms"] or 0.0) + k_ms
    return k_ms


def finish_results(results) -> None:
    """Each kernel's summed work as its bound, printed beside its
    times."""
    for shape_key, by_kernel in results.items():
        for key, r in by_kernel.items():
            r["bound_ms"], r["bound_by"] = bound(r.pop("t_bytes"),
                                                 r.pop("t_ops"))
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.3f} ms against the kernel's "
                   f"{r['library_kernel_ms']:.3f} ms on the same launches")
            phase("kernels", f"{shape_key} total {key}: kernel "
                  f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), library {lib}")


def level_split(label, times, k_ms, tl):
    """The share of its bound and K1's or K5's split of one launch
    (``cuda_fft.LevelTiles``)."""
    b_ms = bound(*times)[0]
    if tl.columns:
        split = (f"wide, a column a thread: {tl.tiles} blocks of {tl.tc} "
                 f"columns x {tl.groups} rows")
    elif tl.wide:
        split = (f"wide, {tl.tiles} slab tiles of {tl.tc} columns x "
                 f"{tl.groups} rows")
    else:
        split = (f"narrow, ra = {tl.ra} rows of {tl.tc} columns a block, "
                 f"pitch {tl.pitch}, {tl.groups} groups")
    phase("kernels", f"{label}: {100 * b_ms / k_ms:.1f} % of its "
          f"{b_ms:.3f} ms bound; split: {split}, grid {tl.grid}, "
          f"{tl.smem} bytes of shared memory")


def kernels_phase(torch, cuda_fft, cuda_kneller, cuda_lag):
    """Each kernel against its plain version at every model phase's
    shapes, at the narrow shapes and, for K8, at d = 5. The JSON numbers
    are the deep model's: M = 2^17 over the EC width, the fft_level times
    summed over the levels of one autocorrelation, K8 summed over the
    windowed run's VACF and Helfand launches (65,536 frames, 2,048
    lags)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    def crandn(*shape):
        return torch.randn(shape, dtype=torch.complex128, device=dev,
                           generator=g)

    def compare(*args, **kwargs):
        return compare_kernel(torch, results, *args, **kwargs)

    def level_work(a, nl, c, order, tw):
        """One level: DFTs of order nl as a matrix product, the twiddle
        elementwise."""
        t_bytes, t_dft = work(32 * a * nl * c + 16 * order,
                              8 * nl * a * nl * c, PEAK_FP64_MMA)
        return t_bytes, t_dft + (6 * a * nl * c if tw else 0) / PEAK_FP64

    lv, lvp = cuda_fft.fft_level, cuda_fft.fft_level_plain
    k6b_ms = {}
    shapes = [(name, n, n_molecules * len(EC_ATOMS), 3)
              for name, n, n_molecules, _ in MODEL_PHASES]
    for shape_key, n, p, d in shapes + NARROW_SHAPES:
        m = 2 * n
        plan = cuda_fft.plan_levels(m)
        w, ph = (p * d + 1) // 2, (p + 1) // 2
        phase("kernels", f"{shape_key}: N = {n}, M = {m}, plan {plan}, "
              f"w = {w}, P = {p}, d = {d}")
        for i, (a, nl, c, order, tw) in enumerate(
                cuda_fft.level_shapes(plan, w)):
            x = crandn(a, nl, c)
            label = f"K1 forward level {i} ({a}, {nl}, {c})"
            times = level_work(a, nl, c, order, tw)
            k_ms = compare(shape_key, "fft_level",
                           lambda: lv(x, order, -1, twiddle_cols=tw),
                           lambda: lvp(x, order, -1, twiddle_cols=tw),
                           label, times,
                           library=lambda: torch.fft.fft(x, dim=1))
            level_split(f"{shape_key} {label}", times, k_ms,
                        cuda_fft.LevelTiles(a, nl, c))
            del x
        z = crandn(m, w)
        k2_work = (16 * m * (w + ph + 1) / PEAK_BYTES,
                   (8 * m * w + 6 * m * ph) / PEAK_FP64
                   + 8 * plan[-1] * m * ph / PEAK_FP64_MMA)
        tl = cuda_fft.UnpackTiles(m, plan[-1], w, p, d)
        k2_ms = compare(shape_key, "unpack_power_inva",
                        lambda: cuda_fft.unpack_power_inva(z, p, d),
                        lambda: cuda_fft.unpack_power_inva_plain(z, p, d),
                        f"K2 unpack_power_inva ({m}, {w}) -> ({plan[-1]}, "
                        f"{m // plan[-1]}, {ph})", k2_work)
        k2_bound = bound(*k2_work)[0]
        phase("kernels", f"{shape_key} K2: {100 * k2_bound / k2_ms:.1f} % "
              f"of its {k2_bound:.3f} ms bound; split: {tl.tq} pairs x "
              f"{tl.nj} k_lows a block, {tl.ktc} k_top rows a pass, "
              f"{tl.tiles} x {tl.runs} blocks, {tl.smem} bytes of shared "
              "memory")
        del z
        *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
        for i, (a, nl, c, order, tw) in enumerate(levels):
            x = crandn(a, nl, c)
            label = f"K1 inverse level {i} ({a}, {nl}, {c})"
            times = level_work(a, nl, c, order, tw)
            k_ms = compare(shape_key, "fft_level",
                           lambda: lv(x, order, +1, twiddle_cols=tw),
                           lambda: lvp(x, order, +1, twiddle_cols=tw),
                           label, times,
                           library=lambda: torch.fft.ifft(x, dim=1,
                                                          norm="forward"))
            level_split(f"{shape_key} {label}", times, k_ms,
                        cuda_fft.LevelTiles(a, nl, c))
            del x
        a, nl, c, _, _ = last
        n_out = min(nl, -(-n // a))
        t = crandn(a, nl, c)
        times = ((16 * a * nl * c + 16 * nl + 8 * n * p) / PEAK_BYTES,
                 8 * nl * a * n_out * c / PEAK_FP64_MMA + n * p / PEAK_FP64)
        k_ms = compare(shape_key, "inverse_last_level",
                       lambda: cuda_fft.inverse_last_level(t, n, p, True),
                       lambda: cuda_fft.inverse_last_level_plain(t, n, p,
                                                                 True),
                       f"K5 inverse_last_level ({a}, {nl}, {c}) -> ({n}, "
                       f"{p}) normalized", times)
        level_split(f"{shape_key} K5", times, k_ms,
                    cuda_fft.LevelTiles(a, nl, c, epilogue=True))
        del t
        # the library's whole autocorrelation, beside K1 + K2 + K5's
        x = torch.randn((n, p * d), dtype=torch.float64, device=dev,
                        generator=g)

        def library():
            f = torch.fft.rfft(x, n=m, dim=0)
            power = f.abs().square().reshape(m // 2 + 1, p, d).sum(-1)
            return torch.fft.irfft(power, n=m, dim=0)[:n]

        diff, scale = max_abs_diff(library(), cuda_fft.autocorr_power_sum(
            x, m, p, d))
        lib_ms = time_ms(torch, library)
        kernels_ms = sum(results[shape_key][key]["ms"] for key in (
            "fft_level", "unpack_power_inva", "inverse_last_level"))
        phase("kernels", f"{shape_key} library autocorrelation (rfft, "
              f"|.|^2, component sum, irfft) of ({n}, {p * d}): "
              f"{lib_ms:.3f} ms against K1 + K2 + K5 "
              f"{kernels_ms:.3f} ms; they agree to {diff / scale:.3e}")
        del x
        v = torch.randn((n, p, d), dtype=torch.float64, device=dev,
                        generator=g)
        sq = (v * v).sum(-1)
        del v
        corr = torch.randn((n, p), dtype=torch.float64, device=dev,
                           generator=g)
        rows = cuda_kneller.KNELLER_ROWS
        nb = -(-n // rows)
        compare(shape_key, "kneller_totals",
                lambda: cuda_kneller.kneller_totals(sq),
                lambda: cuda_kneller.kneller_totals_plain(sq),
                f"K6a kneller_totals ({n}, {p}), both legs from one read "
                "of sq; its library call, the reshape-sum, forms only the "
                "forward leg",
                work(8 * n * p + 16 * nb * p, 2 * n * p),
                library=(lambda: sq.view(nb, rows, p).sum(1))
                if n % rows == 0 else None)
        tot = cuda_kneller.kneller_totals(sq)
        k6b_work = work(8 * (3 * n * p + 2 * nb * p), 6 * n * p)
        k6b_ms[shape_key] = compare(
            shape_key, "kneller_windows",
            lambda: cuda_kneller.kneller_windows(sq, corr, tot, d),
            lambda: cuda_kneller.kneller_windows_plain(sq, corr, d),
            f"K6b kneller_windows ({n}, {p}) mean d={d}", k6b_work)
        k6b_bound = bound(*k6b_work)[0]
        sp = cuda_kneller.windows_split(n, p)
        phase("kernels", f"{shape_key} K6b: "
              f"{100 * k6b_bound / k6b_ms[shape_key]:.1f} % of its "
              f"{k6b_bound:.3f} ms bound; split: {sp.cols} columns x "
              f"{sp.lanes} row lanes a block, tiles of {sp.tile_rows} lags, "
              f"{sp.col_tiles} x {sp.tiles} blocks; scan of {sp.segs} "
              f"segments of {sp.segt} tiles")
        del sq, corr, tot
        torch.cuda.empty_cache()
    phase("kernels", f"K6b past/top time ratio "
          f"{k6b_ms['past'] / k6b_ms['top']:.3f} (2x the frames)")
    for shape_key, n, p, d in shapes + [GROUPED_SHAPE]:
        if shape_key == GROUPED_SHAPE[0]:
            n_lags = GROUPED_LAGS
            runs = [(dtype, mode, reduce_mode, f"d = {d}")
                    for dtype in (torch.float32, torch.float64)
                    for mode, reduce_mode in (("acf", "sum"),
                                              ("einstein", "mean"))]
        elif shape_key in WINDOWED:
            n_lags = (n if WINDOWED[shape_key] is None
                      else WINDOWED[shape_key])
            runs = [(torch.float32, "acf", "sum", "VACF"),
                    (torch.float64, "einstein", "mean", "Helfand")]
            if shape_key in MSD_PHASES:
                runs.append((torch.float32, "einstein", "sum", "MSD"))
        else:
            continue
        for dtype, mode, reduce_mode, what in runs:
            x = torch.randn((n, p, d), dtype=dtype, device=dev, generator=g)
            sub = x[:, ::PLAIN_STRIDE].contiguous()
            pairs = p * d * lag_pairs(n, n_lags, 1 if mode == "einstein"
                                      else 0)
            # acf: one multiply-add a pair, a Gram product of frame tiles
            # on the tensor cores; einstein: a subtract, then a
            # multiply-add, outside them
            times = (work(x.element_size() * n * p * d + 8 * n_lags * p,
                          2 * pairs, PEAK_FP64_MMA) if mode == "acf" else
                     work(x.element_size() * n * p * d + 8 * n_lags * p,
                          3 * pairs))
            library = None
            if mode == "acf":
                # the library's lag sums: a grouped convolution of each
                # float64 series, zero-padded by n_lags - 1 frames, with
                # itself; then the component sum and 1 / (N - lag)
                series = x.reshape(n, p * d).T.to(
                    torch.float64, memory_format=torch.contiguous_format)
                padded = torch.nn.functional.pad(series, (0, n_lags - 1))[
                    None]
                weight = series[:, None]

                def library():
                    return torch.nn.functional.conv1d(padded, weight,
                                                      groups=p * d)

                lags = torch.arange(n_lags, device=dev, dtype=torch.float64)
                diff, scale = max_abs_diff(
                    library()[0].view(p, d, n_lags).sum(1).T / (n - lags)[
                        :, None],
                    cuda_lag.lag_sums(x, n_lags, mode, reduce_mode,
                                      out_dtype=torch.float64))
                phase("kernels", f"{shape_key} library lag sums of {what} "
                      f"(grouped conv1d of the float64 series) agree with "
                      f"K8 to {diff / scale:.3e}")
                del lags
            # float64 sums, of float32 samples too: the float64 work mode
            k_ms = compare(
                shape_key, "lag_sums",
                lambda: cuda_lag.lag_sums(x, n_lags, mode, reduce_mode,
                                          out_dtype=torch.float64),
                lambda: cuda_lag.lag_sums_plain(sub, n_lags, mode,
                                                reduce_mode,
                                                out_dtype=torch.float64),
                f"K8 lag_sums {what}: {str(dtype)[6:]} ({n}, {p}, {d}) "
                f"{mode}/{reduce_mode}, {n_lags} lags (plain on every "
                f"{PLAIN_STRIDE}st atom, {sub.shape[1]} atoms)",
                times, library=library,
                pick=lambda out: out[:, ::PLAIN_STRIDE])
            if mode == "einstein":
                phase("kernels", f"{shape_key} K8 lag_sums {what}: FP64 "
                      f"issue-slot ceiling {1e3 * 2 * pairs / ISSUE_FP64:.3f}"
                      f" ms (2 instructions a pair-component at 17e12/s) "
                      f"beside the flop bound {1e3 * times[1]:.3f} ms")
            else:
                b_ms = bound(*times)[0]
                phase("kernels", f"{shape_key} K8 lag_sums {what}: "
                      f"{100 * b_ms / k_ms:.1f} % of its {b_ms:.3f} ms bound "
                      f"(FP64 tensor cores, 67 TFLOP/s); the FMA pipe's "
                      f"floor {1e3 * pairs / ISSUE_FP64:.3f} ms (one "
                      f"multiply-add a pair-component at 17e12/s)")
            r = results[shape_key]["lag_sums"]
            r["atoms"], r["plain_atoms"] = p, sub.shape[1]
            del x, sub, library
            if mode == "acf":
                del series, padded, weight
        torch.cuda.empty_cache()
    finish_results(results)
    phase("kernels", "fft_level totals sum every forward and inverse "
          "level of one autocorrelation; lag_sums totals sum the windowed "
          "run's launches (VACF, Helfand and, in model, MSD), its plain "
          f"version on every {PLAIN_STRIDE}st atom only, its library call "
          "on the acf (VACF) launch only")
    # the roots tables of this phase's transforms (512 MiB at M = 2^25)
    # would stay cached and count in the model phases' peak memory
    cuda_fft.roots_tensor.cache_clear()
    torch.cuda.empty_cache()
    return results["deep"]


def kernels_f32_phase(torch, cuda_fft, cuda_kneller, cuda_lag,
                      auto_atom_chunk):
    """The float32 work mode's instantiations (complex64 K1, K2, K5;
    float32 K6a, K6b and K8) against their plain versions in the same
    types, within F32_KERNEL_TOL, at the shapes the f32 phase gives them:
    each of F32_PHASES' shapes over the EC width (K8 at its windowed
    run's lags: every lag at the model shape, with the MSD's launch;
    2,048 at the deep shape; its plain version on every 21st atom), and
    the FFT kernels and K6 also at the widths of the f32 phase's chunked
    MSD (``auto_atom_chunk`` of the float32 memory model at the deep
    shape). Bounds: float32 bytes over the memory rate; flop over 67
    TFLOP/s, FP32's peak outside the tensor cores and the FP64 tensor
    cores' (K6's sums, float64, over FP64's 34). Library calls:
    ``torch.fft`` in complex64 per K1 level; rfft, |.|², component sum
    and irfft of the float32 operand beside K1 + K2 + K5; a grouped
    float32 ``F.conv1d`` (TF32 off) for K8's acf launch. Returns the deep
    shape's per-kernel numbers, keyed ``<wrapper>_f32``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    results = {}
    shapes = [(name, n, n_molecules * len(EC_ATOMS), 3)
              for name, n, n_molecules, _ in MODEL_PHASES
              if name in F32_PHASES]
    # the f32 phase's chunked float32 MSD at the deep shape: its chunks'
    # widths, the full chunk and the last one
    _, n_deep, p_deep, _ = next(sh for sh in shapes if sh[0] == "deep")
    chunk = auto_atom_chunk(n_deep, d=3, hbm_budget_gb=STREAM_BUDGET_GB,
                            dtype=np.float32)
    chunks = {chunk, p_deep - chunk * ((p_deep - 1) // chunk)}
    chunk_shapes = [(f"deep chunk of {c} atoms", n_deep, c, 3)
                    for c in sorted(chunks, reverse=True) if c < p_deep]

    def crandn64(*shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev,
                           generator=g)

    def level_work(a, nl, c, order, tw):
        """One complex64 level: DFTs of order nl, the twiddle
        elementwise, at FP32's rate."""
        return work(16 * a * nl * c + 8 * order,
                    8 * nl * a * nl * c + (6 * a * nl * c if tw else 0),
                    PEAK_FP32)

    def fft_kernels(shape_key, n, p, d):
        """K1 (every level), K2, K5 and K6a/K6b at one shape."""
        label32 = f"{shape_key} float32"

        def compare(key, *args, **kwargs):
            return compare_kernel(torch, results, label32, key + "_f32",
                                  *args, tol=F32_KERNEL_TOL, **kwargs)

        m = 2 * n
        plan = cuda_fft.plan_levels(m)
        w, ph = (p * d + 1) // 2, (p + 1) // 2
        phase("kernels", f"{label32}: N = {n}, M = {m}, plan {plan}, "
              f"w = {w}, P = {p}, d = {d}; complex64 / float32 "
              "instantiations")
        lv, lvp = cuda_fft.fft_level, cuda_fft.fft_level_plain
        for i, (a, nl, c, order, tw) in enumerate(
                cuda_fft.level_shapes(plan, w)):
            x = crandn64(a, nl, c)
            label = f"K1 forward level {i} ({a}, {nl}, {c}) complex64"
            times = level_work(a, nl, c, order, tw)
            k_ms = compare("fft_level",
                           lambda: lv(x, order, -1, twiddle_cols=tw),
                           lambda: lvp(x, order, -1, twiddle_cols=tw),
                           label, times,
                           library=lambda: torch.fft.fft(x, dim=1))
            level_split(f"{label32} {label}", times, k_ms,
                        cuda_fft.LevelTiles(a, nl, c, itemsize=8))
            del x
        z = crandn64(m, w)
        compare("unpack_power_inva",
                lambda: cuda_fft.unpack_power_inva(z, p, d),
                lambda: cuda_fft.unpack_power_inva_plain(z, p, d),
                f"K2 unpack_power_inva ({m}, {w}) complex64",
                work(8 * m * (w + ph + 1),
                     8 * m * w + 6 * m * ph + 8 * plan[-1] * m * ph,
                     PEAK_FP32))
        del z
        *levels, last = cuda_fft.level_shapes(plan[:-1], ph, a0=plan[-1])
        for i, (a, nl, c, order, tw) in enumerate(levels):
            x = crandn64(a, nl, c)
            label = f"K1 inverse level {i} ({a}, {nl}, {c}) complex64"
            times = level_work(a, nl, c, order, tw)
            k_ms = compare("fft_level",
                           lambda: lv(x, order, +1, twiddle_cols=tw),
                           lambda: lvp(x, order, +1, twiddle_cols=tw),
                           label, times,
                           library=lambda: torch.fft.ifft(x, dim=1,
                                                          norm="forward"))
            level_split(f"{label32} {label}", times, k_ms,
                        cuda_fft.LevelTiles(a, nl, c, itemsize=8))
            del x
        a, nl, c, _, _ = last
        n_out = min(nl, -(-n // a))
        t = crandn64(a, nl, c)
        compare("inverse_last_level",
                lambda: cuda_fft.inverse_last_level(t, n, p, True),
                lambda: cuda_fft.inverse_last_level_plain(t, n, p, True),
                f"K5 inverse_last_level ({a}, {nl}, {c}) -> ({n}, {p}) "
                "float32",
                work(8 * a * nl * c + 8 * nl + 4 * n * p,
                     8 * nl * a * n_out * c + n * p, PEAK_FP32))
        del t
        x = torch.randn((n, p * d), dtype=torch.float32, device=dev,
                        generator=g)

        def library():
            f = torch.fft.rfft(x, n=m, dim=0)
            power = f.abs().square().reshape(m // 2 + 1, p, d).sum(-1)
            return torch.fft.irfft(power, n=m, dim=0)[:n]

        diff, scale = max_abs_diff(library(), cuda_fft.autocorr_power_sum(
            x, m, p, d, work_dtype=torch.float32))
        lib_ms = time_ms(torch, library)
        kernels_ms = sum(results[label32][key + "_f32"]["ms"] for key in (
            "fft_level", "unpack_power_inva", "inverse_last_level"))
        phase("kernels", f"{label32} library autocorrelation (rfft, |.|^2, "
              f"component sum, irfft) of the float32 ({n}, {p * d}): "
              f"{lib_ms:.3f} ms against K1 + K2 + K5 {kernels_ms:.3f} ms; "
              f"they agree to {diff / scale:.3e}")
        del x
        v = torch.randn((n, p, d), dtype=torch.float32, device=dev,
                        generator=g)
        sq = (v * v).sum(-1)
        del v
        corr = torch.randn((n, p), dtype=torch.float32, device=dev,
                           generator=g)
        rows = cuda_kneller.KNELLER_ROWS
        nb = -(-n // rows)
        compare("kneller_totals", lambda: cuda_kneller.kneller_totals(sq),
                lambda: cuda_kneller.kneller_totals_plain(sq),
                f"K6a kneller_totals ({n}, {p}) float32 sq, float64 totals",
                work(4 * n * p + 16 * nb * p, 2 * n * p),
                library=(lambda: sq.view(nb, rows, p).sum(
                    1, dtype=torch.float64)) if n % rows == 0 else None)
        tot = cuda_kneller.kneller_totals(sq)
        compare("kneller_windows",
                lambda: cuda_kneller.kneller_windows(sq, corr, tot, d),
                lambda: cuda_kneller.kneller_windows_plain(sq, corr, d),
                f"K6b kneller_windows ({n}, {p}) float32, mean d={d}",
                work(4 * 3 * n * p + 16 * nb * p, 6 * n * p))
        del sq, corr, tot
        torch.cuda.empty_cache()

    def lag_kernels(shape_key, n, p, d):
        """K8's float32 launches of the windowed runs at one shape."""
        label32 = f"{shape_key} float32"
        n_lags = n if WINDOWED[shape_key] is None else WINDOWED[shape_key]
        runs = [("acf", "sum", "VACF"), ("einstein", "mean", "Helfand")]
        if shape_key in MSD_PHASES:
            runs.append(("einstein", "sum", "MSD"))
        for mode, reduce_mode, what in runs:
            x = torch.randn((n, p, d), dtype=torch.float32, device=dev,
                            generator=g)
            sub = x[:, ::PLAIN_STRIDE].contiguous()
            pairs = p * d * lag_pairs(n, n_lags,
                                      1 if mode == "einstein" else 0)
            # acf: the float64 Gram on the FP64 tensor cores (67 TFLOP/s);
            # einstein: a float32 subtract and multiply-add at FP32's 67
            times = work(4 * n * p * d + 4 * n_lags * p,
                         (2 if mode == "acf" else 3) * pairs,
                         PEAK_FP64_MMA if mode == "acf" else PEAK_FP32)
            library = None
            if mode == "acf":
                series = x.reshape(n, p * d).T.contiguous()
                padded = torch.nn.functional.pad(series, (0, n_lags - 1))[
                    None]
                weight = series[:, None]

                def library():
                    return torch.nn.functional.conv1d(padded, weight,
                                                      groups=p * d)

                lags = torch.arange(n_lags, device=dev, dtype=torch.float32)
                diff, scale = max_abs_diff(
                    library()[0].view(p, d, n_lags).sum(1).T
                    / (n - lags)[:, None],
                    cuda_lag.lag_sums(x, n_lags, mode, reduce_mode))
                phase("kernels", f"{label32} library lag sums of {what} "
                      f"(grouped float32 conv1d) agree with K8 to "
                      f"{diff / scale:.3e}")
                del lags
            k_ms = compare_kernel(
                torch, results, label32, "lag_sums_f32",
                lambda: cuda_lag.lag_sums(x, n_lags, mode, reduce_mode),
                lambda: cuda_lag.lag_sums_plain(sub, n_lags, mode,
                                                reduce_mode),
                f"K8 lag_sums {what}: float32 ({n}, {p}, {d}) -> float32 "
                f"{mode}/{reduce_mode}, {n_lags} lags (plain on every "
                f"{PLAIN_STRIDE}st atom, {sub.shape[1]} atoms)",
                times, library=library,
                pick=lambda out: out[:, ::PLAIN_STRIDE], tol=F32_KERNEL_TOL)
            b_ms = bound(*times)[0]
            ceiling = ("" if mode == "acf" else
                       f"; FP32 issue-slot ceiling "
                       f"{1e3 * 2 * pairs / ISSUE_FP32:.3f} ms (2 "
                       f"instructions a pair-component at 33.5e12/s)")
            phase("kernels", f"{label32} K8 lag_sums {what}: "
                  f"{100 * b_ms / k_ms:.1f} % of its {b_ms:.3f} ms "
                  f"bound{ceiling}")
            r = results[label32]["lag_sums_f32"]
            r["atoms"], r["plain_atoms"] = p, sub.shape[1]
            del x, sub, library
            if mode == "acf":
                del series, padded, weight
        torch.cuda.empty_cache()

    for shape in shapes + chunk_shapes:
        fft_kernels(*shape)
    # the float32 library convolution runs in float32, not TF32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for shape in shapes:
        lag_kernels(*shape)
    torch.backends.cudnn.allow_tf32 = tf32
    finish_results(results)
    phase("kernels", "float32 totals: fft_level sums every level of one "
          "autocorrelation; lag_sums sums the windowed run's launches (VACF, "
          "Helfand and, in model, MSD)")
    cuda_fft.roots_tensor.cache_clear()
    torch.cuda.empty_cache()
    return results["deep float32"]


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


def ec_universe(ta, pos, vel, attrs):
    """The port's Universe of the EC system's arrays: its topology
    attributes and a MemoryReader of positions and velocities in the
    cubic box."""
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader

    n_atoms = pos.shape[1]
    n_molecules = n_atoms // len(EC_ATOMS)
    u = ta.Universe.empty(
        n_atoms, n_residues=n_molecules,
        atom_resindex=np.repeat(np.arange(n_molecules), len(EC_ATOMS)))
    for attr, values in attrs.items():
        u.add_TopologyAttr(attr, values)
    u.load_new(MemoryReader(pos, velocities=vel,
                            dimensions=[BOX, BOX, BOX, 90.0, 90.0, 90.0],
                            dt=DT))
    return u


def einstein_oracle(a, dfac: int) -> np.ndarray:
    """Host float64 Kneller/Calandrini mean squared lag difference per
    particle of an (N, P, d) float64 array, which it centers in place:
    np.fft correlation plus cumsum window sums, / ((N − lag)·dfac), lag 0
    = 0."""
    a -= a.mean(axis=0, keepdims=True)
    n = a.shape[0]
    m = 2 ** (int(n - 1).bit_length() + 1)  # 2·next_pow_2(N)
    f = np.fft.rfft(a, n=m, axis=0)
    corr = np.fft.irfft((f * np.conj(f)).real.sum(-1), n=m, axis=0)[:n]
    del f
    sq = (a * a).sum(-1)
    css = np.cumsum(sq, axis=0)
    lags = np.arange(n)
    prev = np.concatenate([np.zeros((1, sq.shape[1])), css[:-1]])
    w = css[n - 1 - lags] + css[-1][None] - prev
    out = (w - 2.0 * corr) / ((n - lags) * dfac)[:, None]
    out[0] = 0.0
    return out


def helfand_oracle(masses, vel, pos, d: int) -> np.ndarray:
    """The Helfand function per particle before the 2·k_B·V·T
    normalization: :func:`einstein_oracle` of m·v·x, components
    averaged."""
    return einstein_oracle(masses[None, :, None] * vel.astype(np.float64)
                           * pos.astype(np.float64), d)


def reckoned_windowed_peak(n: int, n_atoms: int, n_lags: int) -> int:
    """Device bytes the windowed analyses hold at their peak: Helfand's
    float64 accumulator beside one float32 feed while it is formed (the
    VACF holds only its float32 feed), then the (n_lags, P) result."""
    s = 3 * n_atoms
    return 12 * n * s + 8 * n_lags * n_atoms


PROFILE_CATEGORIES = [      # (substring of the device event name, label)
    ("Memcpy HtoD", "copy host->device"),
    ("Memcpy DtoH", "copy device->host"),
    ("Memcpy", "copy on device"),
    ("Memset", "memset"),
    ("fft_level", "K1 fft_level"),  # fft_level_columns_, _rows_, _kernel
    ("unpack_power_inva_kernel", "K2 unpack_power_inva"),
    ("inverse_last_level", "K5 inverse_last_level"),
    ("kneller_totals_kernel", "K6a kneller_totals"),
    ("kneller_windows_kernel", "K6b kneller_windows"),
    ("kneller_scan", "K6b kneller_windows scan"),
    ("einstein_tile_kernel", "K8 lag_sums einstein"),
    ("einstein_rows_kernel", "K8 lag_sums einstein"),   # float32 sums
    ("acf_gram_kernel", "K8 lag_sums acf"),
    ("einstein_pair", "K8 lag_sums_pair einstein"),     # the two-block
    ("acf_pair_kernel", "K8 lag_sums_pair acf"),        # launch
]


def profile_phase(torch, name, label, run, card, launches) -> None:
    """One run of ``run`` under torch.profiler, after one warm-up step
    that it traces and drops (without it the profiler missed the first
    launches of some runs); device time by category, busy time as the
    union of the device intervals, idle share of wall, and how many of
    the port's ``launches`` it saw."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()             # the traced step ends with the block
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
        cat = next((lab for key, lab in PROFILE_CATEGORIES if key in ev),
                   "PyTorch kernels (elementwise, reductions)")
        ms, count = totals.get(cat, (0.0, 0))
        totals[cat] = (ms + (end - start) / 1e3, count + 1)
    busy_us, reach = 0.0, float("-inf")
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    wall_ms = wall * 1e3
    for cat, (ms, count) in sorted(totals.items(), key=lambda kv: -kv[1][0]):
        phase(name, f"{label} profile: {cat}: {count} launches, {ms:.3f} "
              f"ms device, {100 * ms / wall_ms:.2f} % of wall")
    phase(name, f"{label} profile: wall {wall_ms:.3f} ms profiled, device "
          f"busy {busy_us / 1e3:.3f} ms (union of device intervals), idle "
          f"{100 * (1 - busy_us / 1e3 / wall_ms):.2f} %, on {card}")
    seen = sum(count for cat, (_, count) in totals.items()
               if cat.startswith("K"))
    # the ``_f32`` counters count a subset of the launches again
    total = sum(count for key, count in launches.items()
                if not key.endswith("_f32"))
    phase(name, f"{label} profile: saw {seen} of the run's {total} "
          "launches of the port's kernels")


def head_errors(got, ref, n: int):
    """max|got - ref| / max|ref| (bench.py's error form) on lags < N/2
    and over all lags."""
    return [float(np.abs(got[s] - ref[s]).max() / np.abs(ref[s]).max())
            for s in (slice(0, n // 2), slice(None))]


class F32Launches:
    """A wrapper's count of the float32 work mode's launches
    (``launches_f32``) under the name ``launches``, so that the counters
    of both instantiations are reset and read alike."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_f32

    @launches.setter
    def launches(self, value):
        self.fn.launches_f32 = value


def counted_run(torch, counters, run):
    """``run`` once with the launch counters reset just before and read
    just after; returns its output, the launches and the wall."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {key: fn.launches for key, fn in counters.items()}, wall


def drive(torch, counters, card, name, label, run, needed, lag_work,
          warm=True, profile=True):
    """``run`` once warm (unless ``warm`` is false: a phase right after
    the same runs in memory), once timed with the launch counters reset
    just before and read just after (the kernels ``needed`` must have
    launched), once profiled (unless ``profile`` is false). Returns the
    timed run's output, launches and wall."""
    t0 = time.perf_counter()
    if warm:
        run()
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out, launches, wall = counted_run(torch, counters, run)
    peak = torch.cuda.max_memory_allocated()
    phase(name, f"{label}: launches in the timed run: {launches}")
    missing = [key for key in needed if launches[key] < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the {name} {label} "
                             f"run: {missing}")
    before = f"warm run {warm_s:.4f} s" if warm else "no warm run"
    phase(name, f"{label}: wall {wall:.4f} s timed ({before}), "
          f"{lag_work / wall:.4e} atom-frame-lags/s, peak device memory "
          f"{peak / 2**30:.3f} GiB, on {card}")
    if profile:
        profile_phase(torch, name, label, run, card, launches)
    return out, launches, wall


def checks(name, n, n_atoms, stride, tol=HEAD_TOL):
    """The checks of a phase's results over ``n`` frames and ``n_atoms``
    atoms, oracles on every ``stride``-th atom, within ``tol``: ``check``
    against a host oracle, ``cross`` a windowed result against the FFT
    one."""
    atoms = slice(None, None, stride)
    n_sampled = len(range(n_atoms)[atoms])
    head = slice(0, n // 2)
    mean_of = ("host f64 over every atom" if stride == 1 else
               "the mean of its own per-particle values")

    def check(label, what, by_particle, timeseries, ref, n_lags):
        """Per-particle values, which must have the run's ``n_lags`` rows,
        on the sampled atoms against the host oracle ``ref`` (its first
        ``n_lags`` rows) on lags < N/2 and over all; the particle mean
        against the oracle's mean over every atom, or, when the oracle
        covers only the sampled atoms, against the mean of the program's
        own per-particle values (a self-consistency check)."""
        ref = ref[:n_lags]
        if (by_particle.shape != (n_lags, n_atoms)
                or timeseries.shape != (n_lags,)
                or not np.isfinite(by_particle).all()
                or not np.isfinite(timeseries).all()):
            raise AssertionError(
                f"{label} {what}: not finite, or shapes {by_particle.shape} "
                f"and {timeseries.shape}, not ({n_lags}, {n_atoms}) and "
                f"({n_lags},)")
        err = head_errors(by_particle[:, atoms], ref, n)
        target = (ref if stride == 1 else by_particle)[head].mean(axis=1)
        ts = float(np.abs(timeseries[head] - target).max()
                   / np.abs(target).max())
        phase(name, f"{label}: {what} vs host f64 on {n_sampled} atoms: "
              f"{err[0]:.3e} (lags < N/2), {err[1]:.3e} (all {n_lags} "
              f"lags); timeseries (lags < N/2) vs {mean_of}: {ts:.3e}")
        if not max(err[0], ts) <= tol:
            raise AssertionError(f"{label} {what} disagrees with host f64 "
                                 f"beyond {tol} on lags < N/2")

    def cross(label, what, windowed, fft):
        """The windowed result against the FFT result of the card, over
        every atom, on lags < N/2."""
        h = slice(0, min(windowed.shape[0], n // 2))
        err = float(np.abs(windowed[h] - fft[h]).max()
                    / np.abs(fft[h]).max())
        phase(name, f"{label}: {what} windowed vs FFT on the card over "
              f"{n_atoms} atoms: {err:.3e} (lags < N/2)")
        if not err <= tol:
            raise AssertionError(f"{label} {what}: windowed and FFT differ "
                                 f"by {err:.3e} > {tol}")

    def scalars(label, d_gk, visc):
        finite = bool(np.isfinite([d_gk, visc.results.viscosity]).all())
        phase(name, f"{label}: D_gk = {d_gk:.6e} Å²/ps, viscosity slope = "
              f"{visc.results.viscosity:.6e}, finite {finite}")
        if not finite:
            raise AssertionError(f"{label}: D_gk or the viscosity slope is "
                                 "not finite")

    return check, cross, scalars


def runs(ta, u):
    """The runs of a phase on Universe ``u``: ``analyses(fft, max_lag)``,
    VACF of the ECA residues, its Green–Kubo D and the Helfand viscosity
    of every atom; ``msd(fft, max_lag)``, EinsteinMSD of the ECA
    residues."""
    def analyses(fft, max_lag=None, **stream):
        def run():
            ag = u.select_atoms("resname ECA")
            vacf = ta.VelocityAutocorr(ag, fft=fft, max_lag=max_lag,
                                       **stream).run()
            d_gk = vacf.self_diffusivity_gk()
            visc = ta.ViscosityHelfand(
                u.atoms, temp_avg=TEMP, linear_fit_window=FIT_WINDOW,
                fft=fft, max_lag=max_lag, **stream).run()
            return vacf, d_gk, visc
        return run

    def msd(fft, max_lag=None, **stream):
        return lambda: ta.EinsteinMSD(u, select="resname ECA", fft=fft,
                                      max_lag=max_lag, **stream).run()

    return analyses, msd


def model_phase(torch, ta, acf_numpy, counters, card, name, n, n_molecules,
                stride):
    """The EC system of ``n_molecules`` at ``n`` frames through the
    phase's runs (module docstring); oracles on every ``stride``-th atom.
    Returns each run's launches and timed wall, and the system."""
    t_phase = time.perf_counter()
    pos, vel, attrs = ec_system(n, n_molecules)
    n_atoms = pos.shape[1]
    from transport_analysis_tpu_torch.ops.acf import chunk_peak_bytes
    from transport_analysis_tpu_torch.utils.units import constants

    u = ec_universe(ta, pos, vel, attrs)
    m = 2 ** (int(n - 1).bit_length() + 1)
    from transport_analysis_tpu_torch.ops.cuda_fft import plan_levels

    phase(name, f"EC system: {n_atoms} atoms x {n} frames, box {BOX} Å, "
          f"f32 feed {pos.nbytes / 2**20:.0f} MiB x 2, M = {m}, plan "
          f"{plan_levels(m)}; generated in "
          f"{time.perf_counter() - t_phase:.1f} s")
    atoms = slice(None, None, stride)
    pairs = n * (n + 1) // 2        # frame-lag pairs of one series
    check, cross, scalars = checks(name, n, n_atoms, stride)
    analyses, msd = runs(ta, u)

    launches, walls = {}, {}
    (vacf, d_gk, visc), launches["fft"], walls["fft"] = drive(
        torch, counters, card, name, "fft", analyses(True), FFT_KERNELS,
        2 * pairs * n_atoms)
    phase(name, f"fft: reckoned peak device memory "
          f"{chunk_peak_bytes(n, n_atoms) / 2**30:.3f} GiB "
          "(ops.acf.chunk_peak_bytes of all atoms)")
    ref_v = acf_numpy(vel[:, atoms])
    check("fft", "VACF", vacf.results.vacf_by_particle,
          vacf.results.timeseries, ref_v, n)
    scale = 2.0 * constants["Boltzmann_constant"] * BOX ** 3 * TEMP
    ref_h = helfand_oracle(attrs["masses"][atoms], vel[:, atoms],
                           pos[:, atoms], 3) / scale
    check("fft", "Helfand", visc.results.visc_by_particle,
          visc.results.timeseries, ref_h, n)
    scalars("fft", d_gk, visc)
    kept = {"fft": (vacf.results, visc.results), "ref_v": ref_v,
            "ref_h": ref_h}
    if name in WINDOWED:
        max_lag = WINDOWED[name]
        n_lags = n if max_lag is None else max_lag
        keep = slice(0, min(n_lags, n // 2))
        fft_v = vacf.results.vacf_by_particle[keep]
        fft_h = visc.results.visc_by_particle[keep]
        del vacf, visc
        (vacf, d_gk, visc), launches["windowed"], walls["windowed"] = drive(
            torch, counters, card, name, "windowed",
            analyses(False, max_lag), WINDOWED_KERNELS,
            2 * lag_pairs(n, n_lags) * n_atoms)
        phase(name, f"windowed: {n_lags} lags, reckoned peak device memory "
              f"{reckoned_windowed_peak(n, n_atoms, n_lags) / 2**30:.3f} "
              "GiB")
        check("windowed", "VACF", vacf.results.vacf_by_particle,
              vacf.results.timeseries, ref_v, n_lags)
        check("windowed", "Helfand", visc.results.visc_by_particle,
              visc.results.timeseries, ref_h, n_lags)
        cross("windowed", "VACF", vacf.results.vacf_by_particle, fft_v)
        cross("windowed", "Helfand", visc.results.visc_by_particle, fft_h)
        scalars("windowed", d_gk, visc)
        kept["windowed"] = (vacf.results, visc.results)
        del fft_v, fft_h
    del vacf, visc, ref_v, ref_h
    if name in MSD_PHASES:
        ref_m = einstein_oracle(pos[:, atoms].astype(np.float64), 1)
        msd_fft, launches["msd_fft"], walls["msd_fft"] = drive(
            torch, counters, card, name, "msd_fft", msd(True), FFT_KERNELS,
            pairs * n_atoms)
        check("msd_fft", "MSD", msd_fft.results.msds_by_particle,
              msd_fft.results.timeseries, ref_m, n)
        msd_win, launches["msd_windowed"], walls["msd_windowed"] = drive(
            torch, counters, card, name, "msd_windowed", msd(False),
            WINDOWED_KERNELS, pairs * n_atoms)
        check("msd_windowed", "MSD", msd_win.results.msds_by_particle,
              msd_win.results.timeseries, ref_m, n)
        cross("msd_windowed", "MSD", msd_win.results.msds_by_particle,
              msd_fft.results.msds_by_particle)
        kept["ref_m"] = ref_m
        kept["msd_fft"], kept["msd_windowed"] = ((msd_fft.results,),
                                                 (msd_win.results,))
        del msd_fft, msd_win, ref_m
    phase(name, f"phase done in {time.perf_counter() - t_phase:.1f} s")
    kept["launches"], kept["walls"] = launches, walls
    return launches, walls, (pos, vel, attrs), kept


def f32_phase(torch, ta, counters, card, shape, system, kept, stride):
    """The float32 work mode (``dtype=np.float32``) on the ``shape``
    phase's system (module docstring): its runs, each against the float64
    run's wall and the host f64 oracles of ``kept`` within F32_TOL on lags
    < N/2, ``fft`` profiled; at the deep shape a chunked float32 MSD's
    peak device memory against its reckoning. Returns each run's
    launches."""
    from transport_analysis_tpu_torch.ops import cuda_fft
    from transport_analysis_tpu_torch.ops.acf import (auto_atom_chunk,
                                                      chunk_peak_bytes)

    name = "f32"
    t_phase = time.perf_counter()
    pos, vel, attrs = system
    n, n_atoms = pos.shape[:2]
    u = ec_universe(ta, pos, vel, attrs)
    analyses, msd = runs(ta, u)
    check, cross, scalars = checks(name, n, n_atoms, stride, tol=F32_TOL)
    pairs = n * (n + 1) // 2
    f32 = {"dtype": np.float32}
    launches, walls = {}, {}

    def run_f32(label, run, kernels, lag_work, results_of):
        """``run`` driven as the model phases drive theirs; it must launch
        the float32 instantiations of ``kernels`` and no other, and give
        float32 results."""
        out, launches[label], walls[label] = drive(
            torch, counters, card, name, f"{shape} {label}", run,
            [key + "_f32" for key in kernels], lag_work,
            profile=label == "fft")
        count = launches[label]
        wrong = [key for key in counters if not key.endswith("_f32")
                 and count[key] != count.get(key + "_f32", 0)]
        if wrong:
            raise AssertionError(f"{shape} {label}: float64 kernels launched "
                                 f"in the float32 work mode: {wrong}")
        arrays = [v for res in results_of(out) for v in res.values()
                  if isinstance(v, np.ndarray)]
        if {a.dtype for a in arrays} != {np.dtype(np.float32)}:
            raise AssertionError(f"{shape} {label}: result dtypes "
                                 f"{[a.dtype for a in arrays]}")
        nbytes = sum(a.nbytes for a in arrays)
        f64_wall = kept["walls"][label]
        phase(name, f"{shape} {label}: wall {walls[label]:.4f} s against the "
              f"float64 run's {f64_wall:.4f} s ({f64_wall / walls[label]:.3f}"
              f"x); float32 results, {nbytes} bytes copied to the host "
              f"(the float64 run's: {2 * nbytes}), on {card}")
        return out

    (vacf, d_gk, visc) = run_f32(
        "fft", analyses(True, **f32), FFT_KERNELS, 2 * pairs * n_atoms,
        lambda out: (out[0].results, out[2].results))
    check(f"{shape} fft", "VACF", vacf.results.vacf_by_particle,
          vacf.results.timeseries, kept["ref_v"], n)
    check(f"{shape} fft", "Helfand", visc.results.visc_by_particle,
          visc.results.timeseries, kept["ref_h"], n)
    scalars(f"{shape} fft", d_gk, visc)
    max_lag = WINDOWED[shape]
    n_lags = n if max_lag is None else max_lag
    keep = slice(0, min(n_lags, n // 2))
    fft_v = vacf.results.vacf_by_particle[keep]
    fft_h = visc.results.visc_by_particle[keep]
    del vacf, visc
    (vacf, d_gk, visc) = run_f32(
        "windowed", analyses(False, max_lag, **f32), WINDOWED_KERNELS,
        2 * lag_pairs(n, n_lags) * n_atoms,
        lambda out: (out[0].results, out[2].results))
    check(f"{shape} windowed", "VACF", vacf.results.vacf_by_particle,
          vacf.results.timeseries, kept["ref_v"], n_lags)
    check(f"{shape} windowed", "Helfand", visc.results.visc_by_particle,
          visc.results.timeseries, kept["ref_h"], n_lags)
    cross(f"{shape} windowed", "VACF", vacf.results.vacf_by_particle, fft_v)
    cross(f"{shape} windowed", "Helfand", visc.results.visc_by_particle,
          fft_h)
    scalars(f"{shape} windowed", d_gk, visc)
    del vacf, visc, fft_v, fft_h
    if shape in MSD_PHASES:
        ref_m = kept["ref_m"]
        msd_fft = run_f32("msd_fft", msd(True, **f32), FFT_KERNELS,
                          pairs * n_atoms, lambda out: (out.results,))
        check(f"{shape} msd_fft", "MSD", msd_fft.results.msds_by_particle,
              msd_fft.results.timeseries, ref_m, n)
        msd_win = run_f32("msd_windowed", msd(False, **f32), WINDOWED_KERNELS,
                          pairs * n_atoms, lambda out: (out.results,))
        check(f"{shape} msd_windowed", "MSD",
              msd_win.results.msds_by_particle, msd_win.results.timeseries,
              ref_m, n)
        cross(f"{shape} msd_windowed", "MSD",
              msd_win.results.msds_by_particle,
              msd_fft.results.msds_by_particle)
        del msd_fft, msd_win, ref_m
    if shape == "deep":
        # a float32 MSD in atom chunks chosen by the float32 memory model
        # for the stream phase's budget: its peak against its reckoning
        chunk = auto_atom_chunk(n, d=3, hbm_budget_gb=STREAM_BUDGET_GB,
                                dtype=np.float32)
        budget = STREAM_BUDGET_GB * 1e9
        cuda_fft.roots_tensor.cache_clear()
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out, count, wall = counted_run(torch, counters,
                                       msd(True, atom_chunk=chunk, **f32))
        peak = torch.cuda.max_memory_allocated()
        reckoned = chunk_peak_bytes(n, chunk, 3, np.float32)
        n_chunks = -(-n_atoms // chunk)
        chunk64 = auto_atom_chunk(n, d=3, hbm_budget_gb=STREAM_BUDGET_GB)
        phase(name, f"{shape} chunked msd_fft: auto_atom_chunk({n}, d=3, "
              f"hbm_budget_gb={STREAM_BUDGET_GB}, dtype=np.float32) = "
              f"{chunk} atoms (float64: {chunk64}), {n_chunks} chunks; "
              f"launches {count}; wall {wall:.4f} s; peak "
              f"device memory {(peak - before) / 1e9:.3f} GB past the "
              f"{before / 1e9:.3f} GB held before, reckoned chunk peak "
              f"{reckoned / 1e9:.3f} GB, budget {budget / 1e9:.1f} GB; on "
              f"{card}")
        if not peak - before <= reckoned <= budget:
            raise AssertionError(f"{shape} chunked float32 MSD: peak device "
                                 "memory past its reckoned peak or the "
                                 "budget")
        if any(count[key + "_f32"] < n_chunks for key in FFT_KERNELS):
            raise AssertionError(f"{shape} chunked float32 MSD: launches "
                                 f"{count}")
        ref_m = einstein_oracle(pos[:, ::stride].astype(np.float64), 1)
        check(f"{shape} chunked msd_fft", "MSD", out.results.msds_by_particle,
              out.results.timeseries, ref_m, n)
        del out, ref_m
    phase(name, f"{shape}: phase done in {time.perf_counter() - t_phase:.1f}"
          " s")
    return launches


def write_pdb(path: str, pos0, attrs) -> None:
    """A PDB of the EC system's atoms in the standard columns: names,
    residue ECA, resids, elements (the readers' masses follow from them),
    frame-0 coordinates and the cubic box. (The packaged generator's PDB
    puts the residue name one column early, so that "resname ECA" selects
    no atom there.)"""
    with open(path, "w") as fh:
        fh.write(f"CRYST1{BOX:9.3f}{BOX:9.3f}{BOX:9.3f}"
                 f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1\n")
        for i, (atom, resid, (x, y, z)) in enumerate(
                zip(attrs["names"], attrs["resids"], pos0)):
            fh.write(f"ATOM  {i + 1:5d} {atom:<4s} ECA A{resid:4d}    "
                     f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          "
                     f"{atom[0]:>2s}\n")
        fh.write("END\n")


def files_phase(torch, ta, acf_numpy, counters, card, system, model_walls,
                tmp):
    """The model phase's EC system through the port's writers and readers
    (module docstring): written as TRR, XTC and DCD into the directory
    ``tmp``, read back through ``Universe(pdb, traj)`` and timed, analysed
    on the card from the files against the same analyses on MemoryReaders
    of the decoded arrays and against host oracles; then the packaged EC
    regression on the card. Returns the PDB's and the TRR's paths, the
    TRR ``fft`` run's wall and its results, for the stream phase."""
    name = "files"
    t_phase = time.perf_counter()
    pos, vel, attrs = system
    n, n_atoms = pos.shape[:2]
    from transport_analysis_tpu_torch import io
    from transport_analysis_tpu_torch.core.trajectory import MemoryReader
    from transport_analysis_tpu_torch.io import _native
    from transport_analysis_tpu_torch.utils.units import constants

    box = [BOX, BOX, BOX, 90.0, 90.0, 90.0]
    writes = {  # extension -> writer options, one frame's write
        "trr": ({}, lambda w, f: w.write(
            positions=pos[f], velocities=vel[f], dimensions=box,
            time=f * DT)),
        "xtc": ({"precision": XTC_PRECISION}, lambda w, f: w.write(
            pos[f], dimensions=box, time=f * DT)),
        "dcd": ({"dt": DT}, lambda w, f: w.write(pos[f], dimensions=box)),
    }
    pdb = os.path.join(tmp, "ec.pdb")
    write_pdb(pdb, pos[0], attrs)
    universes, batches = {}, {}
    for ext, (kwargs, write) in writes.items():
        path = os.path.join(tmp, f"ec.{ext}")
        t0 = time.perf_counter()
        with io.Writer(path, n_atoms, **kwargs) as w:
            for f in range(n):
                write(w, f)
        secs = time.perf_counter() - t0
        phase(name, f"wrote {ext.upper()} of {n_atoms} atoms x {n} "
              f"frames: {os.path.getsize(path)} bytes in {secs:.3f} s, "
              f"on {card}")
        u = ta.Universe(pdb, path)
        calls = _native.decode_trr_batch.calls
        t0 = time.perf_counter()
        batch = u.trajectory.read_frames_batch(range(n))
        secs = time.perf_counter() - t0
        decoded = sum(batch[k].nbytes for k in ("positions", "velocities")
                      if k in batch)
        how = {"trr": "native batch decoder",
               "xtc": "native codec, one call a frame",
               "dcd": "numpy, one frame at a time"}[ext]
        phase(name, f"read {ext.upper()}: read_frames_batch of {n} "
              f"frames in {secs:.3f} s, {decoded / secs / 1e9:.3f} GB/s "
              f"of decoded float32 ({decoded} bytes; {how}), on {card}")
        if ext == "trr" and _native.decode_trr_batch.calls != calls + 1:
            raise AssertionError("the TRR batch did not go through the "
                                 "native decoder")
        universes[ext], batches[ext] = u, batch
    if "xtc" not in _native._loaded:
        raise AssertionError("the XTC frames did not go through the codec")
    if not np.array_equal(universes["trr"].atoms.masses, attrs["masses"]):
        raise AssertionError("the PDB's masses differ from the system's")

    # the decoded arrays against what was written: TRR's nm round trip
    # (two float32 roundings), XTC's quantum (half of 1/precision nm) and
    # DCD's float32 copy
    bounds = {
        ("trr", "positions"): (pos, 2.5e-7, 0.0),
        ("trr", "velocities"): (vel, 2.5e-7, 0.0),
        ("xtc", "positions"): (pos, 2.5e-7, 5.0 / XTC_PRECISION),
        ("dcd", "positions"): (pos, 0.0, 0.0),
    }
    for (ext, key), (orig, rtol, atol) in bounds.items():
        diff = np.abs(batches[ext][key] - orig)
        excess = float((diff - rtol * np.abs(orig) - atol).max())
        unit = "Å" if key == "positions" else "Å/ps"
        phase(name, f"{ext.upper()} {key} decoded vs written: max |Δ| "
              f"{float(diff.max()):.3e} {unit} (bound {rtol} relative + "
              f"{atol} {unit})")
        if excess > 0.0:
            raise AssertionError(f"{ext} {key} decoded beyond its bound")

    def twin(ext):
        """A Universe on a MemoryReader of the reader's decoded arrays,
        with the PDB's topology."""
        b = batches[ext]
        u = ta.Universe(universes["trr"]._topology)
        u.load_new(MemoryReader(
            b["positions"], velocities=b.get("velocities"),
            dimensions=universes[ext].trajectory.ts.dimensions, dt=DT))
        return u

    def same(label, what, got, want):
        err = float(np.abs(got - want).max() / np.abs(want).max())
        phase(name, f"{label}: {what} from the file vs a MemoryReader of "
              f"its decoded arrays: {err:.3e}")
        if not err <= TWIN_TOL:
            raise AssertionError(f"{label} {what}: file-backed and in-memory "
                                 f"runs differ by {err:.3e} > {TWIN_TOL}")

    def beside(label, wall):
        phase(name, f"{label}: file-backed wall {wall:.4f} s against the "
              f"model phase's in-memory {model_walls[label]:.4f} s, on "
              f"{card}")

    check, cross, scalars = checks(name, n, n_atoms, 1)
    pairs = n * (n + 1) // 2
    analyses, _ = runs(ta, universes["trr"])
    twin_analyses, _ = runs(ta, twin("trr"))
    b = batches["trr"]
    ref_v = acf_numpy(b["velocities"])
    scale = (2.0 * constants["Boltzmann_constant"]
             * float(np.mean(b["volumes"])) * TEMP)
    ref_h = helfand_oracle(attrs["masses"], b["velocities"], b["positions"],
                           3) / scale
    fft_keep = {}
    for label, fft, needed in (("fft", True, FFT_KERNELS),
                               ("windowed", False, WINDOWED_KERNELS)):
        (vacf, d_gk, visc), _, wall = drive(
            torch, counters, card, name, label, analyses(fft), needed,
            2 * pairs * n_atoms, warm=False)
        beside(label, wall)
        t_vacf, _, t_visc = twin_analyses(fft)()
        for what, got, want in (
                ("VACF", vacf.results.vacf_by_particle,
                 t_vacf.results.vacf_by_particle),
                ("Helfand", visc.results.visc_by_particle,
                 t_visc.results.visc_by_particle)):
            same(label, what, got, want)
        check(label, "VACF", vacf.results.vacf_by_particle,
              vacf.results.timeseries, ref_v, n)
        check(label, "Helfand", visc.results.visc_by_particle,
              visc.results.timeseries, ref_h, n)
        scalars(label, d_gk, visc)
        if fft:
            fft_keep = {"VACF": vacf.results.vacf_by_particle,
                        "Helfand": visc.results.visc_by_particle}
            kept = {"pdb": pdb, "trr": os.path.join(tmp, "ec.trr"),
                    "wall": wall, "results": (vacf.results, visc.results)}
        else:
            cross(label, "VACF", vacf.results.vacf_by_particle,
                  fft_keep["VACF"])
            cross(label, "Helfand", visc.results.visc_by_particle,
                  fft_keep["Helfand"])
        del vacf, visc, t_vacf, t_visc
    del ref_v, ref_h, fft_keep

    _, msd = runs(ta, universes["xtc"])
    _, twin_msd = runs(ta, twin("xtc"))
    ref_m = einstein_oracle(batches["xtc"]["positions"].astype(np.float64), 1)
    msd_fft = None
    for label, fft, needed in (("msd_fft", True, FFT_KERNELS),
                               ("msd_windowed", False, WINDOWED_KERNELS)):
        out, _, wall = drive(torch, counters, card, name, label, msd(fft),
                             needed, pairs * n_atoms, warm=False)
        beside(label, wall)
        same(label, "MSD", out.results.msds_by_particle,
             twin_msd(fft)().results.msds_by_particle)
        check(label, "MSD", out.results.msds_by_particle,
              out.results.timeseries, ref_m, n)
        if fft:
            msd_fft = out.results.msds_by_particle
        else:
            cross(label, "MSD", out.results.msds_by_particle, msd_fft)
    del universes, batches, ref_m, msd_fft

    # the packaged regression (the JAX package's tests/test_data.py)
    from transport_analysis_tpu_torch.data import files

    u = ta.Universe(files.ec_top, files.ec_traj_trr)
    visc = {dev: ta.ViscosityHelfand(u.atoms, linear_fit_window=FIT_WINDOW,
                                     device=dev).run().results.viscosity
            for dev in ("cuda", "cpu")}
    vacf = {dev: ta.VelocityAutocorr(u.atoms, device=dev).run()
            .results.timeseries for dev in ("cuda", "cpu")}
    err_visc = abs(visc["cuda"] - visc["cpu"]) / abs(visc["cpu"])
    err_vacf = float(np.abs(vacf["cuda"] - vacf["cpu"]).max()
                     / np.abs(vacf["cpu"]).max())
    lag0 = float(vacf["cuda"][0])
    phase(name, f"packaged EC ({u.trajectory.n_frames} frames, TRR): "
          f"viscosity {visc['cuda']:.10e} on the card, {err_visc:.3e} from "
          f"the CPU's, pinned 0.00098984 ± 5e-5; VACF lag 0 {lag0:.6f} "
          f"(pinned 328.965, 1e-4), card vs CPU {err_vacf:.3e}; on {card}")
    if not (err_visc <= HEAD_TOL and err_vacf <= HEAD_TOL
            and abs(visc["cuda"] - 0.00098984) <= 5e-5
            and abs(lag0 - 328.965) <= 1e-4 * 328.965):
        raise AssertionError("the packaged EC regression failed on the card")
    phase(name, f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return kept


def stream_phase(torch, ta, acf_numpy, counters, card, deep, files, tmp):
    """The streaming layer on the card (module docstring): the frame-
    blocked feed and atom chunks at the deep shape, held against the deep
    phase's batch runs ``deep``; a checkpointed, interrupted and resumed
    chunk run; the frame-blocked feed and the out-of-core spools from the
    files phase's TRR (``files``), spools in the directory ``tmp``."""
    import shutil

    from transport_analysis_tpu_torch.io import _native
    from transport_analysis_tpu_torch.ops import acf_fft_from_f32, cuda_fft
    from transport_analysis_tpu_torch.ops.acf import (auto_atom_chunk,
                                                      chunk_peak_bytes)
    from transport_analysis_tpu_torch.parallel import out_of_core, streaming
    from transport_analysis_tpu_torch.utils.units import constants

    name = "stream"
    t_phase = time.perf_counter()
    pos, vel, attrs = deep["system"]
    n, n_atoms = pos.shape[:2]
    stride = next(s for key, _, _, s in MODEL_PHASES if key == "deep")
    u = ec_universe(ta, pos, vel, attrs)
    analyses, msd = runs(ta, u)
    check, _, _ = checks(name, n, n_atoms, stride)
    pairs = n * (n + 1) // 2
    keys = {"VACF": "vacf_by_particle", "Helfand": "visc_by_particle",
            "MSD": "msds_by_particle"}

    def differ(label, what, got, want, tol, against, head=False):
        """max|got − want| / max|want| within ``tol``, over all lags or,
        with ``head``, on lags < N/2 (the error over all lags printed
        beside it); says whether the two are bit-equal."""
        err = float(np.abs(got - want).max() / np.abs(want).max())
        equal = "bit-equal" if np.array_equal(got, want) else "not bit-equal"
        if head:
            err, every = head_errors(got, want, n)[0], err
            equal = f"{every:.3e} over all lags, {equal}"
        phase(name, f"{label}: {what} vs {against}: {err:.3e}"
              f"{' (lags < N/2)' if head else ''} ({equal})")
        if not err <= tol:
            raise AssertionError(f"{label} {what}: {err:.3e} from {against}, "
                                 f"past {tol}")

    # -- the frame-blocked feed at the deep shape: 16 blocks of 4,096
    # frames through BatchPrefetcher into the device buffers
    reader = u.trajectory
    decode = reader.read_frames_batch
    blocks = []

    def counted_blocks(indices):
        blocks.append(len(indices))
        return decode(indices)

    reader.read_frames_batch = counted_blocks
    (vacf, _, visc), _, wall = drive(
        torch, counters, card, name, "deep frame-blocked fft",
        analyses(True, frame_block=STREAM_BLOCK), FFT_KERNELS,
        2 * pairs * n_atoms, warm=False)
    reader.read_frames_batch = decode
    per_run = 2 * (-(-n // STREAM_BLOCK))
    if set(blocks) != {STREAM_BLOCK} or len(blocks) % per_run:
        raise AssertionError(f"the frame-blocked runs read blocks {blocks}")
    phase(name, f"deep frame-blocked fft: {per_run // 2} blocks of "
          f"{STREAM_BLOCK} frames an analysis through BatchPrefetcher; wall "
          f"{wall:.4f} s against the deep phase's batch "
          f"{deep['walls']['fft']:.4f} s, on {card}")
    for what, res, want in (("VACF", vacf.results, deep["fft"][0]),
                            ("Helfand", visc.results, deep["fft"][1])):
        for field in (keys[what], "timeseries"):
            differ("deep frame-blocked fft", f"{what} {field}", res[field],
                   want[field], BLOCKED_TOL, "the deep phase's batch run")
    del vacf, visc

    # -- atom chunks at the deep shape: auto_atom_chunk for an 8 GB budget;
    # the VACF and the MSD (the peak the model reckons) at that chunk,
    # Helfand at one atom less (so one of them has an odd d·chunk). The
    # deep phase runs no MSD: its unchunked runs and oracle come first.
    msd_whole = {}
    for fft, max_lag in ((True, None), (False, WINDOWED["deep"])):
        out, _, wall = counted_run(torch, counters, msd(fft, max_lag))
        msd_whole[fft] = out.results
        phase(name, f"deep unchunked {'fft' if fft else 'windowed'} MSD: "
              f"wall {wall:.4f} s, on {card}")
        del out
    ref_m = einstein_oracle(pos[:, ::stride].astype(np.float64), 1)
    chunk = auto_atom_chunk(n, d=3, hbm_budget_gb=STREAM_BUDGET_GB)
    budget = STREAM_BUDGET_GB * 1e9
    phase(name, f"auto_atom_chunk({n}, d=3, hbm_budget_gb="
          f"{STREAM_BUDGET_GB}) = {chunk} atoms; reckoned chunk peak "
          f"{chunk_peak_bytes(n, chunk) / 1e9:.3f} GB, of all {n_atoms} "
          f"atoms {chunk_peak_bytes(n, n_atoms) / 1e9:.3f} GB")
    fft_launches = deep["launches"]["fft"]
    per_vacf = {key: fft_launches[key] // 2 for key in
                ("fft_level", "unpack_power_inva", "inverse_last_level")}
    per_visc = dict(per_vacf, kneller_totals=fft_launches["kneller_totals"],
                    kneller_windows=fft_launches["kneller_windows"])
    per_run = {(True, "VACF"): per_vacf, (True, "Helfand"): per_visc,
               (True, "MSD"): per_visc, (False, "VACF"): {"lag_sums": 1},
               (False, "Helfand"): {"lag_sums": 1},
               (False, "MSD"): {"lag_sums": 1}}
    ag = u.select_atoms("resname ECA")
    chunked_vacf = None
    for fft, max_lag in ((True, None), (False, WINDOWED["deep"])):
        label = "deep chunked " + ("fft" if fft else "windowed")
        n_lags = n if max_lag is None else max_lag
        want_runs = deep["fft" if fft else "windowed"] + (msd_whole[fft],)
        refs = (deep["ref_v"], deep["ref_h"], ref_m)
        for i, (what, c) in enumerate((("VACF", chunk), ("Helfand", chunk - 1),
                                       ("MSD", chunk))):
            def run(what=what, c=c):
                if what == "VACF":
                    return ta.VelocityAutocorr(ag, fft=fft, max_lag=max_lag,
                                               atom_chunk=c).run()
                if what == "MSD":
                    return msd(fft, max_lag, atom_chunk=c)()
                return ta.ViscosityHelfand(
                    u.atoms, temp_avg=TEMP, linear_fit_window=FIT_WINDOW,
                    fft=fft, max_lag=max_lag, atom_chunk=c).run()

            cuda_fft.roots_tensor.cache_clear()
            torch.backends.cuda.cufft_plan_cache.clear()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, launches, wall = counted_run(torch, counters, run)
            peak = torch.cuda.max_memory_allocated()
            n_chunks = -(-n_atoms // c)
            want = {key: per_run[fft, what].get(key, 0) * n_chunks
                    for key in counters}
            reckoned = chunk_peak_bytes(n, c)
            phase(name, f"{label} {what}: atom_chunk {c} (d·chunk {3 * c}), "
                  f"{n_chunks} chunks; launches {launches}; wall "
                  f"{wall:.4f} s; peak device memory {peak / 1e9:.3f} GB "
                  f"({(peak - before) / 1e9:.3f} GB past the "
                  f"{before / 1e9:.3f} GB held before), reckoned chunk "
                  f"peak {reckoned / 1e9:.3f} GB, budget {budget / 1e9:.1f}"
                  f" GB; on {card}")
            if launches != want:
                raise AssertionError(f"{label} {what}: launches {launches}, "
                                     f"expected {want} ({n_chunks} chunks)")
            # the run's own peak against its reckoning, which the chunk
            # was chosen to keep inside the budget
            if not peak - before <= reckoned <= budget:
                raise AssertionError(f"{label} {what}: peak device memory "
                                     "past its reckoned peak or the budget")
            res, ref = out.results, want_runs[i]
            # the MSD of positions, whose Kneller sums at lags near N
            # carry an absolute floor of about eps·N of the maximum in
            # every float64 evaluation, is held on lags < N/2, as the
            # oracle checks are
            for field in (keys[what], "timeseries"):
                differ(label, f"{what} {field}", res[field], ref[field],
                       CHUNKED_TOL, "the unchunked run", head=what == "MSD")
            check(label, what, res[keys[what]], res.timeseries, refs[i],
                  n_lags)
            if fft and what == "VACF":
                chunked_vacf = res.timeseries
            del out, res
    del msd_whole, ref_m

    # -- checkpoint: the chunked VACF interrupted after two chunks, then
    # resumed from its checkpoint file
    ckpt = os.path.join(tmp, "vacf_checkpoint.npz")
    calls = []

    class Interrupted(Exception):
        pass

    def kernel(v):
        if interrupt and len(calls) == 2:
            raise Interrupted
        calls.append(v.shape[1])
        return acf_fft_from_f32(v)

    interrupt, interrupted = True, False
    try:
        streaming.chunked_per_particle(kernel, vel, chunk,
                                       want_by_particle=False,
                                       checkpoint=ckpt)
    except Interrupted:
        interrupted = True
    if not interrupted or len(calls) != 2:
        raise AssertionError("the chunked run was not interrupted after "
                             "two chunks")
    interrupt = False
    ts, _ = streaming.chunked_per_particle(kernel, vel, chunk,
                                           want_by_particle=False,
                                           checkpoint=ckpt)
    phase(name, f"checkpoint: interrupted after chunks of {calls[:2]} "
          f"atoms, resumed from {os.path.relpath(ckpt, ROOT)} with "
          f"{calls[2:]}")
    if len(calls) != -(-n_atoms // chunk):
        raise AssertionError(f"the resumed run ran chunks {calls[2:]}")
    differ("checkpoint", "resumed VACF timeseries", ts, chunked_vacf, 0.0,
           "the uninterrupted chunked run")
    os.remove(ckpt)
    del ts

    # -- the files phase's TRR: the frame-blocked feed, 8 blocks of 1,024
    # frames through the native decoder
    ut = ta.Universe(files["pdb"], files["trr"])
    analyses_t, msd_t = runs(ta, ut)
    decodes = _native.decode_trr_batch.calls
    (vacf, _, visc), launches, wall = counted_run(
        torch, counters, analyses_t(True, frame_block=FILE_BLOCK))
    nt = ut.trajectory.n_frames
    decodes = _native.decode_trr_batch.calls - decodes
    phase(name, f"TRR frame-blocked fft: {decodes} native batch decodes "
          f"(blocks of {FILE_BLOCK} frames, two analyses); launches "
          f"{launches}; wall {wall:.4f} s against the files phase's batch "
          f"{files['wall']:.4f} s, on {card}")
    if decodes != 2 * (-(-nt // FILE_BLOCK)) or min(
            launches[key] for key in FFT_KERNELS) < 1:
        raise AssertionError("the TRR frame-blocked runs did not decode "
                             "natively in blocks or launch the kernels")
    for what, res, want in (("VACF", vacf.results, files["results"][0]),
                            ("Helfand", visc.results, files["results"][1])):
        differ("TRR frame-blocked fft", f"{what} {keys[what]}",
               res[keys[what]], want[keys[what]], BLOCKED_TOL,
               "the files phase's batch run")
    del vacf, visc

    # -- out of core from the TRR: spools of 1,024 atoms under tmp
    at = ut.select_atoms("resname ECA")
    msd_mem = msd_t(True)().results.timeseries

    def spooled(label, fn, **kwargs):
        spool = os.path.join(tmp, f"spool_{label}")
        stats = {}
        out, launches, wall = counted_run(torch, counters, lambda: fn(
            at, spool, atom_chunk=SPOOL_CHUNK, stats=stats, **kwargs))
        read, stall = sum(stats["read_s"]), sum(stats["stall_s"])
        phase(name, f"out of core {label}: wall {wall:.4f} s (spools and "
              f"correlation); per chunk read_s "
              f"{[round(x, 4) for x in stats['read_s']]}, stall_s "
              f"{[round(x, 4) for x in stats['stall_s']]}, kernel_s "
              f"{[round(x, 4) for x in stats['kernel_s']]}; overlap "
              f"1 − Σstall/Σread = {1 - stall / read:.3f}; launches "
              f"{launches}; on {card}")
        if min(launches[key] for key in ("fft_level", "unpack_power_inva",
                                         "inverse_last_level")) < 1:
            raise AssertionError(f"out of core {label}: kernels not launched")
        return out, spool

    for label, fn, want in (
            ("VACF", out_of_core.vacf_out_of_core,
             files["results"][0].timeseries),
            ("MSD", out_of_core.msd_out_of_core, msd_mem)):
        got, spool = spooled(label, fn)
        differ(f"out of core {label}", "timeseries", got, want, SPOOL_TOL,
               "the in-memory analysis of the file")
        shutil.rmtree(spool)
    (got, _), spool = spooled("Helfand", out_of_core.helfand_out_of_core,
                              temp_avg=TEMP)
    mvx = np.concatenate(
        [np.load(os.path.join(spool, f"mvx_chunk{c:05d}.f32"))
         for c in range(-(-len(at) // SPOOL_CHUNK))], axis=1)
    volume = float(np.mean(out_of_core.load_aux(spool, "mvx")["volumes"]))
    shutil.rmtree(spool)
    oracle = einstein_oracle(mvx.astype(np.float64), 3).mean(axis=1) / (
        2.0 * constants["Boltzmann_constant"] * volume * TEMP)
    del mvx
    err = head_errors(got, oracle, nt)
    drift = head_errors(got, files["results"][1].timeseries, nt)
    phase(name, f"out of core Helfand: vs the host f64 oracle of its float32 "
          f"m·v·x spools {err[0]:.3e} (lags < N/2), {err[1]:.3e} (all); vs "
          f"the in-memory ViscosityHelfand (float64 m·v·x) {drift[0]:.3e}, "
          f"{drift[1]:.3e}: the spools' float32 grade")
    if not err[0] <= HEAD_TOL:
        raise AssertionError("out of core Helfand disagrees with the oracle "
                             f"of its spools beyond {HEAD_TOL}")
    phase(name, f"phase done in {time.perf_counter() - t_phase:.1f} s")


def mesh_phase(torch, ta, cuda_lag, counters, card, model, deep_system,
               files, tmp):
    """Multiple devices on the one card (module docstring): the models in
    four particle shards against the model phase's unsharded runs
    (``model``: its system and kept results), the ring over four frame
    blocks against K8 and its two-block launch against its plain version,
    the sharded FFT on every 10th atom of ``deep_system``, the sharded
    out-of-core runs from the files phase's TRR (spools in ``tmp``), and
    a one-process NCCL group. Returns the launches of its runs, the
    two-block launch's kernel numbers, and the one-process results of the
    ring (with K8's serial sums, on the host) and of the sharded VACF
    (with ``ops.acf_fft``'s) for the multiprocess phase."""
    import shutil

    import torch.distributed as dist

    from transport_analysis_tpu_torch import ops, parallel
    from transport_analysis_tpu_torch.ops.acf import acf_fft_numpy
    from transport_analysis_tpu_torch.parallel import (multihost, out_of_core,
                                                       ring, sharded_fft)
    from transport_analysis_tpu_torch.parallel.mesh import Mesh

    name = "mesh"
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cards = parallel.analysis_mesh()
    phase(name, f"analysis_mesh(): {cards.size} visible card(s) "
          f"{[str(d) for d in cards.devices]}")
    mesh = parallel.analysis_mesh(["cuda"] * MESH_SHARDS)
    frames = Mesh(["cuda"] * MESH_SHARDS, ("frames",))
    phase(name, f"analysis_mesh(['cuda'] * {MESH_SHARDS}): {mesh}")
    launches = {}

    def run_timed(label, run, needed=()):
        """``run`` once, the counters reset just before and read just
        after, with its wall and peak device memory; the kernels
        ``needed`` must have launched."""
        torch.cuda.reset_peak_memory_stats()
        out, count, wall = counted_run(torch, counters, run)
        peak = torch.cuda.max_memory_allocated()
        launched = {key: c for key, c in count.items() if c}
        phase(name, f"{label}: wall {wall:.4f} s, peak device memory "
              f"{peak / 2**30:.3f} GiB, launches {launched}, on {card}")
        missing = [key for key in needed if count[key] < 1]
        if missing:
            raise AssertionError(f"{label}: kernels not launched: {missing}")
        return out, count, wall

    def rel_err(got, want, head=None):
        got, want = np.asarray(got), np.asarray(want)
        if head is not None:
            got, want = got[:head], want[:head]
        return float(np.abs(got - want).max() / np.abs(want).max())

    def within(label, err, tol, against, extra=""):
        phase(name, f"{label} vs {against}: {err:.3e}{extra}")
        if not err <= tol:
            raise AssertionError(f"{label}: {err:.3e} from {against}, past "
                                 f"{tol}")

    # -- the model phase's runs in four particle shards of the card
    pos, vel, attrs = model["system"]
    kept = model["kept"]
    n, n_atoms = pos.shape[:2]
    u = ec_universe(ta, pos, vel, attrs)
    analyses, msd = runs(ta, u)
    check, _, _ = checks(name, n, n_atoms, 1)
    keys = {"VACF": "vacf_by_particle", "Helfand": "visc_by_particle",
            "MSD": "msds_by_particle"}
    refs = {"VACF": kept["ref_v"], "Helfand": kept["ref_h"],
            "MSD": kept["ref_m"]}
    pairs = n * (n + 1) // 2

    def sharded(run):
        def inner():
            with parallel.use_mesh(mesh):
                return run()
        return inner

    for label, run, needed, whats in (
            ("fft", analyses(True), FFT_KERNELS, ("VACF", "Helfand")),
            ("windowed", analyses(False), WINDOWED_KERNELS,
             ("VACF", "Helfand")),
            ("msd_fft", msd(True), FFT_KERNELS, ("MSD",)),
            ("msd_windowed", msd(False), WINDOWED_KERNELS, ("MSD",))):
        out, count, wall = drive(
            torch, counters, card, name, f"{MESH_SHARDS}-shard {label}",
            sharded(run), needed, len(whats) * pairs * n_atoms,
            profile=False)
        want = {key: MESH_SHARDS * c
                for key, c in kept["launches"][label].items()}
        if count != want:
            raise AssertionError(f"{label}: launches {count}, not "
                                 f"{MESH_SHARDS} x the unsharded run's {want}")
        phase(name, f"{MESH_SHARDS}-shard {label}: launches {MESH_SHARDS} x "
              f"the unsharded run's; wall {wall:.4f} s against its "
              f"{kept['walls'][label]:.4f} s")
        got = ((out[0].results, out[2].results) if len(whats) == 2
               else (out.results,))
        for what, res, base in zip(whats, got, kept[label]):
            # the MSD of positions on lags < N/2, as the stream phase
            # holds its chunks (the Kneller sums' floor near lag N)
            head = n // 2 if what == "MSD" else None
            for field in (keys[what], "timeseries"):
                equal = np.array_equal(res[field], base[field])
                extra = (f" (over all lags {rel_err(res[field], base[field]):.3e})"
                         if head else "")
                within(f"{MESH_SHARDS}-shard {label} {what} {field}",
                       rel_err(res[field], base[field], head), MESH_TOL,
                       "the unsharded run",
                       f"{extra} ({'bit-equal' if equal else 'not bit-equal'})")
            check(f"{MESH_SHARDS}-shard {label}", what, res[keys[what]],
                  res.timeseries, refs[what], n)
        launches[label] = count
        del out, got
    torch.cuda.empty_cache()

    # -- the ring over four frame blocks of the model system, all lags
    block = n // MESH_SHARDS
    ring_counts = {torch.float64: [], torch.float32: []}
    kept = {}
    for type_name, mode, sum_d in RING_CASES:
        dtype = getattr(torch, type_name)
        series = vel if mode == "acf" else pos
        x = torch.from_numpy(series).to(dev, dtype)
        label = (f"ring {str(dtype)[6:]} {mode} sum_d={sum_d} ({n}, "
                 f"{n_atoms}, 3) over {MESH_SHARDS} blocks of {block}")
        got, count, wall = run_timed(
            label, lambda: ring.windowed_correlation_ring(
                x, frames, mode=mode, sum_d=sum_d))
        key = "lag_sums_pair" + ("_f32" if dtype == torch.float32 else "")
        rounds = MESH_SHARDS * (MESH_SHARDS + 1) // 2
        if count[key] != rounds or count["lag_sums"]:
            raise AssertionError(f"{label}: {count[key]} two-block launches, "
                                 f"not {rounds}")
        ring_counts[dtype].append(count)
        reduce_mode = "mean" if mode == "einstein" and not sum_d else "sum"
        t0 = time.perf_counter()
        want = cuda_lag.lag_sums(x, n, mode, reduce_mode)
        torch.cuda.synchronize()
        k8_s = time.perf_counter() - t0
        n_pairs = 3 * n_atoms * lag_pairs(n, n)
        b_ms, by = bound(*work(
            x.element_size() * x.numel() + 8 * n * n_atoms,
            (2 if mode == "acf" else 3) * n_pairs,
            PEAK_FP64_MMA if mode == "acf" else
            (PEAK_FP32 if dtype == torch.float32 else PEAK_FP64)))
        diff, scale = max_abs_diff(got, want)
        within(label, diff / scale,
               RING_TOL if dtype == torch.float64 else F32_KERNEL_TOL,
               "K8 lag_sums of the whole series",
               f"; ring wall {1e3 * wall:.3f} ms beside its bound "
               f"{b_ms:.3f} ms ({by}) and K8's {1e3 * k8_s:.3f} ms, "
               f"{count[key]} two-block launches")
        kept[(type_name, mode, sum_d)] = (got.cpu(), want.cpu())
        del x, got, want
    launches["ring"] = {key: sum(c[key] for c in ring_counts[torch.float64])
                        for key in counters}
    launches["ring_f32"] = {key: sum(c[key] for c in
                                     ring_counts[torch.float32])
                            for key in counters}

    # -- the two-block launch against its plain version, plain on every
    # 21st atom: the ring's rounds 0 (xa = xb = block 0, lags 0 .. L - 1,
    # the pairs b >= a), 1 (blocks 0 and 1, lags 1 .. 2L - 1) and 3 (blocks
    # 0 and 3, lags up to N - 1). Round 1's numbers are the JSON line's,
    # its acf launches beside the library's lag sums: a grouped conv1d of
    # each series of xb, zero-padded to the round's lags, with that of xa
    results, others = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 conv1d in float32
    try:
        for k, dtype, mode, series in (
                (k, dtype, mode, series) for k in (1, 0, 3)
                for dtype in (torch.float64, torch.float32)
                for mode, series in (("acf", vel), ("einstein", pos))):
            offset = k * block
            lo, count = ring.round_window(k, block, n)
            x = torch.from_numpy(series).to(dev, dtype)
            xa, xb = x[:block], x[offset:offset + block]
            sa = xa[:, ::PLAIN_STRIDE].contiguous()
            sb = xb[:, ::PLAIN_STRIDE].contiguous()
            f32 = dtype == torch.float32
            shift = lo - offset
            n_pairs = 3 * n_atoms * sum(
                max(0, block - abs(delta))
                for delta in range(shift, shift + count))
            t_bytes = ((1 if k == 0 else 2) * x.element_size() * block
                       * n_atoms * 3 + x.element_size() * count * n_atoms)
            times = (work(t_bytes, 2 * n_pairs, PEAK_FP64_MMA)
                     if mode == "acf" else
                     work(t_bytes, 3 * n_pairs,
                          PEAK_FP32 if f32 else PEAK_FP64))
            library = None
            if mode == "acf" and k == 1:
                weight = xa.reshape(block, -1).T.contiguous()[:, None]
                padded = torch.nn.functional.pad(
                    xb.reshape(block, -1).T, (-shift, count - 1 + shift))[
                        None].contiguous()

                def library():
                    return torch.nn.functional.conv1d(
                        padded, weight, groups=weight.shape[0])

                diff, scale = max_abs_diff(
                    library()[0].view(n_atoms, 3, count).sum(1).T,
                    cuda_lag.lag_sums_pair(xa, xb, offset, lo, count, mode))
                phase("kernels", f"{name} library pair sums of round {k} "
                      f"(grouped {str(dtype)[6:]} conv1d of xb's padded "
                      f"series with xa's) agree with K8's two-block launch "
                      f"to {diff / scale:.3e}")
            key = "lag_sums_pair" + ("_f32" if f32 else "")
            k_ms = compare_kernel(
                torch, results if k == 1 else others, name, key,
                lambda: cuda_lag.lag_sums_pair(xa, xb, offset, lo, count,
                                               mode),
                lambda: cuda_lag.lag_sums_pair_plain(sa, sb, offset, lo,
                                                     count, mode),
                f"K8 lag_sums_pair round {k} {str(dtype)[6:]} {mode}: "
                f"blocks ({block}, {n_atoms}, 3) at offset {offset}, lags "
                f"{lo} .. {lo + count - 1} (plain on every {PLAIN_STRIDE}st "
                f"atom)", times, library=library,
                pick=lambda out: out[:, ::PLAIN_STRIDE],
                tol=F32_KERNEL_TOL if f32 else KERNEL_TOL)
            b_ms = bound(*times)[0]
            split = ""
            if mode == "acf":
                mma, one = cuda_lag.acf_pair_work(block, shift, count)
                split = (f"; the acf split's MMAs do {mma / one:.3f}x its "
                         f"pair-components")
            phase("kernels", f"{name} K8 lag_sums_pair round {k} "
                  f"{str(dtype)[6:]} {mode}: {100 * b_ms / k_ms:.1f} % of "
                  f"its {b_ms:.3f} ms bound{split}")
            if k == 1:
                r = results[name][key]
                r["atoms"], r["plain_atoms"] = n_atoms, sa.shape[1]
            del x, xa, xb, sa, sb, library
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    finish_results(results)
    torch.cuda.empty_cache()

    # -- the sharded FFT at the deep shape over every 10th atom
    pos_d, vel_d, _ = deep_system
    nd = vel_d.shape[0]
    v10 = vel_d[:, ::FFT_STRIDE].astype(np.float64)
    r10 = pos_d[:, ::FFT_STRIDE].astype(np.float64)
    atoms10 = v10.shape[1]
    head = nd // 2
    got, _, _ = run_timed(
        f"sharded_acf_fft ({nd}, {atoms10}, 3) over {MESH_SHARDS} frame "
        "shards", lambda: sharded_fft.sharded_acf_fft(v10, frames),
        ["fft_level"])
    card_ref = ops.acf_fft(torch.from_numpy(v10).to(dev)).cpu().numpy()
    within("sharded_acf_fft", rel_err(got, card_ref, head), KERNEL_TOL,
           "ops.acf_fft on the card (lags < N/2)")
    within("sharded_acf_fft", rel_err(got, acf_fft_numpy(v10), head),
           HEAD_TOL, "host f64 (lags < N/2)")
    kept["fft"] = (got, card_ref)
    del got, card_ref
    got, _, _ = run_timed(
        f"sharded_msd_fft ({nd}, {atoms10}, 3) over {MESH_SHARDS} frame "
        "shards", lambda: sharded_fft.sharded_msd_fft(r10, frames),
        ["fft_level"])
    card_ref = ops.msd_fft(torch.from_numpy(r10).to(dev)).cpu().numpy()
    within("sharded_msd_fft", rel_err(got, card_ref, head), KERNEL_TOL,
           "ops.msd_fft on the card (lags < N/2)")
    within("sharded_msd_fft", rel_err(got, einstein_oracle(r10, 1), head),
           HEAD_TOL, "host f64 (lags < N/2)")
    del got, card_ref, v10, r10
    m = 2 * nd
    g = torch.Generator(device=dev).manual_seed(SEED)
    re, im = torch.randn((2, m, 256), dtype=torch.float64, device=dev,
                         generator=g)
    (zr, zi), _, _ = run_timed(
        f"sharded_fft forward ({m}, 256) complex128",
        lambda: sharded_fft.sharded_fft(re, im, frames), ["fft_level"])
    n2 = m // sharded_fft._pick_n1(m, MESH_SHARDS)
    k1, k2 = torch.arange(m, device=dev).div(n2, rounding_mode="floor"), \
        torch.arange(m, device=dev) % n2
    spectrum = torch.complex(zr.gather(), zi.gather())
    lib = torch.fft.fft(torch.complex(re, im), dim=0)[k2 * (m // n2) + k1]
    diff, scale = max_abs_diff(torch.view_as_real(spectrum),
                               torch.view_as_real(lib))
    within("sharded_fft forward, transposed order", diff / scale, KERNEL_TOL,
           "torch.fft.fft reindexed (row k1·N2 + k2 = frequency k2·N1 + k1)")
    del spectrum, lib
    (xr, xi), _, _ = run_timed(
        "sharded_fft inverse", lambda: sharded_fft.sharded_fft(
            zr, zi, frames, inverse=True), ["fft_level"])
    diff = max(max_abs_diff(xr.gather(), re)[0],
               max_abs_diff(xi.gather(), im)[0])
    within("sharded_fft forward + inverse", diff / float(re.abs().max()),
           KERNEL_TOL, "the input")
    del re, im, zr, zi, xr, xi
    torch.cuda.empty_cache()

    # -- sharded out of core from the files phase's TRR: the plain run
    # builds the spools, the sharded run reuses them
    ut = ta.Universe(files["pdb"], files["trr"])
    at = ut.select_atoms("resname ECA")
    for label, plain, shard, kwargs in (
            ("VACF", out_of_core.vacf_out_of_core,
             out_of_core.vacf_out_of_core_sharded, {}),
            ("Helfand", out_of_core.helfand_out_of_core,
             out_of_core.helfand_out_of_core_sharded, {"temp_avg": TEMP})):
        spool = os.path.join(tmp, f"spool_mesh_{label}")
        want = plain(at, spool, atom_chunk=SPOOL_CHUNK, **kwargs)
        got, _, _ = run_timed(
            f"{label.lower()}_out_of_core_sharded (spools of {SPOOL_CHUNK} "
            f"atoms, {MESH_SHARDS} frame shards)",
            lambda: shard(at, spool, frames, atom_chunk=SPOOL_CHUNK,
                          **kwargs), ["fft_level"])
        if label == "Helfand":
            got, want = got[0], want[0]
        equal = np.array_equal(got, want)
        within(f"{label.lower()}_out_of_core_sharded", rel_err(got, want),
               MESH_TOL, f"{label.lower()}_out_of_core",
               f" ({'bit-equal' if equal else 'not bit-equal'})")
        shutil.rmtree(spool)

    # -- a one-process NCCL group: the multi-process feed through it
    init = os.path.join(tmp, "nccl_init")
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0)
    try:
        gm = multihost.global_mesh(["cuda"] * MESH_SHARDS)
        sl = multihost.atom_shard_for_process(n_atoms, gm)
        feed = multihost.distribute_atom_block(vel[:, sl], n_atoms, gm)
        if not feed.distributed or len(feed.shards) != MESH_SHARDS:
            raise AssertionError("distribute_atom_block did not shard over "
                                 "the group")
        total = feed.psum(lambda s: s.double().square().sum(dim=(1, 2)))
        local = torch.from_numpy(vel).to(dev).double().square().sum(
            dim=(1, 2))
        equal = torch.equal(feed.gather().cpu(), torch.from_numpy(vel))
        within(f"NCCL ({dist.get_backend()}, world {dist.get_world_size()}): "
               f"atoms {sl.start} .. {sl.stop - 1} in {MESH_SHARDS} shards, "
               "all_reduce of Σ v²", rel_err(total.cpu(), local.cpu()),
               MESH_TOL, "the local sum",
               f"; all_gather of the shards equal to the feed: {equal}")
        if not equal:
            raise AssertionError("NCCL all_gather of the shards differs")
    finally:
        dist.destroy_process_group()
    phase(name, f"phase done in {time.perf_counter() - t_phase:.1f} s")
    return launches, results[name], kept


# A gloo child of the multiprocess phase: argv = rank, port, the data
# directory (the model system's float32 velocities and positions and every
# 10th atom of the deep system's velocities, as .npy), the repository.
# It imports no jax, takes its two blocks of a four-block global mesh on
# the card, runs the ring cases and the sharded VACF, and prints one
# MP_REPORT line: each run's wall, bytes sent to the other process,
# kernel launches and the SHA-256 of its result; rank 0 saves the
# results as .npy beside the data.
MP_CHILD = r"""
import hashlib, json, os, sys, time
rank, port, data, root = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist
from transport_analysis_tpu_torch.ops import cuda_fft, cuda_lag
from transport_analysis_tpu_torch.parallel import multihost, ring, sharded_fft
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "transport_analysis_tpu")]
if bad:
    raise SystemExit(f"child imported {bad}")
t_start = time.perf_counter()
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=rank)
mesh = multihost.global_mesh(["cuda"] * 2, "frames")
arrays = {k: np.load(os.path.join(data, k + ".npy")) for k in
          ("vel", "pos", "v10")}
cases = json.loads(sys.argv[5])
report = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
def timed(key, run, counter):
    counter.launches = 0
    sent = multihost.traffic.sent
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    report["runs"][key] = {
        "wall_s": wall, "sent_bytes": multihost.traffic.sent - sent,
        "launches": counter.launches,
        "sha256": hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest()}
    if rank == 0:
        np.save(os.path.join(data, f"mp_{key}.npy"), out)
for type_name, mode, sum_d in cases:
    x = torch.from_numpy(arrays["vel" if mode == "acf" else "pos"]).to(
        "cuda", getattr(torch, type_name))
    timed(f"{type_name}_{mode}_{sum_d}",
          lambda: ring.windowed_correlation_ring(x, mesh, mode=mode,
                                                 sum_d=sum_d),
          cuda_lag.lag_sums_pair)
    del x
timed("fft", lambda: sharded_fft.sharded_acf_fft(
    arrays["v10"].astype(np.float64), mesh), cuda_fft.fft_level)
dist.destroy_process_group()
report["process_wall_s"] = time.perf_counter() - t_start
report["sent_bytes"] = multihost.traffic.sent
print("MP_REPORT " + json.dumps(report), flush=True)
"""


# The traced model VACF run of the multiprocess phase's (d), in a process
# of its own: argv root, trace directory, frames, atoms. It builds the EC
# system as the model phase does, warms the run, traces it with
# utils.profiling.trace and prints one TRACE_REPORT line of the port's
# launches in the traced run.
TRACE_CHILD = r"""
import json, sys
root, log_dir, n, n_atoms = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
sys.path.insert(0, root)
import chip_smoke as cs
import transport_analysis_tpu_torch as ta
from transport_analysis_tpu_torch.ops import cuda_fft
from transport_analysis_tpu_torch.utils.profiling import trace
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "transport_analysis_tpu")]
if bad:
    raise SystemExit(f"child imported {bad}")
pos, vel, attrs = cs.ec_system(n, n_atoms // len(cs.EC_ATOMS))
ag = cs.ec_universe(ta, pos, vel, attrs).select_atoms("resname ECA")
ta.VelocityAutocorr(ag).run()                           # warm
counted = {k: getattr(cuda_fft, k) for k in
           ("fft_level", "unpack_power_inva", "inverse_last_level")}
for fn in counted.values():
    fn.launches = 0
with trace(log_dir):
    ta.VelocityAutocorr(ag).run()
print("TRACE_REPORT " + json.dumps({k: fn.launches
                                    for k, fn in counted.items()}),
      flush=True)
"""

def multiprocess_phase(torch, ta, counters, card, model, deep_system,
                       mesh_kept, tmp):
    """The sequence-parallel paths over meshes of several processes
    (module docstring): (a) the ring and the sharded VACF on a global mesh
    of a one-process NCCL group, (b) in two gloo child processes on the
    card, two blocks each, both against the mesh phase's one-process
    results (``mesh_kept``) and K8's serial sums; (c) the fused step and
    its mesh dry run on the card; (d) a model VACF run's stage timing
    against the card's own time of its ``_conclude``, and its trace.
    Returns the launches of its counted runs."""
    import glob
    import hashlib
    import re
    import shutil
    import socket

    import torch.distributed as dist

    from transport_analysis_tpu_torch import entry
    from transport_analysis_tpu_torch.parallel import (multihost, ring,
                                                       sharded_fft)

    name = "multiprocess"
    t_phase = time.perf_counter()
    pos, vel, attrs = model["system"]
    n, n_atoms = vel.shape[:2]
    v10 = deep_system[1][:, ::FFT_STRIDE]
    launches = {}

    def within(label, err, tol, against, extra=""):
        phase(name, f"{label} vs {against}: {err:.3e}{extra}")
        if not err <= tol:
            raise AssertionError(f"{label}: {err:.3e} from {against}, past "
                                 f"{tol}")

    def held(label, got, case):
        """``got`` (the ring case's or "fft"'s means) against the mesh
        phase's one-process result and K8's serial sums (``ops.acf_fft``
        for the FFT)."""
        base, ref = mesh_kept[case]
        got, base, ref = (torch.as_tensor(a).cpu() for a in (got, base, ref))
        f32 = case != "fft" and case[0] == "float32"
        equal = torch.equal(got, base)
        head = n if case != "fft" else got.shape[0] // 2
        diff, scale = max_abs_diff(got, base)
        within(label, diff / scale, F32_KERNEL_TOL if f32 else MESH_TOL,
               "the mesh phase's one-process run",
               f" ({'bit-equal' if equal else 'not bit-equal'})")
        diff, scale = max_abs_diff(got[:head], ref[:head])
        within(label, diff / scale,
               F32_KERNEL_TOL if f32 else
               (RING_TOL if case != "fft" else KERNEL_TOL),
               "K8's serial sums" if case != "fft"
               else "ops.acf_fft on the card (lags < N/2)")

    # -- (a) a one-process NCCL group: the global mesh takes the
    # one-process path, and nothing crosses a process
    init = os.path.join(tmp, "nccl_init_mp")
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0)
    try:
        gm = multihost.global_mesh(["cuda"] * MESH_SHARDS, "frames")
        sent = multihost.traffic.sent
        for type_name, mode, sum_d in RING_CASES:
            x = torch.from_numpy(vel if mode == "acf" else pos).to(
                "cuda", getattr(torch, type_name))
            label = (f"NCCL world 1 ring {type_name} {mode} sum_d={sum_d} "
                     f"on global_mesh(['cuda'] * {MESH_SHARDS}, 'frames')")
            got, count, wall = counted_run(
                torch, counters, lambda: ring.windowed_correlation_ring(
                    x, gm, mode=mode, sum_d=sum_d))
            key = "lag_sums_pair" + ("_f32" if type_name == "float32"
                                     else "")
            if count[key] != MESH_SHARDS * (MESH_SHARDS + 1) // 2:
                raise AssertionError(f"{label}: {count[key]} two-block "
                                     "launches")
            phase(name, f"{label}: wall {wall:.4f} s, {count[key]} "
                  f"two-block launches, on {card}")
            held(label, got, (type_name, mode, sum_d))
            launches[f"nccl_ring_{type_name}_{mode}_{sum_d}"] = count
            del x, got
        got, count, wall = counted_run(
            torch, counters,
            lambda: sharded_fft.sharded_acf_fft(v10.astype(np.float64), gm))
        label = (f"NCCL world 1 sharded_acf_fft ({v10.shape[0]}, "
                 f"{v10.shape[1]}, 3)")
        phase(name, f"{label}: wall {wall:.4f} s, fft_level launches "
              f"{count['fft_level']}, on {card}")
        if count["fft_level"] < 1:
            raise AssertionError(f"{label}: K1 not launched")
        held(label, got, "fft")
        launches["nccl_fft"] = count
        if multihost.traffic.sent != sent:
            raise AssertionError("a one-process group sent bytes")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # -- (b) two gloo processes on the one card, two blocks each; the
    # kernels' library is built (build phase), so no child runs nvcc
    data = os.path.join(tmp, "mp_data")
    os.makedirs(data)
    for key, arr in (("vel", vel), ("pos", pos), ("v10", v10)):
        np.save(os.path.join(data, key + ".npy"), np.ascontiguousarray(arr))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    child = os.path.join(tmp, "mp_child.py")
    with open(child, "w") as fh:
        fh.write(MP_CHILD)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, child, str(rank), port, data, ROOT,
         json.dumps(RING_CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(MP_RANKS)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MP_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    reports = []
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MP_REPORT ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"gloo child {rank} failed "
                                 f"({proc.returncode}):\n{out[-4000:]}")
        reports.append(json.loads(lines[-1][len("MP_REPORT "):]))
    phase(name, f"{MP_RANKS} gloo processes ({reports[0]['backend']}) on "
          f"the one card: {wall:.1f} s from start to exit; each process's "
          f"wall {[round(r['process_wall_s'], 3) for r in reports]} s, "
          f"bytes sent to the other {[r['sent_bytes'] for r in reports]}, "
          f"on {card}")
    for key in reports[0]["runs"]:
        runs_ = [r["runs"][key] for r in reports]
        if len({r["sha256"] for r in runs_}) != 1:
            raise AssertionError(f"gloo {key}: the ranks' results differ")
        total = sum(r["launches"] for r in runs_)
        if key == "fft":
            case, launched = "fft", total >= 1
        else:
            type_name, mode, sum_d = key.split("_")
            case = (type_name, mode, sum_d == "True")
            launched = total == MESH_SHARDS * (MESH_SHARDS + 1) // 2
        if not launched:
            raise AssertionError(f"gloo {key}: {total} launches in the "
                                 "children")
        phase(name, f"gloo {key}: walls "
              f"{[round(r['wall_s'], 4) for r in runs_]} s, bytes sent "
              f"{[r['sent_bytes'] for r in runs_]}, launches "
              f"{[r['launches'] for r in runs_]}, the ranks' results "
              f"bit-equal")
        got = np.load(os.path.join(data, f"mp_{key}.npy"))
        if hashlib.sha256(got.tobytes()).hexdigest() != runs_[0]["sha256"]:
            raise AssertionError(f"gloo {key}: saved result differs")
        held(f"gloo {key}", got, case)
        del got
    shutil.rmtree(data)

    # -- (c) the fused step on the card against its CPU run, and the mesh
    # dry run on the card
    args = entry.example_args("cuda")
    out, count, wall = counted_run(torch, counters,
                                   lambda: entry.analysis_step(*args))
    missing = [key for key in ("fft_level", "unpack_power_inva",
                               "inverse_last_level", "kneller_totals",
                               "kneller_windows") if count[key] < 1]
    if missing:
        raise AssertionError(f"analysis_step: kernels not launched: "
                             f"{missing}")
    launches["analysis_step"] = count
    want = entry.analysis_step(*entry.example_args("cpu"))
    for label, g, w in zip(("vacf", "diffusivity", "helfand", "viscosity",
                            "msd"), out, want):
        g = g.cpu()
        err = float((g - w).abs().max() / w.abs().max())
        within(f"analysis_step {label} on the card", err, STEP_TOL,
               "its CPU run")
    phase(name, f"analysis_step: wall {wall:.4f} s, launches "
          f"{ {k: c for k, c in count.items() if c} }")
    t0 = time.perf_counter()
    entry.dryrun_multichip(MESH_SHARDS)
    phase(name, f"entry.dryrun_multichip({MESH_SHARDS}) on the card: "
          f"passed in {time.perf_counter() - t0:.2f} s")

    # -- (d) a model VACF run's stage timing against the card's own time
    # of its _conclude, then the same run traced
    u = ec_universe(ta, pos, vel, attrs)
    ag = u.select_atoms("resname ECA")
    ta.VelocityAutocorr(ag).run()                           # warm
    vacf = ta.VelocityAutocorr(ag)
    conclude = vacf._conclude
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed_conclude():
        start.record()
        conclude()
        end.record()

    vacf._conclude = timed_conclude
    for fn in counters.values():
        fn.launches = 0
    vacf.run()
    torch.cuda.synchronize()
    launches["timed_vacf"] = {k: fn.launches for k, fn in counters.items()}
    timing = vacf.timing.as_dict()
    event_ms = start.elapsed_time(end)
    phase(name, f"VelocityAutocorr timing {timing}; _conclude on the card "
          f"{event_ms:.3f} ms (CUDA events), on {card}")
    if not 1e3 * timing["compute"] >= event_ms > 0:
        raise AssertionError(f"timing compute {1e3 * timing['compute']:.3f}"
                             f" ms under the card's {event_ms:.3f} ms")
    # the same run traced in a fresh process: late in a process that has
    # held many profiler sessions, as this one has, the CUDA tracer can
    # lose every kernel record of a session
    log_dir = os.path.join(tmp, "trace")
    child = os.path.join(tmp, "trace_child.py")
    with open(child, "w") as fh:
        fh.write(TRACE_CHILD)
    proc = subprocess.run([sys.executable, child, ROOT, log_dir, str(n),
                           str(n_atoms)], capture_output=True, text=True,
                          timeout=MP_TIMEOUT)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("TRACE_REPORT ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"trace child failed ({proc.returncode}):\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    traced = json.loads(lines[-1][len("TRACE_REPORT "):])
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    csrc = set()
    for src in sorted(glob.glob(os.path.join(ROOT, CSRC, "*.cu"))):
        with open(src) as fh:
            csrc.update(re.findall(r"__global__.{0,80}?\b(\w+_kernel)\b",
                                   fh.read(), re.S))
    seen = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            for kname in csrc:
                if re.search(rf"\b{kname}\b", ev.get("name", "")):
                    seen[kname] = seen.get(kname, 0) + 1
    phase(name, f"trace {os.path.getsize(path)} bytes: port kernels by "
          f"their csrc names {dict(sorted(seen.items()))}; the wrappers "
          f"counted {traced}")
    for need in ("fft_level", "unpack_power_inva_kernel",
                 "inverse_last_level"):
        if not any(need in kname for kname in seen):
            raise AssertionError(f"trace: no {need} kernel event")
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
    from transport_analysis_tpu_torch.ops import (cuda_fft, cuda_kneller,
                                                  cuda_lag)
    from transport_analysis_tpu_torch.ops.acf import (acf_fft_numpy,
                                                      auto_atom_chunk)

    build_phase(_build)
    t0 = time.perf_counter()
    kernel_results = kernels_phase(torch, cuda_fft, cuda_kneller, cuda_lag)
    kernel_results.update(kernels_f32_phase(torch, cuda_fft, cuda_kneller,
                                            cuda_lag, auto_atom_chunk))
    phase("kernels", f"phase done in {time.perf_counter() - t0:.1f} s")
    counters = {
        "fft_level": cuda_fft.fft_level,
        "unpack_power_inva": cuda_fft.unpack_power_inva,
        "inverse_last_level": cuda_fft.inverse_last_level,
        "kneller_totals": cuda_kneller.kneller_totals,
        "kneller_windows": cuda_kneller.kneller_windows,
        "lag_sums": cuda_lag.lag_sums,
        "lag_sums_pair": cuda_lag.lag_sums_pair,
    }
    counters.update({f"{key}_f32": F32Launches(fn)
                     for key, fn in list(counters.items())})
    launches = {}
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name, n, n_molecules, stride in MODEL_PHASES:
            launches[name], walls, system, kept = model_phase(
                torch, ta, acf_fft_numpy, counters, smi, name, n,
                n_molecules, stride)
            torch.cuda.empty_cache()
            if name in F32_PHASES:
                launches[f"{name}_f32"] = f32_phase(
                    torch, ta, counters, smi, name, system, kept, stride)
                torch.cuda.empty_cache()
            if name == "model":
                files = files_phase(torch, ta, acf_fft_numpy, counters, smi,
                                    system, walls, tmp)
                torch.cuda.empty_cache()
                model = {"system": system, "kept": kept}
            elif name == "deep":
                kept["system"] = system
                stream_phase(torch, ta, acf_fft_numpy, counters, smi, kept,
                             files, tmp)
                torch.cuda.empty_cache()
                launches["mesh"], pair_results, mesh_kept = mesh_phase(
                    torch, ta, cuda_lag, counters, smi, model, system, files,
                    tmp)
                kernel_results.update(pair_results)
                torch.cuda.empty_cache()
                launches["multiprocess"] = multiprocess_phase(
                    torch, ta, counters, smi, model, system, mesh_kept, tmp)
                torch.cuda.empty_cache()
                del files, model, mesh_kept
            del system, kept
    if any(mod == "jax" or mod.startswith("jax.") for mod in sys.modules):
        raise AssertionError("jax was imported")
    phase("done", f"all phases in {time.perf_counter() - t_start:.1f} s")

    # launches from the deep phase's timed runs, those of the float32
    # instantiations from the f32 phase's at the deep shape, the two-block
    # launch's from the mesh phase's ring runs
    def main_launches(name):
        if name.startswith("lag_sums_pair"):
            return launches["mesh"]["ring_f32" if name.endswith("_f32")
                                    else "ring"][name]
        return launches["deep_f32" if name.endswith("_f32") else "deep"][
            "windowed" if name.startswith("lag_sums") else "fft"][name]

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": main_launches(name), **kernel_results[name]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Out-of-core correlation for trajectories larger than host memory.

Counterpart of ``transport_analysis_tpu/parallel/out_of_core.py``. The
dense (frames, atoms, 3) block is impossible at 100k atoms × 1M frames
(~2.4 TB as float64), so the run takes two streaming passes:

pass 1 — decode: frame blocks stream through the prefetch pipeline
  (``io.prefetch``, a background decode thread) and are scattered into
  per-atom-chunk *spool* files on disk, each an (n_frames, chunk, d)
  float32 ``.npy`` — a blocked on-disk transpose from frame-major to
  chunk-major.

pass 2 — correlate: each spool is read whole (on a reader thread, one
  spool ahead), copied to the device, correlated by the kernels there and
  summed over its particles on the device; the (L,) sums accumulate in
  float64 on the host. Device and host memory stay bounded by the chunk.

The spools and their names are the JAX package's (``{field}_chunk
{c:05d}.f32``, the ``{field}.complete`` marker, ``{field}_aux.npz``), so
either package reads the other's spools; pass 2 checkpoints after every
spool. The ``*_sharded`` functions correlate each spool with the frame
axis sharded over a mesh (``parallel.sharded_fft``). The Helfand spools hold m·v·x rounded to float32, as the JAX
package's do: ``helfand_out_of_core`` is float32 grade by design (about
1e-5 relative to the in-memory ``ViscosityHelfand``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..io.prefetch import prefetch_batches
from ..utils.errors import NoDataError
from .streaming import to_host


def build_spools(
    reader,
    frames: Sequence[int],
    atom_indices: np.ndarray,
    dim: Sequence[int],
    spool_dir: str,
    atom_chunk: int,
    field: str = "velocities",
    frame_block: int = 1024,
    transform=None,
    aux: Sequence[str] = (),
) -> list[str]:
    """Pass 1: stream-decode ``frames`` and scatter into spool files.

    ``field`` names the spools; by default it is also the batch key to
    spool. ``transform(batch) → (nb, n_selected_atoms, d)`` overrides
    the per-block extraction — this is how derived accumulators (the
    Helfand m·v·x) spool without materializing their factors twice.
    ``aux`` lists per-frame scalar batch keys (e.g. ``volumes``) to
    collect across the whole pass; they are persisted next to the
    spools (``{field}_aux.npz``, see :func:`load_aux`) so resumed runs
    skip the decode entirely.

    Returns the spool paths (one per atom chunk). Existing complete
    spools are reused (resume support).
    """
    os.makedirs(spool_dir, exist_ok=True)
    n_frames = len(frames)
    atom_indices = np.asarray(atom_indices)
    n_atoms = len(atom_indices)
    d = len(dim)
    n_chunks = -(-n_atoms // atom_chunk)

    if transform is None:
        def transform(batch):  # noqa: F811 — default extraction
            return batch[field][:, atom_indices][:, :, dim]

    paths = [
        os.path.join(spool_dir, f"{field}_chunk{c:05d}.f32")
        for c in range(n_chunks)
    ]
    marker = os.path.join(spool_dir, f"{field}.complete")
    if os.path.exists(marker):
        return paths

    mmaps = []
    for c, path in enumerate(paths):
        width = min(atom_chunk, n_atoms - c * atom_chunk)
        mmaps.append(
            np.lib.format.open_memmap(
                path,
                mode="w+",
                dtype=np.float32,
                shape=(n_frames, width, d),
            )
        )

    aux_acc: dict[str, list] = {k: [] for k in aux}
    row = 0
    for batch in prefetch_batches(reader, frames, block_size=frame_block):
        data = np.asarray(transform(batch))
        nb = data.shape[0]
        for c, mm in enumerate(mmaps):
            lo = c * atom_chunk
            hi = min(lo + atom_chunk, n_atoms)
            mm[row:row + nb] = data[:, lo:hi]
        for k in aux:
            aux_acc[k].append(np.asarray(batch[k]))
        row += nb
    for mm in mmaps:
        mm.flush()
    del mmaps
    if aux:
        np.savez(
            os.path.join(spool_dir, f"{field}_aux.npz"),
            **{k: np.concatenate(v) for k, v in aux_acc.items()},
        )
    with open(marker, "w") as fh:
        fh.write("ok\n")
    return paths


def load_aux(spool_dir: str, field: str) -> dict:
    """Per-frame scalars collected during :func:`build_spools` pass 1."""
    with np.load(os.path.join(spool_dir, f"{field}_aux.npz")) as z:
        return {k: z[k] for k in z.files}


def device_f64(block, device) -> torch.Tensor:
    """A float32 spool block copied to ``device`` and upcast there
    (exactly): half the host-to-device bytes of a host-side upcast. The
    port's own spool kernels take :func:`device_f32` into the
    ``*_from_f32`` entries; this one stays as the counterpart of the JAX
    package's ``device_f64``, for a caller's kernel that wants a float64
    operand."""
    return torch.from_numpy(np.ascontiguousarray(block)).to(
        resolve_device(device)).to(torch.float64)


def device_f32(block, device) -> torch.Tensor:
    """A float32 spool block copied to ``device`` as it is, for the
    float64-grade ``*_from_f32`` entries, which upcast it there."""
    return torch.from_numpy(
        np.ascontiguousarray(block, dtype=np.float32)).to(
        resolve_device(device))


def correlate_spools(
    kernel,
    paths: Sequence[str],
    n_particles: int,
    checkpoint: Optional[str] = None,
    prefetch: bool = True,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Pass 2: run ``kernel((N, chunk, d) array) → (L,) or (L, chunk)``
    over each spool and return the particle-mean timeseries (L,).

    Kernels should sum over the particles on the device and return (L,):
    reading back the per-atom curves costs L×chunk×8 bytes a chunk against
    L×8. A 2-D (L, chunk) result is still accepted and summed on the host.
    A tensor result is copied back.

    ``prefetch`` reads spool c+1 on a background thread while the device
    correlates chunk c (host memory holds at most two chunks). The reader
    thread only reads files: every copy to the device happens in
    ``kernel``, on the calling thread.

    ``stats``: pass a dict to receive per-chunk walls: ``read_s`` (disk
    read per spool, on the reader thread), ``stall_s`` (time the consumer
    waited for its block — the part of the read NOT hidden under compute),
    ``kernel_s`` (copy, correlation and read-back per chunk). With
    prefetch, the feed-overlap fraction is 1 - sum(stall)/sum(read).
    """
    acc = None
    start = 0
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as state:
            if int(state["n_particles"]) == n_particles:
                acc = state["acc"]
                start = int(state["next_spool"])

    read_s: list = []
    stall_s: list = []
    kernel_s: list = []

    def _read(c):
        # one sequential read of the whole spool (no mmap page faults
        # while the device works): one contiguous buffer to copy
        t0 = time.perf_counter()
        with open(paths[c], "rb") as fh:
            out = np.lib.format.read_array(fh)
        read_s.append(time.perf_counter() - t0)
        return out

    todo = range(start, len(paths))
    if prefetch and len(todo) > 1:
        q: queue.Queue = queue.Queue(maxsize=1)

        def loop():
            for c in todo:
                q.put(_read(c))

        threading.Thread(target=loop, daemon=True).start()

        def _get():
            t0 = time.perf_counter()
            out = q.get()
            stall_s.append(time.perf_counter() - t0)
            return out

        blocks = (_get() for _ in todo)
    else:
        blocks = (_read(c) for c in todo)

    for c, block in zip(todo, blocks):
        t0 = time.perf_counter()
        result = to_host(kernel(block))
        kernel_s.append(time.perf_counter() - t0)
        del block
        if acc is None:
            acc = np.zeros(result.shape[0], np.float64)
        acc += result if result.ndim == 1 else result.sum(axis=1)
        del result
        if checkpoint:
            tmp = checkpoint + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, acc=acc, next_spool=c + 1,
                         n_particles=n_particles)
            os.replace(tmp, checkpoint)
    if stats is not None:
        stats["read_s"] = read_s
        stats["stall_s"] = stall_s
        stats["kernel_s"] = kernel_s
    return acc / max(n_particles, 1)


def _auto_chunk(atom_chunk, n_frames: int, d: int, device) -> int:
    """Resolve atom_chunk="auto" via ops.acf.auto_atom_chunk (the port's
    device-memory model); integer values pass through unchanged."""
    if atom_chunk == "auto":
        from ..ops.acf import auto_atom_chunk

        return auto_atom_chunk(n_frames, d=d, device=device)
    return int(atom_chunk)


def _resolve(universe_or_ag, start, stop, step):
    from ..core.groups import AtomGroup

    ag = (
        universe_or_ag
        if isinstance(universe_or_ag, AtomGroup)
        else universe_or_ag.atoms
    )
    reader = ag.universe.trajectory
    s, e, st = reader.check_slice_indices(start, stop, step)
    return ag, reader, np.arange(s, e, st)


def _particle_sums(out: torch.Tensor, max_lag) -> torch.Tensor:
    """(N, chunk) per-particle curves → their (L,) sum on the device."""
    if max_lag:
        out = out[:max_lag]
    return out.sum(dim=1)


def vacf_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
    device=None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """End-to-end out-of-core VACF: file → spools → device → timeseries.

    Returns the particle-averaged VACF (max_lag or n_frames long).
    ``device``: the CUDA card by default, the CPU as ``"cpu"``; ``stats``
    as in :func:`correlate_spools`.
    """
    from .. import ops

    dev = resolve_device(device)
    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim), dev)
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="velocities",
    )

    def kernel(block):
        # spool blocks are float32 trajectory samples: the float64-grade
        # entry upcasts them on the device
        return _particle_sums(ops.acf_fft_from_f32(device_f32(block, dev)),
                              max_lag)

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint, stats=stats
    )


def _mvx_spools(ag, reader, frames, dim, spool_dir, atom_chunk):
    """Pass 1 of the Helfand runs: spool m·v·x, formed in float64 on the
    host and rounded to float32 by the spool, with the per-frame volumes
    and times; returns the paths and the mean volume."""
    masses = np.asarray(ag.masses, np.float64)
    indices = ag.indices
    dim = list(dim)

    def transform(batch):
        v = batch["velocities"][:, indices][:, :, dim]
        x = batch["positions"][:, indices][:, :, dim]
        return masses[None, :, None] * v.astype(np.float64) * x

    paths = build_spools(
        reader, frames, indices, dim, spool_dir, atom_chunk,
        field="mvx", transform=transform, aux=("volumes", "times"),
    )
    volumes = load_aux(spool_dir, "mvx")["volumes"]
    if np.any(volumes == 0.0):
        raise NoDataError(
            "viscosity computation requires a nonzero box volume in "
            "every frame (matches ViscosityHelfand's in-memory check)"
        )
    return paths, float(np.mean(volumes))


def helfand_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    temp_avg: float = 300.0,
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
    linear_fit_window: Optional[tuple] = None,
    device=None,
    stats: Optional[dict] = None,
):
    """Out-of-core Einstein–Helfand viscosity function (and slope).

    Pass 1 spools the *derived accumulator* m·v·x — one float32 stream
    instead of separate velocity/position spools — and collects per-
    frame box volumes; pass 2 runs the FFT lag-difference kernels per
    atom chunk. Mirrors ``ViscosityHelfand`` semantics (mean over
    components, ÷ 2·k_B·⟨V⟩·T, lag-0 row ≡ 0; reference
    viscosity.py:201-245), at float32 grade: the spool rounds m·v·x.

    Returns ``(timeseries, viscosity_or_None)``.
    """
    from .. import ops
    from ..utils.units import constants

    dev = resolve_device(device)
    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim), dev)
    paths, vol_avg = _mvx_spools(ag, reader, frames, dim, spool_dir,
                                 atom_chunk)

    def kernel(block):
        return _particle_sums(ops.einstein_difference_fft_from_f32(
            device_f32(block, dev), "mean"), max_lag)

    raw = correlate_spools(kernel, paths, len(ag), checkpoint=checkpoint,
                           stats=stats)
    k_B = constants["Boltzmann_constant"]
    timeseries = raw / (2.0 * k_B * vol_avg * temp_avg)

    viscosity = None
    if linear_fit_window is not None:
        lo, hi = linear_fit_window
        lagtimes = np.arange(len(timeseries), dtype=np.float64)
        slope, _ = np.polyfit(lagtimes[lo:hi], timeseries[lo:hi], 1)
        viscosity = slope
    return timeseries, viscosity


def msd_out_of_core(
    universe_or_ag,
    spool_dir: str,
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    max_lag: Optional[int] = None,
    checkpoint: Optional[str] = None,
    device=None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Out-of-core Einstein MSD (components summed, matching
    ``EinsteinMSD`` / tidynamics.msd semantics)."""
    from .. import ops

    dev = resolve_device(device)
    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim), dev)
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="positions",
    )

    def kernel(block):
        return _particle_sums(ops.einstein_difference_fft_from_f32(
            device_f32(block, dev), "sum"), max_lag)

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint, stats=stats
    )


def vacf_out_of_core_sharded(
    universe_or_ag,
    spool_dir: str,
    mesh,
    axis_name: str = "frames",
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    start=None,
    stop=None,
    step=None,
    checkpoint: Optional[str] = None,
    stats: Optional[dict] = None,
) -> np.ndarray:
    """Out-of-core VACF with the FFT frame axis sharded over a mesh: atoms
    stream through disk spools (host memory bound), frames shard over the
    mesh's devices (device memory bound), and each chunk's correlation
    runs the four-step distributed FFT (``parallel/sharded_fft.py``).
    ``atom_chunk='auto'`` sizes the chunk for the mesh's first device;
    ``stats`` as in :func:`correlate_spools`.

    Per-lag normalization matches :func:`vacf_out_of_core`; the two agree
    at float64 rounding."""
    from .sharded_fft import sharded_acf_fft

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim),
                             mesh.devices[0])
    paths = build_spools(
        reader, frames, ag.indices, list(dim), spool_dir, atom_chunk,
        field="velocities",
    )

    def kernel(block):
        # particle sum on the host of the (L, chunk) curves, as the JAX
        # package's kernel does
        return sharded_acf_fft(np.asarray(block, dtype=np.float64), mesh,
                               axis_name).sum(axis=1)

    return correlate_spools(
        kernel, paths, len(ag), checkpoint=checkpoint, stats=stats
    )


def helfand_out_of_core_sharded(
    universe_or_ag,
    spool_dir: str,
    mesh,
    axis_name: str = "frames",
    atom_chunk='auto',
    dim: Sequence[int] = (0, 1, 2),
    temp_avg: float = 300.0,
    start=None,
    stop=None,
    step=None,
    checkpoint: Optional[str] = None,
    linear_fit_window: Optional[tuple] = None,
    stats: Optional[dict] = None,
):
    """Out-of-core Einstein–Helfand viscosity with the FFT frame axis
    sharded over a mesh: the m·v·x spools of :func:`helfand_out_of_core`,
    each chunk's Einstein lag-difference curve from the distributed
    four-step FFT (``sharded_fft.sharded_msd_fft`` with the Helfand
    component mean). Semantics match :func:`helfand_out_of_core`.

    Returns ``(timeseries, viscosity_or_None)``."""
    from .sharded_fft import sharded_msd_fft
    from ..utils.units import constants

    ag, reader, frames = _resolve(universe_or_ag, start, stop, step)
    atom_chunk = _auto_chunk(atom_chunk, len(frames), len(dim),
                             mesh.devices[0])
    paths, vol_avg = _mvx_spools(ag, reader, frames, dim, spool_dir,
                                 atom_chunk)

    def kernel(block):
        return sharded_msd_fft(np.asarray(block, dtype=np.float64), mesh,
                               axis_name, reduce_mode="mean").sum(axis=1)

    raw = correlate_spools(kernel, paths, len(ag), checkpoint=checkpoint,
                           stats=stats)
    k_B = constants["Boltzmann_constant"]
    timeseries = raw / (2.0 * k_B * vol_avg * temp_avg)

    viscosity = None
    if linear_fit_window is not None:
        lo, hi = linear_fit_window
        lagtimes = np.arange(len(timeseries), dtype=np.float64)
        slope, _ = np.polyfit(lagtimes[lo:hi], timeseries[lo:hi], 1)
        viscosity = slope
    return timeseries, viscosity

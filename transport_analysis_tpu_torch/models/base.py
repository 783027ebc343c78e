"""Analysis runtime: the engine that drives trajectory analyses.

Counterpart of ``transport_analysis_tpu/models/base.py``. Re-provides the
``MDAnalysis.analysis.base.AnalysisBase`` template-method contract the
reference plugs into (SURVEY.md §1 L2): ``run(start, stop, step, frames,
verbose)`` drives ``_prepare()`` → per-frame work → ``_conclude()``,
exposing ``n_frames``, ``times``, ``frames``, ``_frame_index``, ``_ts``
and a dict-like ``results``.

Subclasses that implement ``_process_batch`` receive the entire strided
frame selection as stacked arrays in one ``read_frames_batch`` call; the
per-frame ``_single_frame`` hook remains, for subclasses written against
the MDAnalysis API and as the explicit ``engine="frame"`` parity mode.
With ``frame_block=`` the selection arrives in blocks of that many frames,
decoded on a background thread (``io.prefetch``), and each block is
copied into a :class:`DeviceSeriesBuffer` on the analysis's device, so the
host holds one decoded block at a time.

Every run records ``analysis.timing`` (``utils.profiling.StageTimer`` on
the analysis's device): "io" around the feed, "compute" around
``_conclude``, the frame, particle and lag counters of its throughputs,
its ``run_id`` and the bytes its host copies moved (``counts()``). The
run is a ``ta.run.<run_id>`` span; the feed's reads are ``ta.feed.read``
and its selections ``ta.feed.select`` spans (``utils.profiling.span``).

The analyses with per-particle results (VACF, Helfand, MSD) correlate
through :meth:`AnalysisBase._per_particle`: the whole selection at once,
its particle shards under a mesh, or atom chunks
(``parallel.streaming``), given by ``atom_chunk`` or chosen by the run
itself where the whole FFT run would not fit the device's budget.

From the second run on a card over one ``MemoryReader`` on, each of its
arrays that a run copies to the card whole, as views of it (the whole
selection, or frame blocks), is page-locked in place, whole and once
(``_host_pool.ReaderStores``), so its copies cross by DMA; the reader's
collection unregisters them. The first run keeps the pageable copy: a
registration costs about as much as one pageable copy of the array, so
only a repeat pays it back.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import _host_pool
from .._device import h2d, resolve_device, to_host, work_types
from ..core.trajectory import MemoryReader, take_axis
from ..ops import acf
from ..parallel.mesh import current_mesh
from ..parallel.sharding import map_particles
from ..parallel.streaming import chunked_per_particle, particle_block
from ..utils.profiling import StageTimer, count, span

NO_F32_SOURCE_ENV = "TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE"


def source_cast(arr, work_dtype, keep_f32: bool) -> np.ndarray:
    """f32-exact source handling for model feed buffers: float32 samples
    stay float32 under a float64 work dtype when ``keep_f32`` (the
    analysis resolves it once, in ``_prepare``); otherwise cast to the
    work dtype."""
    arr = np.asarray(arr)
    work_dtype = np.dtype(work_dtype)
    if keep_f32 and work_dtype == np.float64 and arr.dtype == np.float32:
        return arr
    return arr if arr.dtype == work_dtype else arr.astype(work_dtype)


def select_series(block, indices, dim) -> np.ndarray:
    """The atoms ``indices`` and components ``dim`` of an
    (N, n_atoms, 3) frame block, as a C-contiguous (N, n_sel, len(dim))
    array ready for the host-to-device copy (no copy at all for a whole
    universe in xyz)."""
    return np.ascontiguousarray(
        take_axis(take_axis(block, indices, 1), dim, 2))


class DeviceSeriesBuffer:
    """Assembles an (n_frames, …) series on ``device`` from host frame
    blocks: the host holds one decoded block at a time while the whole
    selection accumulates on the device. One ``torch.empty`` of ``shape``
    whose dtype is the first block's (float32 samples stay float32 under
    the f32-source mode); each block is copied into its rows."""

    def __init__(self, shape, dtype, device):
        self._buf = torch.empty(shape, dtype=work_types(dtype)[0],
                                device=device)

    def write(self, block: np.ndarray, offset: int) -> None:
        nb = block.shape[0]
        with h2d(block, self._buf.device):
            self._buf[offset:offset + nb].copy_(torch.from_numpy(block))

    def array(self) -> torch.Tensor:
        return self._buf


class Results(dict):
    """dict with attribute access (MDAnalysis ``Results`` parity;
    consumed by the reference at velocityautocorr.py:121-125)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as err:
            raise AttributeError(
                f"'Results' object has no attribute '{key}'"
            ) from err

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as err:
            raise AttributeError(
                f"'Results' object has no attribute '{key}'"
            ) from err


class AnalysisBase:
    """``device``: where the analysis computes — the CUDA (Hopper) card by
    default, which raises where there is none, or the CPU when asked for
    as ``"cpu"``. Subclasses check their own arguments before calling
    this, so a bad argument raises its own error on a machine with no
    card."""

    def __init__(self, trajectory, verbose: bool = False, engine=None,
                 frame_block: Optional[int] = None, device=None, **kwargs):
        self._trajectory = trajectory
        self._verbose = verbose
        if engine not in (None, "batch", "frame"):
            raise ValueError("engine must be 'batch' or 'frame'")
        self._engine = engine
        if frame_block is not None and frame_block < 1:
            raise ValueError("frame_block must be a positive int")
        self._frame_block = frame_block
        self.device = resolve_device(device)
        self.results = Results()

    # --- frame bookkeeping ----------------------------------------------------
    def _setup_frames(
        self, trajectory, start=None, stop=None, step=None, frames=None
    ):
        if frames is not None:
            if not (start is None and stop is None and step is None):
                raise ValueError(
                    "start/stop/step cannot be combined with frames"
                )
            frames = np.asarray(frames)
            if frames.dtype == bool:
                frames = np.flatnonzero(frames)
            frame_indices = frames.astype(np.int64)
            self.start = self.stop = self.step = None
        else:
            start, stop, step = trajectory.check_slice_indices(
                start, stop, step
            )
            self.start, self.stop, self.step = start, stop, step
            frame_indices = np.arange(start, stop, step, dtype=np.int64)
        self.frames = frame_indices
        self.n_frames = len(frame_indices)
        self.times = np.zeros(self.n_frames, dtype=np.float64)

    # --- subclass hooks ---------------------------------------------------------
    def _prepare(self):
        """Per-run set-up. Reads the f32-source opt-out once, so every
        block of one analysis is fed the same way: float32 samples cross
        to the device as float32 and are upcast there, exactly, unless
        ``TRANSPORT_ANALYSIS_TPU_NO_F32_SOURCE`` is set, which upcasts
        them on the host; the results are identical either way. Counts
        the run on its trajectory (:meth:`_repeat_stores`)."""
        self._keep_f32 = not os.environ.get(NO_F32_SOURCE_ENV)
        self._buffers = {}
        self._stores = self._repeat_stores()

    def _select(self, block, indices) -> np.ndarray:
        """The feed of the atoms ``indices`` of an (N, n_atoms, 3) frame
        block in the analysis's components (``self._dim``):
        :func:`select_series`, then :func:`source_cast`, in a
        ``ta.feed.select`` span; a new host array's bytes count as the
        run's ``select_bytes``. A view that the run copies to the card
        whole (no atom chunk and no mesh, or frame blocks) page-locks the
        reader's array it lies in where :meth:`_repeat_stores` gave
        them."""
        with span("ta.feed.select"):
            out = source_cast(select_series(block, indices, self._dim),
                              self._work_dtype, self._keep_f32)
            if not np.may_share_memory(out, block):
                count("select_bytes", out.nbytes)
                return out
        if self._stores is not None and (
                self._frame_block is not None
                or (current_mesh() is None and not self._run_chunk())):
            reader = self._trajectory
            for attr in ("positions", "velocities", "forces"):
                array = reader.get_array(attr)
                if array is not None and np.may_share_memory(out, array):
                    self._stores.pin(array)
        return out

    def _repeat_stores(self):
        """The page-locked arrays (``_host_pool.reader_stores``) of the
        run's trajectory where the run is on a card and the trajectory a
        ``MemoryReader`` that an earlier run on a card read; else None.
        This run's count is taken here."""
        reader = self._trajectory
        if self.device.type != "cuda" or not isinstance(reader,
                                                        MemoryReader):
            return None
        stores = _host_pool.reader_stores(reader)
        return stores if stores.count_run() > 1 else None

    def _feed_block(self, key, batch, indices, offset) -> None:
        """Frame-blocked feed: the block ``batch[key]`` of the atoms
        ``indices`` in the analysis's components (``self._dim``), copied
        into the device buffer ``self._<key>`` at row ``offset``; the
        buffer is made at the first block, with that block's dtype, and
        released when the run has concluded."""
        block = self._select(batch[key], indices)
        if offset == 0:
            self._buffers[key] = DeviceSeriesBuffer(
                (self.n_frames, len(indices), len(self._dim)), block.dtype,
                self.device)
        self._buffers[key].write(block, offset)
        setattr(self, "_" + key, self._buffers[key].array())

    def _run_chunk(self) -> Optional[int]:
        """The atom chunk this run correlates by: ``atom_chunk`` where
        given; else, on the FFT path with no mesh current, where the
        whole run's ``ops.acf.chunk_peak_bytes`` (frames N, particles P,
        components d, the work dtype) is past ``ops.acf.device_budget_gb``
        of the device, ``ops.acf.auto_atom_chunk``'s; else None, the
        whole run at once. (The windowed path reckons far less.) For the
        analyses that set ``fft``, ``atom_chunk``, ``dim_fac``,
        ``n_particles`` and ``_work_dtype``."""
        if self.atom_chunk:
            return self.atom_chunk
        if not self.fft or current_mesh() is not None:
            return None
        n, d, dtype = self.n_frames, self.dim_fac, self._work_dtype
        budget = acf.device_budget_gb(self.device)
        if acf.chunk_peak_bytes(n, self.n_particles, d, dtype) <= budget * 1e9:
            return None
        return acf.auto_atom_chunk(n, d, hbm_budget_gb=budget, dtype=dtype,
                                   device=self.device)

    def _per_particle(self, kernel, series, piece=None, divisor=None):
        """(timeseries (L,), by_particle (L, P)) of ``kernel`` ((N, p, d)
        tensor → (L, p)) over the particles of ``series`` (N, P, d), as
        host arrays, both divided by ``divisor`` where given: in the
        atom chunks of :meth:`_run_chunk` (``parallel.streaming``;
        ``checkpoint`` with an explicit ``atom_chunk`` only; float64
        accumulators), else on each particle shard of the current mesh
        (``piece`` as ``parallel.sharding.map_particles`` takes it), else
        the whole selection at once on the analysis's device."""
        chunk = self._run_chunk()
        if chunk:
            return chunked_per_particle(
                kernel, series, chunk, device=self.device, divisor=divisor,
                checkpoint=self.checkpoint if self.atom_chunk else None)
        if current_mesh() is None:
            by_particle = kernel(particle_block(series, 0, series.shape[1],
                                                self.device))
        else:
            by_particle = map_particles(kernel, series, piece)
        if divisor is not None:
            by_particle /= divisor
        host = to_host(by_particle)
        return to_host(by_particle.mean(dim=1)), host

    def _single_frame(self):  # pragma: no cover - overridden
        raise NotImplementedError(
            "analysis subclasses must implement _single_frame "
            "or _process_batch"
        )

    def _validate_trajectory(self):
        """Batch-engine hook: raise (e.g. NoDataError) if the trajectory
        lacks required per-frame data. Called before any frame is read."""

    def _conclude(self):
        pass

    # --- results persistence ---------------------------------------------------
    def save(self, path) -> None:
        """Persist ``results`` plus run metadata (times, frames,
        analysis class) to a single ``.npz``."""
        if not self.results:
            raise RuntimeError(
                "nothing to save — call run() before save()"
            )
        payload = {}
        for key, value in self.results.items():
            if value is None:
                continue
            payload[f"results/{key}"] = np.asarray(value)
        payload["meta/class"] = np.asarray(type(self).__name__)
        payload["meta/times"] = np.asarray(self.times)
        payload["meta/frames"] = np.asarray(self.frames)
        np.savez(path, **payload)

    @staticmethod
    def load_results(path):
        """Load an ``.npz`` written by :meth:`save` →
        ``(Results, meta_dict)``; scalar results come back as Python
        floats."""
        results = Results()
        meta = {}
        with np.load(path, allow_pickle=False) as z:
            for key in z.files:
                kind, _, name = key.partition("/")
                value = z[key]
                if kind == "results":
                    results[name] = (
                        float(value) if value.ndim == 0 else value
                    )
                else:
                    meta[name] = (
                        str(value) if value.dtype.kind in "US"
                        else value
                    )
        return results, meta

    # --- driver --------------------------------------------------------------------
    def run(
        self,
        start: Optional[int] = None,
        stop: Optional[int] = None,
        step: Optional[int] = None,
        frames=None,
        verbose: Optional[bool] = None,
    ):
        self.timing = StageTimer(self.device)
        with self.timing.running():
            self._run(start, stop, step, frames, verbose)
        return self

    def _run(self, start, stop, step, frames, verbose) -> None:
        self._setup_frames(
            self._trajectory, start=start, stop=stop, step=step, frames=frames
        )
        self._prepare()
        show_progress = verbose if verbose is not None else self._verbose
        use_batch = (
            hasattr(self, "_process_batch") and self._engine != "frame"
        )
        if (use_batch and self._frame_block is not None
                and hasattr(self, "_process_block")):
            self._validate_trajectory()
            with self.timing.stage("io"):
                from ..io.prefetch import prefetch_batches
                from ..utils.progress import progress_bar

                times = []
                offset = 0
                blocks = iter(prefetch_batches(
                    self._trajectory, self.frames,
                    block_size=self._frame_block,
                ))
                bar = progress_bar(
                    total=len(self.frames),
                    desc=type(self).__name__,
                    disable=not show_progress,
                )
                while True:
                    with span("ta.feed.read"):
                        block = next(blocks, None)
                    if block is None:
                        break
                    times.append(np.asarray(block["times"]))
                    self._process_block(block, offset)
                    offset += len(block["times"])
                    bar.update(len(block["times"]))
                bar.close()
                self.times = np.concatenate(times).astype(np.float64)
        elif use_batch:
            self._validate_trajectory()
            with self.timing.stage("io"):
                with span("ta.feed.read"):
                    batch = self._trajectory.read_frames_batch(self.frames)
                self.times = np.asarray(batch["times"], dtype=np.float64)
                self._process_batch(batch)
        else:
            with self.timing.stage("io"):
                from ..utils.progress import progress_bar

                bar = progress_bar(
                    total=self.n_frames,
                    desc=type(self).__name__,
                    disable=not show_progress,
                )
                for i, frame_index in enumerate(self.frames):
                    ts = self._trajectory[int(frame_index)]
                    self._frame_index = i
                    self._ts = ts
                    self.times[i] = ts.time
                    self._single_frame()
                    bar.update(1)
                bar.close()
        with self.timing.stage("compute"):
            self._conclude()
        self.timing.counters(
            n_frames=self.n_frames,
            n_particles=getattr(self, "n_particles", 0),
            n_lags=getattr(self, "n_lags", None),
        )
        # a finished run keeps its results, not its feed on the device
        for key in getattr(self, "_buffers", {}):
            setattr(self, "_" + key, None)
        self._buffers = {}

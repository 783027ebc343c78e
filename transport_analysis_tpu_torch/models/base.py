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
decoded on a background thread (``io.prefetch``), and each block goes to
``_process_block``.

Every run records ``analysis.timing`` (``utils.profiling.StageTimer`` on
the analysis's device): "io" around the feed, "compute" around
``_conclude``, the frame, particle and lag counters of its throughputs,
its ``run_id`` and the bytes its host copies moved (``counts()``). The
run is a ``ta.run.<run_id>`` span; the feed's reads are ``ta.feed.read``
and its selections ``ta.feed.select`` spans (``utils.profiling.span``).

The analyses with per-particle results (VACF, Helfand, MSD) are
:class:`ParticleAnalysis` subclasses. It owns their shared arguments,
their feed and their run plan. Each declares the trajectory arrays it
reads (``FEEDS``) and its missing-data message; the feed is those
arrays' float32 samples, as every reader yields them, in all three
engines: views of the batch where :func:`select_series` gives one, a
:class:`DeviceSeriesBuffer` on the analysis's device for frame blocks (the
host holds one decoded block at a time), float32 host buffers filled from
each ``Timestep`` per frame. The run plan, decided once a run in
``_prepare``: atom chunks (``parallel.streaming``), given by
``atom_chunk`` or chosen where the whole FFT run would not fit the
device's budget; else the particle shards of the current mesh; else the
whole selection at once.

From the second run on a card over one ``MemoryReader`` on, each of its
arrays that a run copies to the card whole, as views of it (the whole
selection, or frame blocks), is page-locked in place, whole and once
(``_host_pool.ReaderStores``), so its copies cross by DMA; the reader's
collection unregisters them. The first run keeps the pageable copy: a
registration costs about as much as one pageable copy of the array, so
only a repeat pays it back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _host_pool
from .._device import WORK_TYPES, h2d, resolve_device, to_host, work_types
from ..core.trajectory import MemoryReader, take_axis
from ..ops import acf
from ..parallel.mesh import current_mesh
from ..parallel.sharding import map_particles
from ..parallel.streaming import chunked_per_particle, particle_block
from ..utils.errors import NoDataError
from ..utils.profiling import StageTimer, count, span
from ._dims import parse_dim_type


def check_work_dtype(dtype) -> None:
    """The analyses' work dtype, as the JAX package takes it: float64
    (the default, reference-grade numerics) or float32 (the float32 work
    mode, about 1e-6 grade); anything else raises ``ValueError``."""
    if np.dtype(dtype) not in WORK_TYPES:
        raise ValueError(
            f"dtype must be float64 or float32, got dtype={np.dtype(dtype)}")


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
    in ``dtype`` (the blocks' own, float32 for a trajectory's samples);
    each block is copied into its rows."""

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
        pass

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


class ParticleAnalysis(AnalysisBase):
    """An analysis of per-particle series of one AtomGroup (VACF,
    Helfand, MSD): their shared arguments, their feed and their run plan.

    A subclass declares ``FEEDS``, the trajectory arrays it reads
    ("velocities", "positions"), and ``NO_DATA_MSG``, the
    ``NoDataError`` message when one is missing; every engine then gives
    it ``self._<feed>``, the (N, P, d) float32 samples of its atoms and
    components: the batch's :func:`select_series` (a view where it gives
    one), a :class:`DeviceSeriesBuffer` of frame blocks, or float32 host
    buffers filled frame by frame. ``_feed_frames`` takes any other
    per-frame data; ``_conclude`` correlates through
    :meth:`_per_particle`.
    """

    FEEDS: tuple = ()
    NO_DATA_MSG = ""

    def __init__(self, atomgroup, dim_type: str = "xyz", fft: bool = True,
                 max_lag=None, atom_chunk=None, checkpoint=None,
                 dtype=np.float64, **kwargs):
        self._dim, self.dim_fac = parse_dim_type(dim_type)
        check_work_dtype(dtype)
        super().__init__(atomgroup.universe.trajectory, **kwargs)
        self.atomgroup = atomgroup
        self.n_particles = len(atomgroup)
        self.fft = fft
        self.max_lag = max_lag
        self.atom_chunk = atom_chunk
        self.checkpoint = checkpoint
        self._work_dtype = np.dtype(dtype)

    def _prepare(self):
        """Per-run set-up: the lags, the run plan and the trajectory's
        page-locked arrays (:meth:`_repeat_stores`, which counts the run
        on its trajectory). The plan is decided here, once: atom chunks
        of ``self._chunk`` particles (:meth:`_run_chunk`), else the
        current mesh's particle shards, else the whole selection
        (``self._whole``)."""
        self.n_lags = (self.n_frames if self.max_lag is None
                       else min(self.max_lag, self.n_frames))
        self._chunk = self._run_chunk()
        self._whole = not self._chunk and current_mesh() is None
        self._buffers = {}
        self._stores = self._repeat_stores()

    def _run(self, *args) -> None:
        super()._run(*args)
        # a finished run keeps its results, not its feed on the device
        for key in self._buffers:
            setattr(self, "_" + key, None)
        self._buffers = {}

    # --- the feed ------------------------------------------------------------
    def _validate_trajectory(self):
        if not all(getattr(self._trajectory, "has_" + key)
                   for key in self.FEEDS):
            raise NoDataError(self.NO_DATA_MSG)

    def _frames(self, frames, offset) -> list:
        """The ``FEEDS`` arrays of ``frames`` (a batch, a frame block or
        one frame, as ``read_frames_batch`` keys them) whose first frame
        is the run's ``offset``, after :meth:`_feed_frames` has taken its
        data; a missing one raises ``NoDataError``."""
        if any(key not in frames for key in self.FEEDS):
            raise NoDataError(self.NO_DATA_MSG)
        self._feed_frames(frames, offset)
        return [frames[key] for key in self.FEEDS]

    def _feed_frames(self, frames, offset) -> None:
        """Hook: the analysis's own per-frame data of ``frames``."""

    def _process_batch(self, batch):
        for key, block in zip(self.FEEDS, self._frames(batch, 0)):
            setattr(self, "_" + key, self._select(block))

    def _process_block(self, batch, offset):
        """Frame-blocked feed: each block copied into a device buffer
        at row ``offset``; the buffer is made at the first block, with
        that block's dtype, and released when the run has concluded."""
        for key, block in zip(self.FEEDS, self._frames(batch, offset)):
            block = self._select(block)
            if offset == 0:
                self._buffers[key] = DeviceSeriesBuffer(
                    (self.n_frames,) + block.shape[1:], block.dtype,
                    self.device)
            self._buffers[key].write(block, offset)
            setattr(self, "_" + key, self._buffers[key].array())

    def _single_frame(self):
        """Per-frame engine: the Timestep's samples of the atoms, in the
        analysis's components, into float32 host buffers at row
        ``_frame_index``."""
        ts, i = self._ts, self._frame_index
        frame = {"volumes": [ts.volume]}
        frame.update((key, getattr(self.atomgroup, key)[:, self._dim])
                     for key in self.FEEDS if getattr(ts, "has_" + key))
        for key, sample in zip(self.FEEDS, self._frames(frame, i)):
            if i == 0:
                setattr(self, "_" + key, np.empty(
                    (self.n_frames,) + sample.shape, np.float32))
            getattr(self, "_" + key)[i] = sample

    def _select(self, block) -> np.ndarray:
        """The feed of an (N, n_atoms, 3) frame block: its
        :func:`select_series` of the analysis's atoms and components, in
        a ``ta.feed.select`` span; a new host array's bytes count as the
        run's ``select_bytes``. A view that the run copies to the card
        whole (the whole plan, or frame blocks) page-locks the reader's
        array it lies in where :meth:`_repeat_stores` gave them."""
        with span("ta.feed.select"):
            out = select_series(block, self.atomgroup.indices, self._dim)
            if not np.may_share_memory(out, block):
                count("select_bytes", out.nbytes)
                return out
        if self._stores is not None and (self._frame_block is not None
                                         or self._whole):
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

    # --- the run plan --------------------------------------------------------
    def _run_chunk(self) -> Optional[int]:
        """The atom chunk this run correlates by: ``atom_chunk`` where
        given; else, on the FFT path with no mesh current, where the
        whole run's ``ops.acf.chunk_peak_bytes`` (frames N, particles P,
        components d, the work dtype) is past ``ops.acf.device_budget_gb``
        of the device, ``ops.acf.auto_atom_chunk``'s; else None, the
        whole run at once. (The windowed path reckons far less.)"""
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
        host arrays, both divided by ``divisor`` where given, by the
        run's plan: in its atom chunks (``parallel.streaming``;
        ``checkpoint`` with an explicit ``atom_chunk`` only; float64
        accumulators), the whole selection at once on the analysis's
        device, or each particle shard of the current mesh (``piece`` as
        ``parallel.sharding.map_particles`` takes it)."""
        if self._chunk:
            return chunked_per_particle(
                kernel, series, self._chunk, device=self.device,
                divisor=divisor,
                checkpoint=self.checkpoint if self.atom_chunk else None)
        if self._whole:
            by_particle = kernel(particle_block(series, 0, series.shape[1],
                                                self.device))
        else:
            by_particle = map_particles(kernel, series, piece)
        if divisor is not None:
            by_particle /= divisor
        host = to_host(by_particle)
        return to_host(by_particle.mean(dim=1)), host

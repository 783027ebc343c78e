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
``_conclude``, and the frame and particle counters of its throughputs.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, work_types
from ..core.trajectory import take_axis

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
        them on the host; the results are identical either way."""
        self._keep_f32 = not os.environ.get(NO_F32_SOURCE_ENV)
        self._buffers = {}

    def _feed_block(self, key, batch, indices, offset) -> None:
        """Frame-blocked feed: the block ``batch[key]`` of the atoms
        ``indices`` in the analysis's components (``self._dim``), copied
        into the device buffer ``self._<key>`` at row ``offset``; the
        buffer is made at the first block, with that block's dtype, and
        released when the run has concluded."""
        block = source_cast(select_series(batch[key], indices, self._dim),
                            self._work_dtype, self._keep_f32)
        if offset == 0:
            self._buffers[key] = DeviceSeriesBuffer(
                (self.n_frames, len(indices), len(self._dim)), block.dtype,
                self.device)
        self._buffers[key].write(block, offset)
        setattr(self, "_" + key, self._buffers[key].array())

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
        from ..utils.profiling import StageTimer

        self.timing = StageTimer(self.device)
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
                blocks = prefetch_batches(
                    self._trajectory, self.frames,
                    block_size=self._frame_block,
                )
                bar = progress_bar(
                    total=len(self.frames),
                    desc=type(self).__name__,
                    disable=not show_progress,
                )
                for block in blocks:
                    times.append(np.asarray(block["times"]))
                    self._process_block(block, offset)
                    offset += len(block["times"])
                    bar.update(len(block["times"]))
                bar.close()
                self.times = np.concatenate(times).astype(np.float64)
        elif use_batch:
            self._validate_trajectory()
            with self.timing.stage("io"):
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
        )
        # a finished run keeps its results, not its feed on the device
        for key in getattr(self, "_buffers", {}):
            setattr(self, "_" + key, None)
        self._buffers = {}
        return self

"""Trajectory reader protocol and the in-memory reader.

Re-provides the slice of MDAnalysis's trajectory-reader contract the
reference consumes (SURVEY.md §2b): ``n_frames``, per-frame ``Timestep``
iteration, random access, strided slicing, and an in-memory reader
(``MemoryReader``, reference tests/utils.py:4,70).

Batch extension: ``read_frames_batch`` returns whole *stacked*
``(n_frames, n_atoms, 3)`` arrays for a strided frame selection in one
call, so the analysis runtime can ship a single contiguous block to the
device instead of looping frame-by-frame in Python (the reference's hot
loop #1, velocityautocorr.py:178-194). ``MemoryReader`` overrides it
with :func:`take_axis` (views of its arrays for evenly spaced frames);
the base class falls back to a seek loop.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from .timestep import Timestep, box_volumes


def take_axis(arr: np.ndarray, indices, axis: int) -> np.ndarray:
    """``arr`` at ``indices`` along ``axis``, in C order. Evenly spaced
    indices (a whole universe, a residue range, every dim_type, a strided
    frame range) become a basic slice, a view that copies nothing; others
    go through ``np.take``. numpy's advanced indexing on an inner axis
    returns a transposed layout instead, whose C-order copy for the
    host-to-device transfer crawls through memory (about 1.7 s for a
    362 MB block on an H100 host)."""
    indices = np.asarray(indices, dtype=np.int64)
    n = len(indices)
    step = int(indices[1] - indices[0]) if n > 1 else 1
    if n and step > 0 and np.array_equal(
            indices, indices[0] + step * np.arange(n)):
        cut = [slice(None)] * arr.ndim
        cut[axis] = slice(int(indices[0]), int(indices[-1]) + 1, step)
        return arr[tuple(cut)]
    return np.take(arr, indices, axis=axis)


class ProtoReader:
    """Base trajectory reader.

    Subclasses must set ``n_atoms``, ``n_frames`` and implement
    ``_read_frame(i) -> Timestep`` (updating ``self.ts`` in place).
    """

    n_atoms: int = 0
    n_frames: int = 0

    def __init__(self):
        self.ts: Optional[Timestep] = None
        self._transformations = []

    # --- capability flags (of the whole trajectory) -----------------------
    @property
    def has_positions(self) -> bool:
        return self.ts is not None and self.ts.has_positions

    @property
    def has_velocities(self) -> bool:
        return self.ts is not None and self.ts.has_velocities

    @property
    def has_forces(self) -> bool:
        return self.ts is not None and self.ts.has_forces

    @property
    def dt(self) -> float:
        return self.ts.dt if self.ts is not None else 1.0

    @property
    def time(self) -> float:
        return self.ts.time

    @property
    def frame(self) -> int:
        return self.ts.frame

    # --- core access -------------------------------------------------------
    def _read_frame(self, i: int) -> Timestep:  # pragma: no cover - abstract
        raise NotImplementedError

    def _read_frame_with_aux(self, i: int) -> Timestep:
        ts = self._read_frame(i)
        for t in self._transformations:
            ts = t(ts)
        return ts

    def add_transformations(self, *transformations):
        """Register per-frame transformations applied on every read
        (mirror of MDAnalysis trajectory transformations)."""
        self._transformations.extend(transformations)
        # re-apply to the current frame so ts reflects them immediately
        if self.ts is not None and self.ts.frame >= 0:
            self._read_frame_with_aux(self.ts.frame)

    def rewind(self) -> Timestep:
        return self._read_frame_with_aux(0)

    def __len__(self) -> int:
        return self.n_frames

    def __iter__(self):
        for i in range(self.n_frames):
            yield self._read_frame_with_aux(i)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            i = int(item)
            if i < 0:
                i += self.n_frames
            if not 0 <= i < self.n_frames:
                raise IndexError(
                    f"frame index {item} out of range [0, {self.n_frames})"
                )
            return self._read_frame_with_aux(i)
        if isinstance(item, slice):
            indices = range(*item.indices(self.n_frames))

            def _iter():
                for i in indices:
                    yield self._read_frame_with_aux(i)

            return _SlicedTrajectory(self, indices, _iter)
        if isinstance(item, (Sequence, np.ndarray)):
            indices = [int(i) for i in item]

            def _iter():
                for i in indices:
                    yield self._read_frame_with_aux(i)

            return _SlicedTrajectory(self, indices, _iter)
        raise TypeError(f"cannot index trajectory with {type(item)}")

    def check_slice_indices(self, start, stop, step):
        """Normalize run(start, stop, step) arguments against n_frames,
        with MDAnalysis semantics (None → full range)."""
        if step == 0:
            raise ValueError("step cannot be 0")
        start = 0 if start is None else int(start)
        stop = self.n_frames if stop is None else int(stop)
        step = 1 if step is None else int(step)
        if start < 0:
            start += self.n_frames
        if stop < 0:
            stop += self.n_frames
        stop = min(stop, self.n_frames)
        return start, stop, step

    # --- batch feed path -------------------------------------------------------
    def read_frames_batch(self, indices: Iterable[int]) -> dict:
        """Decode many frames at once into stacked arrays.

        Returns a dict with any of the keys ``positions`` / ``velocities``
        / ``forces`` shaped ``(len(indices), n_atoms, 3)`` (present only if
        the trajectory carries them), plus ``times`` ``(F,)``, ``volumes``
        ``(F,)`` and ``frames`` ``(F,)`` int64.

        Base implementation seeks frame-by-frame; file readers override
        with batched decoding.
        """
        indices = np.asarray(list(indices), dtype=np.int64)
        F = len(indices)
        out: dict = {"frames": indices}
        first = self._read_frame_with_aux(int(indices[0])) if F else self.ts
        has_pos = first.has_positions if first is not None else False
        has_vel = first.has_velocities if first is not None else False
        has_frc = first.has_forces if first is not None else False
        if has_pos:
            out["positions"] = np.empty((F, self.n_atoms, 3), np.float32)
        if has_vel:
            out["velocities"] = np.empty((F, self.n_atoms, 3), np.float32)
        if has_frc:
            out["forces"] = np.empty((F, self.n_atoms, 3), np.float32)
        out["times"] = np.empty((F,), np.float64)
        out["volumes"] = np.empty((F,), np.float64)
        for j, i in enumerate(indices):
            ts = (
                first
                if j == 0 and first is not None
                else self._read_frame_with_aux(int(i))
            )
            if has_pos:
                out["positions"][j] = ts.positions
            if has_vel:
                out["velocities"][j] = ts.velocities
            if has_frc:
                out["forces"][j] = ts.forces
            out["times"][j] = ts.time
            out["volumes"][j] = ts.volume
        return out

    def close(self):
        pass


class _SlicedTrajectory:
    """Iterable view over a strided frame selection (what
    ``trajectory[start:stop:step]`` returns)."""

    def __init__(self, reader, indices, iter_factory):
        self._reader = reader
        self._indices = list(indices)
        self._iter_factory = iter_factory

    def __len__(self):
        return len(self._indices)

    def __iter__(self):
        return self._iter_factory()

    def __getitem__(self, j):
        return self._reader[self._indices[j]]


class MemoryReader(ProtoReader):
    """Trajectory backed by in-memory numpy arrays.

    The ``Timestep`` exposes *views* into the backing arrays, so in-place
    writes through ``AtomGroup.velocities = ...`` persist across frame
    seeks — matching MDAnalysis ``MemoryReader`` semantics the reference
    test fixtures rely on (test_velocityautocorr.py:54-57 assigns
    velocities frame-by-frame and reads them back later).
    """

    format = "MEMORY"

    def __init__(
        self,
        coordinate_array: Optional[np.ndarray] = None,
        velocities: Optional[np.ndarray] = None,
        forces: Optional[np.ndarray] = None,
        dimensions: Optional[np.ndarray] = None,
        dt: float = 1.0,
        n_atoms: Optional[int] = None,
        n_frames: Optional[int] = None,
    ):
        super().__init__()
        if coordinate_array is not None:
            coordinate_array = np.asarray(coordinate_array, dtype=np.float32)
            if coordinate_array.ndim == 2:
                coordinate_array = coordinate_array[None]
            n_frames, n_atoms, _ = coordinate_array.shape
        if n_atoms is None or n_frames is None:
            raise ValueError(
                "need coordinate_array or explicit n_atoms and n_frames"
            )
        self.n_atoms = int(n_atoms)
        self.n_frames = int(n_frames)
        self._pos = coordinate_array
        self._vel = (
            None
            if velocities is None
            else np.asarray(velocities, dtype=np.float32).reshape(
                self.n_frames, self.n_atoms, 3
            )
        )
        self._frc = (
            None
            if forces is None
            else np.asarray(forces, dtype=np.float32).reshape(
                self.n_frames, self.n_atoms, 3
            )
        )
        if dimensions is not None:
            dimensions = np.asarray(dimensions, dtype=np.float64)
            if dimensions.ndim == 1:
                dimensions = np.tile(dimensions, (self.n_frames, 1))
        self._dims = dimensions
        self._dt = float(dt)

        self.ts = Timestep(
            self.n_atoms,
            positions=self._pos is not None,
            velocities=self._vel is not None,
            forces=self._frc is not None,
        )
        self.ts.dt = self._dt
        self._read_frame(0)

    @classmethod
    def allocate(
        cls,
        n_atoms: int,
        n_frames: int,
        positions: bool = True,
        velocities: bool = False,
        forces: bool = False,
        dt: float = 1.0,
    ) -> "MemoryReader":
        """Zero-filled writable trajectory (backs ``Universe.empty``)."""
        reader = cls.__new__(cls)
        ProtoReader.__init__(reader)
        reader.n_atoms = int(n_atoms)
        reader.n_frames = int(n_frames)
        shape = (n_frames, n_atoms, 3)
        reader._pos = np.zeros(shape, np.float32) if positions else None
        reader._vel = np.zeros(shape, np.float32) if velocities else None
        reader._frc = np.zeros(shape, np.float32) if forces else None
        reader._dims = np.zeros((n_frames, 6), np.float64)
        reader._dt = float(dt)
        reader.ts = Timestep(
            n_atoms,
            positions=positions,
            velocities=velocities,
            forces=forces,
        )
        reader.ts.dt = reader._dt
        reader._read_frame(0)
        return reader

    def _read_frame(self, i: int) -> Timestep:
        ts = self.ts
        ts.frame = i
        ts.time = i * self._dt
        # rebind views so writes persist into the backing store
        if self._pos is not None:
            ts._positions = self._pos[i]
        if self._vel is not None:
            ts._velocities = self._vel[i]
        if self._frc is not None:
            ts._forces = self._frc[i]
        if self._dims is not None:
            ts.dimensions = self._dims[i]
        return ts

    def read_frames_batch(self, indices) -> dict:
        if self._transformations:
            # registered per-frame transformations (e.g. set_dimensions)
            # must be applied; only the base seek loop runs them
            return ProtoReader.read_frames_batch(self, indices)
        indices = np.asarray(list(indices), dtype=np.int64)
        out = {"frames": indices}
        # views of the backing arrays where the frames are evenly spaced
        if self._pos is not None:
            out["positions"] = take_axis(self._pos, indices, 0)
        if self._vel is not None:
            out["velocities"] = take_axis(self._vel, indices, 0)
        if self._frc is not None:
            out["forces"] = take_axis(self._frc, indices, 0)
        out["times"] = indices.astype(np.float64) * self._dt
        if self._dims is not None:
            out["volumes"] = box_volumes(self._dims[indices])
        else:
            out["volumes"] = np.zeros(len(indices), np.float64)
        return out

    def get_array(self, attr: str) -> Optional[np.ndarray]:
        return {"positions": self._pos, "velocities": self._vel,
                "forces": self._frc}[attr]

"""Per-frame trajectory state.

Provides the ``Timestep`` contract the reference consumes from MDAnalysis:
``ts.has_velocities`` / ``ts.has_positions`` flags and ``ts.volume``
(triclinic box volume in Å**3) at reference viscosity.py:178-189, plus
``ts.time`` / ``ts.frame`` feeding ``AnalysisBase.times`` (SURVEY.md §2b).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def box_volumes(dimensions) -> np.ndarray:
    """Volume (Å**3) of each triclinic box ``[lx, ly, lz, α, β, γ]`` of an
    (n, 6) array, in one numpy pass; 0.0 for a box with a zero edge or a
    degenerate cell.

    Uses the standard crystallographic formula
    V = lx·ly·lz·sqrt(1 − cos²α − cos²β − cos²γ + 2·cosα·cosβ·cosγ).
    """
    d = np.asarray(dimensions, dtype=np.float64).reshape(-1, 6)
    lx, ly, lz = d[:, 0], d[:, 1], d[:, 2]
    ca, cb, cg = np.cos(np.radians(d[:, 3:])).T
    factor = 1.0 - ca * ca - cb * cb - cg * cg + 2.0 * ca * cb * cg
    empty = (lx == 0.0) | (ly == 0.0) | (lz == 0.0) | (factor <= 0.0)
    return np.where(empty, 0.0,
                    lx * ly * lz * np.sqrt(np.where(empty, 1.0, factor)))


def box_volume(dimensions) -> float:
    """:func:`box_volumes` of one box; 0.0 when ``dimensions`` is None."""
    return 0.0 if dimensions is None else float(box_volumes(dimensions)[0])


class Timestep:
    """State of one trajectory frame.

    Positions/velocities/forces are ``(n_atoms, 3)`` float32 arrays (the
    dtype MDAnalysis readers expose and the reference gathers from at
    velocityautocorr.py:192, viscosity.py:192-199); any of them may be
    absent, reported via ``has_*`` flags.
    """

    def __init__(
        self,
        n_atoms: int,
        positions: bool = True,
        velocities: bool = False,
        forces: bool = False,
        dtype=np.float32,
    ):
        self.n_atoms = int(n_atoms)
        self.frame = -1
        self.time = 0.0
        self.dt = 1.0
        self.dimensions: Optional[np.ndarray] = None
        self.data: dict = {}
        self._dtype = np.dtype(dtype)
        self._positions = (
            np.zeros((self.n_atoms, 3), dtype=dtype) if positions else None
        )
        self._velocities = (
            np.zeros((self.n_atoms, 3), dtype=dtype) if velocities else None
        )
        self._forces = (
            np.zeros((self.n_atoms, 3), dtype=dtype) if forces else None
        )

    # --- presence flags ---------------------------------------------------
    @property
    def has_positions(self) -> bool:
        return self._positions is not None

    @property
    def has_velocities(self) -> bool:
        return self._velocities is not None

    @property
    def has_forces(self) -> bool:
        return self._forces is not None

    # --- array accessors ----------------------------------------------------
    def _get(self, attr, name):
        arr = getattr(self, attr)
        if arr is None:
            from ..utils.errors import NoDataError

            raise NoDataError(f"This Timestep has no {name}")
        return arr

    @property
    def positions(self) -> np.ndarray:
        return self._get("_positions", "positions information")

    @positions.setter
    def positions(self, value):
        if self._positions is None:
            self._positions = np.zeros((self.n_atoms, 3), dtype=self._dtype)
        self._positions[:] = value

    @property
    def velocities(self) -> np.ndarray:
        return self._get("_velocities", "velocities information")

    @velocities.setter
    def velocities(self, value):
        if self._velocities is None:
            self._velocities = np.zeros((self.n_atoms, 3), dtype=self._dtype)
        self._velocities[:] = value

    @property
    def forces(self) -> np.ndarray:
        return self._get("_forces", "forces information")

    @forces.setter
    def forces(self, value):
        if self._forces is None:
            self._forces = np.zeros((self.n_atoms, 3), dtype=self._dtype)
        self._forces[:] = value

    @property
    def volume(self) -> float:
        """Box volume in Å**3; 0.0 when no box is set (reference
        viscosity.py:182 treats volume == 0 as missing data)."""
        return box_volume(self.dimensions)

    def copy(self) -> "Timestep":
        new = Timestep(
            self.n_atoms,
            positions=self.has_positions,
            velocities=self.has_velocities,
            forces=self.has_forces,
            dtype=self._dtype,
        )
        new.frame = self.frame
        new.time = self.time
        new.dt = self.dt
        if self.dimensions is not None:
            new.dimensions = np.array(self.dimensions, copy=True)
        for attr in ("_positions", "_velocities", "_forces"):
            src = getattr(self, attr)
            if src is not None:
                setattr(new, attr, src.copy())
        new.data = dict(self.data)
        return new

    def __repr__(self):
        return f"<Timestep frame={self.frame} n_atoms={self.n_atoms}>"

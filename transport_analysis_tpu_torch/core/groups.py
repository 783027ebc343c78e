"""AtomGroup: a static set of atom indices with per-frame array views.

Re-provides the AtomGroup contract the reference consumes (SURVEY.md §2b):
``len(ag)`` → particle count (reference velocityautocorr.py:139), per-frame
``ag.velocities`` / ``ag.positions`` as ``(n_atoms, 3)`` float32 views
(velocityautocorr.py:192, viscosity.py:192-199), ``ag.masses``
(viscosity.py:123), and the ``UpdatingAtomGroup`` subtype both analyses
must reject (velocityautocorr.py:127-130, viscosity.py:96-99).
"""

from __future__ import annotations

import numpy as np


class AtomGroup:
    def __init__(self, indices, universe):
        self._ix = np.asarray(indices, dtype=np.int64)
        self._u = universe

    # --- identity ---------------------------------------------------------
    @property
    def universe(self):
        return self._u

    @property
    def indices(self) -> np.ndarray:
        return self._ix

    @property
    def ix(self) -> np.ndarray:
        return self._ix

    @property
    def n_atoms(self) -> int:
        return len(self._ix)

    def __len__(self) -> int:
        return len(self._ix)

    def __getitem__(self, item):
        return AtomGroup(np.atleast_1d(self._ix[item]), self._u)

    def __add__(self, other):
        return AtomGroup(
            np.concatenate([self._ix, other._ix]), self._u
        )

    def __repr__(self):
        return f"<AtomGroup with {len(self)} atoms>"

    # --- per-frame dynamic data --------------------------------------------
    @property
    def positions(self) -> np.ndarray:
        return self._u.trajectory.ts.positions[self._ix]

    @positions.setter
    def positions(self, values):
        self._u.trajectory.ts.positions[self._ix] = values

    @property
    def velocities(self) -> np.ndarray:
        return self._u.trajectory.ts.velocities[self._ix]

    @velocities.setter
    def velocities(self, values):
        self._u.trajectory.ts.velocities[self._ix] = values

    @property
    def forces(self) -> np.ndarray:
        return self._u.trajectory.ts.forces[self._ix]

    @forces.setter
    def forces(self, values):
        self._u.trajectory.ts.forces[self._ix] = values

    # --- static topology data -----------------------------------------------
    def _topattr(self, name) -> np.ndarray:
        return self._u._topology.get_atom_values(name)[self._ix]

    @property
    def masses(self) -> np.ndarray:
        return self._topattr("masses")

    @property
    def charges(self) -> np.ndarray:
        return self._topattr("charges")

    @property
    def names(self) -> np.ndarray:
        return self._topattr("names")

    @property
    def types(self) -> np.ndarray:
        return self._topattr("types")

    @property
    def resids(self) -> np.ndarray:
        return self._topattr("resids")

    @property
    def resnames(self) -> np.ndarray:
        return self._topattr("resnames")

    @property
    def segids(self) -> np.ndarray:
        return self._topattr("segids")

    # --- derived quantities (MDAnalysis convenience surface) ------------------
    def total_mass(self) -> float:
        return float(np.sum(self.masses))

    def total_charge(self) -> float:
        return float(np.sum(self.charges))

    def center_of_geometry(self) -> np.ndarray:
        return self.positions.astype(np.float64).mean(axis=0)

    centroid = center_of_geometry

    def center_of_mass(self) -> np.ndarray:
        m = self.masses.astype(np.float64)
        return (
            self.positions.astype(np.float64) * m[:, None]
        ).sum(axis=0) / m.sum()

    def radius_of_gyration(self) -> float:
        m = self.masses.astype(np.float64)
        d = self.positions.astype(np.float64) - self.center_of_mass()
        return float(np.sqrt(np.sum(m * np.sum(d * d, axis=1)) / m.sum()))

    # --- selections ----------------------------------------------------------
    def select_atoms(self, selection: str, updating: bool = False):
        from .selection import select

        indices = select(self._u, selection, subset=self._ix)
        if updating:
            return UpdatingAtomGroup(indices, self._u, selection, self._ix)
        return AtomGroup(indices, self._u)


class UpdatingAtomGroup(AtomGroup):
    """An AtomGroup whose membership is re-evaluated every frame.

    The analyses reject this type because lag correlations require a fixed
    particle set (reference velocityautocorr.py:127-130).
    """

    def __init__(self, indices, universe, selection: str, base_indices=None):
        super().__init__(indices, universe)
        self._selection = selection
        self._base_indices = base_indices
        self._last_frame = universe.trajectory.ts.frame

    def _refresh(self):
        frame = self._u.trajectory.ts.frame
        if frame != self._last_frame:
            from .selection import select

            self._ix = select(
                self._u, self._selection, subset=self._base_indices
            )
            self._last_frame = frame

    def __len__(self):
        self._refresh()
        return len(self._ix)

    @property
    def indices(self):
        self._refresh()
        return self._ix

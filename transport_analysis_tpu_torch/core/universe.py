"""Universe: topology + trajectory, the user-facing entry object.

Re-provides the MDAnalysis ``Universe`` contract the reference consumes
(SURVEY.md §2b): ``Universe(topology, reader)`` construction (from
files once ``io/`` is ported), ``Universe.empty(...)`` synthetic factory
(reference test_velocityautocorr.py:54), ``load_new`` (test_velocityautocorr.py:71),
``select_atoms`` with ``updating=`` (test_velocityautocorr.py:140), and
``add_TopologyAttr`` (test_viscosity.py:85).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .groups import AtomGroup, UpdatingAtomGroup
from .topology import Topology
from .trajectory import MemoryReader, ProtoReader
from ..utils.errors import not_ported


class Universe:
    def __init__(self, *args, **kwargs):
        topology = None
        trajectory: Optional[ProtoReader] = None

        for a in args:
            if isinstance(a, Topology):
                topology = a
            elif isinstance(a, ProtoReader):
                trajectory = a
            else:
                raise not_ported(
                    f"Universe from a file ({a!r})", "io"
                )

        if topology is None:
            raise TypeError("Universe requires a topology")
        self._topology = topology
        self.trajectory = trajectory
        if self.trajectory is None:
            self.trajectory = MemoryReader.allocate(
                topology.n_atoms, 1, positions=True
            )
        self.atoms = AtomGroup(np.arange(topology.n_atoms), self)

    # --- factories -----------------------------------------------------------
    @classmethod
    def empty(
        cls,
        n_atoms: int,
        n_residues: int = 1,
        n_segments: int = 1,
        atom_resindex=None,
        residue_segindex=None,
        trajectory: bool = False,
        velocities: bool = False,
        forces: bool = False,
        n_frames: int = 1,
    ) -> "Universe":
        """Build a Universe with no file backing (synthetic-test factory,
        mirroring ``MDAnalysis.Universe.empty``; the reference's entire
        analytic-oracle suite is built on this, SURVEY.md §4)."""
        if atom_resindex is None and n_residues > 1:
            atom_resindex = np.repeat(
                np.arange(n_residues), n_atoms // n_residues
            )
        if residue_segindex is None and n_segments > 1:
            residue_segindex = np.repeat(
                np.arange(n_segments), n_residues // n_segments
            )
        top = Topology(
            n_atoms,
            n_residues,
            n_segments,
            atom_resindex=atom_resindex,
            residue_segindex=residue_segindex,
        )
        make_traj = trajectory or velocities or forces or n_frames > 1
        reader = MemoryReader.allocate(
            n_atoms,
            n_frames if make_traj else 1,
            positions=True,
            velocities=velocities,
            forces=forces,
        )
        return cls(top, reader)

    # --- API ------------------------------------------------------------------
    @property
    def dimensions(self):
        return self.trajectory.ts.dimensions

    def select_atoms(self, selection: str, updating: bool = False):
        from .selection import select

        indices = select(self, selection)
        if updating:
            return UpdatingAtomGroup(indices, self, selection)
        return AtomGroup(indices, self)

    def load_new(self, coordinates, velocities=None, forces=None, dt=1.0):
        """Replace the trajectory with in-memory arrays
        (``(n_frames, n_atoms, 3)`` or ``(n_atoms, 3)``) or an open
        reader such as :class:`MemoryReader` (MDAnalysis
        ``Universe.load_new`` parity). File paths raise
        ``NotImplementedError`` until ``io/`` is ported.

        ``velocities``/``forces``/``dt`` only apply to in-memory
        arrays; passing them with a reader raises rather than being
        silently dropped (readers carry their own frame data and
        times).
        """
        if isinstance(coordinates, (str, os.PathLike)):
            raise not_ported(
                f"load_new from a file ({coordinates!r})", "io"
            )
        if isinstance(coordinates, ProtoReader):
            if velocities is not None or forces is not None or dt != 1.0:
                raise ValueError(
                    "velocities/forces/dt apply only to in-memory "
                    "arrays; readers carry their own per-frame data "
                    "and times"
                )
            self.trajectory = coordinates
            return self
        coordinates = np.asarray(coordinates, dtype=np.float32)
        if coordinates.ndim == 2:
            coordinates = coordinates[None]
        self.trajectory = MemoryReader(
            coordinates, velocities=velocities, forces=forces, dt=dt
        )
        return self

    def add_TopologyAttr(self, name: str, values=None):
        self._topology.add_attr(name, values)

    def __repr__(self):
        return f"<Universe with {self._topology.n_atoms} atoms>"

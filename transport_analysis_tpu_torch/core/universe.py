"""Universe: topology + trajectory, the user-facing entry object.

Re-provides the MDAnalysis ``Universe`` contract the reference consumes
(SURVEY.md §2b): ``Universe(top, traj)`` construction from files,
``Universe.empty(...)`` synthetic factory (reference
test_velocityautocorr.py:54), ``load_new`` (test_velocityautocorr.py:71),
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


class Universe:
    def __init__(self, *args, **kwargs):
        topology = None
        trajectory: Optional[ProtoReader] = None

        file_args = []
        for a in args:
            if isinstance(a, Topology):
                topology = a
            elif isinstance(a, ProtoReader):
                trajectory = a
            else:
                file_args.append(a)

        if file_args:
            from ..io import load_topology, open_trajectory

            if topology is None:
                topology = load_topology(file_args[0])
                traj_files = file_args[1:]
                single = file_args[0]
            else:
                # Topology instance + trajectory path(s):
                # Universe(Topology(n), "traj.trr")
                traj_files = file_args
                single = None
            if traj_files:
                trajectory = open_trajectory(
                    traj_files[0], n_atoms=topology.n_atoms
                )
            elif trajectory is None and single is not None:
                # single-file universe: topology file may carry coordinates
                trajectory = open_trajectory(
                    single, n_atoms=topology.n_atoms
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
        (``(n_frames, n_atoms, 3)`` or ``(n_atoms, 3)``) or a
        trajectory file path / open reader (MDAnalysis
        ``Universe.load_new`` parity).

        ``velocities``/``forces``/``dt`` only apply to in-memory
        arrays; passing them with a path or reader raises rather than
        being silently dropped (files carry their own frame data and
        times).
        """
        if isinstance(coordinates, (ProtoReader, str, os.PathLike)):
            if velocities is not None or forces is not None or dt != 1.0:
                raise ValueError(
                    "velocities/forces/dt apply only to in-memory "
                    "arrays; trajectory files and readers carry their "
                    "own per-frame data and times"
                )
        if isinstance(coordinates, ProtoReader):
            self.trajectory = coordinates
            return self
        if isinstance(coordinates, (str, os.PathLike)):
            from ..io import open_trajectory

            self.trajectory = open_trajectory(coordinates)
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

"""Carry a system's state into the port from plain numpy arrays.

The analyses have no weights: their state is the Universe, topology
attributes plus trajectory arrays. :func:`universe_from_arrays` rebuilds
it from arrays, for example those of a ``transport_analysis_tpu``
Universe (``u.trajectory.get_array(...)`` and the per-atom topology
attributes), so that both packages analyse the identical system without
the port touching a JAX object.
"""

from __future__ import annotations

import numpy as np

from .core.topology import Topology
from .core.trajectory import MemoryReader
from .core.universe import Universe


def universe_from_arrays(n_atoms: int, attrs: dict, positions,
                         velocities=None, dimensions=None,
                         dt: float = 1.0) -> Universe:
    """Universe with a :class:`MemoryReader` over the given arrays.

    ``attrs`` maps atom- or residue-level topology attribute names
    (``names``, ``masses``, ``resids``, ``resnames``, ...) to per-atom
    arrays of length ``n_atoms``. Residues are the runs of equal
    consecutive ``resids`` (one residue when none are given).
    ``positions``/``velocities`` are (n_frames, n_atoms, 3); ``dimensions``
    is one box ``[lx, ly, lz, alpha, beta, gamma]`` or one per frame.
    """
    attrs = {name: np.asarray(values) for name, values in attrs.items()}
    resids = attrs.get("resids")
    if resids is not None and n_atoms:
        starts = np.r_[True, resids[1:] != resids[:-1]]
        resindex = np.cumsum(starts) - 1
    else:
        resindex = np.zeros(n_atoms, np.int64)
    n_residues = int(resindex.max()) + 1 if n_atoms else 1
    top = Topology(n_atoms, n_residues, atom_resindex=resindex)
    for name, values in attrs.items():
        top.add_attr(name, values)
    reader = MemoryReader(positions, velocities=velocities,
                          dimensions=dimensions, dt=dt)
    return Universe(top, reader)

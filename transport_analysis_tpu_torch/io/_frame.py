"""Writer input coercion: accept Timestep / AtomGroup / Universe.

MDAnalysis writers accept ``w.write(universe_or_atomgroup)`` (and
historically Timesteps); the reference's users carry that habit, so
every writer here routes its first argument through
:func:`extract_frame` — plain arrays pass through untouched.
"""

from __future__ import annotations

import numpy as np


def extract_frame(obj):
    """Normalize a writer's first argument.

    Returns ``(positions, velocities, forces, dimensions, time)`` with
    unavailable fields ``None``. Accepts a Universe (its atoms), an
    AtomGroup (its selection against the current frame), a Timestep,
    or a plain ``(n_atoms, 3)`` array of positions.
    """
    if obj is None:
        return None, None, None, None, None
    if hasattr(obj, "atoms") and hasattr(obj, "trajectory"):  # Universe
        obj = obj.atoms
    if hasattr(obj, "universe"):  # AtomGroup
        ts = obj.universe.trajectory.ts
        return (
            obj.positions if ts.has_positions else None,
            obj.velocities if ts.has_velocities else None,
            obj.forces if getattr(ts, "has_forces", False) else None,
            ts.dimensions,
            float(ts.time),
        )
    if hasattr(obj, "has_positions"):  # Timestep
        return (
            obj.positions if obj.has_positions else None,
            obj.velocities if obj.has_velocities else None,
            obj.forces if getattr(obj, "has_forces", False) else None,
            obj.dimensions,
            float(obj.time),
        )
    return np.asarray(obj), None, None, None, None

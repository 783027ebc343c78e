"""On-the-fly trajectory transformations.

Mirrors the slice of ``MDAnalysis.transformations`` the reference tests
use: ``set_dimensions`` (reference test_viscosity.py:9,82 applies it per
frame to give the synthetic box its volume).
"""

from __future__ import annotations

import numpy as np


class set_dimensions:
    """Set the unit-cell ``[lx, ly, lz, alpha, beta, gamma]`` on a
    Timestep. Writes in place when the Timestep exposes a backing-store
    view so the assignment persists across frame seeks."""

    def __init__(self, dimensions):
        self.dimensions = np.asarray(dimensions, dtype=np.float64)
        if self.dimensions.shape != (6,):
            raise ValueError(
                "dimensions must be [lx, ly, lz, alpha, beta, gamma]"
            )

    def __call__(self, ts):
        if ts.dimensions is None:
            ts.dimensions = self.dimensions.copy()
        else:
            ts.dimensions[:] = self.dimensions
        return ts

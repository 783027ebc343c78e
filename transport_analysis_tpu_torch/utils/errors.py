"""Exception types.

Mirrors the error contract the reference consumes from MDAnalysis:
``NoDataError`` raised when a trajectory lacks required per-frame data
(reference velocityautocorr.py:186-189, viscosity.py:178-186).
"""

import numpy as np


class TransportAnalysisError(Exception):
    """Base class for all transport_analysis_tpu_torch errors."""


class NoDataError(TransportAnalysisError, ValueError, AttributeError):
    """Data required for the analysis is missing from the trajectory.

    Subclasses ``ValueError`` and ``AttributeError`` like MDAnalysis's
    ``NoDataError`` so existing except-clauses keep working.
    """


class SelectionError(TransportAnalysisError, ValueError):
    """Raised for invalid atom-selection strings."""


def check_work_dtype(dtype) -> None:
    """The analyses' work dtype, as the JAX package takes it: float64
    (the default, reference-grade numerics) or float32 (the float32 work
    mode, about 1e-6 grade); anything else raises ``ValueError``."""
    # imported here: ``_device`` imports ``utils.profiling``, so this
    # package, for its spans
    from .._device import WORK_TYPES

    if np.dtype(dtype) not in WORK_TYPES:
        raise ValueError(
            f"dtype must be float64 or float32, got dtype={np.dtype(dtype)}")

"""Exception types.

Mirrors the error contract the reference consumes from MDAnalysis:
``NoDataError`` raised when a trajectory lacks required per-frame data
(reference velocityautocorr.py:186-189, viscosity.py:178-186).
"""


class TransportAnalysisError(Exception):
    """Base class for all transport_analysis_tpu_torch errors."""


class NoDataError(TransportAnalysisError, ValueError, AttributeError):
    """Data required for the analysis is missing from the trajectory.

    Subclasses ``ValueError`` and ``AttributeError`` like MDAnalysis's
    ``NoDataError`` so existing except-clauses keep working.
    """


class SelectionError(TransportAnalysisError, ValueError):
    """Raised for invalid atom-selection strings."""


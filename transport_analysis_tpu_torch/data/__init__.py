"""Packaged data: the ethylene-carbonate regression system
(``files.ec_top``, ``files.ec_traj_trr``), generated on first access by
``generate.py``, and a logo text file."""

from . import files  # noqa: F401

__all__ = ["files"]

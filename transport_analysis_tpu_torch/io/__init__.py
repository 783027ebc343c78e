"""Trajectory / topology file I/O.

Format dispatch by file extension. Readers implement the ProtoReader
batch contract (core/trajectory.py); TRR batches and XTC frames decode in
C++ (io/_native, compiled with g++ at first use; a failed build raises).
``io.prefetch`` decodes frame blocks on a background thread.
"""

from __future__ import annotations

import os


def _ext(path) -> str:
    return os.path.splitext(str(path))[1].lower().lstrip(".")


def load_topology(path):
    """Parse a topology file → core.topology.Topology."""
    ext = _ext(path)
    if ext == "pdb":
        from .pdb import parse_pdb_topology

        return parse_pdb_topology(path)
    if ext == "psf":
        from .psf import parse_psf_topology

        return parse_psf_topology(path)
    raise ValueError(f"unsupported topology format: .{ext}")


def open_trajectory(path, n_atoms=None):
    """Open a trajectory file → ProtoReader subclass."""
    ext = _ext(path)
    if ext == "trr":
        from .trr import TRRReader

        return TRRReader(path)
    if ext == "xtc":
        from .xtc import XTCReader

        return XTCReader(path)
    if ext == "dcd":
        from .dcd import DCDReader

        return DCDReader(path)
    if ext in ("nc", "ncdf", "netcdf"):
        from .netcdf import NCDFReader

        return NCDFReader(path)
    if ext in ("h5md", "h5", "hdf5"):
        from .h5md import H5MDReader

        return H5MDReader(path)
    if ext == "pdb":
        from .pdb import PDBReader

        return PDBReader(path)
    raise ValueError(f"unsupported trajectory format: .{ext}")


def Writer(path, n_atoms: int, **kwargs):
    """Uniform writer dispatch by extension (MDAnalysis
    ``mda.Writer``-style): returns a context-manager writer whose
    ``write()`` accepts a Universe / AtomGroup / Timestep or plain
    arrays (io/_frame.extract_frame).

    kwargs pass through to the format writer (e.g. ``precision=`` for
    XTC, ``velocities=True`` for NetCDF/H5MD).
    """
    ext = _ext(path)
    if ext == "trr":
        from .trr import TRRWriter

        return TRRWriter(path, n_atoms, **kwargs)
    if ext == "xtc":
        from .xtc import XTCWriter

        return XTCWriter(path, n_atoms, **kwargs)
    if ext == "dcd":
        from .dcd import DCDWriter

        return DCDWriter(path, n_atoms, **kwargs)
    if ext in ("nc", "ncdf", "netcdf"):
        from .netcdf import NCDFWriter

        return NCDFWriter(path, n_atoms, **kwargs)
    if ext in ("h5md", "h5", "hdf5"):
        from .h5md import H5MDWriter

        return H5MDWriter(path, n_atoms, **kwargs)
    raise ValueError(f"unsupported trajectory format: .{ext}")

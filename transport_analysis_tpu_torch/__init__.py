"""
transport_analysis_tpu_torch
============================

The PyTorch/CUDA port of ``transport_analysis_tpu``: the same analyses and
public names, computed in float64 on NVIDIA Hopper cards (H100) through
kernels written by hand in CUDA C++, or on the CPU through their plain
PyTorch versions.

* ``core``   — Universe / AtomGroup / Timestep data model + selection
               language (numpy only, copied from the JAX package).
* ``models`` — ``VelocityAutocorr``, ``ViscosityHelfand`` and
               ``EinsteinMSD`` with the reference's API surface, plus
               ``device=``; ``fft=True`` (default) or the exact windowed
               ``fft=False`` with ``max_lag``.
* ``ops``    — the Wiener–Khinchin autocorrelation (four-step FFT
               kernels, ``ops/cuda_fft.py``), the Kneller/Calandrini
               Einstein assembly (``ops/cuda_kneller.py``), the windowed
               lag sums (``ops/cuda_lag.py``), integration and linear
               fits.
* ``velocityautocorr``, ``viscosity`` — the reference's import paths.
* ``io``     — TRR, XTC, DCD, AMBER NetCDF, H5MD and PDB trajectories,
               PDB and PSF topologies (``Universe(top, traj)``); TRR
               batches and XTC frames decode in C++ compiled by g++ at
               first use (``io/_native``).
* ``data``   — the ethylene-carbonate regression files, generated on
               first access.
* ``convert`` — builds a Universe from plain numpy arrays.
* ``entry``  — the fused VACF + Green–Kubo + Helfand + MSD step and its
               mesh dry run (the JAX package's ``__graft_entry__.py``).
* ``utils``  — units, errors, progress bars, stage timing
               (``analysis.timing``) and ``torch.profiler`` traces.
* ``due``    — the duecredit citation shim (a no-op without it).
* ``parallel`` — meshes of devices over which the analyses shard their
               particle axis (``use_mesh``, ``analysis_mesh``), the exact
               ring over frame blocks, the frame-sharded FFT, the
               multi-process feed (``torch.distributed``), atom-chunked
               streaming and the out-of-core spools.

The kernels (``csrc/*.cu``) are compiled by nvcc for sm_90a at first use
(``_build.py``). A CUDA tensor always goes to its kernel, or raises; a CPU
tensor runs the plain version. This package never imports jax.
"""

from ._version import __version__, get_versions as _get_versions
from ._device import resolve_device
from .utils.errors import NoDataError
from .core.universe import Universe
from .core.groups import AtomGroup, UpdatingAtomGroup
from .models.velocityautocorr import VelocityAutocorr
from .models.viscosity import ViscosityHelfand
from .models.msd import EinsteinMSD
from . import convert, data, io, ops, parallel

__all__ = [
    "Universe",
    "AtomGroup",
    "UpdatingAtomGroup",
    "NoDataError",
    "VelocityAutocorr",
    "ViscosityHelfand",
    "EinsteinMSD",
    "resolve_device",
    "__version__",
]


def __getattr__(name: str):
    # ``__git_revision__`` asks git when it is read, so that importing the
    # package starts no process
    if name == "__git_revision__":
        return _get_versions()["full-revisionid"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

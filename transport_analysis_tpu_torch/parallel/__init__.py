"""Multi-device and streaming runs.

Counterpart of ``transport_analysis_tpu/parallel``: a mesh of this
process's devices (``mesh``) over which the analyses shard their particle
axis (``sharding``), the exact ring of the windowed correlation over frame
blocks (``ring``), the frame-sharded four-step FFT (``sharded_fft``), the
multi-process feed (``multihost``, on ``torch.distributed``), atom-chunked
streaming with checkpoint/resume (``streaming``) and the out-of-core
spools (``out_of_core``).
"""

import importlib

from .mesh import analysis_mesh, use_mesh, current_mesh
from .sharding import shard_frames_axis, shard_particles

_SUBMODULES = ("streaming", "out_of_core", "ring", "sharded_fft",
               "multihost")

__all__ = [
    "analysis_mesh",
    "use_mesh",
    "current_mesh",
    "shard_particles",
    "shard_frames_axis",
]


def __getattr__(name: str):
    # ``from ...parallel import ring`` looks the name up here before it
    # imports the submodule, so the submodules load on lookup
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Streaming and out-of-core runs on one card.

``parallel.streaming`` (atom chunks with checkpoint/resume) and
``parallel.out_of_core`` (the disk-spool pipeline) are ported. The
multi-device names of ``transport_analysis_tpu.parallel`` (meshes and
sharding) are not: they raise ``NotImplementedError`` naming ROADMAP.md
queue 1 item 5.
"""

import importlib

from ..utils.errors import not_ported_module

_SUBMODULES = ("streaming", "out_of_core")
_not_ported = not_ported_module("parallel", "multigpu")


def __getattr__(name: str):
    # ``from ...parallel import streaming`` looks the name up here before
    # it imports the submodule, so the ported submodules load on lookup
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    return _not_ported(name)

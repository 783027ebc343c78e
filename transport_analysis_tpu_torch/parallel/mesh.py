"""Device-mesh management.

Counterpart of ``transport_analysis_tpu/parallel/mesh.py``. The analyses
scale by sharding the *particle* axis over devices: per-particle
correlations are embarrassingly parallel, so the only communication is
gathering the per-particle results before the particle mean.

A mesh is a list of torch devices of this process with a named axis, and
the analyses inside ``use_mesh`` run their kernels on each device's shard
(one controller, as in the JAX package). One device may stand in a mesh
more than once: ``analysis_mesh(["cuda"] * 4)`` splits the work four ways
on one card, ``analysis_mesh(["cpu"] * 8)`` eight ways on the CPU; on a
node of several cards each shard lives on its own card, and the kernels
of different cards run concurrently. ``torch.distributed`` spans
processes only in ``parallel.multihost``.

Usage::

    from transport_analysis_tpu_torch import parallel
    with parallel.use_mesh(parallel.analysis_mesh()):
        VelocityAutocorr(ag).run()
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

from .._device import resolve_device

_state = threading.local()

ATOM_AXIS = "atoms"


class Mesh:
    """A 1-D mesh: ``devices`` (torch devices, or names such as "cuda:1";
    repeats allowed) along the one axis of ``axis_names``. ``shape[axis]``
    is the axis' size, as for a JAX mesh. A CUDA device without an index
    is the current card. Every device must be of one type: a mesh that
    mixes the CPU and CUDA raises ``ValueError``. ``processes`` > 1 is a
    global mesh of that many processes, each holding ``devices``
    (``parallel.multihost.global_mesh``): its axis is processes ×
    devices long."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str],
                 processes: int = 1):
        axis_names = tuple(axis_names)
        if len(axis_names) != 1:
            raise ValueError(f"a mesh has one axis, got {axis_names}")
        devices = tuple(_resolved(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devices}
        if len(kinds) > 1:
            raise ValueError(f"a mesh's devices must be all CPU or all CUDA, "
                             f"got {sorted(kinds)}")
        if processes < 1:
            raise ValueError(f"processes = {processes} must be >= 1")
        self.devices = devices
        self.axis_names = axis_names
        self.processes = processes
        self.shape = {axis_names[0]: processes * len(devices)}

    @property
    def size(self) -> int:
        return self.shape[self.axis_names[0]]

    def __repr__(self) -> str:
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, processes={self.processes})")


def _resolved(device) -> torch.device:
    """A mesh device: :func:`resolve_device`, a CUDA device given its
    index."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def analysis_mesh(devices=None) -> Mesh:
    """A 1-D mesh over every visible CUDA device (or the given ones) with
    axis 'atoms'; without a card the default raises, as the port's
    defaults do."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([f"cuda:{i}" for i in range(count)] if count
                   else [None])  # resolve_device(None) raises
    return Mesh(devices, (ATOM_AXIS,))


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Context manager: analyses run inside shard their particle axis
    over ``mesh`` (thread-local, as in the JAX package)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev

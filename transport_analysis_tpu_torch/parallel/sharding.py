"""Sharding placement helpers.

Counterpart of ``transport_analysis_tpu/parallel/sharding.py``.
``shard_particles`` splits a ``(frames, particles, dims)`` block along its
particle axis over the active mesh (``parallel.mesh``): the axis is padded
with zeros to a multiple of the mesh size, as the JAX package pads it, and
cut into contiguous shards, each copied to its device. A
:class:`ShardedBlock` carries them. The analyses run the same kernels on
every shard, each on its own device, and :func:`gather` joins the
per-particle results in shard order; zero-padded particles give zero rows,
which the callers slice away with the original count before the mean.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .._device import as_tensor
from .mesh import ATOM_AXIS, Mesh, current_mesh


class ShardedBlock:
    """A block split along ``axis`` into ``shards``, tensors in mesh order,
    each on its device; ``shape`` is the global (padded) shape and
    ``offsets[i]`` shard i's first index along the axis. ``distributed``:
    the block's other shards lie in other processes
    (``parallel.multihost``); :meth:`gather` and :meth:`psum` then reach
    them through ``torch.distributed``."""

    def __init__(self, shards: Sequence[torch.Tensor], shape, axis: int,
                 offsets: Sequence[int], distributed: bool = False):
        self.shards = list(shards)
        self.shape = tuple(shape)
        self.axis = axis
        self.offsets = list(offsets)
        self.distributed = distributed

    def map(self, fn: Callable) -> list:
        """``fn`` of each shard, in shard order. The kernels launch on
        each shard's device, so shards on different cards run
        concurrently."""
        return [fn(s) for s in self.shards]

    def gather(self, device=None) -> torch.Tensor:
        """The whole block on ``device`` (default: the first shard's):
        the shards joined along the axis, and across the processes in
        rank order when ``distributed``."""
        local = gather(self.shards, self.axis, device)
        if not self.distributed:
            return local
        from .multihost import all_gather

        return torch.cat(all_gather(local), dim=self.axis)

    def psum(self, fn: Callable, device=None) -> torch.Tensor:
        """Σ over every shard of ``fn(shard)`` on ``device`` (default:
        the first shard's), all-reduced across the processes when
        ``distributed``."""
        device = self.shards[0].device if device is None else device
        total = None
        for part in self.map(fn):
            part = part.to(device)
            total = part if total is None else total + part
        if self.distributed:
            from .multihost import all_reduce

            all_reduce(total)
        return total


def gather(parts: Sequence[torch.Tensor], axis: int,
           device=None) -> torch.Tensor:
    """``parts`` (tensors on any devices) joined along ``axis`` on
    ``device`` (default: the first part's)."""
    device = parts[0].device if device is None else device
    return torch.cat([p.to(device) for p in parts], dim=axis)


def _key(ndim: int, axis: int, lo: int, hi: int) -> tuple:
    return (slice(None),) * axis + (slice(lo, hi),) + (slice(None),) * (
        ndim - axis - 1)


def shard_pieces(piece: Callable, shape, axis: int,
                 mesh: Mesh) -> ShardedBlock:
    """A :class:`ShardedBlock` of a block of ``shape`` over ``mesh``'s
    devices, whose shard i takes indices [i·w, (i + 1)·w) along ``axis``,
    w = ceil(shape[axis] / mesh size): ``piece(lo, hi, device)`` gives the
    block's indices [lo, hi) along the axis as a tensor on ``device``, and
    indices past shape[axis] are zeros."""
    if mesh.processes > 1:
        raise ValueError("a mesh of several processes takes its block "
                         "through parallel.multihost.distribute_atom_block")
    n = shape[axis]
    width = -(-n // mesh.size)
    shards, offsets = [], []
    for i, device in enumerate(mesh.devices):
        lo = min(i * width, n)
        hi = min(lo + width, n)
        t = as_tensor(piece(lo, hi, device), device)
        if hi - lo < width:
            pad = list(t.shape)
            pad[axis] = width - (hi - lo)
            t = torch.cat([t, t.new_zeros(pad)], dim=axis)
        shards.append(t.contiguous())
        offsets.append(i * width)
    padded = list(shape)
    padded[axis] = width * mesh.size
    return ShardedBlock(shards, padded, axis, offsets)


def shard_particles(arr, axis: int = 1, device=None):
    """``arr`` with its particle axis sharded over the active mesh:
    (:class:`ShardedBlock`, original count). The axis is padded with
    zeros up to a multiple of the mesh size (callers slice results back
    with the original count). With no mesh active: (``arr`` as a tensor
    on ``device``, count)."""
    mesh = current_mesh()
    if mesh is None:
        t = as_tensor(arr, device)
        return t, t.shape[axis]
    ndim = len(arr.shape)
    block = shard_pieces(
        lambda lo, hi, dev: arr[_key(ndim, axis, lo, hi)], arr.shape, axis,
        mesh)
    return block, arr.shape[axis]


def shard_frames_axis(arr, device=None):
    """Device placement for a (frames, particles, dims) analysis block:
    the particle axis over the mesh when one is active (a
    :class:`ShardedBlock`, possibly padded), else ``arr`` as a tensor on
    ``device``. Zero-padded particles contribute zero rows that callers
    drop by slicing to the original particle count."""
    return shard_particles(arr, axis=1, device=device)[0]


def map_particles(kernel: Callable, series, piece: Optional[Callable] = None
                  ) -> torch.Tensor:
    """The analyses' particle sharding under the active mesh: ``kernel``
    ((N, w, d) tensor → (L, w) per-particle results) on each particle
    shard of ``series`` (N, P, d), each on its device; the results
    gathered in shard order on the mesh's first device and sliced to the
    P particles. ``piece(lo, hi, device)`` gives particles [lo, hi) on
    ``device`` where slicing ``series`` does not (default: its slice)."""
    mesh = current_mesh()
    n = series.shape[1]
    if piece is None:
        block, _ = shard_particles(series)
    else:
        block = shard_pieces(piece, series.shape, 1, mesh)
    return gather(block.map(kernel), 1, mesh.devices[0])[:, :n]


__all__ = ["ATOM_AXIS", "ShardedBlock", "gather", "map_particles",
           "shard_frames_axis", "shard_particles", "shard_pieces"]

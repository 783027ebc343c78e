"""Multi-process data feed.

Counterpart of ``transport_analysis_tpu/parallel/multihost.py``. Where
several processes each drive their own devices (one per node, or one per
card group), the trajectory is fed per process: each process loads only
the atoms of its own shards of a global mesh and receives them as a
:class:`~.sharding.ShardedBlock` with the global shape, whose
cross-process reductions (:meth:`~.sharding.ShardedBlock.psum`) and
``gather()`` go through ``torch.distributed`` on the default group: gloo
for CPU tensors, NCCL for CUDA ones. The caller starts the group
(``torch.distributed.init_process_group``, with its address, world size
and rank); the process index and count come from it, and are 0 and 1
when no group is initialised, so a one-process run takes the same path.

The exchanges of the sequence-parallel paths (``parallel.ring``,
``parallel.sharded_fft``) travel through :func:`send_recv`,
:func:`all_to_all`, :func:`all_reduce` and :func:`all_gather`, which
hide what the backend takes: NCCL moves CUDA tensors as they are; gloo
takes CPU tensors only, so a CUDA tensor is staged through a host copy
and copied back onto its card (two processes on one card must use gloo:
NCCL refuses two ranks on one GPU). Only the message travels through the
host; the compute stays where the tensors are. NCCL has no complex
types, so complex tensors travel as their ``torch.view_as_real`` views.
:data:`traffic` counts the bytes this process hands over for others.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from .mesh import ATOM_AXIS, Mesh
from .sharding import ShardedBlock


class Traffic:
    """Bytes this process handed to ``torch.distributed`` for other
    processes (``sent``): a send's payload, an all-to-all's blocks for
    the other ranks, and an all-reduce's or all-gather's local tensor once
    for each other process (what direct transfers would move; a
    collective's own algorithm may move more)."""

    def __init__(self):
        self.sent = 0


traffic = Traffic()


def _host_staged() -> bool:
    import torch.distributed as dist

    return dist.get_backend() == "gloo"


def _wire(t: torch.Tensor, host: bool) -> torch.Tensor:
    """``t`` as it travels: complex as its real view, contiguous, and on
    the host when ``host`` (gloo)."""
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.cpu().contiguous() if host else t.contiguous()


def _wire_empty(like: torch.Tensor, host: bool) -> torch.Tensor:
    """An empty buffer for a wire tensor of ``like``."""
    shape = tuple(like.shape) + ((2,) if like.is_complex() else ())
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if host else like.device)


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received wire tensor back in ``like``'s type, on its device."""
    w = w.to(like.device)
    return torch.view_as_complex(w) if like.is_complex() else w


def send_recv(sends, recvs) -> list:
    """Point-to-point transfers, all posted at once
    (``batch_isend_irecv``), so that no order of the ranks deadlocks:
    ``sends`` are (tensor, destination rank) pairs, ``recvs`` (template,
    source rank) pairs. Returns one tensor a receive, of its template's
    shape, type and device."""
    if not sends and not recvs:
        return []
    import torch.distributed as dist

    host = _host_staged()
    ops, bufs = [], []
    for t, dst in sends:
        w = _wire(t, host)
        traffic.sent += w.numel() * w.element_size()
        ops.append(dist.P2POp(dist.isend, w, dst))
    for like, src in recvs:
        buf = _wire_empty(like, host)
        bufs.append((buf, like))
        ops.append(dist.P2POp(dist.irecv, buf, src))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_unwire(buf, like) for buf, like in bufs]


def all_to_all(outgoing) -> list:
    """All-to-all of equal blocks across the processes, by one
    ``all_to_all_single`` with split sizes: ``outgoing[q]`` is this
    process's list of tensors for rank q, of one shape and type
    throughout and the same count for every other rank (this rank's own
    entry is ignored: its blocks stay local copies). Returns, for each
    rank q, the list of q's tensors for this process (empty for this
    rank), on the device of this process's first block."""
    import torch.distributed as dist

    rank, world = process_index_count()
    host = _host_staged()
    like = next(t for q, ts in enumerate(outgoing) if q != rank for t in ts)
    wires = [[_wire(t, host).reshape(-1) for t in ts] if q != rank else []
             for q, ts in enumerate(outgoing)]
    send = torch.cat([w for ws in wires for w in ws])
    recv = torch.empty_like(send)
    splits = [sum(w.numel() for w in ws) for ws in wires]
    dist.all_to_all_single(recv, send, splits, splits)
    traffic.sent += send.numel() * send.element_size()
    shape = _wire_empty(like, host).shape
    out, pos = [], 0
    for q, ws in enumerate(wires):
        got = []
        for w in ws:
            got.append(_unwire(recv[pos:pos + w.numel()].view(shape), like))
            pos += w.numel()
        out.append(got)
    return out


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes, in place, and returned."""
    import torch.distributed as dist

    _, world = process_index_count()
    w = _wire(t, _host_staged())
    dist.all_reduce(w)
    traffic.sent += (world - 1) * w.numel() * w.element_size()
    if w is not t:
        t.copy_(_unwire(w, t))
    return t


def all_gather(t: torch.Tensor) -> list:
    """``t`` of every process, in rank order, on ``t``'s device."""
    import torch.distributed as dist

    _, world = process_index_count()
    w = _wire(t, _host_staged())
    parts = [torch.empty_like(w) for _ in range(world)]
    dist.all_gather(parts, w)
    traffic.sent += (world - 1) * w.numel() * w.element_size()
    return [_unwire(p, t) for p in parts]


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group, or
    (0, 1) when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def axis_position(mesh: Mesh) -> int:
    """The position on the axis of ``mesh`` of this process's first
    device: rank × its devices. The mesh must span the default group's
    processes (one process and no group, or a group of one, for a mesh
    of one process), else ``ValueError``."""
    rank, world = process_index_count()
    if mesh.processes != world:
        raise ValueError(f"a mesh of {mesh.processes} process(es) in a "
                         f"group of {world}")
    return rank * len(mesh.devices)


def global_mesh(devices, axis_name: str = ATOM_AXIS) -> Mesh:
    """The global mesh of the processes of the default group, each holding
    ``devices`` (this process's; one number of devices in every process,
    else ``ValueError``), along ``axis_name``: 'atoms' for the feed,
    'frames' for the ring and the sharded FFT. World × len(devices)
    shards, process r's in positions [r·len(devices), (r+1)·len(devices))."""
    devices = list(devices)
    _, world = process_index_count()
    if world > 1:
        import torch.distributed as dist

        counts = [None] * world
        dist.all_gather_object(counts, len(devices))
        if len(set(counts)) != 1:
            raise ValueError(f"a global mesh needs the same number of "
                             f"devices in every process, got {counts}")
    return Mesh(devices, (axis_name,), processes=world)


def atom_shard_for_process(n_atoms: int, mesh: Mesh) -> slice:
    """Global atom range this process must load: contiguous block
    matching the atoms-axis sharding."""
    n_shards = mesh.shape[ATOM_AXIS]
    if n_atoms % n_shards:
        raise ValueError(
            f"n_atoms={n_atoms} must divide evenly over the "
            f"'{ATOM_AXIS}' axis ({n_shards})"
        )
    per_shard = n_atoms // n_shards
    # shards owned by this process = its devices' positions on the axis
    proc, n_proc = process_index_count()
    shards_per_proc = n_shards // n_proc
    lo = proc * shards_per_proc * per_shard
    hi = lo + shards_per_proc * per_shard
    return slice(lo, hi)


def distribute_atom_block(local_block, n_atoms: int,
                          mesh: Mesh) -> ShardedBlock:
    """This process's (frames, local_atoms, d) slab (its
    ``atom_shard_for_process`` range) as the :class:`ShardedBlock` of its
    shards of the global (frames, n_atoms, d) array: one shard a local
    device of ``mesh``, ``distributed`` when a default group is
    initialised (its ``psum`` and ``gather`` then go through it, also at
    world size 1)."""
    sl = atom_shard_for_process(n_atoms, mesh)
    if local_block.shape[1] != sl.stop - sl.start:
        raise ValueError(f"this process's slab holds {local_block.shape[1]} "
                         f"atoms, its shards {sl.stop - sl.start}")
    per_shard = n_atoms // mesh.shape[ATOM_AXIS]
    shards, offsets = [], []
    for i, dev in enumerate(mesh.devices):
        lo = i * per_shard
        shards.append(as_tensor(local_block[:, lo:lo + per_shard],
                                dev).contiguous())
        offsets.append(sl.start + lo)
    import torch.distributed as dist

    shape = (local_block.shape[0], n_atoms, local_block.shape[2])
    return ShardedBlock(shards, shape, 1, offsets,
                        distributed=dist.is_available()
                        and dist.is_initialized())


__all__ = ["Traffic", "all_gather", "all_reduce", "all_to_all",
           "atom_shard_for_process", "axis_position",
           "distribute_atom_block", "global_mesh", "process_index_count",
           "send_recv", "traffic"]

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
"""

from __future__ import annotations


from .._device import as_tensor
from .mesh import ATOM_AXIS, Mesh
from .sharding import ShardedBlock


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` group, or
    (0, 1) when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(devices) -> Mesh:
    """The global mesh of the processes of the default group, each holding
    ``devices`` (this process's; one number of devices in every process,
    else ``ValueError``), along axis 'atoms': world × len(devices)
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
    return Mesh(devices, (ATOM_AXIS,), processes=world)


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


__all__ = ["atom_shard_for_process", "distribute_atom_block", "global_mesh",
           "process_index_count"]

"""Ring-distributed windowed lag correlation (sequence parallelism).

Counterpart of ``transport_analysis_tpu/parallel/ring.py``. The frame axis
is the analyses' "sequence": for the exact windowed correlations at frame
counts past one device, the trajectory is cut into B contiguous frame
blocks of L frames, block i on mesh device i, and the block pairs meet on
a ring:

    round k (k = 0..B-1):
      device i holds its own block X_i and a visiting block X_j, j = i + k
      (non-cyclic: devices with j ≥ B add nothing); it adds the pair's
      lag sums over the window [kL − L + 1, kL + L − 1] ∩ [0, N) to its
      (N, P) float64 sums; then the visiting block moves one device down
      the ring, a device-to-device copy (peer to peer on a node).

Every lag 0..N-1 receives the sums of exactly the frame pairs the serial
windowed sums take (round 0 the pairs b ≥ a of one block), so after the
partial sums are added on the first device (the JAX package's ``psum``)
the result equals the single-device windowed kernel's up to the order of
the additions. The pair sums run on the card as K8's two-block launch
(``ops.cuda_lag.lag_sums_pair``), O(L²) pairs a round for each device.

The mesh may span several processes (``parallel.multihost.global_mesh``
of the default ``torch.distributed`` group): block g = r·D + l then lives
on local device l of rank r, each process takes its own blocks of the
global array every process passes, a hop across a process boundary goes
from rank r+1's first device to rank r's last one (``multihost.
send_recv``), posted only while the visiting block is live (both ends
test the same condition), and each process's sum over its devices is
all-reduced across the processes (``multihost.all_reduce``). A group of
one process runs no transfer or collective, as without a group.

``mode='acf'`` sums v·v lag products (VACF); ``mode='einstein'`` sums
(A_i − A_j)² differences (Helfand/MSD).
"""

from __future__ import annotations

import torch

from .._device import REAL_TYPES, as_tensor
from ..ops.cuda_lag import lag_sums_pair
from . import multihost
from .mesh import Mesh


def round_window(k: int, block: int, n: int) -> tuple[int, int]:
    """(first lag, lags) of ring round ``k`` over blocks of ``block``
    frames of an N-frame series: [kL − L + 1, kL + L − 1] ∩ [0, N); round
    0 takes lags ≥ 0 only, the pairs b ≥ a of each block."""
    lo = max(0, k * block - block + 1)
    hi = min(n - 1, k * block + block - 1)
    return lo, hi - lo + 1


def windowed_correlation_ring(
    x,
    mesh: Mesh,
    axis_name: str = "frames",
    mode: str = "acf",
    sum_d: bool = True,
) -> torch.Tensor:
    """Distributed exact windowed correlation over a frame-sharded block.

    Parameters
    ----------
    x : (N, P, d) float64 or float32 array or tensor; N must divide evenly
        by the mesh axis size. Arrays go to the mesh's first device. On a
        mesh of several processes every process passes the same global
        array and takes its own blocks of it.
    mesh : ``parallel.mesh.Mesh`` with the axis ``axis_name``, of this
        process's devices or global (``multihost.global_mesh``).
    mode : 'acf' (lag products) or 'einstein' (squared lag differences).
    sum_d : einstein only: sum the components (MSD) or average them
        (Helfand); the acf mode sums them, as the JAX function does.

    Returns
    -------
    (N, P) per-lag *means* on the mesh's first device of this process, of
    ``x``'s type: sums / (N − lag), matching ``ops.acf_windowed`` /
    ``ops.einstein_difference_windowed``; einstein row 0 is 0. Every
    process gets the same means.
    """
    devices = mesh.devices
    n_blocks = mesh.shape[axis_name]
    first = multihost.axis_position(mesh)
    rank, world = multihost.process_index_count()
    x = as_tensor(x, None if isinstance(x, torch.Tensor) else devices[0])
    if x.dtype not in REAL_TYPES or x.ndim != 3:
        raise TypeError(f"the ring takes an (N, P, d) float64 or float32 "
                        f"operand, got {x.dtype} of shape {tuple(x.shape)}")
    if mode not in ("acf", "einstein"):
        raise ValueError(f"mode must be 'acf' or 'einstein', got {mode!r}")
    n, p, _ = x.shape
    if n % n_blocks:
        raise ValueError(
            f"n_frames={n} must be divisible by mesh axis "
            f"{axis_name}={n_blocks}"
        )
    block = n // n_blocks
    n_loc = len(devices)
    reduce_mode = "mean" if mode == "einstein" and not sum_d else "sum"
    own = [x[g * block:(g + 1) * block].to(dev).contiguous()
           for g, dev in zip(range(first, first + n_loc), devices)]
    sums = [torch.zeros((n, p), dtype=torch.float64, device=dev)
            for dev in devices]
    visit = list(own)
    for k in range(n_blocks):
        lo, count = round_window(k, block, n)
        # local device i (axis position first + i) holds block first + i + k
        for i in range(len(visit)):
            part = lag_sums_pair(own[i], visit[i], k * block, lo, count,
                                 mode, reduce_mode)
            sums[i][lo:lo + count] += part
        # the visiting blocks move one device down the ring: device i
        # holds one next round while first + i + k + 1 < B; rank r + 1's
        # first device sends to rank r's last while its block is live
        live = min(n_loc, max(0, n_blocks - k - 1 - first))
        hop = [visit[i + 1].to(devices[i])
               for i in range(min(live, n_loc - 1))]
        sends = ([(visit[0], rank - 1)]
                 if rank > 0 and first + k < n_blocks else [])
        recvs = ([(own[-1], rank + 1)]
                 if live == n_loc and rank + 1 < world else [])
        visit = hop + multihost.send_recv(sends, recvs)
    total = sums[0]
    for part in sums[1:]:
        total += part.to(total.device)
    if world > 1:
        multihost.all_reduce(total)
    out = total / (n - torch.arange(n, dtype=torch.float64,
                                    device=total.device))[:, None]
    if mode == "einstein":
        out[0] = 0.0
    return out.to(x.dtype)

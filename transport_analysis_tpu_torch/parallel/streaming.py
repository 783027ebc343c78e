"""Atom-chunked streaming with checkpoint/resume.

Counterpart of ``transport_analysis_tpu/parallel/streaming.py``. The
particle axis streams through the device in chunks: the full (N, P, d)
series stays where it is (host memory, or the card when the frame-blocked
feed put it there), one chunk at a time is copied to the device and
correlated there, and the running particle sum accumulates in float64 on
the host. Device memory is then bounded by the chunk (``ops.acf``
``auto_atom_chunk``), whatever the number of atoms.

Each chunk boundary is a checkpoint: with ``checkpoint=path`` the
accumulators land in an ``.npz`` after every chunk (written to
``path + ".tmp"``, then ``os.replace``d) and an interrupted run resumes
after the last finished chunk. The file has the JAX package's keys, so a
checkpoint written by either package resumes in the other.

The analyses come here by themselves when a whole run would not fit the
card (``models.base.ParticleAnalysis._per_particle``). Each chunk's turn is
a ``ta.chunk`` span; in it, ``ta.chunk.gather`` around the host copy
that makes the chunk's columns contiguous (before its ``ta.h2d``) and
``ta.chunk.merge`` around the running sum and the scatter into the
(L, P) result (and, after the last chunk, its division by ``divisor``).
The run counts ``chunks``, ``chunk_gather_bytes`` and
``chunk_merge_bytes`` (``utils.profiling.COUNTS``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .._device import as_tensor, resolve_device, to_host
from ..utils.profiling import count, span


def shares_memory(t: torch.Tensor, series) -> bool:
    """Whether the tensor ``t`` may share memory with ``series``, a tensor
    or a numpy array: a kernel that writes to its operand copies it
    first when this holds."""
    if isinstance(series, torch.Tensor):
        return (t.untyped_storage().data_ptr()
                == series.untyped_storage().data_ptr())
    return t.device.type == "cpu" and np.may_share_memory(t.numpy(), series)


def gather_columns(part, device=None):
    """A host array's particle range ``part`` (a view of an (N, P, d)
    array: a chunk's, or a Helfand factor's mesh shard) as a C-contiguous
    array for its copy to ``device`` (default: the card). A
    non-contiguous numpy view is copied, in a ``ta.chunk.gather`` span,
    its bytes counted as the run's ``chunk_gather_bytes``: on PyTorch's
    intra-op threads (numpy's copy runs on one core), into page-locked
    memory where the copy goes to a card (a tensor of PyTorch's caching
    host allocator, whose blocks are recycled, held by the array), so
    that copy runs at the bus's rate. Anything else is returned as it
    is."""
    if not isinstance(part, np.ndarray) or part.flags.c_contiguous:
        return part
    src = torch.from_numpy(part)
    with span("ta.chunk.gather"):
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=(
            resolve_device(device).type == "cuda"))
        out.copy_(src)
    count("chunk_gather_bytes", out.nbytes)
    return out.numpy()


def particle_block(series, lo: int, hi: int, device=None) -> torch.Tensor:
    """Particles [lo, hi) of ``series`` (an (N, P, d) array, tensor, or
    object whose ``[:, lo:hi, :]`` gives one) as a contiguous tensor on
    ``device`` (default: a tensor's own device, the card for an
    array)."""
    return as_tensor(gather_columns(series[:, lo:hi, :], device),
                     device).contiguous()


def chunked_per_particle(
    kernel: Callable,
    series,
    chunk_particles: int,
    want_by_particle: bool = True,
    checkpoint: Optional[str] = None,
    device=None,
    divisor: Optional[float] = None,
):
    """Run ``kernel((N, p, d) tensor) → (L, p)`` over particle chunks.

    ``series`` is an (N, P, d) numpy array or tensor, or any object with
    a ``shape`` whose ``[:, lo:hi, :]`` gives one; each chunk reaches the
    kernel as a contiguous tensor on ``device`` (default: a tensor's own
    device, the CUDA card for an array). The operand may share memory
    with ``series``: a kernel that writes to it copies it first where
    :func:`shares_memory` says so.

    Returns (timeseries_mean (L,), by_particle (L, P) or None), numpy
    float64: the mean is the sum over chunks of each chunk's particle sum,
    divided by P, as in the JAX package; both divided by ``divisor``,
    where given, once every chunk has run (a checkpoint holds them
    undivided).
    """
    n_frames, n_particles, _ = series.shape
    n_chunks = -(-n_particles // chunk_particles)

    # accumulators are sized from the kernel output (kernels may return
    # fewer rows than n_frames, e.g. with max_lag capping)
    acc = None
    by_particle = None
    start_chunk = 0

    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint) as state:
            if (
                int(state["n_frames"]) == n_frames
                and int(state["n_particles"]) == n_particles
                and int(state["chunk_particles"]) == chunk_particles
            ):
                start_chunk = int(state["next_chunk"])
                acc = state["acc"]
                if want_by_particle and "by_particle" in state:
                    by_particle = state["by_particle"]

    for c in range(start_chunk, n_chunks):
        lo = c * chunk_particles
        hi = min(lo + chunk_particles, n_particles)
        with span("ta.chunk"):
            count("chunks", 1)
            result = to_host(kernel(particle_block(series, lo, hi, device)))
            with span("ta.chunk.merge"):
                if acc is None:
                    acc = np.zeros(result.shape[0], dtype=np.float64)
                if by_particle is None and want_by_particle:
                    by_particle = np.zeros((result.shape[0], n_particles))
                # on PyTorch's intra-op threads, as the gather
                acc += torch.from_numpy(result).sum(dim=1).numpy()
                if by_particle is not None:
                    torch.from_numpy(by_particle[:, lo:hi]).copy_(
                        torch.from_numpy(result))
            count("chunk_merge_bytes", result.nbytes)
            # the chunk's host block goes back before the next chunk's copy
            del result
            if checkpoint:
                payload = {
                    "n_frames": n_frames,
                    "n_particles": n_particles,
                    "chunk_particles": chunk_particles,
                    "next_chunk": c + 1,
                    "acc": acc,
                }
                if by_particle is not None:
                    payload["by_particle"] = by_particle
                tmp = checkpoint + ".tmp"
                with open(tmp, "wb") as fh:
                    np.savez(fh, **payload)
                os.replace(tmp, checkpoint)

    if acc is None:  # zero particles / zero chunks
        acc = np.zeros(n_frames, dtype=np.float64)
    timeseries = acc / max(n_particles, 1)
    if divisor is not None:
        with span("ta.chunk.merge"):
            timeseries /= divisor
            if by_particle is not None:
                torch.from_numpy(by_particle).div_(divisor)
        if by_particle is not None:
            count("chunk_merge_bytes", by_particle.nbytes)
    return timeseries, by_particle

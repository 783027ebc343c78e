"""Read-only memory-mapped trajectory buffers.

Readers index and decode straight out of an ``mmap`` instead of
slurping the whole file with ``fh.read()`` — a trajectory larger than
host RAM (the out-of-core contract, parallel/out_of_core.py) must be
pageable, not resident. ``struct.unpack_from`` and ``np.frombuffer``
both accept mmap objects; byte-range slices (``buf[a:b]``) copy only
the slice; the native decoders receive the map's base address.
"""

from __future__ import annotations

import mmap

import numpy as np


def map_readonly(path: str) -> mmap.mmap:
    """Read-only map of ``path``. Raises IOError on an empty file (an
    empty trajectory is malformed anyway, and mmap cannot map it)."""
    with open(path, "rb") as fh:
        try:
            return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:
            raise IOError(f"cannot map {path}: {e}") from e


def base_address(buf) -> int:
    """C base address of a buffer (mmap or bytes) for ctypes calls.

    The returned np.uint8 view must stay referenced for the address's
    lifetime, so callers should hold the buffer itself (the view is
    recreated per call — zero-copy either way).
    """
    view = np.frombuffer(buf, dtype=np.uint8)
    return view.ctypes.data

"""Device selection: one NVIDIA Hopper card, or the CPU when asked.

The port runs on the card unless the caller passes ``device="cpu"`` or
hands in a CPU tensor; with no card the default raises, it never moves to
the CPU. The kernels are built for ``sm_90a`` only, so a CUDA device must
have compute capability (9, 0). On the CPU every kernel wrapper runs its
plain PyTorch version; that choice follows the tensor's device and
nothing else.

Host data crosses to the card through :func:`as_tensor` (or inside
:func:`h2d`) and results come back through :func:`to_host`: each copy in
a ``ta.h2d`` or ``ta.d2h`` span, its bytes counted on the current run
(``utils.profiling``). A copy crosses by DMA where its host side is
page-locked: a pinned tensor, or a view of a trajectory's array that
the analyses' feed (``models.base.ParticleAnalysis``) page-locked in
place. The feed is the float32 samples every reader yields; the work
types below are what the device computes in.

A result of ``_host_pool.POOL_MIN_BYTES`` or more comes back in a
recycled page-locked host block (``_host_pool``), one DMA at the bus's
rate, where a fresh pageable array would be copied at the pace of the
host's first touch of its pages. The array is an ordinary writable
numpy array, valid for as long as the caller holds it or any view of
it; its block is recycled only after that. Blocks are kept by exact
size, and the pool holds no more bytes than the most bytes of results
that were live at once and the last block made. A new block is made
inside a ``ta.d2h.alloc`` span, and the bytes of results that landed in
a recycled one are counted as the run's ``d2h_pool_hit_bytes``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _host_pool
from .utils.profiling import NO_SPAN, count, span

HOPPER = (9, 0)

# The analyses' two work types, by numpy dtype: (real, complex) torch
# types of the float64 mode and of the float32 work mode (dtype=np.float32)
WORK_TYPES = {np.dtype(np.float64): (torch.float64, torch.complex128),
              np.dtype(np.float32): (torch.float32, torch.complex64)}
REAL_TYPES = tuple(real for real, _ in WORK_TYPES.values())
COMPLEX_TYPES = tuple(cplx for _, cplx in WORK_TYPES.values())


def work_types(dtype) -> tuple[torch.dtype, torch.dtype]:
    """The (real, complex) torch types of the work type ``dtype`` belongs
    to: a numpy dtype, or a torch real or complex type, of float64 or
    float32. Any other raises ``TypeError``."""
    for key, types in WORK_TYPES.items():
        if dtype in types or (not isinstance(dtype, torch.dtype)
                              and np.dtype(dtype) == key):
            return types
    raise TypeError(f"no work type of {dtype}: float64 or float32 only")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. ``None`` means the CUDA card, and
    raises as ``"cuda"`` does where there is none. A CUDA device must be a
    Hopper card; anything but it and ``"cpu"`` raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is false"
            )
        cap = tuple(torch.cuda.get_device_capability(device))
        if cap != HOPPER:
            raise RuntimeError(
                f"{torch.cuda.get_device_name(device)} has compute "
                f"capability {cap}; the kernels are built for sm_90a "
                f"(Hopper, {HOPPER})"
            )
    elif device.type != "cpu":
        raise ValueError(
            f"unsupported device {device}: use 'cuda' (Hopper) or 'cpu'"
        )
    return device


def h2d(host, device: torch.device):
    """The span of a copy of ``host`` (a numpy array or a CPU tensor) to
    ``device``: on a card ``ta.h2d``, its bytes counted as the current
    run's ``h2d_bytes`` and, where its host side is page-locked (a pinned
    tensor, an array of a page-locked trajectory), ``h2d_pinned_bytes``;
    on the CPU nothing."""
    if device.type != "cuda":
        return NO_SPAN
    count("h2d_bytes", host.nbytes)
    if (host if isinstance(host, torch.Tensor)
            else torch.from_numpy(host)).is_pinned():
        count("h2d_pinned_bytes", host.nbytes)
    return span("ta.h2d")


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor on ``device``: tensors keep their device when ``device``
    is None; numpy arrays and sequences go to :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        if device is None:
            return x
        device = resolve_device(device)
        if x.device.type != "cpu":
            return x.to(device)
    else:
        x, device = np.asarray(x), resolve_device(device)
    with h2d(x, device):
        return torch.as_tensor(x, device=device)


def to_host(result) -> np.ndarray:
    """A result as a numpy array: a tensor is copied back, from a card
    inside a ``ta.d2h`` span, its bytes counted as the current run's
    ``d2h_bytes``; one of ``_host_pool.POOL_MIN_BYTES`` or more into a
    page-locked block of the pool, with the layout ``.cpu()`` gives."""
    if not isinstance(result, torch.Tensor):
        return np.asarray(result)
    if result.device.type != "cuda":
        return result.cpu().numpy()
    count("d2h_bytes", result.nbytes)
    with span("ta.d2h"):
        if result.nbytes < _host_pool.POOL_MIN_BYTES:
            return result.cpu().numpy()
        return _host_pool.POOL.copy_back(result)

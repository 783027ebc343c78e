"""Device selection: one NVIDIA Hopper card, or the CPU when asked.

The port runs on the card unless the caller passes ``device="cpu"`` or
hands in a CPU tensor; with no card the default raises, it never moves to
the CPU. The kernels are built for ``sm_90a`` only, so a CUDA device must
have compute capability (9, 0). On the CPU every kernel wrapper runs its
plain PyTorch version; that choice follows the tensor's device and
nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

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


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor on ``device``: tensors keep their device when ``device``
    is None; numpy arrays and sequences go to :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))

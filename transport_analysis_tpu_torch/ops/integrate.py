"""Numerical integration and linear fits on tensors.

Counterpart of ``transport_analysis_tpu/ops/integrate.py``: replacements
for the scipy routines the reference calls on the host
(``scipy.integrate.trapezoid/simpson/cumulative_trapezoid`` at
velocityautocorr.py:316,355,408 and ``np.polyfit`` at viscosity.py:240),
with the same numerics, in float64 on the operand's device.
"""

from __future__ import annotations

import torch

from .._device import as_tensor


def _pair(y, x):
    y = as_tensor(y)
    return y, as_tensor(x, y.device).to(y.dtype)


def trapezoid(y, x) -> torch.Tensor:
    """Composite trapezoid rule (scipy.integrate.trapezoid parity)."""
    y, x = _pair(y, x)
    dx = x[1:] - x[:-1]
    return torch.sum(dx * (y[1:] + y[:-1]) * 0.5)


def cumulative_trapezoid(y, x, initial: float = 0.0) -> torch.Tensor:
    """Cumulative trapezoid with an ``initial`` value prepended
    (scipy.integrate.cumulative_trapezoid(..., initial=0) parity)."""
    y, x = _pair(y, x)
    dx = x[1:] - x[:-1]
    partial = torch.cumsum(dx * (y[1:] + y[:-1]) * 0.5, dim=0)
    return torch.cat([torch.full((1,), initial, dtype=y.dtype,
                                 device=y.device), partial + initial])


def _simpson_pairs(y, x) -> torch.Tensor:
    """Composite Simpson over an odd number of points (non-uniform x)."""
    y0, y1, y2 = y[:-2:2], y[1:-1:2], y[2::2]
    x0, x1, x2 = x[:-2:2], x[1:-1:2], x[2::2]
    h0 = x1 - x0
    h1 = x2 - x1
    hsum = h0 + h1
    term = (hsum / 6.0) * (
        (2.0 - h1 / h0) * y0
        + (hsum * hsum / (h0 * h1)) * y1
        + (2.0 - h0 / h1) * y2
    )
    return torch.sum(term)


def simpson(y, x) -> torch.Tensor:
    """Composite Simpson rule (scipy.integrate.simpson parity).

    Odd point counts use pairwise composite Simpson with non-uniform
    spacing. Even point counts apply Cartwright's parabolic correction
    for the final interval, matching modern scipy's default.
    """
    y, x = _pair(y, x)
    n = y.shape[0]
    if n < 3:
        return trapezoid(y, x)
    if n % 2 == 1:
        return _simpson_pairs(y, x)
    main = _simpson_pairs(y[:-1], x[:-1])
    h0 = x[-2] - x[-3]
    h1 = x[-1] - x[-2]
    alpha = (2.0 * h1 * h1 + 3.0 * h0 * h1) / (6.0 * (h0 + h1))
    beta = (h1 * h1 + 3.0 * h0 * h1) / (6.0 * h0)
    eta = h1 ** 3 / (6.0 * h0 * (h0 + h1))
    return main + alpha * y[-1] + beta * y[-2] - eta * y[-3]


def polyfit_linear(x, y):
    """Degree-1 least-squares fit → (slope, intercept)
    (np.polyfit(x, y, 1) parity; reference viscosity.py:240-245).

    Runs in the floating dtype of the inputs; integer inputs promote to
    float64."""
    y = as_tensor(y)
    x = as_tensor(x, y.device)
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float64
    x, y = x.to(dtype), y.to(dtype)
    xm = torch.mean(x)
    ym = torch.mean(y)
    dx = x - xm
    slope = torch.sum(dx * (y - ym)) / torch.sum(dx * dx)
    return slope, ym - slope * xm

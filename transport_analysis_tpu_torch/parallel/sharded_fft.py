"""Frame-axis-sharded four-step FFT (sequence-parallel spectral path).

Counterpart of ``transport_analysis_tpu/parallel/sharded_fft.py``. The
FFT path's frame axis is the analyses' "sequence"; a long enough series
does not fit one device. This module distributes the transform over the
D devices of a mesh axis with the four-step factorization M = N1·N2,
j = j1·N2 + j2, k = k2·N1 + k1, N1 from :func:`_pick_n1` and N2
divisible by D:

forward (input natural order, frame-block sharded: device d holds rows
j = j1·N2 + j2 for its N1/D block of j1):
  1. all-to-all: device d sends its (N1/D, N2/D, B) block of each j2
     block to the device that owns it, so device e holds every j1 of its
     j2 block [e·N2/D, (e+1)·N2/D);
  2. DFT over j1, K1 (``ops.cuda_fft.fft_forward``);
  3. twiddle W_M^{k1·j2}, the root of index (k1·j2) mod M in the order-M
     table ``ops.cuda_fft.roots_tensor``, so large global indices carry no
     large-angle rounding;
  4. all-to-all back: device d receives the rows of its N1/D block of k1
     from every j2 block;
  5. DFT over j2, K1 again, local.

The output stays in "transposed" order: device d holds rows
k1_loc·N2 + k2 of its k1 block, the JAX package's order, which costs
nothing for autocorrelation: the power spectrum is elementwise, and the
inverse transform (the steps mirrored, ``fft_forward`` with sign +1,
and the 1/M scale) consumes exactly that layout and returns natural order.

The JAX package instead contracts a DFT matrix with each device's rows
and reduce-scatters an (N1, N2·B) partial, the whole array on every
device; the two all-to-alls move each value once a transform. A float32
operand runs in complex64, a float64 one in complex128. Each real series
is transformed as a full complex FFT, as in the JAX package: the
Hermitian unpack would need an index reversal across the sharded k1 axis.
On a mesh that repeats one device the exchanges are copies on it.

The mesh may span several processes (``parallel.multihost.global_mesh``
of the default ``torch.distributed`` group): the axis then holds every
process's devices, rank r's at positions [r·D, (r+1)·D). Blocks between
the devices of one process stay local copies; those for another process
are packed into one buffer a peer and moved by one all-to-all with split
sizes (``multihost.all_to_all``), and the results are
:class:`ShardedBlock` s with ``distributed`` set, whose ``gather()``
all-gathers across the processes.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import work_types
from ..ops import cuda_fft
from ..ops.acf import next_pow_2
from . import multihost
from .mesh import Mesh
from .sharding import ShardedBlock


def _pick_n1(m: int, n_dev: int) -> int:
    """N1 must be a power of two, a multiple of the device count, and
    divide M; 128 matches the MXU tile when M is large enough."""
    n1 = max(n_dev, min(128, m // n_dev))
    if m % n1 or n1 % n_dev:
        raise ValueError(
            f"cannot factor M={m} over {n_dev} devices (need pow2 M, "
            f"pow2 device count, M ≥ devices²)"
        )
    return n1


def _factor(m: int, n_dev: int) -> tuple[int, int]:
    """(N1, N2) of the transform of length M over D devices: N1 from
    :func:`_pick_n1`, and N2 = M/N1 divisible by D, which the all-to-all
    blocks need."""
    n1 = _pick_n1(m, n_dev)
    if (m // n1) % n_dev:
        raise ValueError(
            f"cannot factor M={m} over {n_dev} devices: N2 = {m // n1} is "
            f"not divisible by {n_dev}"
        )
    return n1, m // n1


class _Axis:
    """The frames axis of a mesh as this process sees it: its
    ``devices``, the position ``first`` of the first on the axis, the
    axis' ``size`` and the mesh's ``processes``."""

    def __init__(self, mesh: Mesh, axis_name: str):
        self.devices = mesh.devices
        self.first = multihost.axis_position(mesh)
        self.size = mesh.shape[axis_name]
        self.processes = mesh.processes


def _dft(z: torch.Tensor, sign: int) -> torch.Tensor:
    """DFT along axis 0 of a complex (R, C) tensor through K1 (unscaled
    for sign +1); a length-1 transform is the identity."""
    if z.shape[0] == 1:
        return z
    return cuda_fft.fft_forward(z.contiguous(), sign)


def _dft_middle(z: torch.Tensor, sign: int) -> torch.Tensor:
    """DFT along axis 1 of a complex (A, R, B) tensor, written back in that
    layout."""
    a, r, b = z.shape
    y = _dft(z.transpose(0, 1).reshape(r, a * b), sign)
    return y.view(r, a, b).transpose(0, 1).contiguous()


def _twiddle(z: torch.Tensor, j2_0: int, m: int, sign: int) -> torch.Tensor:
    """``z`` (N1, n2_loc, B) times W_M^{±k1·j2}, j2 = j2_0 + its local
    index, each root read from the order-M table at (k1·j2) mod M."""
    n1, n2_loc, _ = z.shape
    k1 = torch.arange(n1, device=z.device)
    j2 = j2_0 + torch.arange(n2_loc, device=z.device)
    tw = cuda_fft.roots_tensor(m, z.device, z.dtype)[(k1[:, None] * j2) % m]
    if sign > 0:
        tw = tw.conj()
    return z * tw[:, :, None]


def _exchange(parts, ax: _Axis) -> list:
    """All-to-all over the axis: ``parts[d][e]``, local device d's block
    for axis position e (blocks of one shape), reaches e's device; returns,
    for each local device, its blocks in axis order of their sources.
    Blocks within the process are copies; the others travel by
    ``multihost.all_to_all``, rank q's list holding, for each local
    source d and each of q's devices e, block (d, e)."""
    n_loc = len(ax.devices)
    recv = [[None] * ax.size for _ in range(n_loc)]
    for e, dev in enumerate(ax.devices):
        for d in range(n_loc):
            recv[e][ax.first + d] = parts[d][ax.first + e].to(dev)
    if ax.processes > 1:
        rank = ax.first // n_loc
        outgoing = [[parts[d][q * n_loc + e] for d in range(n_loc)
                     for e in range(n_loc)] if q != rank else []
                    for q in range(ax.processes)]
        for q, blocks in enumerate(multihost.all_to_all(outgoing)):
            for i, blk in enumerate(blocks):
                d, e = divmod(i, n_loc)
                recv[e][q * n_loc + d] = blk.to(ax.devices[e])
    return recv


def _forward_shards(shards, n1: int, n2: int, ax: _Axis) -> list:
    """The forward four-step of natural-order complex shards (M/D, B) →
    transposed-order shards (rows k1_loc·N2 + k2)."""
    n_dev = ax.size
    n1_loc, n2_loc = n1 // n_dev, n2 // n_dev
    m = n1 * n2
    b = shards[0].shape[1]
    blocks = [s.view(n1_loc, n2, b) for s in shards]
    recv = _exchange([[x[:, e * n2_loc:(e + 1) * n2_loc] for e in range(n_dev)]
                      for x in blocks], ax)
    cols = []
    for e, parts in enumerate(recv):
        y = torch.cat(parts, dim=0)                    # (N1, n2_loc, B): j1
        y = _dft(y.view(n1, n2_loc * b), -1).view(n1, n2_loc, b)   # k1
        cols.append(_twiddle(y, (ax.first + e) * n2_loc, m, -1))
    del recv
    recv = _exchange([[y[d * n1_loc:(d + 1) * n1_loc] for d in range(n_dev)]
                      for y in cols], ax)
    del cols
    out = []
    for parts in recv:
        z = torch.cat(parts, dim=1)                    # (n1_loc, N2, B): j2
        out.append(_dft_middle(z, -1).view(n1_loc * n2, b))   # k2
    return out


def _inverse_shards(shards, n1: int, n2: int, ax: _Axis) -> list:
    """The inverse four-step of transposed-order shards → natural-order
    shards, the 1/M scale included."""
    n_dev = ax.size
    n1_loc, n2_loc = n1 // n_dev, n2 // n_dev
    m = n1 * n2
    b = shards[0].shape[1]
    blocks = [_dft_middle(s.view(n1_loc, n2, b), +1) for s in shards]  # j2
    recv = _exchange([[x[:, e * n2_loc:(e + 1) * n2_loc] for e in range(n_dev)]
                      for x in blocks], ax)
    del blocks
    cols = []
    for e, parts in enumerate(recv):
        c = _twiddle(torch.cat(parts, dim=0), (ax.first + e) * n2_loc, m,
                     +1)                                           # k1, j2
        cols.append(_dft(c.view(n1, n2_loc * b), +1).view(n1, n2_loc, b))
    del recv
    recv = _exchange([[c[d * n1_loc:(d + 1) * n1_loc] for d in range(n_dev)]
                      for c in cols], ax)
    del cols
    return [torch.cat(parts, dim=1).view(n1_loc * n2, b) * (1.0 / m)
            for parts in recv]


def _row_shards(x, m: int, ax: _Axis) -> list:
    """This process's row blocks of the (M, S) zero-padded global operand
    of an (N, S) array or tensor, N ≤ M: M/D rows an axis position, each
    made on its device (no padded copy on the host)."""
    rows = m // ax.size
    n = x.shape[0]
    shards = []
    for i, dev in zip(range(ax.first, ax.first + len(ax.devices)),
                      ax.devices):
        lo, hi = i * rows, min((i + 1) * rows, n)
        part = torch.as_tensor(x[lo:max(lo, hi)]).to(dev)
        t = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=part.dtype,
                        device=dev)
        t[:part.shape[0]] = part
        shards.append(t)
    return shards


def _complex_shards(re, im, m: int, ax: _Axis) -> list:
    """Global (M, B) real and imaginary parts (arrays, tensors or
    :class:`ShardedBlock` s of axis 0) → this process's complex row
    shards."""
    if isinstance(re, ShardedBlock):
        re_s, im_s = re.shards, im.shards
    else:
        re_s, im_s = _row_shards(re, m, ax), _row_shards(im, m, ax)
    return [torch.complex(r.to(dev), i.to(dev))
            for r, i, dev in zip(re_s, im_s, ax.devices)]


def _block(shards, m: int, ax: _Axis) -> ShardedBlock:
    rows = shards[0].shape[0]
    return ShardedBlock(shards, (m,) + tuple(shards[0].shape[1:]), 0,
                        [(ax.first + i) * rows for i in range(len(shards))],
                        distributed=ax.processes > 1)


def sharded_fft(re, im, mesh: Mesh, axis_name: str = "frames",
                inverse: bool = False, transposed_output: bool = True):
    """Distributed complex FFT along axis 0 of global (M, B) arrays.

    Forward maps natural order → transposed (k1-major) order; inverse
    maps transposed → natural. Round-tripping forward + inverse
    returns the original natural-order array (this is how the
    autocorrelation uses it — elementwise ops in between are layout-
    blind). ``transposed_output`` is part of the contract, not an
    optimization flag; it exists so callers document which layout they
    hold.

    ``re``, ``im``: arrays or tensors of the global (M, B) parts, or the
    :class:`ShardedBlock` s a previous call returned; float32 parts run in
    complex64, float64 ones in complex128. Returns the (real, imaginary)
    parts as :class:`ShardedBlock` s of row shards on the mesh's devices
    (``.gather()`` joins them, across the processes of a global mesh).
    """
    if not transposed_output:
        raise NotImplementedError(
            "natural-order spectral output needs a k1 all-to-all; "
            "autocorrelation never materializes it"
        )
    ax = _Axis(mesh, axis_name)
    m = re.shape[0]
    n1, n2 = _factor(m, ax.size)
    z = _complex_shards(re, im, m, ax)
    out = (_inverse_shards if inverse else _forward_shards)(z, n1, n2, ax)
    return (_block([s.real for s in out], m, ax),
            _block([s.imag for s in out], m, ax))


def _raw_autocorr_shards(shards, m: int, ax: _Axis) -> list:
    """fwd FFT → power spectrum → inv FFT of real natural-order row
    shards; the real part, natural order."""
    n1, n2 = _factor(m, ax.size)
    cplx = work_types(shards[0].dtype)[1]
    z = _forward_shards([s.to(cplx) for s in shards], n1, n2, ax)
    power = [(s.real.square() + s.imag.square()).to(cplx) for s in z]
    del z
    return [s.real for s in _inverse_shards(power, n1, n2, ax)]


def sharded_raw_autocorr(x, mesh: Mesh, axis_name: str = "frames"
                         ) -> ShardedBlock:
    """Raw linear autocorrelation per column of global (M, S) real
    input (already zero-padded to M ≥ 2·series_length, M a power of
    two), frame-sharded over ``axis_name``. Returns the full (M, S)
    circular result in natural order as a :class:`ShardedBlock` of row
    shards (callers slice [:n_out] of ``.gather()``)."""
    ax = _Axis(mesh, axis_name)
    m = x.shape[0]
    shards = (x.shards if isinstance(x, ShardedBlock)
              else _row_shards(x, m, ax))
    return _block(_raw_autocorr_shards(shards, m, ax), m, ax)


def sharded_acf_fft(x, mesh: Mesh, axis_name: str = "frames") -> np.ndarray:
    """Frame-sharded batched VACF: (N, P, d) → (N, P), matching
    ops.acf_fft (reference velocityautocorr.py:208-215 semantics) with
    the frame axis distributed over the mesh. Numpy in, numpy out (of the
    JAX function's type: float64)."""
    x = np.asarray(x)
    n, p, d = x.shape
    m = 2 * next_pow_2(n)
    ax = _Axis(mesh, axis_name)
    shards = _row_shards(x.reshape(n, p * d), m, ax)
    raw = _block(_raw_autocorr_shards(shards, m, ax), m, ax).gather()[:n]
    raw = raw.reshape(n, p, d).sum(-1).to(torch.float64)
    lags = torch.arange(n, dtype=torch.float64, device=raw.device)
    return (raw / (n - lags)[:, None]).cpu().numpy()


def sharded_msd_fft(a, mesh: Mesh, axis_name: str = "frames",
                    reduce_mode: str = "sum") -> np.ndarray:
    """Frame-sharded Einstein lag-difference curve: (N, P, d) → (N, P).

    Same identity as ops.einstein_difference_fft — centered series,
    S_head + S_tail − 2·corr — with the correlation term computed by
    the distributed FFT and the centering and prefix sums on the mesh's
    first device (O(N·P), small beside the transform). float64, numpy in
    and out."""
    ax = _Axis(mesh, axis_name)
    dev = ax.devices[0]
    a = torch.as_tensor(np.asarray(a, np.float64), device=dev)
    n, p, d = a.shape
    a = a - a.mean(dim=0, keepdim=True)
    m = 2 * next_pow_2(n)
    corr = sharded_raw_autocorr(
        _block(_row_shards(a.reshape(n, p * d), m, ax), m, ax), mesh,
        axis_name).gather(dev)[:n]
    corr = corr.reshape(n, p, d).sum(-1)

    sq = (a * a).sum(-1)
    css = torch.cumsum(sq, dim=0)
    total = css[-1]
    lags = torch.arange(n, device=dev)
    s_head = css[n - 1 - lags]
    css_prev = torch.cat([sq.new_zeros((1, p)), css[:-1]], dim=0)
    s_tail = total[None, :] - css_prev
    raw = s_head + s_tail - 2.0 * corr
    out = raw / (n - lags).to(torch.float64)[:, None]
    if reduce_mode == "mean":
        out = out / d
    out[0] = 0.0
    return out.cpu().numpy()

"""The fused analysis step and its mesh dry run.

Counterpart of the JAX package's ``__graft_entry__.py`` (which stays that
package's). :func:`entry` returns the fused transport-analysis step,
batched VACF (Wiener–Khinchin), Green–Kubo self-diffusivity, the
Einstein–Helfand viscosity function and its linear-fit slope, and the
Einstein MSD, with example arguments; on the card it launches K1, K2 and
K5 (the FFT path of ``acf_fft``, ``einstein_difference_fft`` and
``msd_fft``) and K6a and K6b (their Kneller assembly).

:func:`dryrun_multichip` runs the step over a mesh of ``n`` devices and
the sequence-parallel paths over the same devices, each against the
one-device result. The JAX dry run shards the step over a 2-D frames ×
atoms mesh; the port's meshes are 1-D, as the JAX package's analyses use
them (its ``parallel/mesh.py``): the step shards its particle axis
(``parallel.use_mesh``), and the ring, the sharded FFT and the sharded
out-of-core runs shard the frame axis. One device may stand in the mesh
``n`` times, so no re-execution is needed: ``Mesh(["cuda"] * n)`` splits
the work n ways on one card, ``Mesh(["cpu"] * n)`` on the CPU.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import ops
from ._device import as_tensor, resolve_device
from .parallel.mesh import ATOM_AXIS, Mesh, current_mesh, use_mesh
from .parallel.sharding import map_particles
from .utils.units import constants

_KB = constants["Boltzmann_constant"]
RTOL, ATOL = 1e-10, 1e-12   # the JAX dry run's bounds


def _by_particle(kernel, series: torch.Tensor) -> torch.Tensor:
    """``kernel`` ((N, P, d) → (N, P)) of ``series``, each particle shard
    on its device under an active mesh."""
    if current_mesh() is None:
        return kernel(series)
    return map_particles(kernel, series)


def analysis_step(velocities, positions, masses, volumes, times):
    """Fused VACF + Green–Kubo D + Helfand viscosity + MSD step on
    tensors: (N, P, d) velocities and positions, (P,) masses, (N,)
    volumes and times. Returns (VACF, D, Helfand function, viscosity
    slope, MSD), the time series (N,) and the scalars 0-d, on the device
    of the velocities (the mesh's first device under ``use_mesh``)."""
    n_frames = velocities.shape[0]
    dim_fac = velocities.shape[-1]

    # VACF (per particle, batched FFT) and Green–Kubo diffusivity
    vacf_ts = _by_particle(ops.acf_fft, velocities).mean(dim=1)
    diffusivity = ops.trapezoid(vacf_ts, times) / dim_fac

    # Einstein–Helfand viscosity function and its slope
    accum = masses[None, :, None] * velocities * positions
    visc_ts = _by_particle(
        lambda a: ops.einstein_difference_fft(a, "mean"), accum
    ).mean(dim=1) / (2.0 * _KB * as_tensor(volumes, vacf_ts.device).mean()
                     * 300.0)
    lagtimes = torch.arange(1, n_frames, dtype=visc_ts.dtype,
                            device=visc_ts.device)
    window = slice(2, max(3, n_frames // 2))
    viscosity, _ = ops.polyfit_linear(lagtimes[window], visc_ts[window])

    # Einstein MSD (positions)
    msd_ts = _by_particle(ops.msd_fft, positions).mean(dim=1)

    return vacf_ts, diffusivity, visc_ts, viscosity, msd_ts


def example_args(device=None, n_frames: int = 64,
                 n_particles: int = 32) -> tuple:
    """The JAX package's ``_example_args``: the same
    ``np.random.RandomState(0)`` draws, float64 tensors on ``device`` (the
    card by default)."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    velocities = rng.normal(0, 5, (n_frames, n_particles, 3))
    positions = np.cumsum(rng.normal(0, 1, (n_frames, n_particles, 3)),
                          axis=0)
    masses = rng.uniform(1, 16, n_particles)
    volumes = np.full((n_frames,), 8.0)
    times = np.arange(n_frames, dtype=np.float64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (velocities, positions, masses, volumes, times))


def entry(device=None):
    """(fn, example_args) of the fused step, the arguments on ``device``
    (the card by default)."""
    return analysis_step, example_args(device)


def _close(got, want, what: str) -> None:
    got, want = (np.asarray(torch.as_tensor(a).cpu()) for a in (got, want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the fused step and the sequence-parallel paths over a mesh of
    ``n_devices`` repeats of ``device`` (the card by default, or "cpu"),
    each against the one-device result at rtol 1e-10 and atol 1e-12, as
    the JAX dry run does; raises ``AssertionError`` on a mismatch.

    Checked: the step with its particle axis sharded over the mesh; the
    exact ring (``parallel.ring``) against ``ops.acf_windowed``; the
    frame-sharded FFT's VACF against ``ops.acf_fft``; the sharded
    out-of-core VACF and Helfand runs against the serial ones, on spools
    in a temporary directory."""
    from .core.transformations import set_dimensions
    from .core.universe import Universe
    from .parallel.out_of_core import (
        helfand_out_of_core, helfand_out_of_core_sharded, vacf_out_of_core,
        vacf_out_of_core_sharded)
    from .parallel.ring import windowed_correlation_ring
    from .parallel.sharded_fft import sharded_acf_fft

    device = resolve_device(device)
    devices = [device] * n_devices
    args = example_args(device, n_frames=16 * n_devices,
                        n_particles=4 * n_devices)

    # the step, its particle axis sharded over the mesh
    with use_mesh(Mesh(devices, (ATOM_AXIS,))):
        out = analysis_step(*args)
    ref = analysis_step(*args)
    for name, got, want in zip(("vacf", "diffusivity", "helfand",
                                "viscosity", "msd"), out, ref):
        _close(got, want, f"sharded step {name}")

    # the sequence-parallel paths: the frame axis over the same devices
    frames = Mesh(devices, ("frames",))
    series = args[0]
    _close(windowed_correlation_ring(series, frames, mode="acf"),
           ops.acf_windowed(series), "ring")
    _close(sharded_acf_fft(series.cpu().numpy(), frames),
           ops.acf_fft(series), "sharded FFT")

    # out-of-core spools (atom axis) and the frame-sharded FFT a chunk,
    # against the serial out-of-core runs of the same universe
    rng = np.random.RandomState(3)
    n_f, n_p = 16 * n_devices, 6
    u = Universe.empty(n_p, n_frames=n_f, velocities=True)
    setter = set_dimensions([8.0, 8.0, 8.0, 90.0, 90.0, 90.0])
    for ts in u.trajectory:
        u.atoms.velocities = rng.normal(0, 5, (n_p, 3))
        u.atoms.positions = rng.uniform(0, 8, (n_p, 3))
        setter(ts)
    u.add_TopologyAttr("masses", np.full(n_p, 2.0))
    with tempfile.TemporaryDirectory() as td:
        _close(vacf_out_of_core_sharded(u, os.path.join(td, "sh"), frames,
                                        atom_chunk=4),
               vacf_out_of_core(u, os.path.join(td, "serial"), atom_chunk=4,
                                device=device),
               "sharded out-of-core VACF")
        _close(helfand_out_of_core_sharded(u, os.path.join(td, "hsh"),
                                           frames, atom_chunk=4)[0],
               helfand_out_of_core(u, os.path.join(td, "hserial"),
                                   atom_chunk=4, device=device)[0],
               "sharded out-of-core Helfand")


__all__ = ["analysis_step", "dryrun_multichip", "entry", "example_args"]

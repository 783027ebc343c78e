"""Velocity autocorrelation function (VACF) and Green–Kubo diffusivity.

Counterpart of ``transport_analysis_tpu/models/velocityautocorr.py`` and of
the reference's ``VelocityAutocorr`` (velocityautocorr.py:72-422):

    C(j Δt) = 1/(N−j) · Σ_i v(iΔt)·v((i+j)Δt)

averaged over all atoms in the group. Same public surface — ctor
``(atomgroup, dim_type, fft)``, ``run(start, stop, step)``,
``results.timeseries`` / ``results.vacf_by_particle``,
``self_diffusivity_gk`` / ``_gk_odd``, ``plot_vacf`` /
``plot_running_integral`` — plus ``device=``. The frame selection's
float32 velocities (the feed of ``models.base.ParticleAnalysis``) cross
to the device in one transfer, upcast there under the float64 work
dtype, and the FFT path runs batched over every particle at once;
``fft=False`` runs the exact windowed sums (K8) on the same feed,
O(N·n_lags) per atom. ``frame_block=`` feeds the card in
frame blocks; ``atom_chunk=`` correlates that many atoms at a time
(``parallel.streaming``), with ``checkpoint=`` an ``.npz`` to resume
from; without it, an FFT run too large for the device's budget streams
``ops.acf.auto_atom_chunk`` chunks by itself (``models.base``). Inside
``parallel.use_mesh`` the particle axis is sharded over the mesh's
devices (``atom_chunk`` ignores the mesh, as in the JAX package).
``dtype=np.float32`` is the float32 work mode, as in the JAX package
(``velocityautocorr.py:60-62``): float32 samples, float32 results
at about 1e-6 grade, through the float32/complex64 instantiations of the
same kernels (an atom-chunked run's results are float64 accumulators of
them, as the JAX package's are).

Results are in MDAnalysis standard units: (Å/ps)² against ps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.groups import UpdatingAtomGroup
from .. import ops
from .._device import as_tensor, work_types
from ..ops import cuda_lag
from ..utils.profiling import span
from .base import ParticleAnalysis


class VelocityAutocorr(ParticleAnalysis):
    """Velocity autocorrelation function over an AtomGroup.

    Parameters
    ----------
    atomgroup : AtomGroup
        Atoms to average over. ``UpdatingAtomGroup`` is rejected — lag
        correlations need a fixed particle set.
    dim_type : {'xyz', 'xy', 'yz', 'xz', 'x', 'y', 'z'}
        Components included in the VACF. Defaults to 'xyz'.
    fft : bool
        ``True`` (default): Wiener–Khinchin FFT algorithm, batched over
        particles. ``False``: exact windowed per-lag summation, O(N·L)
        for L lags; give ``max_lag`` to bound L on long trajectories.
    max_lag : int, optional
        Lags [0, max_lag) only (default: all frames).
    atom_chunk : int, optional
        Correlate this many atoms at a time on the device (bounds device
        memory). Default: the whole selection at once, or, on the FFT
        path with no mesh, where ``ops.acf.chunk_peak_bytes`` of the whole
        run is past ``ops.acf.device_budget_gb``, the chunks of
        ``ops.acf.auto_atom_chunk``.
    checkpoint : str, optional
        With ``atom_chunk``: an ``.npz`` written after every chunk, from
        which an interrupted run resumes (ignored without ``atom_chunk``).
    frame_block : int, optional
        Feed the device in blocks of this many frames, decoded on a
        background thread (the host holds one block at a time).
    dtype : {np.float64, np.float32}
        The work dtype: float64 (default, reference-grade numerics) or
        float32, the fast mode (about 1e-6 relative accuracy).
    device : torch device, optional
        Where the analysis computes: the CUDA card by default (raises
        where there is none), the CPU only as ``"cpu"``.
    """

    FEEDS = ("velocities",)
    NO_DATA_MSG = "VACF computation requires velocities in the trajectory"

    def __init__(self, atomgroup, dim_type: str = "xyz", fft: bool = True,
                 max_lag=None, atom_chunk=None, checkpoint=None,
                 dtype=np.float64, **kwargs):
        if isinstance(atomgroup, UpdatingAtomGroup):
            raise TypeError(
                "UpdatingAtomGroups are not valid for VACF computation"
            )
        self.dim_type = dim_type.lower()
        super().__init__(atomgroup, self.dim_type, fft, max_lag, atom_chunk,
                         checkpoint, dtype, **kwargs)
        self._run_called = False

    def _conclude(self):
        work = work_types(self._work_dtype)[0]

        def kernel(v):
            # the float32 feed is upcast inside the kernel, exactly,
            # under the float64 work dtype
            if not self.fft:
                return cuda_lag.lag_sums(v, self.n_lags, "acf", "sum",
                                         out_dtype=work)
            if work == torch.float64:
                return ops.acf_fft_from_f32(v)[: self.n_lags]
            return ops.acf_fft(v)[: self.n_lags]

        (self.results.timeseries,
         self.results.vacf_by_particle) = self._per_particle(
            kernel, self._velocities)
        self._run_called = True

    def _on_device(self, arr) -> torch.Tensor:
        return as_tensor(arr, self.device)

    # --- derived quantities ---------------------------------------------------
    def _require_run(self, what="plotting"):
        if not self._run_called:
            raise RuntimeError(f"Analysis must be run prior to {what}")

    def self_diffusivity_gk(self, start: int = 0, stop: int = 0,
                            step: int = 1):
        """Green–Kubo self-diffusivity D = ∫C(t)dt / d via the trapezoid
        rule (reference velocityautocorr.py:287-322). Part of the run
        (its ``ta.run.<run_id>`` span and counters), in a ``ta.fit``
        span."""
        self._require_run("computing self-diffusivity")
        return self._integral(ops.trapezoid, start, stop, step)

    def self_diffusivity_gk_odd(self, start: int = 0, stop: int = 0,
                                step: int = 1):
        """Green–Kubo self-diffusivity via Simpson's rule; recommended
        for an odd number of evenly spaced points (reference
        velocityautocorr.py:324-360); spans and counters as
        :meth:`self_diffusivity_gk`."""
        self._require_run("computing self-diffusivity")
        return self._integral(ops.simpson, start, stop, step)

    def _integral(self, rule, start, stop, step) -> float:
        """∫C(t)dt / d over lags [start, stop) by ``rule``, as part of
        the run."""
        with self.timing.running(), span("ta.fit"):
            stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
            return float(
                rule(
                    self._on_device(self.results.timeseries[start:stop:step]),
                    self._on_device(
                        self.times[: self.n_lags][start:stop:step]),
                )
            ) / self.dim_fac

    # --- plotting -------------------------------------------------------------
    def plot_vacf(
        self,
        start: int = 0,
        stop: int = 0,
        step: int = 1,
        xlabel: str = "Time (ps)",
        ylabel: str = "Velocity Autocorrelation Function (Å^2 / ps^2)",
    ):
        """VACF vs time plot; returns the matplotlib ``Line2D`` list
        (reference velocityautocorr.py:240-285)."""
        import matplotlib.pyplot as plt

        self._require_run("plotting")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        fig, ax_vacf = plt.subplots()
        ax_vacf.set_xlabel(xlabel)
        ax_vacf.set_ylabel(ylabel)
        return ax_vacf.plot(
            self.times[: self.n_lags][start:stop:step],
            self.results.timeseries[start:stop:step],
        )

    def plot_running_integral(
        self,
        start: int = 0,
        stop: int = 0,
        step: int = 1,
        initial: float = 0,
        xlabel: str = "Time (ps)",
        ylabel: str = "Running Integral of the VACF (Å^2 / ps)",
    ):
        """Running integral ∫C(t)dt / d vs time (reference
        velocityautocorr.py:362-422)."""
        import matplotlib.pyplot as plt

        self._require_run("plotting")
        stop = self.n_lags if stop == 0 else min(stop, self.n_lags)
        times = self.times[: self.n_lags]
        running_integral = (
            ops.cumulative_trapezoid(
                self._on_device(self.results.timeseries[start:stop:step]),
                self._on_device(times[start:stop:step]),
                initial=initial,
            ).cpu().numpy()
            / self.dim_fac
        )
        fig, ax = plt.subplots()
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        return ax.plot(times[start:stop:step], running_integral)

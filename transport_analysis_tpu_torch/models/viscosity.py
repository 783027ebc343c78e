"""Einstein–Helfand shear viscosity.

Counterpart of ``transport_analysis_tpu/models/viscosity.py`` and of the
reference's ``ViscosityHelfand`` (viscosity.py:26-272): computes the
"viscosity function" η(t)·t — the per-lag mean of squared differences of
the mass-weighted position·velocity accumulator m·v·x, divided by
2·k_B·⟨V⟩·T (eq. 5 of Kirova & Norman 2015 J. Phys.: Conf. Ser. 653
012106) — and optionally its linear-fit slope over ``linear_fit_window``
as ``results.viscosity``.

The Einstein differences run through the Kneller/Calandrini FFT path
(ops/einstein.py) on the device, or with ``fft=False`` through the exact
windowed sums (K8), the reference's algorithm; the accumulator m·v·x is
formed there in the work dtype from the float32 feed of velocities and
positions (``models.base.ParticleAnalysis``). ``frame_block=``
feeds the card in frame blocks (the per-frame volumes stay on the host);
``atom_chunk=`` forms m·v·x and correlates it a chunk of atoms at a time
(``parallel.streaming``), with ``checkpoint=`` an ``.npz`` to resume from
(an FFT run too large for the device's budget streams chunks by itself,
as in ``VelocityAutocorr``);
``parallel.use_mesh`` shards the particle axis as in ``VelocityAutocorr``.
``dtype=np.float32`` is the float32 work mode, as in the JAX package
(``viscosity.py:89-109``, ``:194-230``): masses, samples and m·v·x in
float32, float32 results at about 1e-6 grade.
"""

from __future__ import annotations

import numpy as np

from ..core.groups import UpdatingAtomGroup
from ..utils.errors import NoDataError
from ..utils.units import constants
from .. import ops
from ..ops.einstein import einstein_difference_fft_
from .._device import as_tensor
from ..parallel.streaming import gather_columns
from ..utils.profiling import span
from .base import ParticleAnalysis


class HelfandSeries:
    """The Helfand accumulator m·v·x of (N, P, d) velocities and positions
    (host arrays or device tensors) and (P,) masses, formed on ``device``
    in the masses' type (the work dtype) for the atoms a slice asks for:
    ``series[:, lo:hi, :]`` is a new (N, hi − lo, d) tensor, (m·v)·x in
    the reference's multiply order (viscosity.py:197); under float64
    masses float32 samples are upcast exactly inside the products. Only
    the sliced atoms' factors are copied to the device (a host factor's
    columns made contiguous first, ``parallel.streaming.gather_columns``),
    so an atom-chunked run never holds the whole accumulator there."""

    def __init__(self, masses, velocities, positions, device):
        self._masses = masses
        self._velocities = velocities
        self._positions = positions
        self._device = device
        self.shape = tuple(velocities.shape)

    def __getitem__(self, key):
        frames, atoms, comps = key
        masses = as_tensor(self._masses[atoms], self._device)
        accum = masses.reshape(1, -1, 1) * as_tensor(gather_columns(
            self._velocities[frames, atoms, comps], self._device),
            self._device)
        accum.mul_(as_tensor(gather_columns(
            self._positions[frames, atoms, comps], self._device),
            self._device))
        return accum


class ViscosityHelfand(ParticleAnalysis):
    """Einstein–Helfand viscosity function over an AtomGroup.

    Parameters
    ----------
    atomgroup : AtomGroup
        Atoms to average over (``UpdatingAtomGroup`` rejected).
    temp_avg : float
        Average simulation temperature in K (default 300).
    dim_type : {'xyz', 'xy', 'yz', 'xz', 'x', 'y', 'z'}
        Components included (averaged, per the reference's
        viscosity.py:222 convention).
    linear_fit_window : (int, int), optional
        Lag-index window for the linear fit; when given,
        ``results.viscosity`` holds the fitted slope.
    fft : bool
        ``True`` (default): O(N log N) FFT evaluation of the Einstein
        differences. ``False``: exact windowed per-lag summation, O(N·L)
        for L lags; give ``max_lag`` to bound L on long trajectories.
    max_lag : int, optional
        Lags [0, max_lag) only (default: all frames).
    atom_chunk, checkpoint, frame_block :
        Atom chunks (chosen by the run where not given), their resume
        file and the frame-blocked feed, as in ``VelocityAutocorr``; the
        timeseries and per-particle values of a chunked run are divided
        by 2·k_B·⟨V⟩·T after the chunks.
    dtype : {np.float64, np.float32}
        The work dtype, as in ``VelocityAutocorr``.
    device : torch device, optional
        Where the analysis computes: the CUDA card by default (raises
        where there is none), the CPU only as ``"cpu"``.
    """

    FEEDS = ("velocities", "positions")
    NO_DATA_MSG = (
        "Helfand viscosity computation requires "
        "velocities, positions, and box volume in the trajectory"
    )

    def __init__(
        self,
        atomgroup,
        temp_avg: float = 300.0,
        dim_type: str = "xyz",
        linear_fit_window=None,
        fft: bool = True,
        max_lag=None,
        atom_chunk=None,
        checkpoint=None,
        dtype=np.float64,
        **kwargs,
    ):
        if isinstance(atomgroup, UpdatingAtomGroup):
            raise TypeError(
                "UpdatingAtomGroups are not valid for viscosity computation"
            )
        self.temp_avg = temp_avg
        self.dim_type = dim_type.lower()
        self.linear_fit_window = linear_fit_window
        super().__init__(atomgroup, self.dim_type, fft, max_lag, atom_chunk,
                         checkpoint, dtype, **kwargs)

    def _prepare(self):
        super()._prepare()
        self._masses = np.asarray(
            self.atomgroup.masses, dtype=self._work_dtype
        )
        # keep the historical-typo fallback contract (MDAnalysis #4213)
        try:
            self.boltzmann = constants["Boltzmann_constant"]
        except KeyError:  # pragma: no cover
            self.boltzmann = constants["Boltzman_constant"]

    def _feed_frames(self, frames, offset):
        """The per-frame box volumes, (N,) scalars kept on the host, of
        every engine's frames; a zero volume raises."""
        volumes = np.asarray(frames["volumes"], dtype=np.float64)
        if np.any(volumes == 0.0):
            raise NoDataError(self.NO_DATA_MSG)
        if offset == 0:
            self._volumes = np.zeros(self.n_frames)
        self._volumes[offset:offset + len(volumes)] = volumes

    def _conclude(self):
        self._vol_avg = float(np.average(self._volumes))
        dev = self.device
        # the accumulator m·v·x, formed in the work dtype on the device
        # for the atoms asked for (all of them, or one chunk at a time)
        series = HelfandSeries(self._masses, self._velocities,
                               self._positions, dev)

        def kernel(accum):
            # ``accum`` is a new tensor of ``series``: the FFT path
            # centers it in place (the windowed path differences it as it
            # is), so it is the one full-size tensor of the work dtype
            if self.fft:
                return einstein_difference_fft_(accum, "mean")[
                    : self.n_lags]
            return ops.einstein_difference_windowed(
                accum, "mean", max_lag=self.n_lags)

        denom = 2.0 * self.boltzmann * self._vol_avg * self.temp_avg
        # each particle shard's m·v·x formed and correlated on its mesh
        # device (parallel.use_mesh)
        (self.results.timeseries,
         self.results.visc_by_particle) = self._per_particle(
            kernel, series, lambda lo, hi, device: HelfandSeries(
                self._masses, self._velocities, self._positions,
                device)[:, lo:hi, :], divisor=denom)

        if self.linear_fit_window is not None:
            fit_start, fit_end = (
                self.linear_fit_window[0],
                self.linear_fit_window[1],
            )
            # NOTE: mirrors the reference exactly (viscosity.py:207,240-245):
            # x values are lagtimes[fit_start:fit_end] with
            # lagtimes = arange(1, n_frames), i.e. offset by one relative
            # to the timeseries indices being fit.
            lagtimes = np.arange(1, self.n_frames)
            with span("ta.fit"):
                slope, _ = ops.polyfit_linear(
                    as_tensor(lagtimes[fit_start:fit_end], dev),
                    as_tensor(self.results.timeseries[fit_start:fit_end],
                              dev),
                )
                self.results.viscosity = float(slope)

    # --- plotting -----------------------------------------------------------
    def plot_viscosity_function(self, show: bool = False):
        """Viscosity function vs lag-time, with the fit window marked
        (reference viscosity.py:247-272)."""
        import matplotlib.pyplot as plt

        lagtimes = np.arange(0, self.n_frames)
        plt.plot(
            lagtimes, self.results.timeseries, label="Viscosity Function"
        )
        if self.linear_fit_window is not None:
            fit_start, fit_end = (
                self.linear_fit_window[0],
                self.linear_fit_window[1],
            )
            plt.axvline(
                fit_start, color="red", linestyle="--", label="Fit Start"
            )
            plt.axvline(
                fit_end, color="blue", linestyle="--", label="Fit End"
            )
        plt.xlabel("Lag-time")
        plt.ylabel("Viscosity Function")
        plt.title("Viscosity Function vs Lag-time")
        plt.legend()
        if show:  # pragma: no cover
            plt.show()

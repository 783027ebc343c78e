"""Einstein mean-squared-displacement (MSD) analysis.

Counterpart of ``transport_analysis_tpu/models/msd.py`` and of
``MDAnalysis.analysis.msd.EinsteinMSD``, which the reference consumes as
the independent Einstein-relation cross-check on Green–Kubo diffusivity
(reference test_velocityautocorr.py:15,589-597). Computes

    MSD(j Δt) = ⟨ |r(iΔt + jΔt) − r(iΔt)|² ⟩_{i, particles}

with the components summed, either by the Kneller/Calandrini FFT
algorithm (``fft=True``: K1, K2, K5, K6a, K6b on the card) or by the
exact windowed sums (``fft=False``: K8), batched over every particle in
one device call. Float32 positions cross to the device at 4 bytes a
value and are upcast there, exactly. ``frame_block=``, ``atom_chunk=``
and ``checkpoint=`` stream (an FFT run too large for the device's budget
streams atom chunks by itself), and ``parallel.use_mesh`` shards the
particle axis, as in ``VelocityAutocorr``. ``dtype=
np.float32`` is the float32 work mode, as in the JAX package
(``msd.py:58``, ``:105-153``): float32 positions and results.
"""

from __future__ import annotations

import numpy as np

from ..core.groups import AtomGroup
from ..utils.errors import NoDataError, check_work_dtype
from ..ops import cuda_lag
from ..ops.einstein import einstein_difference_fft_
from .._device import work_types
from ..parallel.streaming import shares_memory
from .base import AnalysisBase
from ._dims import parse_dim_type


class EinsteinMSD(AnalysisBase):
    """MSD via the Einstein relation.

    Parameters
    ----------
    u : Universe or AtomGroup
        Universe (with ``select`` applied) or an AtomGroup directly.
    select : str
        Selection string applied to ``u`` (to an AtomGroup only when it
        is not "all"). Default "all".
    msd_type : {'xyz', 'xy', 'yz', 'xz', 'x', 'y', 'z'}
        Components included (summed, MSD convention).
    fft : bool
        FFT algorithm (default) or exact windowed summation, O(N·L) for
        L lags; give ``max_lag`` to bound L on long trajectories.
    max_lag : int, optional
        Lags [0, max_lag) only (default: all frames).
    atom_chunk, checkpoint, frame_block :
        Atom chunks (chosen by the run where not given), their resume
        file and the frame-blocked feed, as in ``VelocityAutocorr``.
    dtype : {np.float64, np.float32}
        The work dtype, as in ``VelocityAutocorr``.
    device : torch device, optional
        Where the analysis computes: the CUDA card by default (raises
        where there is none), the CPU only as ``"cpu"``.
    """

    def __init__(self, u, select: str = "all", msd_type: str = "xyz",
                 fft: bool = True, max_lag=None, atom_chunk=None,
                 checkpoint=None, dtype=np.float64, **kwargs):
        if isinstance(u, AtomGroup):
            ag = u if select in ("all", None) else u.select_atoms(select)
        else:
            ag = u.select_atoms(select)
        check_work_dtype(dtype)
        self.msd_type = msd_type.lower()
        self._dim, self.dim_fac = parse_dim_type(self.msd_type)
        super().__init__(ag.universe.trajectory, **kwargs)
        self.ag = ag
        self.atomgroup = ag
        self.fft = fft
        self.max_lag = max_lag
        self.atom_chunk = atom_chunk
        self.checkpoint = checkpoint
        self._work_dtype = np.dtype(dtype)
        self.n_particles = len(ag)

    _NO_DATA_MSG = "MSD computation requires positions"

    def _prepare(self):
        super()._prepare()
        self.results.msds_by_particle = np.zeros(
            (self.n_frames, self.n_particles)
        )
        self._positions = np.zeros(
            (self.n_frames, self.n_particles, self.dim_fac),
            dtype=self._work_dtype,
        )

    def _validate_trajectory(self):
        if not self._trajectory.has_positions:
            raise NoDataError(self._NO_DATA_MSG)

    def _process_batch(self, batch):
        if "positions" not in batch:
            raise NoDataError(self._NO_DATA_MSG)
        # float32 samples stay float32 (half the transfer); under the
        # float64 work dtype the device upcasts them exactly
        self._positions = self._select(batch["positions"], self.ag.indices)

    def _process_block(self, batch, offset):
        """Frame-blocked feed (models/base.py ``DeviceSeriesBuffer``)."""
        if "positions" not in batch:
            raise NoDataError(self._NO_DATA_MSG)
        self._feed_block("positions", batch, self.ag.indices, offset)

    def _single_frame(self):
        if not self._ts.has_positions:
            raise NoDataError(self._NO_DATA_MSG)
        self._positions[self._frame_index] = self.ag.positions[:, self._dim]

    def _conclude(self):
        self.n_lags = (
            self.n_frames
            if self.max_lag is None
            else min(self.max_lag, self.n_frames)
        )
        feed = self._positions
        work = work_types(self._work_dtype)[0]

        def kernel(r):
            if not self.fft:
                # float32 samples under the float64 work dtype are upcast
                # inside the kernel, exactly
                return cuda_lag.lag_sums(r, self.n_lags, "einstein", "sum",
                                         out_dtype=work)
            # the FFT path centers its operand in place: hand it one of
            # its own, a copy only where ``r`` may still be the feed
            owned = r.to(work, copy=shares_memory(r, feed))
            return einstein_difference_fft_(owned, "sum")[: self.n_lags]

        (self.results.timeseries,
         self.results.msds_by_particle) = self._per_particle(kernel, feed)

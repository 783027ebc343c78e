"""Einstein mean-squared-displacement (MSD) analysis.

Counterpart of ``transport_analysis_tpu/models/msd.py`` and of
``MDAnalysis.analysis.msd.EinsteinMSD``, which the reference consumes as
the independent Einstein-relation cross-check on Green–Kubo diffusivity
(reference test_velocityautocorr.py:15,589-597). Computes

    MSD(j Δt) = ⟨ |r(iΔt + jΔt) − r(iΔt)|² ⟩_{i, particles}

with the components summed, either by the Kneller/Calandrini FFT
algorithm (``fft=True``: K1, K2, K5, K6a, K6b on the card) or by the
exact windowed sums (``fft=False``: K8), batched over every particle in
one device call. Float32 positions (the feed of
``models.base.ParticleAnalysis``) cross to the device at 4 bytes a value
and are upcast there, exactly. ``frame_block=``, ``atom_chunk=``
and ``checkpoint=`` stream (an FFT run too large for the device's budget
streams atom chunks by itself), and ``parallel.use_mesh`` shards the
particle axis, as in ``VelocityAutocorr``. ``dtype=
np.float32`` is the float32 work mode, as in the JAX package
(``msd.py:58``, ``:105-153``): float32 positions and results.
"""

from __future__ import annotations

import numpy as np

from ..core.groups import AtomGroup
from ..ops import cuda_lag
from ..ops.einstein import einstein_difference_fft_
from .._device import work_types
from ..parallel.streaming import shares_memory
from .base import ParticleAnalysis


class EinsteinMSD(ParticleAnalysis):
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

    FEEDS = ("positions",)
    NO_DATA_MSG = "MSD computation requires positions"

    def __init__(self, u, select: str = "all", msd_type: str = "xyz",
                 fft: bool = True, max_lag=None, atom_chunk=None,
                 checkpoint=None, dtype=np.float64, **kwargs):
        if isinstance(u, AtomGroup):
            ag = u if select in ("all", None) else u.select_atoms(select)
        else:
            ag = u.select_atoms(select)
        self.msd_type = msd_type.lower()
        super().__init__(ag, self.msd_type, fft, max_lag, atom_chunk,
                         checkpoint, dtype, **kwargs)
        self.ag = ag

    def _conclude(self):
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

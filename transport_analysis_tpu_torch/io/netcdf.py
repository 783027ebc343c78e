"""Amber NetCDF trajectory reader/writer (AMBER conventions).

The reference's main velocity-bearing regression data is the Amber
NCBOX water box (TRJ_NCBOX, reference test_velocityautocorr.py:19-24).
Amber NetCDF is NetCDF-3 (64-bit offset), readable/writable with
scipy's pure-Python netcdf module — no libnetcdf needed.

Units per the AMBER convention: coordinates Å, time ps, velocities in
Å/(1/20.455 ps) with ``scale_factor = 20.455`` → Å/ps after scaling
(matching MDAnalysis's handling).
"""

from __future__ import annotations

import numpy as np

from ..core.timestep import Timestep
from ..core.trajectory import ProtoReader

AMBER_VEL_SCALE = 20.455


class NCDFReader(ProtoReader):
    format = "NCDF"

    def __init__(self, path):
        super().__init__()
        from scipy.io import netcdf_file

        self._nc = netcdf_file(str(path), "r", mmap=True)
        v = self._nc.variables
        if "coordinates" not in v:
            raise IOError(f"{path}: no coordinates variable")
        self.n_frames = v["coordinates"].shape[0]
        self.n_atoms = v["coordinates"].shape[1]
        self._has_vel = "velocities" in v
        self._vel_scale = AMBER_VEL_SCALE
        if self._has_vel:
            sf = getattr(v["velocities"], "scale_factor", None)
            if sf is not None:
                self._vel_scale = float(sf)
        self._has_time = "time" in v
        self._has_cell = "cell_lengths" in v
        self.ts = Timestep(
            self.n_atoms, positions=True, velocities=self._has_vel
        )
        if self._has_time and self.n_frames > 1:
            t = v["time"]
            self.ts.dt = float(t[1] - t[0])
        self._read_frame(0)

    def _read_frame(self, i: int) -> Timestep:
        v = self._nc.variables
        ts = self.ts
        ts.frame = i
        ts.positions = np.array(v["coordinates"][i], np.float32)
        if self._has_vel:
            ts.velocities = (
                np.array(v["velocities"][i], np.float32) * self._vel_scale
            )
        if self._has_time:
            ts.time = float(v["time"][i])
        else:
            ts.time = i * ts.dt
        if self._has_cell:
            ts.dimensions = np.concatenate(
                [
                    np.array(v["cell_lengths"][i], np.float64),
                    np.array(v["cell_angles"][i], np.float64),
                ]
            )
        return ts

    def read_frames_batch(self, indices) -> dict:
        if self._transformations:
            # registered per-frame transformations must run;
            # only the base seek loop applies them
            from ..core.trajectory import ProtoReader

            return ProtoReader.read_frames_batch(self, indices)
        from ..core.timestep import box_volume

        indices = np.asarray(list(indices), dtype=np.int64)
        v = self._nc.variables
        out = {"frames": indices}
        out["positions"] = np.array(
            v["coordinates"][indices], np.float32
        )
        if self._has_vel:
            out["velocities"] = (
                np.array(v["velocities"][indices], np.float32)
                * self._vel_scale
            )
        if self._has_time:
            out["times"] = np.array(v["time"][indices], np.float64)
        else:
            out["times"] = indices * self.ts.dt
        if self._has_cell:
            lengths = np.array(v["cell_lengths"][indices], np.float64)
            angles = np.array(v["cell_angles"][indices], np.float64)
            out["volumes"] = np.array(
                [
                    box_volume(np.concatenate([lengths[j], angles[j]]))
                    for j in range(len(indices))
                ]
            )
        else:
            out["volumes"] = np.zeros(len(indices))
        return out

    def close(self):
        self._nc.close()


class NCDFWriter:
    """Write AMBER-convention NetCDF trajectories via scipy."""

    def __init__(self, path, n_atoms: int, velocities: bool = False,
                 with_cell: bool = True):
        from scipy.io import netcdf_file

        self._nc = netcdf_file(str(path), "w", version=2)
        nc = self._nc
        nc.Conventions = "AMBER"
        nc.ConventionVersion = "1.0"
        nc.program = "transport_analysis_tpu"  # as the JAX package writes
        nc.programVersion = "0.1"
        nc.createDimension("frame", None)
        nc.createDimension("atom", n_atoms)
        nc.createDimension("spatial", 3)
        nc.createDimension("cell_spatial", 3)
        nc.createDimension("cell_angular", 3)
        self._time = nc.createVariable("time", "d", ("frame",))
        self._time.units = "picosecond"
        self._coords = nc.createVariable(
            "coordinates", "f", ("frame", "atom", "spatial")
        )
        self._coords.units = "angstrom"
        self._vels = None
        if velocities:
            self._vels = nc.createVariable(
                "velocities", "f", ("frame", "atom", "spatial")
            )
            self._vels.units = "angstrom/picosecond"
            self._vels.scale_factor = AMBER_VEL_SCALE
        self._cl = self._ca = None
        if with_cell:
            self._cl = nc.createVariable(
                "cell_lengths", "d", ("frame", "cell_spatial")
            )
            self._cl.units = "angstrom"
            self._ca = nc.createVariable(
                "cell_angles", "d", ("frame", "cell_angular")
            )
            self._ca.units = "degree"
        self._i = 0

    def write(self, positions, velocities=None, dimensions=None,
              time: float = 0.0):
        if not isinstance(positions, (np.ndarray, list, tuple)):
            from ._frame import extract_frame

            pos, vel, _frc, dims, t = extract_frame(positions)
            positions = pos
            velocities = vel if velocities is None else velocities
            dimensions = dims if dimensions is None else dimensions
            time = t if t is not None else time
        i = self._i
        self._coords[i] = np.asarray(positions, np.float32)
        self._time[i] = time
        if self._vels is not None and velocities is not None:
            self._vels[i] = (
                np.asarray(velocities, np.float64) / AMBER_VEL_SCALE
            ).astype(np.float32)
        if self._cl is not None:
            # record variables must stay in sync across records
            if dimensions is not None:
                dims = np.asarray(dimensions, np.float64)
            else:
                dims = np.zeros(6)
            self._cl[i] = dims[:3]
            self._ca[i] = dims[3:]
        self._i += 1

    def close(self):
        self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

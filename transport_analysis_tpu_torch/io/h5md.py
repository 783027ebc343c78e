"""H5MD trajectory reader/writer (HDF5 via h5py).

H5MD is the other velocity-capable format the reference points users
at (reference viscosity.py:33-35 docstring). Layout per the H5MD spec:
``/particles/<group>/{position,velocity}/value`` with ``step``/``time``
datasets and ``box/edges``.

Spec coverage beyond the basics:

* **units** — ``unit`` attributes on value/time datasets are honored
  on read (Angstrom/nm/pm for lengths, ps/fs/ns for times, length/time
  for velocities) and written as MDAnalysis conventions (Å, ps, Å/ps).
* **time-dependent triclinic boxes** — ``box/edges/value`` may hold
  per-frame (3, 3) cell matrices; the writer emits matrices whenever
  the cell has non-90° angles and plain cuboid edge triples otherwise.
* **distinct velocity sampling** — the velocity element may be sampled
  on a different step grid than position (``velocity_every=`` on the
  writer). On read, if the velocity steps do not cover every position
  step, per-frame velocities are NOT exposed (``has_velocities`` is
  False — misaligned data must never silently feed a VACF); the raw
  samples remain available via :meth:`H5MDReader.velocity_samples`.

Gated on h5py availability; importing this module without h5py raises
an informative ImportError.
"""

from __future__ import annotations

import numpy as np

from ..core.timestep import Timestep
from ..core.trajectory import ProtoReader

try:
    import h5py
except ImportError as _err:  # pragma: no cover
    h5py = None
    _H5PY_ERR = _err


def _require_h5py():
    if h5py is None:  # pragma: no cover
        raise ImportError(
            "h5py is required for H5MD support"
        ) from _H5PY_ERR


_LENGTH_TO_ANGSTROM = {
    "Angstrom": 1.0, "angstrom": 1.0, "A": 1.0, "Å": 1.0,
    "nm": 10.0, "nanometer": 10.0, "pm": 0.01,
}
_TIME_TO_PS = {"ps": 1.0, "picosecond": 1.0, "fs": 1e-3, "ns": 1e3}


def _unit_attr(ds) -> str | None:
    u = ds.attrs.get("unit")
    if u is None:
        return None
    if isinstance(u, bytes):
        u = u.decode()
    return str(u)


def _length_scale(ds) -> float:
    u = _unit_attr(ds)
    if u is None:
        return 1.0  # MDAnalysis convention assumed: Å
    try:
        return _LENGTH_TO_ANGSTROM[u]
    except KeyError:
        raise ValueError(f"unsupported H5MD length unit {u!r}")


def _time_scale(ds) -> float:
    u = _unit_attr(ds)
    if u is None:
        return 1.0
    try:
        return _TIME_TO_PS[u]
    except KeyError:
        raise ValueError(f"unsupported H5MD time unit {u!r}")


def _velocity_scale(ds) -> float:
    u = _unit_attr(ds)
    if u is None:
        return 1.0
    # H5MD composes units with spaces and exponents: "Angstrom ps-1"
    parts = u.split()
    if len(parts) == 2 and parts[1].endswith("-1"):
        length, time = parts[0], parts[1][:-2]
        if length in _LENGTH_TO_ANGSTROM and time in _TIME_TO_PS:
            return _LENGTH_TO_ANGSTROM[length] / _TIME_TO_PS[time]
    raise ValueError(f"unsupported H5MD velocity unit {u!r}")


class H5MDReader(ProtoReader):
    format = "H5MD"

    def __init__(self, path, group: str | None = None):
        _require_h5py()
        super().__init__()
        self._file = h5py.File(str(path), "r")
        particles = self._file["particles"]
        if group is None:
            group = next(iter(particles))
        self._grp = particles[group]
        has_pos = "position" in self._grp
        has_vel = "velocity" in self._grp
        ref = self._grp["position" if has_pos else "velocity"]["value"]
        self.n_frames, self.n_atoms = ref.shape[0], ref.shape[1]

        self._pos_scale = (
            _length_scale(self._grp["position"]["value"])
            if has_pos else 1.0
        )
        self._vel_scale = (
            _velocity_scale(self._grp["velocity"]["value"])
            if has_vel else 1.0
        )

        # distinct sampling: map position steps → velocity sample rows
        self._vel_map = None
        if has_pos and has_vel:
            pos_steps = self._steps("position", self.n_frames)
            n_vel = self._grp["velocity"]["value"].shape[0]
            vel_steps = self._steps("velocity", n_vel)
            if not np.array_equal(pos_steps, vel_steps):
                lookup = {int(s): j for j, s in enumerate(vel_steps)}
                self._vel_map = np.array(
                    [lookup.get(int(s), -1) for s in pos_steps],
                    np.int64,
                )
                if np.any(self._vel_map < 0):
                    # some frames have no velocity sample: never
                    # silently misalign — drop per-frame velocities
                    has_vel = False
                    self._vel_map = None

        self.ts = Timestep(
            self.n_atoms, positions=has_pos, velocities=has_vel
        )
        self._times = None
        for name in ("position", "velocity"):
            if name in self._grp and "time" in self._grp[name]:
                t = self._grp[name]["time"]
                if t.shape:  # explicit per-frame times
                    self._times = np.asarray(t, np.float64) * _time_scale(t)
                break
        if self._times is not None and self.n_frames > 1:
            self.ts.dt = float(self._times[1] - self._times[0])
        self._edges = None
        self._edges_static = True
        box = self._grp.get("box")
        if box is not None and "edges" in box:
            edges = box["edges"]
            if isinstance(edges, h5py.Group):
                # spec: time-dependent box = element group with value
                self._edges_static = False
                scale = _length_scale(edges["value"])
                self._edges = np.asarray(edges["value"], np.float64)
            else:
                scale = _length_scale(edges)
                self._edges = np.asarray(edges, np.float64)
            self._edges = self._edges * scale
        self._read_frame(0)

    def _steps(self, name: str, n: int) -> np.ndarray:
        el = self._grp[name]
        if "step" in el and el["step"].shape:
            return np.asarray(el["step"], np.int64)
        return np.arange(n, dtype=np.int64)

    def velocity_samples(self):
        """Raw velocity element ``(steps, times, values)`` in
        MDAnalysis units — available even when distinct sampling makes
        per-frame velocities unexposable."""
        el = self._grp["velocity"]
        n = el["value"].shape[0]
        steps = self._steps("velocity", n)
        if "time" in el and el["time"].shape:
            times = np.asarray(el["time"], np.float64) * _time_scale(
                el["time"]
            )
        else:
            times = steps.astype(np.float64) * self.ts.dt
        values = np.asarray(el["value"], np.float32) * np.float32(
            self._vel_scale
        )
        return steps, times, values

    def _dims_for(self, i):
        if self._edges is None:
            return None
        e = self._edges if self._edges_static else self._edges[i]
        if e.ndim == 2:  # full (3, 3) cell matrix (triclinic)
            from .trr import _box_matrix_to_dimensions

            return _box_matrix_to_dimensions(e)
        return np.array([e[0], e[1], e[2], 90.0, 90.0, 90.0])

    def _read_frame(self, i: int) -> Timestep:
        ts = self.ts
        ts.frame = i
        if ts.has_positions:
            ts.positions = np.asarray(
                self._grp["position"]["value"][i], np.float32
            ) * np.float32(self._pos_scale)
        if ts.has_velocities:
            j = i if self._vel_map is None else int(self._vel_map[i])
            ts.velocities = np.asarray(
                self._grp["velocity"]["value"][j], np.float32
            ) * np.float32(self._vel_scale)
        ts.time = (
            float(self._times[i]) if self._times is not None else i * ts.dt
        )
        dims = self._dims_for(i)
        if dims is not None:
            ts.dimensions = dims
        return ts

    def read_frames_batch(self, indices) -> dict:
        if self._transformations:
            # registered per-frame transformations must run;
            # only the base seek loop applies them
            from ..core.trajectory import ProtoReader

            return ProtoReader.read_frames_batch(self, indices)
        from ..core.timestep import box_volume

        indices = np.asarray(list(indices), dtype=np.int64)
        out = {"frames": indices}
        idx = list(map(int, indices))
        if self.ts.has_positions:
            out["positions"] = np.asarray(
                self._grp["position"]["value"][idx], np.float32
            ) * np.float32(self._pos_scale)
        if self.ts.has_velocities:
            vidx = (
                idx if self._vel_map is None
                else list(map(int, self._vel_map[indices]))
            )
            out["velocities"] = np.asarray(
                self._grp["velocity"]["value"][vidx], np.float32
            ) * np.float32(self._vel_scale)
        out["times"] = (
            self._times[indices]
            if self._times is not None
            else indices * self.ts.dt
        )
        out["volumes"] = np.array(
            [
                0.0 if (d := self._dims_for(i)) is None else box_volume(d)
                for i in idx
            ]
        )
        return out

    def close(self):
        self._file.close()


class H5MDWriter:
    """Write H5MD files: positions (+ optionally velocities, possibly
    on a sparser step grid via ``velocity_every``), per-frame boxes
    (cuboid edge triples or full triclinic matrices), and MDAnalysis
    unit attributes (Å, ps, Å/ps)."""

    def __init__(self, path, n_atoms: int, velocities: bool = False,
                 group: str = "trajectory", velocity_every: int = 1,
                 triclinic: bool = False):
        _require_h5py()
        self._file = h5py.File(str(path), "w")
        h5md = self._file.create_group("h5md")
        h5md.attrs["version"] = [1, 1]
        author = h5md.create_group("author")
        author.attrs["name"] = "transport_analysis_tpu"
        creator = h5md.create_group("creator")
        creator.attrs["name"] = "transport_analysis_tpu"
        creator.attrs["version"] = "0.1"
        grp = self._file.create_group(f"particles/{group}")
        self._n_atoms = n_atoms
        self._pos_v = grp.create_dataset(
            "position/value", shape=(0, n_atoms, 3),
            maxshape=(None, n_atoms, 3), dtype="f4",
        )
        self._pos_v.attrs["unit"] = "Angstrom"
        self._pos_t = grp.create_dataset(
            "position/time", shape=(0,), maxshape=(None,), dtype="f8"
        )
        self._pos_t.attrs["unit"] = "ps"
        self._pos_s = grp.create_dataset(
            "position/step", shape=(0,), maxshape=(None,), dtype="i8"
        )
        self._vel_v = self._vel_t = self._vel_s = None
        self._vel_every = max(1, int(velocity_every))
        if velocities:
            self._vel_v = grp.create_dataset(
                "velocity/value", shape=(0, n_atoms, 3),
                maxshape=(None, n_atoms, 3), dtype="f4",
            )
            self._vel_v.attrs["unit"] = "Angstrom ps-1"
            self._vel_t = grp.create_dataset(
                "velocity/time", shape=(0,), maxshape=(None,),
                dtype="f8",
            )
            self._vel_t.attrs["unit"] = "ps"
            self._vel_s = grp.create_dataset(
                "velocity/step", shape=(0,), maxshape=(None,),
                dtype="i8",
            )
        box = grp.create_group("box")
        box.attrs["dimension"] = 3
        box.attrs["boundary"] = ["periodic"] * 3
        self._triclinic = bool(triclinic)
        edge_shape = (0, 3, 3) if triclinic else (0, 3)
        edge_max = (None, 3, 3) if triclinic else (None, 3)
        self._edges = box.create_dataset(
            "edges/value", shape=edge_shape, maxshape=edge_max,
            dtype="f8",
        )
        self._edges.attrs["unit"] = "Angstrom"
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
        for ds in (self._pos_v, self._pos_t, self._pos_s, self._edges):
            ds.resize(i + 1, axis=0)
        self._pos_v[i] = np.asarray(positions, np.float32)
        self._pos_t[i] = time
        self._pos_s[i] = i
        if (
            self._vel_v is not None
            and velocities is not None
            and i % self._vel_every == 0
        ):
            j = self._vel_v.shape[0]
            for ds in (self._vel_v, self._vel_t, self._vel_s):
                ds.resize(j + 1, axis=0)
            self._vel_v[j] = np.asarray(velocities, np.float32)
            self._vel_t[j] = time
            self._vel_s[j] = i
        if dimensions is not None:
            if self._triclinic:
                from .trr import _dimensions_to_box_matrix

                self._edges[i] = _dimensions_to_box_matrix(dimensions)
            else:
                self._edges[i] = np.asarray(dimensions[:3], np.float64)
        self._i += 1

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

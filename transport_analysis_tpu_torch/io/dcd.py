"""CHARMM/NAMD DCD trajectory reader.

DCD carries positions only — it is the reference's no-velocities
error-path format (PSF/DCD fixtures at reference test_viscosity.py:33-40
must make ViscosityHelfand raise NoDataError). Fortran-record binary
with both endiannesses supported.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.timestep import Timestep
from ..core.trajectory import ProtoReader


class DCDReader(ProtoReader):
    format = "DCD"

    def __init__(self, path):
        super().__init__()
        self._path = str(path)
        with open(self._path, "rb") as fh:
            self._buf = fh.read()
        self._parse()
        self._read_frame(0)

    def _parse(self):
        buf = self._buf
        (first_len,) = struct.unpack_from("<i", buf, 0)
        self._end = "<" if first_len == 84 else ">"
        e = self._end
        if struct.unpack_from(e + "i", buf, 0)[0] != 84:
            raise IOError("not a DCD file (bad header record length)")
        magic = buf[4:8]
        if magic != b"CORD":
            raise IOError("not a coordinate DCD file")
        icntrl = struct.unpack_from(e + "20i", buf, 8)
        self._n_frames_hdr = icntrl[0]
        self._istart = icntrl[1]
        self._nsavc = icntrl[2] or 1
        # CHARMM stores delta as a float in icntrl[9]
        (self._delta,) = struct.unpack_from(e + "f", buf, 8 + 9 * 4)
        self._has_cell = icntrl[10] == 1
        self._charmm = icntrl[19] != 0
        pos = 8 + 80 + 4  # first record + trailing length
        # title record
        (tlen,) = struct.unpack_from(e + "i", buf, pos)
        pos += 4 + tlen + 4
        # natoms record
        (nlen,) = struct.unpack_from(e + "i", buf, pos)
        if nlen != 4:
            raise IOError("malformed DCD natoms record")
        (natoms,) = struct.unpack_from(e + "i", buf, pos + 4)
        pos += 12
        self.n_atoms = natoms

        cell_bytes = (4 + 48 + 4) if self._has_cell else 0
        coord_bytes = 4 + 4 * natoms + 4
        self._frame_bytes = cell_bytes + 3 * coord_bytes
        self._first_frame_offset = pos
        avail = (len(buf) - pos) // self._frame_bytes
        self.n_frames = min(self._n_frames_hdr, avail) or avail

        self.ts = Timestep(natoms, positions=True)
        # AKMA time -> ps (CHARMM delta is in AKMA units)
        self.ts.dt = self._delta * self._nsavc * 4.888821e-2

    @staticmethod
    def _cell_to_dimensions(cell):
        a, gamma, b, beta, alpha, c = cell
        angles = []
        for v in (alpha, beta, gamma):
            # modern files store cos(angle); legacy store degrees
            if -1.0 <= v <= 1.0:
                angles.append(np.degrees(np.arccos(v)))
            else:
                angles.append(v)
        return np.array([a, b, c, angles[0], angles[1], angles[2]])

    def _read_frame(self, i: int) -> Timestep:
        e = self._end
        buf = self._buf
        pos = self._first_frame_offset + i * self._frame_bytes
        ts = self.ts
        if self._has_cell:
            cell = np.frombuffer(buf, e + "f8", 6, pos + 4)
            ts.dimensions = self._cell_to_dimensions(cell)
            pos += 4 + 48 + 4
        n = self.n_atoms
        xyz = np.empty((n, 3), np.float32)
        for axis in range(3):
            xyz[:, axis] = np.frombuffer(buf, e + "f4", n, pos + 4)
            pos += 4 + 4 * n + 4
        ts.positions = xyz
        ts.frame = i
        ts.time = i * ts.dt
        return ts


class DCDWriter:
    """Minimal CHARMM-format DCD writer (positions, optional unit cell)."""

    def __init__(self, path, n_atoms: int, dt: float = 1.0,
                 with_cell: bool = True):
        self._fh = open(path, "wb")
        self.n_atoms = int(n_atoms)
        self._with_cell = with_cell
        self._n_written = 0
        self._head_pos = None
        icntrl = [0] * 20
        icntrl[0] = 0  # frame count, patched on close
        icntrl[1] = 0
        icntrl[2] = 1
        icntrl[10] = 1 if with_cell else 0
        icntrl[19] = 24  # CHARMM version marker
        rec = b"CORD" + struct.pack("<9i", *icntrl[:9])
        rec += struct.pack("<f", dt / 4.888821e-2)
        rec += struct.pack("<10i", *icntrl[10:])
        self._fh.write(struct.pack("<i", 84) + rec + struct.pack("<i", 84))
        # the JAX package's title: both packages write the same bytes
        title = b"Created by transport_analysis_tpu".ljust(80)
        self._fh.write(
            struct.pack("<i", 84)
            + struct.pack("<i", 1)
            + title
            + struct.pack("<i", 84)
        )
        self._fh.write(
            struct.pack("<i", 4)
            + struct.pack("<i", self.n_atoms)
            + struct.pack("<i", 4)
        )

    def write(self, positions, dimensions=None):
        if not isinstance(positions, (np.ndarray, list, tuple)):
            from ._frame import extract_frame

            pos, _vel, _frc, dims, _t = extract_frame(positions)
            positions = pos
            dimensions = dims if dimensions is None else dimensions
        positions = np.asarray(positions, np.float32)
        if self._with_cell:
            if dimensions is None:
                dimensions = [0.0] * 6
            a, b, c, alpha, beta, gamma = (float(v) for v in dimensions)
            cell = np.array(
                [a, np.cos(np.radians(gamma)), b, np.cos(np.radians(beta)),
                 np.cos(np.radians(alpha)), c]
            )
            self._fh.write(
                struct.pack("<i", 48)
                + cell.astype("<f8").tobytes()
                + struct.pack("<i", 48)
            )
        nb = 4 * self.n_atoms
        for axis in range(3):
            self._fh.write(struct.pack("<i", nb))
            self._fh.write(positions[:, axis].astype("<f4").tobytes())
            self._fh.write(struct.pack("<i", nb))
        self._n_written += 1

    def close(self):
        # patch the frame count into icntrl[0]
        self._fh.seek(8)
        self._fh.write(struct.pack("<i", self._n_written))
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""GROMACS TRR trajectory reader/writer (pure-Python XDR codec).

TRR is the reference's velocity-bearing regression format (the packaged
ethylene-carbonate trajectory, reference data/files.py:21, consumed at
test_viscosity.py:24-25). Frame layout follows the GROMACS xdrfile TRR
container: big-endian XDR with a per-frame header

    magic(1993) | 13 | 12 | "GMX_trn_file" | ir/e/box/vir/pres/top/sym/
    x/v/f sizes | natoms | step | nre | t | lambda |
    [box 3x3][vir][pres][x 3N][v 3N][f 3N]

in single or double precision (detected from the size fields).

Unit handling matches MDAnalysis: GROMACS stores nm and nm/ps; we
expose Å and Å/ps (×10 on read, ÷10 on write).

``read_frames_batch`` decodes through the C++ batched decoder
(io/_native, built with g++ at first use; a failed build raises);
``_read_frames_batch_py`` is its plain numpy version, which the tests
hold it against. The per-frame path (``reader[i]``) and the writer are
numpy.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

from ..core.timestep import Timestep
from ..core.trajectory import ProtoReader

_MAGIC = 1993
_VERSION = b"GMX_trn_file"
_HEADER_INTS = 10  # ir, e, box, vir, pres, top, sym, x, v, f sizes


def _box_matrix_to_dimensions(m: np.ndarray) -> np.ndarray:
    """3x3 triclinic box matrix (Å) → [lx, ly, lz, alpha, beta, gamma]."""
    a, b, c = m[0], m[1], m[2]
    la, lb, lc = (np.linalg.norm(v) for v in (a, b, c))
    if la == 0 or lb == 0 or lc == 0:
        return np.zeros(6)

    def angle(u, v, lu, lv):
        return np.degrees(
            np.arccos(np.clip(np.dot(u, v) / (lu * lv), -1.0, 1.0))
        )

    return np.array(
        [la, lb, lc, angle(b, c, lb, lc), angle(a, c, la, lc),
         angle(a, b, la, lb)]
    )


def _dimensions_to_box_matrix(dims) -> np.ndarray:
    """[lx, ly, lz, alpha, beta, gamma] (Å) → GROMACS triclinic matrix."""
    lx, ly, lz, alpha, beta, gamma = (float(v) for v in dims)
    m = np.zeros((3, 3))
    if lx == 0.0 and ly == 0.0 and lz == 0.0:
        return m  # "no box" Timestep (all-zero dims): write a zero cell
    ca, cb, cg = (np.cos(np.radians(x)) for x in (alpha, beta, gamma))
    sg = np.sin(np.radians(gamma))
    if sg == 0.0:
        raise ValueError(f"degenerate box angles in dimensions {dims}")
    m[0, 0] = lx
    m[1, 0] = ly * cg
    m[1, 1] = ly * sg
    m[2, 0] = lz * cb
    m[2, 1] = lz * (ca - cb * cg) / sg
    m[2, 2] = lz * np.sqrt(
        max(0.0, 1.0 - cb * cb - ((ca - cb * cg) / sg) ** 2)
    )
    return m


class _FrameInfo:
    __slots__ = ("offset", "natoms", "double", "box_size", "x_size",
                 "v_size", "f_size", "step", "time", "lam", "data_offset")


def _parse_header(buf: bytes, offset: int) -> Optional[_FrameInfo]:
    # fixed header = magic block (24) + sizes (40) + natoms/step/nre
    # (12) + t/λ (8 or 16); a file ending inside it is a truncated
    # trailing frame — report end-of-index, the caller warns
    if offset + 24 > len(buf):
        return None
    if offset + 12 + 12 + 4 * _HEADER_INTS + 12 + 16 > len(buf):
        return None
    magic, slen, wlen = struct.unpack_from(">iii", buf, offset)
    if magic != _MAGIC or slen != 13 or wlen != 12:
        raise IOError(f"not a TRR frame at offset {offset}")
    pos = offset + 12 + 12  # header ints + version string
    sizes = struct.unpack_from(f">{_HEADER_INTS}i", buf, pos)
    pos += 4 * _HEADER_INTS
    (ir, e, box_size, vir, pres, top, sym, x_size, v_size, f_size) = sizes
    natoms, step, nre = struct.unpack_from(">iii", buf, pos)
    pos += 12
    # precision from the first nonzero per-frame payload
    double = False
    if box_size:
        double = box_size == 9 * 8
    elif x_size:
        double = x_size == natoms * 3 * 8
    elif v_size:
        double = v_size == natoms * 3 * 8
    rsize = 8 if double else 4
    t, lam = struct.unpack_from(">dd" if double else ">ff", buf, pos)
    pos += 2 * rsize

    info = _FrameInfo()
    info.offset = offset
    info.natoms = natoms
    info.double = double
    info.box_size = box_size
    info.x_size = x_size
    info.v_size = v_size
    info.f_size = f_size
    info.step = step
    info.time = t
    info.lam = lam
    info.data_offset = pos + ir + e  # ir/e blocks precede box in spec
    return info


def _frame_payload(info: _FrameInfo) -> int:
    return (
        info.box_size + info.x_size + info.v_size + info.f_size
        # vir/pres/top/sym blocks are rarely present; sizes were zero
    )


class TRRReader(ProtoReader):
    format = "TRR"

    def __init__(self, path):
        super().__init__()
        self._path = str(path)
        from ._mmap import map_readonly

        self._buf = map_readonly(self._path)
        self._index: list[_FrameInfo] = []
        offset = 0
        truncated = False
        while True:
            info = _parse_header(self._buf, offset)
            if info is None:
                # clean EOF lands exactly at the buffer end; leftover
                # bytes mean the final frame's header was cut short
                truncated = offset < len(self._buf)
                break
            end = info.data_offset + _frame_payload(info)
            if end > len(self._buf):
                truncated = True  # payload cut short
                break
            self._index.append(info)
            offset = end
        if truncated:
            # trailing partial frame (crashed writer / truncated copy):
            # drop it rather than indexing unreadable data (GROMACS
            # tools behave the same way)
            import warnings

            warnings.warn(
                f"{self._path}: dropping truncated final frame "
                f"(frame {len(self._index)})",
                stacklevel=2,
            )
        if not self._index:
            raise IOError(f"no frames found in {self._path}")
        first = self._index[0]
        self.n_frames = len(self._index)
        self.n_atoms = first.natoms
        self.ts = Timestep(
            self.n_atoms,
            positions=first.x_size > 0,
            velocities=first.v_size > 0,
            forces=first.f_size > 0,
        )
        if self.n_frames > 1:
            self.ts.dt = self._index[1].time - self._index[0].time
        self._read_frame(0)

    def _decode(self, info: _FrameInfo):
        dt = ">f8" if info.double else ">f4"
        pos = info.data_offset
        box = None
        if info.box_size:
            box = np.frombuffer(self._buf, dt, 9, pos).reshape(3, 3)
            pos += info.box_size
        n3 = info.natoms * 3
        x = v = f = None
        if info.x_size:
            x = np.frombuffer(self._buf, dt, n3, pos).reshape(-1, 3)
            pos += info.x_size
        if info.v_size:
            v = np.frombuffer(self._buf, dt, n3, pos).reshape(-1, 3)
            pos += info.v_size
        if info.f_size:
            f = np.frombuffer(self._buf, dt, n3, pos).reshape(-1, 3)
        return box, x, v, f

    def _read_frame(self, i: int) -> Timestep:
        info = self._index[i]
        box, x, v, f = self._decode(info)
        ts = self.ts
        ts.frame = i
        ts.time = info.time
        ts.data["step"] = info.step
        ts.data["lambda"] = info.lam
        if box is not None:
            ts.dimensions = _box_matrix_to_dimensions(
                np.asarray(box, np.float64) * 10.0
            )
        if x is not None:
            ts.positions = x.astype(np.float32) * 10.0
        if v is not None:
            ts.velocities = v.astype(np.float32) * 10.0
        if f is not None:
            ts.forces = f.astype(np.float32) * 10.0
        return ts

    def read_frames_batch(self, indices) -> dict:
        if self._transformations:
            # registered per-frame transformations must run;
            # only the base seek loop applies them
            from ..core.trajectory import ProtoReader

            return ProtoReader.read_frames_batch(self, indices)
        from ._native import decode_trr_batch

        return decode_trr_batch(
            self, np.asarray(list(indices), dtype=np.int64))

    def _read_frames_batch_py(self, indices) -> dict:
        """The native decoder's plain version: the same arrays, decoded
        frame by frame in numpy (volumes from the box's dimensions)."""
        from ..core.timestep import box_volume

        F = len(indices)
        first = self._index[0]
        out = {"frames": indices}
        if first.x_size:
            out["positions"] = np.empty((F, self.n_atoms, 3), np.float32)
        if first.v_size:
            out["velocities"] = np.empty((F, self.n_atoms, 3), np.float32)
        out["times"] = np.empty(F, np.float64)
        out["volumes"] = np.zeros(F, np.float64)
        for j, i in enumerate(indices):
            info = self._index[int(i)]
            box, x, v, _ = self._decode(info)
            if x is not None and "positions" in out:
                out["positions"][j] = x * 10.0
            if v is not None and "velocities" in out:
                out["velocities"][j] = v * 10.0
            out["times"][j] = info.time
            if box is not None:
                out["volumes"][j] = box_volume(
                    _box_matrix_to_dimensions(
                        np.asarray(box, np.float64) * 10.0
                    )
                )
        return out


class TRRWriter:
    """Write TRR frames (single precision), MDAnalysis-compatible units
    (Å in → nm on disk)."""

    def __init__(self, path, n_atoms: int):
        self._fh = open(path, "wb")
        self.n_atoms = int(n_atoms)
        self._step = 0

    def write(
        self,
        positions=None,
        velocities=None,
        forces=None,
        dimensions=None,
        time: float = 0.0,
        step: Optional[int] = None,
        lam: float = 0.0,
    ):
        # MDAnalysis writer parity: first arg may be a Universe /
        # AtomGroup / Timestep instead of a positions array
        if positions is not None and not isinstance(
            positions, (np.ndarray, list, tuple)
        ):
            from ._frame import extract_frame

            pos, vel, frc, dims, t = extract_frame(positions)
            positions = pos
            velocities = vel if velocities is None else velocities
            forces = frc if forces is None else forces
            dimensions = dims if dimensions is None else dimensions
            time = t if t is not None else time
        n3 = self.n_atoms * 3
        box_size = 9 * 4 if dimensions is not None else 0
        x_size = n3 * 4 if positions is not None else 0
        v_size = n3 * 4 if velocities is not None else 0
        f_size = n3 * 4 if forces is not None else 0
        step = self._step if step is None else step
        hdr = struct.pack(
            ">iii", _MAGIC, len(_VERSION) + 1, len(_VERSION)
        ) + _VERSION
        hdr += struct.pack(
            f">{_HEADER_INTS}i",
            0, 0, box_size, 0, 0, 0, 0, x_size, v_size, f_size,
        )
        hdr += struct.pack(">iii", self.n_atoms, step, 0)
        hdr += struct.pack(">ff", float(time), float(lam))
        self._fh.write(hdr)
        if dimensions is not None:
            m = _dimensions_to_box_matrix(dimensions) / 10.0
            self._fh.write(m.astype(">f4").tobytes())
        for arr in (positions, velocities, forces):
            if arr is not None:
                nm = np.asarray(arr, np.float64) / 10.0
                self._fh.write(nm.astype(">f4").tobytes())
        self._step += 1

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

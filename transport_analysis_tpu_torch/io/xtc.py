"""GROMACS XTC trajectory reader/writer.

XTC is the most common GROMACS output format: positions-only, lossy
fixed-precision compression (the xdr3dfcoord algorithm). Frame layout
(big-endian XDR):

    magic(1995) | natoms | step | time |
    box 3x3 f32 | lsize |
    [natoms > 9:] precision | minint[3] | maxint[3] | smallidx |
                  nbytes | compressed payload (padded to 4)
    [else:] plain 3N f32

The bitstream codec lives in C++ (io/_native/xtc_codec.cpp, built with
g++ at first use; a failed build raises) — decoding is branchy integer
work that belongs in native code; Python handles the frame framing.
``read_frames_batch`` is the base class's seek loop, one codec call a
frame. Units: nm on disk ↔ Å in the API (MDAnalysis
convention). Positions-only means VACF/Helfand raise NoDataError on
XTC input — only MSD-style analyses apply (same as upstream).
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.timestep import Timestep
from ..core.trajectory import ProtoReader
from .trr import _box_matrix_to_dimensions, _dimensions_to_box_matrix

_MAGIC = 1995


class _XTCFrame:
    __slots__ = ("natoms", "step", "time", "box", "precision", "minint",
                 "maxint", "smallidx", "data_offset", "nbytes", "plain")


class XTCReader(ProtoReader):
    format = "XTC"

    def __init__(self, path):
        super().__init__()
        self._path = str(path)
        from ._mmap import map_readonly

        self._buf = map_readonly(self._path)
        self._index: list[_XTCFrame] = []
        pos = 0
        buf = self._buf
        while pos + 16 <= len(buf):
            magic, natoms, step = struct.unpack_from(">iii", buf, pos)
            if magic != _MAGIC:
                raise IOError(f"bad XTC magic at offset {pos}")
            (t,) = struct.unpack_from(">f", buf, pos + 12)
            f = _XTCFrame()
            f.natoms = natoms
            f.step = step
            f.time = t
            f.box = np.frombuffer(buf, ">f4", 9, pos + 16).reshape(3, 3)
            pos += 16 + 36
            (lsize,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            if natoms <= 9:
                f.plain = True
                f.data_offset = pos
                f.nbytes = 12 * natoms
                pos += f.nbytes
            else:
                f.plain = False
                if pos + 36 > len(buf):
                    break  # truncated trailing frame: drop it
                (f.precision,) = struct.unpack_from(">f", buf, pos)
                f.minint = struct.unpack_from(">3i", buf, pos + 4)
                f.maxint = struct.unpack_from(">3i", buf, pos + 16)
                (f.smallidx,) = struct.unpack_from(">i", buf, pos + 28)
                (f.nbytes,) = struct.unpack_from(">i", buf, pos + 32)
                pos += 36
                f.data_offset = pos
                pos += (f.nbytes + 3) // 4 * 4  # padded
            if f.data_offset + f.nbytes > len(buf):
                break  # payload truncated: drop the partial frame
            self._index.append(f)
        if not self._index:
            raise IOError(f"no frames found in {self._path}")
        first = self._index[0]
        self.n_frames = len(self._index)
        self.n_atoms = first.natoms
        self.ts = Timestep(self.n_atoms, positions=True)
        if self.n_frames > 1:
            self.ts.dt = self._index[1].time - self._index[0].time
        self._read_frame(0)

    def _decode(self, f: _XTCFrame) -> np.ndarray:
        if f.plain:
            return np.frombuffer(
                self._buf, ">f4", f.natoms * 3, f.data_offset
            ).reshape(-1, 3).astype(np.float32)
        from ._native import library

        lib = library("xtc")
        out = np.empty((f.natoms, 3), np.float32)
        minint = np.asarray(f.minint, np.int32)
        maxint = np.asarray(f.maxint, np.int32)
        rc = lib.xtc_decode(
            f.natoms,
            f.precision,
            minint,
            maxint,
            f.smallidx,
            self._buf[f.data_offset:f.data_offset + f.nbytes],
            f.nbytes,
            out,
        )
        if rc != 0:
            raise IOError(f"corrupt XTC frame (step {f.step})")
        return out

    def _read_frame(self, i: int) -> Timestep:
        f = self._index[i]
        ts = self.ts
        ts.frame = i
        ts.time = f.time
        ts.data["step"] = f.step
        ts.positions = self._decode(f) * 10.0  # nm → Å
        ts.dimensions = _box_matrix_to_dimensions(
            np.asarray(f.box, np.float64) * 10.0
        )
        return ts


class XTCWriter:
    """Write XTC files (always-literal compression variant)."""

    def __init__(self, path, n_atoms: int, precision: float = 1000.0):
        self._fh = open(path, "wb")
        self.n_atoms = int(n_atoms)
        self.precision = float(precision)  # counts per nm
        self._step = 0

    def write(self, positions, dimensions=None, time: float = 0.0,
              step=None):
        if not isinstance(positions, (np.ndarray, list, tuple)):
            from ._frame import extract_frame

            pos, _vel, _frc, dims, t = extract_frame(positions)
            positions = pos
            dimensions = dims if dimensions is None else dimensions
            time = t if t is not None else time
        step = self._step if step is None else step
        hdr = struct.pack(
            ">iiif", _MAGIC, self.n_atoms, step, float(time)
        )
        if dimensions is not None:
            box = _dimensions_to_box_matrix(dimensions) / 10.0
        else:
            box = np.zeros((3, 3))
        hdr += box.astype(">f4").tobytes()
        hdr += struct.pack(">i", self.n_atoms)
        self._fh.write(hdr)

        nm = (np.asarray(positions, np.float64) / 10.0).astype(np.float32)
        if self.n_atoms <= 9:
            self._fh.write(nm.astype(">f4").tobytes())
        else:
            from ._native import library

            lib = library("xtc")
            cap = self.n_atoms * 16 + 1024
            out = np.empty(cap, np.uint8)
            minint = np.zeros(3, np.int32)
            maxint = np.zeros(3, np.int32)
            smallidx = np.zeros(1, np.int32)
            nbytes = lib.xtc_encode(
                np.ascontiguousarray(nm, np.float32),
                self.n_atoms,
                self.precision,
                minint,
                maxint,
                smallidx,
                out,
                cap,
            )
            if nbytes < 0:
                raise IOError("XTC encode buffer overflow")
            self._fh.write(struct.pack(">f", self.precision))
            self._fh.write(minint.astype(">i4").tobytes())
            self._fh.write(maxint.astype(">i4").tobytes())
            self._fh.write(struct.pack(">ii", int(smallidx[0]), nbytes))
            padded = (nbytes + 3) // 4 * 4
            payload = out[:nbytes].tobytes() + b"\x00" * (padded - nbytes)
            self._fh.write(payload)
        self._step += 1

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

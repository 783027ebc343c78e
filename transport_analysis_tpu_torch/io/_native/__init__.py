"""The host decoders of ``io/``: C++ compiled with g++ at first use, bound
with ctypes.

``trr_decode.cpp`` decodes a batch of TRR frames, multithreaded over the
frames; ``xtc_codec.cpp`` is the XTC (xdr3dfcoord) bitstream codec. Each
source is compiled with ``g++ -O3 -shared -fPIC ... -lpthread`` into
``build/torch_native/`` of the checkout (an installed copy builds under the
user's cache, see ``_build.build_dir``), under a name that carries a hash
of the source and the flags, so an edited source is rebuilt. A build is
written under a temporary name and moved into place with ``os.replace``:
concurrent builds (test workers) never load half a library.

A failed build raises ``RuntimeError`` with g++'s output. There is no
fallback to a Python decoder and no switch that turns the decoders off:
``TRRReader._read_frames_batch_py`` is the TRR decoder's plain version,
which the tests hold it against. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..._build import build_dir

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = {"trr": "trr_decode.cpp", "xtc": "xtc_codec.cpp"}
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
N_THREADS = min(8, os.cpu_count() or 1)  # trr_decode_batch's workers

_i32 = np.ctypeslib.ndpointer(np.int32)
SIGNATURES = {
    "trr": {
        # buf (mmap base), data_offsets, n_frames, natoms, is_double,
        # box_size, x_size, v_size, positions, velocities, volumes,
        # n_threads
        "trr_decode_batch": [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.int64),
            *[ctypes.c_int64] * 2, ctypes.c_int, *[ctypes.c_int64] * 3,
            *[ctypes.c_void_p] * 3, ctypes.c_int],
    },
    "xtc": {
        # natoms, precision, minint, maxint, smallidx, data, len, out
        "xtc_decode": [ctypes.c_int64, ctypes.c_float, _i32, _i32,
                       ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.float32)],
        # coords, natoms, precision, minint, maxint, smallidx (out), out,
        # cap
        "xtc_encode": [np.ctypeslib.ndpointer(np.float32), ctypes.c_int64,
                       ctypes.c_float, _i32, _i32, _i32,
                       np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64],
    },
}
RESTYPES = {"trr_decode_batch": ctypes.c_int, "xtc_decode": ctypes.c_int,
            "xtc_encode": ctypes.c_int64}

_lock = threading.Lock()
_loaded: dict = {}


def library_path(key: str) -> Path:
    """Where the shared object of source ``key`` ("trr", "xtc") lives."""
    src = SOURCE_DIR / SOURCES[key]
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    name = f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    return build_dir("torch_native") / name


def build(key: str) -> Path:
    """Compile source ``key`` unless its shared object exists; raises
    ``RuntimeError`` with g++'s output when the build fails."""
    path = library_path(key)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE_DIR / SOURCES[key]),
           "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"cannot run g++ to build the {key} decoder: "
                           f"{err}") from err
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ failed with code {res.returncode}:\n{' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or none
    return path


def library(key: str) -> ctypes.CDLL:
    """The shared object of source ``key``, built on first use and loaded
    once."""
    with _lock:
        if key not in _loaded:
            lib = ctypes.CDLL(str(build(key)))
            for name, argtypes in SIGNATURES[key].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES[name]
            _loaded[key] = lib
        return _loaded[key]


def _layout(info) -> tuple:
    return (info.natoms, info.double, info.box_size, info.x_size,
            info.v_size)


def decode_trr_batch(reader, indices) -> dict:
    """The TRR frames ``indices`` of ``reader`` as ``read_frames_batch``
    returns them, decoded by ``trr_decode_batch``: one call for the frames
    of each layout (precision and blocks; a file almost always has one).
    Counts its calls in ``decode_trr_batch.calls``. A frame that lacks a
    block the first frame carries, or has another atom count, raises
    ``IOError``."""
    from .._mmap import base_address

    lib = library("trr")
    infos = [reader._index[int(i)] for i in indices]
    first = reader._index[0]
    n_frames = len(infos)
    shape = (n_frames, reader.n_atoms, 3)
    out = {"frames": np.asarray(indices, np.int64)}
    if first.x_size:
        out["positions"] = np.empty(shape, np.float32)
    if first.v_size:
        out["velocities"] = np.empty(shape, np.float32)
    out["volumes"] = np.zeros(n_frames, np.float64)
    out["times"] = np.array([info.time for info in infos], np.float64)
    groups: dict = {}
    for j, info in enumerate(infos):
        groups.setdefault(_layout(info), []).append(j)
    for (natoms, double, box_size, x_size, v_size), rows in groups.items():
        if (natoms != reader.n_atoms or ("positions" in out and not x_size)
                or ("velocities" in out and not v_size)):
            raise IOError(
                f"{reader._path}: frame {int(indices[rows[0]])} has "
                f"{natoms} atoms and blocks x {x_size}, v {v_size} bytes; "
                f"the first frame has {reader.n_atoms} atoms and blocks x "
                f"{first.x_size}, v {first.v_size}")
        whole = len(groups) == 1
        sel = {key: out[key] if whole else np.empty(
            (len(rows),) + out[key].shape[1:], out[key].dtype)
            for key in ("positions", "velocities", "volumes") if key in out}
        offsets = np.array([infos[j].data_offset for j in rows], np.int64)
        lib.trr_decode_batch(
            base_address(reader._buf), offsets, len(rows), natoms,
            int(double), box_size, x_size, v_size,
            *(sel[key].ctypes.data if key in sel else None
              for key in ("positions", "velocities", "volumes")),
            N_THREADS)
        if not whole:
            for key, part in sel.items():
                out[key][rows] = part
    decode_trr_batch.calls += 1
    return out


decode_trr_batch.calls = 0

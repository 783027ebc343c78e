"""Build and load the port's CUDA kernels.

The sources ``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process a source, all started together, and linked into one
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` of the repository checkout that holds the package
(an installed copy builds under the user's cache directory instead, see
:func:`build_dir`). The library's name carries a
hash of the sources and flags, so an edited source is rebuilt. It is loaded
with ``ctypes``; every C entry returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on a non-zero code.

Importing this module compiles and loads nothing, so it imports on a
machine without ``nvcc`` or a card; only :func:`library` needs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P, _L, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# C entry point -> argument types; each returns a cudaError_t as int
SIGNATURES = {
    # in, out, roots, A, n, C, sign, tw_cols, m, tc, ra, pitch, grid x, y,
    # stream
    "ta_fft_level": [_P, _P, _P, *[_L] * 11, _P],
    # z, out, roots, m, n_top, R, w, P, d, ph, shift, tq, nj, ktc, cols,
    # fine_bits, grid x, y, stream
    "ta_unpack_power_inva": [_P, _P, _P, *[_L] * 15, _P],
    # in, out, roots, A, n, ph, n_out, N, P, normalize, tc, ra, pitch,
    # grid x, y, stream
    "ta_inverse_last_level": [_P, _P, _P, *[_L] * 12, _P],
    # sq, tot, n, p, rows, nb, run, runs, grid x, y, stream
    "ta_kneller_totals": [_P, _P, *[_L] * 8, _P],
    # sq, corr, tot, seg, off, out, n, p, rows, nb, dfac, log2c, g, tiles,
    # segt, segs, chunk, grid x, grid y of the scan, of the windows, stream
    "ta_kneller_windows": [*[_P] * 6, *[_L] * 4, _D, *[_L] * 9, _P],
    # x, out, n, p, d, n_lags, f64, einstein, dfac, lag_block, cols,
    # grid x, y, stream
    "ta_lag_sums": [_P, _P, *[_L] * 6, _D, *[_L] * 4, _P],
    # xa, xb, out, n, p, d, n_lags, shift, f64, einstein, dfac, lag_block,
    # cols, grid x, y, stream
    "ta_lag_pair": [_P, _P, _P, *[_L] * 7, _D, *[_L] * 4, _P],
}
# the float32 work mode's instantiations (complex64 / float32 operands
# and results), each entry's ``_f32`` twin: the same arguments
SIGNATURES.update({f"{name}_f32": args for name, args in SIGNATURES.items()})

_lock = threading.Lock()
_loaded: dict = {}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir(kind: str = "torch_kernels") -> Path:
    """``build/<kind>`` of the checkout when the package lies in one
    (``pyproject.toml`` beside it), else a per-user cache directory
    (``$XDG_CACHE_HOME``, default ``~/.cache``), so installed copies in a
    shared environment do not build into ``site-packages``. The CUDA
    kernels build into ``torch_kernels``, the host decoders of ``io/``
    into ``torch_native``."""
    root = PACKAGE_DIR.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / kind
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "transport_analysis_tpu_torch" / kind


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libta_kernels-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the port's CUDA kernels are built from "
        "transport_analysis_tpu_torch/csrc at first use and need the CUDA "
        "toolkit"
    )


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    each source to an object by its own ``nvcc`` process, all at once,
    then one link. nvcc's report (``-Xptxas=-v``: registers, shared
    memory, spills) is kept beside the library as ``.log``."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    stem = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [Path(f"{stem}.{src.stem}.o") for src in sources()]
    steps = [[nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
             for src, obj in zip(sources(), objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in steps]
    results = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in zip(steps, procs)]
    tmp = Path(f"{stem}.so")
    if all(code == 0 for _, _, code in results):
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        results.append((cmd, res.stdout, res.returncode))
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = "".join(out for _, out, _ in results)
    path.with_suffix(".log").write_text(log)
    failed = [(cmd, out, code) for cmd, out, code in results if code != 0]
    if failed:
        cmd, out, code = failed[0]
        raise RuntimeError(
            f"nvcc failed with code {code}:\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or none
    return path


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ta_error_string.argtypes = [ctypes.c_int]
            lib.ta_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return _loaded["lib"]


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = library().ta_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# The launch contract every ctypes wrapper keeps.

MAX_GRID_X = 2 ** 31 - 1  # CUDA's grid x limit
MAX_GRID_Y = 65535       # CUDA's grid y limit


def launch_grid(tiles: int, rows: int) -> tuple[int, int]:
    """The (x, y) grid of a kernel whose blocks take ``tiles`` column
    tiles along x and ``rows`` rows along y: past ``MAX_GRID_Y`` rows a
    block strides over them by the grid's y size, so only x is bounded."""
    if not 1 <= tiles <= MAX_GRID_X or rows < 1:
        raise ValueError(f"no launch grid for {tiles} column tiles "
                         f"x {rows} rows (x limit {MAX_GRID_X})")
    return tiles, min(rows, MAX_GRID_Y)


def kernel_operand(t, name: str) -> None:
    """What the CUDA kernels take: a contiguous CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}: the kernel takes CUDA tensors, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def _float32_mode(dtype) -> bool:
    """Whether operands of ``dtype`` belong to the float32 work mode."""
    from ._device import work_types

    return work_types(dtype) == work_types("float32")


def entry(name: str, dtype):
    """The C entry of kernel ``name`` for operands of ``dtype``: the
    float64 one, or its ``_f32`` twin for the float32 work mode's
    float32 / complex64 operands."""
    return getattr(library(), f"{name}_f32" if _float32_mode(dtype)
                   else name)


def count_launch(wrapper, dtype, n: int = 1) -> None:
    """Add the ``n`` kernel launches a wrapper just made to its count,
    ``wrapper.launches``, and those of the float32 work mode's
    instantiations (float32 or complex64 operands) also to
    ``wrapper.launches_f32``."""
    wrapper.launches += n
    if _float32_mode(dtype):
        wrapper.launches_f32 += n

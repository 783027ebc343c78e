"""The port's io/ against transport_analysis_tpu.io on identical inputs.

Every reader of the port must return the bits the JAX package's reader
returns on the same file: positions, velocities, forces, times, steps and
dimensions bit-equal, frame by frame and in ``read_frames_batch``. Batch
volumes agree to 1e-15 relative: the port's ``box_volume`` is the
vectorised ``box_volumes`` and the JAX package's a scalar ``math``
formula, so they may differ in the last bit. Every writer of the port
writes the bytes the JAX package's writer writes (TRR, XTC, DCD), and each
package reads what the other wrote. The native TRR decoder is held
against its plain numpy version, ``_read_frames_batch_py``. Inputs are
the committed ``tests/golden`` files and arrays drawn from numpy seeds.
"""

import os
import struct

import numpy as np
import pytest

import transport_analysis_tpu as jta
import transport_analysis_tpu.io as jio
import transport_analysis_tpu_torch as ta
import transport_analysis_tpu_torch.io as pio
from transport_analysis_tpu.core.topology import Topology as JTopology
from transport_analysis_tpu.core.trajectory import MemoryReader as JMemoryReader
from transport_analysis_tpu_torch.core.topology import Topology
from transport_analysis_tpu_torch.core.trajectory import MemoryReader
from transport_analysis_tpu_torch.io import _native
from transport_analysis_tpu_torch.io.trr import (
    TRRReader, TRRWriter, _HEADER_INTS, _MAGIC, _VERSION,
    _dimensions_to_box_matrix)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
VOLUME_TOL = 1e-15
GOLDEN_FILES = ["golden.trr", "golden.xtc", "golden12.xtc", "golden_rle.xtc",
                "golden.dcd", "golden.ncdf", "golden.h5md"]
FRAME_FIELDS = ("positions", "velocities", "forces")


def same(a, b) -> bool:
    """Bit-equal arrays (or both None)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())


def needs(path):
    if str(path).endswith(".h5md"):
        pytest.importorskip("h5py")


def assert_frames_equal(port, ref):
    """Every frame of two readers, as Timesteps, bit for bit; the port's
    samples are float32 (the analyses feed them as they are)."""
    assert (port.n_frames, port.n_atoms) == (ref.n_frames, ref.n_atoms)
    assert port.ts.dt == ref.ts.dt
    for i in range(ref.n_frames):
        p, r = port[i], ref[i]
        assert p.frame == r.frame == i
        assert p.time == r.time
        assert same(p.dimensions, r.dimensions)
        for field in FRAME_FIELDS:
            has = f"has_{field}"
            assert getattr(p, has) == getattr(r, has)
            if getattr(r, has):
                assert same(getattr(p, field), getattr(r, field)), field
                assert getattr(p, field).dtype == np.float32, field
        assert p.data.get("step") == r.data.get("step")


def assert_batches_equal(port, ref):
    """Two ``read_frames_batch`` results: arrays bit-equal, volumes to
    VOLUME_TOL relative; the first's samples float32 (the analyses feed
    them as they are)."""
    assert sorted(port) == sorted(ref)
    for key in port:
        if key in FRAME_FIELDS:
            assert port[key].dtype == np.float32, key
        if key == "volumes":
            np.testing.assert_allclose(port[key], ref[key], rtol=VOLUME_TOL,
                                       atol=0)
        else:
            assert same(port[key], ref[key]), key


def open_both(path):
    needs(path)
    return pio.open_trajectory(path), jio.open_trajectory(path)


# --- the committed golden files ---------------------------------------------


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_frames_bit_equal(name):
    port, ref = open_both(os.path.join(GOLDEN, name))
    assert port.format == ref.format
    assert_frames_equal(port, ref)


@pytest.mark.parametrize("name", GOLDEN_FILES)
@pytest.mark.parametrize("frames", [None, [2, 0], [1]])
def test_golden_batches_bit_equal(name, frames):
    port, ref = open_both(os.path.join(GOLDEN, name))
    frames = range(ref.n_frames) if frames is None else frames
    if name.endswith(".h5md"):
        frames = sorted(frames)  # h5py reads increasing indices only
    assert_batches_equal(port.read_frames_batch(frames),
                         ref.read_frames_batch(frames))


@pytest.mark.parametrize("name,npz,keys", [
    ("golden.trr", "golden_arrays.npz", ("positions", "velocities")),
    ("golden.xtc", "golden_arrays.npz", ("positions",)),
    ("golden12.xtc", "golden_arrays.npz", ("positions12",)),
    ("golden_rle.xtc", "golden_arrays.npz", ("positions_rle",)),
    ("golden.dcd", "golden_arrays_r2.npz", ("positions",)),
    ("golden.ncdf", "golden_arrays_r2.npz", ("positions", "velocities")),
    ("golden.h5md", "golden_arrays_r2.npz", ("positions", "velocities")),
])
def test_golden_files_hold_their_arrays(name, npz, keys):
    """The port reads each golden file as the arrays it was written from:
    exactly for the lossless formats, to XTC's quantum (1/precision nm =
    0.01 Å at 1000) for XTC."""
    port, _ = open_both(os.path.join(GOLDEN, name))
    arrays = np.load(os.path.join(GOLDEN, npz))
    batch = port.read_frames_batch(range(port.n_frames))
    lossy = name.endswith(".xtc")
    for key in keys:
        field = "velocities" if key == "velocities" else "positions"
        np.testing.assert_allclose(batch[field], arrays[key],
                                   atol=0.011 if lossy else 1e-5, rtol=0)
    for i in range(port.n_frames):
        np.testing.assert_allclose(port[i].dimensions, arrays["dimensions"],
                                   atol=1e-4)


def write_golden_trr(w, g, i):
    w.write(positions=g["positions"][i], velocities=g["velocities"][i],
            dimensions=g["dimensions"], time=0.5 * i, step=i)


def write_golden_xtc(key):
    return lambda w, g, i: w.write(positions=g[key][i],
                                   dimensions=g["dimensions"], time=0.5 * i,
                                   step=i)


def write_golden_dcd(w, g, i):
    w.write(positions=g["positions"][i], dimensions=g["dimensions"])


def write_golden_ncdf(w, g, i):
    w.write(positions=g["positions"][i], velocities=g["velocities"][i],
            dimensions=g["dimensions"], time=0.5 * i)


@pytest.mark.parametrize("name,npz,n_atoms,kwargs,write", [
    ("golden.trr", "golden_arrays.npz", 5, {}, write_golden_trr),
    ("golden.xtc", "golden_arrays.npz", 5, {}, write_golden_xtc("positions")),
    ("golden_rle.xtc", "golden_arrays.npz", 60, {},
     write_golden_xtc("positions_rle")),
    ("golden.dcd", "golden_arrays_r2.npz", 7, {"dt": 0.5}, write_golden_dcd),
    ("golden.ncdf", "golden_arrays_r2.npz", 7, {"velocities": True},
     write_golden_ncdf),
])
def test_golden_bytes_rewritten(name, npz, n_atoms, kwargs, write, tmp_path):
    """The port's writers reproduce the committed golden bytes from the
    arrays they were written from (golden12.xtc came from an earlier
    literal-only encoder and is read, not rewritten)."""
    g = np.load(os.path.join(GOLDEN, npz))
    out = tmp_path / name
    with pio.Writer(out, n_atoms, **kwargs) as w:
        for i in range(3):
            write(w, g, i)
    with open(os.path.join(GOLDEN, name), "rb") as fh:
        assert out.read_bytes() == fh.read()


# --- cross round trips --------------------------------------------------------


def frames_of(seed, n_frames, n_atoms, box=30.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, box, (n_frames, n_atoms, 3)).astype(np.float32)
    vel = rng.normal(0, 5, (n_frames, n_atoms, 3)).astype(np.float32)
    frc = rng.normal(0, 50, (n_frames, n_atoms, 3)).astype(np.float32)
    dims = [[box + i, box, box + 0.5 * i, 90.0, 80.0 + i, 70.0]
            for i in range(n_frames)]
    return pos, vel, frc, dims


def write_frames(io, kind, path, n_atoms, pos, vel, frc, dims, kwargs):
    with io.Writer(path, n_atoms, **kwargs) as w:
        for i in range(len(pos)):
            if kind == "trr":
                w.write(positions=pos[i], velocities=vel[i], forces=frc[i],
                        dimensions=dims[i], time=0.25 * i)
            elif kind == "xtc":
                w.write(pos[i], dimensions=dims[i], time=0.25 * i)
            elif kind == "dcd":
                w.write(pos[i], dimensions=dims[i])
            else:
                w.write(pos[i], velocities=vel[i], dimensions=dims[i],
                        time=0.25 * i)


CROSS = [
    ("trr", {}, 7),
    ("trr", {}, 1),
    ("xtc", {}, 5),
    ("xtc", {}, 40),
    ("xtc", {"precision": 100.0}, 300),
    ("xtc", {"precision": 10000.0}, 33),
    ("dcd", {}, 11),
    ("dcd", {"with_cell": False}, 4),
    ("ncdf", {"velocities": True}, 6),
    ("ncdf", {"velocities": False, "with_cell": False}, 3),
    ("h5md", {"velocities": True}, 5),
    ("h5md", {"velocities": True, "triclinic": True}, 5),
]


@pytest.mark.parametrize("kind,kwargs,n_atoms", CROSS)
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_cross_round_trip(kind, kwargs, n_atoms, direction, tmp_path):
    """One package writes, both read: bit-equal frames and batches. TRR,
    XTC and DCD files of the two writers are byte-equal."""
    if kind == "h5md":
        pytest.importorskip("h5py")
    pos, vel, frc, dims = frames_of(n_atoms, 4, n_atoms)
    writer, other = (pio, jio) if direction == "port-to-jax" else (jio, pio)
    path = tmp_path / f"w.{kind}"
    write_frames(writer, kind, path, n_atoms, pos, vel, frc, dims, kwargs)
    port, ref = pio.open_trajectory(path), jio.open_trajectory(path)
    assert_frames_equal(port, ref)
    frames = [0, 2, 3] if kind == "h5md" else [3, 0, 2]  # h5py: increasing
    assert_batches_equal(port.read_frames_batch(frames),
                         ref.read_frames_batch(frames))
    if kind in ("trr", "xtc", "dcd"):
        twin = tmp_path / f"twin.{kind}"
        write_frames(other, kind, twin, n_atoms, pos, vel, frc, dims, kwargs)
        assert twin.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("kind", ["trr", "xtc", "dcd", "ncdf", "h5md"])
@pytest.mark.parametrize("what", ["universe", "atomgroup", "timestep"])
def test_writers_take_universe_atomgroup_timestep(kind, what, tmp_path):
    """``write(obj)`` with a Universe, an AtomGroup or a Timestep of each
    package gives files both packages read the same."""
    if kind == "h5md":
        pytest.importorskip("h5py")
    pos, vel, _, dims = frames_of(3, 2, 12)
    kwargs = {"velocities": True} if kind in ("ncdf", "h5md") else {}
    paths = {}
    for name, pkg, io, reader in (("port", ta, pio, MemoryReader),
                                  ("jax", jta, jio, JMemoryReader)):
        u = pkg.Universe.empty(12, trajectory=True)
        u.load_new(reader(pos, velocities=vel, dimensions=dims[0], dt=0.5))
        paths[name] = tmp_path / f"{name}.{kind}"
        with io.Writer(paths[name], 12, **kwargs) as w:
            for ts in u.trajectory:
                obj = {"universe": u, "atomgroup": u.atoms,
                       "timestep": ts}[what]
                w.write(obj)
    assert_frames_equal(pio.open_trajectory(paths["port"]),
                        jio.open_trajectory(paths["jax"]))
    if kind in ("trr", "xtc", "dcd"):
        assert paths["port"].read_bytes() == paths["jax"].read_bytes()


def h5md_nm_fs(path):
    """An H5MD file of another writer: nm and fs units, a static box."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(1)
    with h5py.File(path, "w") as f:
        g = f.create_group("particles/stuff")
        v = g.create_dataset("position/value",
                             data=rng.uniform(0, 3, (3, 4, 3)).astype("f4"))
        v.attrs["unit"] = "nm"
        t = g.create_dataset("position/time", data=[0.0, 500.0, 1000.0])
        t.attrs["unit"] = "fs"
        e = g.create_dataset("box/edges", data=[3.0, 3.1, 3.2])
        e.attrs["unit"] = "nm"


def h5md_sparse_velocities(path):
    """Velocities sampled every second position step: not exposed per
    frame; the raw samples stay readable."""
    pos, vel, _, dims = frames_of(3, 6, 4)
    with jio.Writer(path, 4, velocities=True, velocity_every=2) as w:
        for i in range(6):
            w.write(pos[i], velocities=vel[i], dimensions=dims[i],
                    time=float(i))


@pytest.mark.parametrize("make", [h5md_nm_fs, h5md_sparse_velocities])
def test_h5md_units_and_sampling_bit_equal(make, tmp_path):
    pytest.importorskip("h5py")
    path = tmp_path / "f.h5md"
    make(path)
    port, ref = open_both(path)
    assert_frames_equal(port, ref)
    assert_batches_equal(port.read_frames_batch([0, 1, 2]),
                         ref.read_frames_batch([0, 1, 2]))
    if make is h5md_sparse_velocities:
        assert not port.ts.has_velocities
        for got, want in zip(port.velocity_samples(), ref.velocity_samples()):
            assert same(got, want)


# --- the native TRR decoder against its plain version -------------------------


def write_double_trr(path, positions, velocities, dims, times):
    """Double-precision TRR frames (the writers emit single precision;
    GROMACS double builds write f8 payloads)."""
    n_atoms = positions.shape[1]
    n3 = n_atoms * 3
    with open(path, "wb") as fh:
        for i in range(len(positions)):
            fh.write(struct.pack(">iii", _MAGIC, len(_VERSION) + 1,
                                 len(_VERSION)) + _VERSION)
            fh.write(struct.pack(f">{_HEADER_INTS}i", 0, 0, 9 * 8, 0, 0, 0,
                                 0, n3 * 8, n3 * 8, 0))
            fh.write(struct.pack(">iii", n_atoms, i, 0))
            fh.write(struct.pack(">dd", times[i], 0.0))
            fh.write((_dimensions_to_box_matrix(dims[i]) / 10.0)
                     .astype(">f8").tobytes())
            for arr in (positions[i], velocities[i]):
                fh.write((np.asarray(arr, np.float64) / 10.0)
                         .astype(">f8").tobytes())


def trr_file(tmp_path, precision, n_frames=9, n_atoms=23):
    rng = np.random.RandomState(5)
    pos = rng.uniform(0, 40, (n_frames, n_atoms, 3))
    vel = rng.normal(0, 7, (n_frames, n_atoms, 3))
    dims = [[40.0 + i, 41.0, 42.0, 90.0, 75.0, 65.0] for i in range(n_frames)]
    path = tmp_path / f"{precision}.trr"
    if precision == "double":
        write_double_trr(path, pos, vel, dims, np.arange(n_frames) * 0.5)
    else:
        with TRRWriter(path, n_atoms) as w:
            for i in range(n_frames):
                w.write(positions=pos[i], velocities=vel[i],
                        dimensions=dims[i], time=0.5 * i)
    return path


FRAME_LISTS = [list(range(9)), [0, 2, 4, 6, 8], [8, 1, 5, 1, 0], [4]]


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("frames", FRAME_LISTS)
def test_native_trr_decode_vs_plain(precision, frames, tmp_path):
    """Native and plain batch decodes agree bit for bit (volumes: the
    box matrix's determinant against the dimensions' formula, to 1e-15),
    and both agree with the JAX package's reader."""
    path = trr_file(tmp_path, precision)
    r = TRRReader(path)
    calls = _native.decode_trr_batch.calls
    native = r.read_frames_batch(frames)
    assert _native.decode_trr_batch.calls == calls + 1
    plain = r._read_frames_batch_py(np.asarray(frames, np.int64))
    assert_batches_equal(native, plain)
    assert native["positions"].flags.c_contiguous
    ref = jio.open_trajectory(path)
    assert_batches_equal(native, ref.read_frames_batch(frames))
    assert_batches_equal(plain, ref._read_frames_batch_py(
        np.asarray(frames, np.int64)))


@pytest.mark.parametrize("precision", ["single", "double"])
def test_double_and_single_frames_bit_equal(precision, tmp_path):
    path = trr_file(tmp_path, precision)
    assert_frames_equal(TRRReader(path), jio.open_trajectory(path))


def test_native_decode_mixed_layouts(tmp_path):
    """Frames with and without a box decode in one call per layout, as
    the plain version decodes them; a frame that lacks velocities the
    batch carries raises rather than leaving the rows unset."""
    rng = np.random.RandomState(8)
    pos = rng.uniform(0, 20, (5, 6, 3))
    vel = rng.normal(0, 1, (5, 6, 3))
    path = tmp_path / "mixed.trr"
    with TRRWriter(path, 6) as w:
        for i in range(5):
            w.write(positions=pos[i], velocities=vel[i],
                    dimensions=[20, 20, 20, 90, 90, 90] if i % 2 else None,
                    time=float(i))
    r = TRRReader(path)
    frames = [4, 1, 0, 3]
    assert_batches_equal(r.read_frames_batch(frames),
                         r._read_frames_batch_py(np.array(frames)))
    holes = tmp_path / "holes.trr"
    with TRRWriter(holes, 6) as w:
        for i in range(3):
            w.write(positions=pos[i], velocities=vel[i] if i != 1 else None,
                    time=float(i))
    with pytest.raises(IOError, match="blocks"):
        TRRReader(holes).read_frames_batch([0, 1, 2])


def broken_sources(tmp_path, monkeypatch, how):
    """Point the native build at a missing or an uncompilable source,
    with nothing loaded yet."""
    src = tmp_path / "src"
    src.mkdir()
    if how == "broken":
        for name in _native.SOURCES.values():
            (src / name).write_text("this is not C++ {\n")
    monkeypatch.setattr(_native, "SOURCE_DIR", src)
    monkeypatch.setattr(_native, "_loaded", {})


@pytest.mark.parametrize("how", ["missing", "broken"])
def test_failed_native_build_raises_never_falls_back(how, tmp_path,
                                                     monkeypatch):
    """A decoder that does not build raises; the TRR batch never falls
    back to the plain decode and XTC never decodes without its codec."""
    trr = trr_file(tmp_path, "single")
    xtc = tmp_path / "w.xtc"
    pos, _, _, dims = frames_of(2, 2, 40)
    write_frames(jio, "xtc", xtc, 40, pos, None, None, dims, {})
    r = TRRReader(trr)
    x = pio.open_trajectory(xtc)
    broken_sources(tmp_path, monkeypatch, how)

    def plain(*args):
        raise AssertionError("fell back to the plain decode")

    monkeypatch.setattr(r, "_read_frames_batch_py", plain)
    error = FileNotFoundError if how == "missing" else RuntimeError
    with pytest.raises(error):
        r.read_frames_batch([0, 1])
    with pytest.raises(error):
        x.read_frames_batch([0, 1])
    with pytest.raises(error):
        pio.Writer(tmp_path / "out.xtc", 40).write(pos[0])


def test_native_build_dir_and_name(tmp_path, monkeypatch):
    """The decoders build into build/torch_native of the checkout, under
    names that carry their source's hash; an edited source gets a new
    name."""
    from transport_analysis_tpu_torch import _build

    root = _build.PACKAGE_DIR.parent
    path = _native.library_path("trr")
    assert path.parent == root / "build" / "torch_native"
    assert path.name.startswith("libtrr_decode-")
    src = tmp_path / "src"
    src.mkdir()
    for name in _native.SOURCES.values():
        (src / name).write_bytes((_native.SOURCE_DIR / name).read_bytes())
    monkeypatch.setattr(_native, "SOURCE_DIR", src)
    assert _native.library_path("trr") == path
    (src / "trr_decode.cpp").write_text(
        (src / "trr_decode.cpp").read_text() + "\n// edited\n")
    assert _native.library_path("trr") != path


# --- edge cases both packages share -------------------------------------------


@pytest.mark.parametrize("frac", [0.45, 0.75, 0.95])
def test_truncated_trr_drops_partial_frame(frac, tmp_path):
    full = trr_file(tmp_path, "single").read_bytes()
    cut = tmp_path / "cut.trr"
    cut.write_bytes(full[: int(len(full) * frac)])
    with pytest.warns(UserWarning, match="truncated"):
        port = TRRReader(cut)
    with pytest.warns(UserWarning, match="truncated"):
        ref = jio.open_trajectory(cut)
    assert_frames_equal(port, ref)


def test_truncated_xtc_drops_partial_frame(tmp_path):
    pos, _, _, dims = frames_of(1, 3, 40)
    path = tmp_path / "t.xtc"
    write_frames(pio, "xtc", path, 40, pos, None, None, dims, {})
    cut = tmp_path / "cut.xtc"
    cut.write_bytes(path.read_bytes()[: int(path.stat().st_size * 0.8)])
    port = pio.open_trajectory(cut)
    assert 1 <= port.n_frames < 3
    assert_frames_equal(port, jio.open_trajectory(cut))


@pytest.mark.parametrize("ext", ["trr", "xtc"])
def test_garbage_raises(ext, tmp_path):
    g = tmp_path / f"g.{ext}"
    g.write_bytes(b"\x00" * 200)
    with pytest.raises(IOError):
        pio.open_trajectory(g)


@pytest.mark.parametrize("call", [
    lambda tmp: pio.open_trajectory(tmp / "x.gro"),
    lambda tmp: pio.load_topology(tmp / "x.gro"),
    lambda tmp: pio.Writer(tmp / "x.pdb", 3),
])
def test_unsupported_formats_raise(call, tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        call(tmp_path)


# --- prefetch ---------------------------------------------------------------


@pytest.mark.parametrize("n,block", [(10, 4), (10, 10), (10, 1), (0, 3)])
def test_iter_frame_blocks_vs_jax(n, block):
    from transport_analysis_tpu.io.prefetch import iter_frame_blocks as jifb
    from transport_analysis_tpu_torch.io.prefetch import iter_frame_blocks

    frames = np.arange(0, 2 * n, 2)
    got, want = list(iter_frame_blocks(frames, block)), list(
        jifb(frames, block))
    assert len(got) == len(want) == -(-n // block)
    assert all(same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("source", ["memory", "golden.trr", "golden.xtc",
                                    "golden.dcd"])
def test_prefetch_batches_vs_jax(source):
    """Every block the prefetcher yields is bit-equal to the JAX
    package's, on a MemoryReader (of float32 positions and float64
    velocities) and through the file readers (the TRR batch through the
    native decoder), its samples float32."""
    from transport_analysis_tpu.io.prefetch import prefetch_batches as jpb
    from transport_analysis_tpu_torch.io.prefetch import prefetch_batches

    if source == "memory":
        rng = np.random.RandomState(0)
        pos = rng.rand(20, 5, 3).astype(np.float32)
        vel = rng.rand(20, 5, 3)
        reader = MemoryReader(pos, velocities=vel)
        jreader = JMemoryReader(pos, velocities=vel)
        frames, block = np.arange(0, 20, 2), 3
    else:
        path = os.path.join(GOLDEN, source)
        reader, jreader = pio.open_trajectory(path), jio.open_trajectory(path)
        frames, block = np.arange(reader.n_frames), 2
    got = list(prefetch_batches(reader, frames, block_size=block))
    want = list(jpb(jreader, frames, block_size=block))
    assert len(got) == len(want) == -(-len(frames) // block)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in FRAME_FIELDS + ("times", "frames"):
            if key in w:
                assert same(g[key], w[key]), key
        for key in set(FRAME_FIELDS) & set(g):
            assert g[key].dtype == np.float32, key
        assert np.allclose(g["volumes"], w["volumes"], rtol=VOLUME_TOL,
                           atol=0)


def test_prefetch_producer_error_reaches_the_consumer():
    """The blocks decoded before the failure arrive, then the producer's
    exception is raised on the consuming thread."""
    from transport_analysis_tpu_torch.io.prefetch import BatchPrefetcher

    reader = MemoryReader(np.zeros((6, 1, 3), np.float32))
    direct = reader.read_frames_batch

    class Boom(RuntimeError):
        pass

    def read_frames_batch(indices):
        if indices[0] >= 4:
            raise Boom("decode failed")
        return direct(indices)

    reader.read_frames_batch = read_frames_batch
    pf = BatchPrefetcher(reader, [np.arange(0, 2), np.arange(2, 4),
                                  np.arange(4, 6)])
    assert len(pf) == 3
    seen = []
    with pytest.raises(Boom, match="decode failed"):
        for batch in pf:
            seen.append(batch["frames"].tolist())
    assert seen == [[0, 1], [2, 3]]


# --- topologies ----------------------------------------------------------------


PSF_TEXT = """PSF EXT

         2 !NTITLE
* test
*

         4 !NATOM
         1 WAT      1        WAT      OH2      OT       -0.834000       15.9994           0
         2 WAT      1        WAT      H1       HT        0.417000        1.0080           0
         3 WAT      2        WAT      OH2      OT       -0.834000       15.9994           0
         4 PRO      1        ALA      CA       CT        0.070000       12.0110           0

         0 !NBOND
"""

PDB_TEXT = """CRYST1   30.000   31.000   32.000  90.00  80.00  70.00 P 1           1
MODEL        1
ATOM      1 OW   SOL A   1       1.000   2.000   3.000  1.00  0.00           O
ATOM      2 HW1  SOL A   1       1.500   2.500   3.500  1.00  0.00
HETATM    3 CL   CL  B   2      10.000  11.000  12.000  1.00  0.00
ATOM      4 1HB  ALA C   3       4.000   5.000   6.000  1.00  0.00
ENDMDL
MODEL        2
ATOM      1 OW   SOL A   1       1.100   2.100   3.100  1.00  0.00           O
ATOM      2 HW1  SOL A   1       1.600   2.600   3.600  1.00  0.00
HETATM    3 CL   CL  B   2      10.100  11.100  12.100  1.00  0.00
ATOM      4 1HB  ALA C   3       4.100   5.100   6.100  1.00  0.00
ENDMDL
END
"""


def topology_attrs(top):
    names = [n for n in ("names", "types", "elements", "charges", "masses",
                         "resids", "resnames", "segids") if top.has(n)]
    return (top.n_atoms, top.n_residues, top.n_segments, names,
            [np.asarray(top.get_atom_values(n)).tolist() for n in names])


@pytest.mark.parametrize("ext,text", [("psf", PSF_TEXT), ("pdb", PDB_TEXT)],
                         ids=["psf", "pdb"])
def test_topologies_equal(ext, text, tmp_path):
    path = tmp_path / f"t.{ext}"
    path.write_text(text)
    port, ref = pio.load_topology(path), jio.load_topology(path)
    assert isinstance(port, Topology)
    assert topology_attrs(port) == topology_attrs(ref)


def test_pdb_reader_models_bit_equal(tmp_path):
    path = tmp_path / "m.pdb"
    path.write_text(PDB_TEXT)
    port, ref = pio.open_trajectory(path), jio.open_trajectory(path)
    assert port.n_frames == 2
    assert_frames_equal(port, ref)


@pytest.mark.parametrize("ext,text", [("psf", PSF_TEXT), ("pdb", PDB_TEXT)],
                         ids=["psf", "pdb"])
def test_universe_from_topology_file(ext, text, tmp_path):
    path = tmp_path / f"t.{ext}"
    path.write_text(text)
    u = ta.Universe(str(path), MemoryReader(np.zeros((3, 4, 3), np.float32)))
    ju = jta.Universe(str(path), JMemoryReader(np.zeros((3, 4, 3),
                                                        np.float32)))
    for sel in ("name OW OH2", "resid 1", "resname SOL WAT", "segid A WAT"):
        assert np.array_equal(u.select_atoms(sel).indices,
                              ju.select_atoms(sel).indices)


# --- Universe and load_new from files ------------------------------------------


@pytest.mark.parametrize("name", ["golden.trr", "golden.xtc", "golden.dcd",
                                  "golden.ncdf", "golden.h5md"])
def test_universe_and_load_new_from_files(name):
    path = os.path.join(GOLDEN, name)
    needs(path)
    ref = jio.open_trajectory(path)
    u = ta.Universe(Topology(ref.n_atoms), path)
    assert_frames_equal(u.trajectory, ref)
    v = ta.Universe(Topology(ref.n_atoms)).load_new(path)
    assert_frames_equal(v.trajectory, ref)
    with pytest.raises(ValueError, match="in-memory"):
        v.load_new(path, dt=2.0)


def test_vacf_from_trr_equals_memory_reader(tmp_path):
    """A TRR-backed VACF on the CPU equals the same analysis on a
    MemoryReader holding the reader's own decoded arrays, and the JAX
    package's on the same file."""
    path = trr_file(tmp_path, "single")
    u = ta.Universe(Topology(23), path)
    got = ta.VelocityAutocorr(u.atoms, device="cpu").run()
    batch = u.trajectory.read_frames_batch(range(9))
    m = ta.Universe(Topology(23), MemoryReader(
        batch["positions"], velocities=batch["velocities"], dt=0.5))
    want = ta.VelocityAutocorr(m.atoms, device="cpu").run()
    assert same(got.results.timeseries, want.results.timeseries)
    ju = jta.Universe(JTopology(23), str(path))
    ref = jta.VelocityAutocorr(ju.atoms).run().results.timeseries
    np.testing.assert_allclose(got.results.timeseries, ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


# --- what io/ and data/ import ---------------------------------------------------


PORT = os.path.join(os.path.dirname(HERE), "transport_analysis_tpu_torch")
IO_MODULES = sorted(
    os.path.relpath(os.path.join(d, f), PORT)
    for sub in ("io", "data") for d, _, fs in os.walk(os.path.join(PORT, sub))
    for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("module", IO_MODULES)
def test_io_modules_import_numpy_not_torch_or_jax(module):
    """io/ and data/ import numpy, the standard library, the port's own
    modules and optionally h5py or scipy: never torch, jax or the JAX
    package."""
    import ast

    with open(os.path.join(PORT, module)) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"torch", "jax", "jaxlib", "transport_analysis_tpu"}
    assert names <= {"__future__", "ast", "ctypes", "hashlib", "mmap",
                     "numpy", "os", "pathlib", "queue", "struct",
                     "subprocess",
                     "tempfile", "threading", "typing", "warnings", "h5py",
                     "scipy"}, names

"""Page-locked trajectory arrays (``models.base``, ``_host_pool.ReaderStores``):
from the second run on a card over one ``MemoryReader`` on, each array of
it that a run copies to the card whole is page-locked in place, once,
and collecting the reader unregisters it. On the CPU the CUDA runtime is
a fake that records registrations (``torch.cuda.cudart``), and a run "on
a card" is an analysis whose device reads CUDA, run up to its feed: its
kernels do not run. The file imports no jax; the card's side is in
``tests/test_torch_gpu.py``.
"""

import gc
import mmap
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transport_analysis_tpu_torch import (  # noqa: E402
    VelocityAutocorr, ViscosityHelfand, _device, _host_pool, convert)
from transport_analysis_tpu_torch.core.trajectory import (  # noqa: E402
    MemoryReader)
from transport_analysis_tpu_torch.models import base  # noqa: E402
from transport_analysis_tpu_torch.ops import acf  # noqa: E402
from transport_analysis_tpu_torch.utils import profiling  # noqa: E402

CUDA = torch.device("cuda")
# a lowered store size, so that the arrays stay small
SMALL_MIN = 4096
N_FRAMES, N_ATOMS = 64, 32      # 24,576 bytes an array
BOX = [20.0, 20.0, 20.0, 90.0, 90.0, 90.0]


class FakeRuntime:
    """Stands in for ``torch.cuda.cudart()``: records the ranges
    registered and unregistered, refusing registrations where
    ``refuse``; ``delay`` seconds a registration."""

    def __init__(self):
        self.registered, self.unregistered = [], []
        self.calls, self.refuse, self.delay = 0, False, 0.0

    def cudaHostRegister(self, ptr, n, flags):
        self.calls += 1
        time.sleep(self.delay)
        if self.refuse:
            return 2
        self.registered.append((ptr, n, flags))
        return 0

    def cudaHostUnregister(self, ptr):
        [hit] = [r for r in self.registered if r[0] == ptr]
        self.registered.remove(hit)
        self.unregistered.append(hit)
        return 0


@pytest.fixture
def runtime(monkeypatch):
    """The fake runtime, a lowered store size, and a fixed device budget
    (the FFT path's chunk decision reads none from the fake card)."""
    def check(err):
        if err:
            raise RuntimeError(f"CUDA error {err}")

    fake = FakeRuntime()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    monkeypatch.setattr(torch.cuda, "check_error", check)
    monkeypatch.setattr(_host_pool, "POOL_MIN_BYTES", SMALL_MIN)
    monkeypatch.setenv(acf.HBM_BUDGET_ENV, "16")
    yield fake
    gc.collect()


def frames(seed=0, n_frames=N_FRAMES, n_atoms=N_ATOMS):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n_frames, n_atoms, 3)).astype(np.float32)


def universe(pos=None, vel=None, forces=None):
    pos = frames(1) if pos is None else pos
    vel = frames(2) if vel is None else vel
    u = convert.universe_from_arrays(
        N_ATOMS, {"masses": np.linspace(1.0, 16.0, N_ATOMS)}, pos,
        velocities=vel, dimensions=BOX)
    if forces is not None:
        u.trajectory._frc = forces
    return u


def on_card(cls):
    """``cls`` as on a card up to its feed: its device reads CUDA and its
    run stops before the kernels."""

    class OnCard(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, device="cpu", **kwargs)
            self.device = CUDA

        def run(self, start=None, stop=None, step=None):
            self.timing = profiling.StageTimer()
            with self.timing.running():
                self._run(start, stop, step, None, None)
            return self

        def _conclude(self):
            pass

    return OnCard


def run(u, kind="vacf", select="all", start=None, stop=None, step=None,
        **kwargs):
    """One run over ``u`` on the fake card; its counts."""
    if kind == "vacf":
        a = on_card(VelocityAutocorr)(u.select_atoms(select), **kwargs)
    else:
        a = on_card(ViscosityHelfand)(u.select_atoms(select),
                                      linear_fit_window=(2, 9), **kwargs)
    return a.run(start, stop, step).timing.counts()


def registered(runtime):
    return [(ptr, n) for ptr, n, _ in runtime.registered]


def whole(*arrays):
    return [(a.ctypes.data, a.nbytes) for a in arrays]


@pytest.mark.parametrize("kinds, fed", [
    (("vacf", "vacf"), ("velocities",)),
    (("vacf", "helfand"), ("velocities", "positions")),
    (("helfand", "vacf"), ("velocities",)),
    (("helfand", "helfand"), ("velocities", "positions")),
])
def test_a_repeat_run_pins_the_arrays_it_feeds_whole(runtime, kinds, fed):
    """The second run registers, portable and whole, each array it feeds
    as a view, and counts its bytes; the first registers nothing. Forces
    are never fed, so never registered."""
    u = universe(forces=frames(3))
    reader = u.trajectory
    first = run(u, kinds[0])
    assert runtime.calls == 0 and first["h2d_register_bytes"] == 0
    second = run(u, kinds[1], start=8, stop=40)
    arrays = [reader.get_array(attr) for attr in fed]
    assert sorted(registered(runtime)) == sorted(whole(*arrays))
    assert all(flags == 1 for *_, flags in runtime.registered)
    assert second["h2d_register_bytes"] == sum(a.nbytes for a in arrays)
    assert second["select_bytes"] == 0


@pytest.mark.parametrize("kind", ["vacf", "helfand"])
@pytest.mark.parametrize("fft", [True, False])
def test_the_first_run_registers_nothing(runtime, kind, fft):
    """A trajectory read once keeps the pageable copy: a registration
    costs about one pageable copy of the array."""
    u = universe()
    counts = run(u, kind, fft=fft, max_lag=None if fft else 12)
    assert runtime.calls == 0
    assert counts["h2d_register_bytes"] == 0
    assert _host_pool.reader_stores(u.trajectory).runs == 1


@pytest.mark.parametrize("kind", ["vacf", "helfand"])
def test_a_repeat_run_decides_its_plan_once(runtime, monkeypatch, kind):
    """The page-locking of a repeat run reads the run's plan, decided
    once in ``_prepare``, for every array it feeds."""
    calls = []
    real = base.ParticleAnalysis._run_chunk

    def counted(self):
        calls.append(self.n_frames)
        return real(self)

    monkeypatch.setattr(base.ParticleAnalysis, "_run_chunk", counted)
    u = universe()
    run(u, kind)
    run(u, kind, start=8)
    assert calls == [N_FRAMES, N_FRAMES - 8]
    assert runtime.calls == (2 if kind == "helfand" else 1)


def test_frame_blocks_pin_the_array_they_lie_in(runtime, monkeypatch):
    """A frame-blocked feed copies each block whole: the blocks' array is
    registered once, at the repeat run's first block."""
    class HostBuffer(base.DeviceSeriesBuffer):
        def __init__(self, shape, dtype, device):
            super().__init__(shape, dtype, "cpu")

    monkeypatch.setattr(base, "DeviceSeriesBuffer", HostBuffer)
    u = universe()
    run(u, frame_block=16)
    counts = run(u, frame_block=16)
    vel = u.trajectory.get_array("velocities")
    assert registered(runtime) == whole(vel)
    assert counts["h2d_register_bytes"] == vel.nbytes
    run(u, frame_block=16)
    assert runtime.calls == 1


def test_two_threads_register_an_array_once(runtime):
    runtime.delay = 0.05
    array = frames(4)
    stores = _host_pool.ReaderStores()
    barrier = threading.Barrier(8)
    counted = []

    def worker():
        barrier.wait(timeout=30)
        timer = profiling.StageTimer()
        with timer.running():
            stores.pin(array)
        counted.append(timer.counts()["h2d_register_bytes"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(counted) == [0] * 7 + [array.nbytes]
    assert runtime.calls == 1
    assert registered(runtime) == whole(array)
    stores.release()
    assert runtime.registered == []


def mapped(tmp_path, mode):
    """A float32 (N_FRAMES, N_ATOMS, 3) array backed by a file."""
    path = tmp_path / "vel.npy"
    np.save(path, frames(5))
    if mode == "mmap":
        with open(path, "r+b") as fh:
            memory = mmap.mmap(fh.fileno(), 0)
        offset = path.stat().st_size - frames(5).nbytes
        return np.frombuffer(memory, np.float32, offset=offset).reshape(
            N_FRAMES, N_ATOMS, 3)
    return np.load(path, mmap_mode=mode)


@pytest.mark.parametrize("case", [
    "a_selection", "strided_frames", "atom_chunk", "non_contiguous",
    "under_the_store_size", "file_r+", "file_c", "file_mmap", "on_the_cpu"])
def test_these_runs_register_nothing(runtime, monkeypatch, tmp_path, case):
    """Repeat runs whose feed is a new array (a selection, strided
    frames), or crosses in gathered chunks, or whose array is not
    C-contiguous, under the store size or a file's mapping, or that run
    on the CPU."""
    vel, kwargs = None, {}
    if case == "non_contiguous":
        vel = np.zeros((3, N_FRAMES, N_ATOMS), np.float32).transpose(1, 2, 0)
    elif case == "under_the_store_size":
        monkeypatch.setattr(_host_pool, "POOL_MIN_BYTES", frames().nbytes + 1)
    elif case.startswith("file_"):
        vel = mapped(tmp_path, case[5:])
    elif case == "atom_chunk":
        kwargs = {"atom_chunk": 8}
    u = universe(vel=vel)
    if case.startswith("file_"):
        assert _host_pool.file_backed(u.trajectory.get_array("velocities"))
    select = "index 0:9" if case == "a_selection" else "all"
    step = 2 if case == "strided_frames" else None
    for _ in range(3):
        if case == "on_the_cpu":
            a = VelocityAutocorr(u.atoms, device="cpu").run()
            counts = a.timing.counts()
        else:
            counts = run(u, select=select, step=step, **kwargs)
        assert counts["h2d_register_bytes"] == 0
    assert runtime.calls == 0


def copy(host, device=CUDA):
    """A copy of ``host`` as the port makes one, in a run: its counts.
    (The fake card copies nothing.)"""
    timer = profiling.StageTimer()
    with timer.running(), _device.h2d(host, device):
        pass
    return timer.counts()


def test_a_refused_registration_leaves_the_copy_pageable(runtime):
    """The runs go on, the copy counts the same bytes, nothing raises,
    and the array is not tried again."""
    runtime.refuse = True
    u = universe()
    for _ in range(4):
        counts = run(u, start=4, stop=20)
        assert counts["h2d_register_bytes"] == 0
    assert runtime.calls == 1 and runtime.registered == []
    assert _host_pool.reader_stores(u.trajectory).pinned() == []
    view = u.trajectory.get_array("velocities")[4:20]
    counts = copy(view)
    assert counts["h2d_bytes"] == view.nbytes
    assert counts["h2d_pinned_bytes"] == 0
    np.testing.assert_array_equal(_device.as_tensor(view, "cpu").numpy(),
                                  view)


@pytest.mark.parametrize("how", ["dropped", "in_a_cycle", "lock_held"])
def test_collecting_the_reader_unregisters_its_arrays(runtime, how):
    """Nothing is unregistered while the reader lives, whatever else is
    collected; once it is, what it page-locked is unregistered, also
    where the collection interrupts a thread that holds its lock."""
    u, other = universe(), universe(frames(6), frames(7))
    for _ in range(2):
        run(u, "helfand")
        run(other)
    reader = u.trajectory
    mine = sorted(whole(reader.get_array("positions"),
                        reader.get_array("velocities")))
    view = reader.get_array("positions")[1:3]
    del other
    gc.collect()
    assert sorted(registered(runtime)) == mine
    stores = _host_pool.reader_stores(reader)
    if how == "in_a_cycle":
        reader.cycle = reader
    if how == "lock_held":
        stores._lock.acquire()
    try:
        del u, reader
        gc.collect()
        assert runtime.registered == []
    finally:
        if how == "lock_held":
            stores._lock.release()
    assert sorted((p, n) for p, n, _ in runtime.unregistered[-2:]) == mine
    assert stores.pinned() == []
    # a view that outlives the reader keeps its memory
    assert view.base is not None and np.isfinite(view).all()


def test_the_cpu_count_dicts_are_unchanged(runtime):
    """Runs on the CPU count COUNTS, the page-locked and registered
    bytes at 0, and register nothing; an unknown counter raises."""
    u = universe()
    for cls, kwargs in ((VelocityAutocorr, {}),
                        (ViscosityHelfand, {"linear_fit_window": (2, 9)})):
        for fft in (True, False):
            for _ in range(2):
                a = cls(u.atoms, fft=fft, max_lag=None if fft else 12,
                        device="cpu", **kwargs).run()
                counts = a.timing.counts()
                assert set(counts) == set(profiling.COUNTS)
                assert counts["h2d_pinned_bytes"] == 0
                assert counts["h2d_register_bytes"] == 0
    assert runtime.calls == 0
    timer = profiling.StageTimer()
    with pytest.raises(KeyError):
        timer.count("bytes", 1)

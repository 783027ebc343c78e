"""The pool of recycled page-locked host blocks (``_host_pool``) that
``_device.to_host`` copies results into. On the CPU the pool's
bookkeeping runs over ordinary anonymous mappings standing in for
page-locked blocks: a block is not handed out again while any view of
its array lives, it is once the array is collected, blocks are keyed by
exact size, the blocks of a size never outnumber the most that were
live at once, the bytes held across sizes never pass the most bytes
live at once, threads get distinct blocks, and ``copy_back`` lays a
result out as ``.cpu()`` does. The file imports no jax: the tests
marked ``gpu`` check ``to_host`` on the card, where

    python -m pytest tests/test_torch_host_pool.py -m gpu --noconftest -q

runs them; without a card they skip.
"""

import gc
import sys
import threading
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from transport_analysis_tpu_torch import _device, _host_pool  # noqa: E402
from transport_analysis_tpu_torch._host_pool import (  # noqa: E402
    HostBlockPool, map_block, unmap_block)
from transport_analysis_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N = 1 << 16


class Recorder:
    """``allocate`` and ``free`` over anonymous mappings, recording the
    blocks made and freed."""

    def __init__(self):
        self.made, self.freed = [], []

    def allocate(self, nbytes):
        block = map_block(nbytes)
        self.made.append(block)
        return block

    def free(self, block):
        self.freed.append(block)
        unmap_block(block)


@pytest.fixture
def pool():
    rec = Recorder()
    p = HostBlockPool(rec.allocate, rec.free)
    p.recorder = rec
    yield p
    gc.collect()
    p.clear()


def handed_out(pool, nbytes=N):
    """An array of float64 over a block of ``nbytes`` taken from the
    pool, and its block."""
    block, _ = pool.take(nbytes)
    return pool.array(block, (nbytes // 8,), np.float64, (8,)), block


@pytest.mark.parametrize("view", [
    lambda a: a[::3],
    lambda a: a.reshape(64, -1).T,
    lambda a: torch.from_numpy(a),
    lambda a: memoryview(a),
    lambda a: a.view(np.uint8)[5:],
])
def test_a_block_is_not_handed_out_while_a_view_lives(pool, view):
    a, block = handed_out(pool)
    a[:] = 7.0
    v = view(a)
    seen = np.array(np.asarray(v))
    del a
    gc.collect()
    b, _ = handed_out(pool)
    assert b.ctypes.data != block.ptr
    b[:] = -1.0
    # the view still sees the first array's values
    assert np.array_equal(np.asarray(v), seen)
    assert len(pool.recorder.made) == 2
    del v
    c, _ = handed_out(pool)
    assert c.ctypes.data == block.ptr
    assert len(pool.recorder.made) == 2


def test_a_block_is_handed_out_again_once_collected(pool):
    a, block = handed_out(pool)
    ref = weakref.ref(a)
    del a
    assert ref() is None
    got, hit = pool.take(N)
    assert hit and got is block
    # an array held in a reference cycle comes back after a collection
    b = pool.array(got, (N // 8,), np.float64, (8,))
    cycle = [b]
    cycle.append(cycle)
    del b, cycle
    gc.collect()
    again, hit = pool.take(N)
    assert hit and again is block
    assert pool.recorder.made == [block]


def test_blocks_are_keyed_by_exact_size(pool):
    sizes = (N, N + 8, N - 8)
    held = [handed_out(pool, n) for n in sizes]
    blocks = [block for _, block in held]
    del held
    # no free block of another size serves a take, however close
    for n in (N - 8, N, N + 8):
        got, hit = pool.take(n)
        assert hit and got is blocks[sizes.index(n)]
        pool.array(got, (n // 8,), np.float64, (8,))
    other, hit = pool.take(N + 16)
    assert not hit and other.nbytes == N + 16
    assert [b.nbytes for b in pool.recorder.made] == [N, N + 8, N - 8,
                                                      N + 16]


@pytest.mark.parametrize("at_once", [1, 3, 6])
def test_free_blocks_are_bounded_by_the_live_high_water(pool, at_once):
    for _ in range(4):
        held = [handed_out(pool)[0] for _ in range(at_once)]
        stats = pool.stats()[N]
        assert stats == {"live": at_once, "free": 0, "high": at_once}
        del held
        stats = pool.stats()[N]
        assert stats == {"live": 0, "free": at_once, "high": at_once}
        assert pool.held_bytes() == at_once * N
    # rounds after the first hit: no block beyond the high water
    assert len(pool.recorder.made) == at_once
    assert pool.recorder.freed == []
    # one fewer at once takes no more blocks, one more takes one more
    held = [handed_out(pool)[0] for _ in range(at_once + 1)]
    assert len(pool.recorder.made) == at_once + 1
    assert pool.stats()[N] == {"live": at_once + 1, "free": 0,
                               "high": at_once + 1}
    del held


def test_the_free_blocks_given_back_longest_ago_go_first(pool):
    """A miss frees the free blocks of other sizes, longest given back
    first, until they and the blocks live before it fit in the most
    bytes live at once."""
    arrays = {k: handed_out(pool, k * N) for k in (1, 2, 3)}
    assert pool.high_bytes == 6 * N
    for k in (2, 1, 3):
        del arrays[k]
    # nothing live: the free blocks fit, and stay beside the new one
    kept, _ = handed_out(pool, N + 8)
    assert pool.recorder.freed == []
    grown, hit = pool.take(2 * N + 16)
    assert not hit
    assert [b.nbytes for b in pool.recorder.freed] == [2 * N]
    assert pool.held_bytes() == 7 * N + 24
    again, hit = pool.take(3 * N)
    assert hit and again.nbytes == 3 * N
    del kept


@pytest.mark.parametrize("at_once", [1, 2, 5])
def test_held_bytes_stay_within_the_most_live_and_the_last_block(
        pool, at_once):
    """Results of ever new sizes, as a session of analyses over other
    selections and lags makes them, held a few at a time and let go:
    the blocks of sizes gone are freed, and the bytes held never pass
    the most bytes that were live at once and the last block made."""
    rng = np.random.default_rng(at_once)
    held, most = [], 0
    for _ in range(60):
        nbytes = 8 * int(rng.integers(N // 16, 4 * N // 8))
        held.append(handed_out(pool, nbytes)[0])
        most = max(most, sum(a.nbytes for a in held))
        if len(held) >= at_once:
            held.pop(int(rng.integers(len(held))))
        assert pool.high_bytes == most
        assert pool.held_bytes() <= most + pool.recorder.made[-1].nbytes
    made = sum(b.nbytes for b in pool.recorder.made)
    freed = sum(b.nbytes for b in pool.recorder.freed)
    assert made - freed == pool.held_bytes()
    assert len(pool.recorder.freed) >= 60 - 3 * at_once


@pytest.mark.parametrize("kept", [1, 2, 3])
def test_two_sizes_that_take_turns_miss_only_while_the_most_live_grows(
        pool, kept):
    """Two analyses take turns, as a caller keeps the last ``kept``
    answers of each and the one before the current: once the most live
    at once is reached, every request is recycled, and no block of one
    size was freed for the other."""
    sizes = (N, N + N // 8)
    for n in sizes:                     # a warm-up of each
        handed_out(pool, n)
    answers, previous = {n: [] for n in sizes}, None
    for i in range(40):
        n = sizes[i % 2]
        got, _ = handed_out(pool, n)
        answers[n] = (answers[n] + [got])[-kept:]
        previous = got
    assert pool.recorder.freed == []
    high = pool.stats()
    assert len(pool.recorder.made) == sum(s["high"] for s in high.values())
    assert all(s["high"] == kept + 1 for s in high.values())
    del previous


def test_a_hit_keeps_the_bytes_held(pool):
    a, block = handed_out(pool)
    b, _ = handed_out(pool, 2 * N)
    del a, b
    again, hit = pool.take(N)
    assert hit and again is block
    assert pool.held_bytes() == 3 * N and pool.recorder.freed == []


def test_a_holder_of_every_result_pays_for_no_free_block(pool):
    held = [handed_out(pool)[0] for _ in range(8)]
    assert pool.stats()[N] == {"live": 8, "free": 0, "high": 8}
    assert pool.held_bytes() == sum(a.nbytes for a in held)


def test_clear_frees_the_free_blocks_and_keeps_the_live(pool):
    keep, kept_block = handed_out(pool)
    drop, drop_block = handed_out(pool)
    del drop
    pool.clear()
    assert pool.recorder.freed == [drop_block]
    assert pool.stats()[N] == {"live": 1, "free": 0, "high": 1}
    assert pool.high_bytes == N
    keep[:] = 3.0
    del keep
    got, hit = pool.take(N)
    assert hit and got is kept_block


def test_a_failed_allocation_leaves_the_counts(pool):
    def refuse(nbytes):
        raise MemoryError("no page-locked memory left")

    failing = HostBlockPool(refuse, pool.recorder.free)
    with pytest.raises(MemoryError):
        failing.take(N)
    assert failing.stats() == {N: {"live": 0, "free": 0, "high": 1}}


def test_concurrent_copies_get_distinct_blocks(pool):
    """More threads than cores take, fill and check arrays at a short
    switch interval: no two live arrays share a block, and no thread
    sees another's values in its own."""
    threads, rounds = 16, 25
    errors, live = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(threads)

    def work(k):
        try:
            barrier.wait(timeout=30)
            for r in range(rounds):
                source = torch.full((N // 8,), float(k * rounds + r),
                                    dtype=torch.float64)
                a = pool.copy_back(source)
                with lock:
                    live.append(a)
                    if len(live) > threads:
                        live.pop(0)
                if not np.all(a == k * rounds + r):
                    errors.append((k, r))
        except Exception as e:   # report, do not hang the barrier
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work, args=(k,))
                   for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert errors == []
    addresses = [a.ctypes.data for a in live]
    assert len(set(addresses)) == len(addresses)
    # the pool never made more blocks than were live at once: the list's,
    # and each thread's last array and the one it is copying into
    stats = pool.stats()[N]
    assert len(pool.recorder.made) == stats["high"]
    assert stats["high"] <= 3 * threads


def tensors():
    x = torch.arange(96 * 40, dtype=torch.float64).reshape(96, 40) / 7
    return {
        "series": x[:, 0].contiguous(),
        "by_particle": x,
        "by_particle_f32": x.to(torch.float32),
        "strided": x[:, ::3],
        "transposed": x.T,
        "transposed_f32": x.to(torch.float32).T,
    }


@pytest.mark.parametrize("name", list(tensors()))
def test_copy_back_lays_out_as_cpu_does(pool, name):
    result = tensors()[name]
    # a copy, as ``.cpu()`` makes of a card's tensor (of a CPU tensor it
    # returns the tensor itself)
    want = result.to("cpu", copy=True).numpy()
    got = pool.copy_back(result)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.strides == want.strides
    assert got.flags.c_contiguous == want.flags.c_contiguous
    assert got.flags.f_contiguous == want.flags.f_contiguous
    assert got.flags.writeable
    assert got.tobytes(order="A") == want.tobytes(order="A")
    assert not np.may_share_memory(got, want)


class FakeRuntime:
    """Stands in for ``torch.cuda.cudart()``: records registrations,
    refusing them all where ``refuse``."""

    def __init__(self, refuse=False):
        self.registered, self.refuse = [], refuse

    def cudaHostRegister(self, ptr, n, flags):
        if self.refuse:
            return 2
        self.registered.append((ptr, n, flags))
        return 0

    def cudaHostUnregister(self, ptr):
        [hit] = [r for r in self.registered if r[0] == ptr]
        self.registered.remove(hit)
        return 0


@pytest.fixture
def runtime(monkeypatch):
    def check(err):
        if err:
            raise RuntimeError(f"CUDA error {err}")

    fake = FakeRuntime()
    monkeypatch.setattr(torch.cuda, "cudart", lambda: fake)
    monkeypatch.setattr(torch.cuda, "check_error", check)
    return fake


def test_a_block_is_registered_whole_for_every_card(runtime):
    """One registration a block, portable, page-aligned: a copy that
    crosses from one registered range into another fails on the card."""
    nbytes = 5 * 4096 + 8
    block = _host_pool.pinned_block(nbytes)
    assert runtime.registered == [(block.ptr, nbytes, 1)]
    assert block.ptr % 4096 == 0 and block.nbytes == nbytes
    _host_pool.unpin_block(block)
    assert runtime.registered == [] and block.memory.closed


def test_a_refused_registration_unmaps_the_block(runtime, monkeypatch):
    runtime.refuse = True
    mapped = []

    def recording_map(nbytes):
        mapped.append(map_block(nbytes))
        return mapped[-1]

    monkeypatch.setattr(_host_pool, "map_block", recording_map)
    with pytest.raises(RuntimeError):
        _host_pool.pinned_block(4096)
    assert [b.memory.closed for b in mapped] == [True]


def test_copy_back_counts_the_hits(pool):
    timer = profiling.StageTimer()
    result = torch.ones(N // 8, dtype=torch.float64)
    with timer.running():
        first = pool.copy_back(result)
        assert timer.counts()["d2h_pool_hit_bytes"] == 0
        del first
        pool.copy_back(result)
    assert timer.counts()["d2h_pool_hit_bytes"] == N
    # the copy counters of to_host stay its own
    assert timer.counts()["d2h_bytes"] == 0


def test_the_cpu_path_of_to_host_is_unchanged():
    """A CPU tensor comes back as ``.cpu().numpy()`` (the tensor's own
    memory), a numpy array as itself; no pool, no copy counted."""
    before = _host_pool.POOL.stats()
    timer = profiling.StageTimer()
    x = torch.arange(1 << 20, dtype=torch.float64)
    with timer.running():
        got = _device.to_host(x)
        arr = np.arange(5.0)
        assert _device.to_host(arr) is arr
    assert np.shares_memory(got, x.numpy())
    assert timer.counts() == dict.fromkeys(profiling.COUNTS, 0)
    assert _host_pool.POOL.stats() == before


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA Hopper card: run on the H100 with "
                    "python -m pytest tests/test_torch_host_pool.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


BIG = _host_pool.POOL_MIN_BYTES


def card_results(device):
    """Results above the pool's size (and one below it) on the card:
    1-D series and (L, P) arrays in both work types, contiguous and not."""
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(4096, BIG // 4096 // 8 + 512, dtype=torch.float64,
                    device=device, generator=g)
    return {
        "series": x.reshape(-1)[:BIG // 8 + 1000].clone(),
        "by_particle": x,
        "by_particle_f32": torch.randn(4096, BIG // 4096 // 4 + 512,
                                       dtype=torch.float32, device=device,
                                       generator=g),
        "strided": torch.cat([x, x], dim=1)[:, ::2],
        "transposed": x.T,
        "small": x[:64, :64].contiguous(),
        # a block past 2 GiB, as dhfr's results are
        "past_2_gib": torch.randn((1 << 28) + 12288, dtype=torch.float64,
                                  device=device, generator=g),
        "large_transposed": torch.randn(40_000, 3357, dtype=torch.float64,
                                        device=device, generator=g).T,
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["series", "by_particle", "by_particle_f32",
                                  "strided", "transposed", "small",
                                  "past_2_gib", "large_transposed"])
def test_to_host_is_bit_equal_on_the_card(cuda_device, name):
    result = card_results(cuda_device)[name]
    want = result.cpu().numpy()
    for _ in range(2):      # a new block, then a recycled one
        got = _device.to_host(result)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.strides == want.strides
        assert got.flags.c_contiguous == want.flags.c_contiguous
        assert got.flags.writeable
        assert got.tobytes(order="A") == want.tobytes(order="A")
        if "transposed" not in name:
            assert got.flags.c_contiguous
        del got


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes", [BIG, (2 << 30) + 98304])
@pytest.mark.parametrize("non_blocking", [False, True])
def test_a_result_goes_back_to_the_card(cuda_device, nbytes, non_blocking):
    """A result in a page-locked block copies back to the card whole, as
    a user's next step may do (and the benchmark's check does)."""
    x = torch.randn(nbytes // 8, dtype=torch.float64, device=cuda_device)
    got = _device.to_host(x)
    back = torch.from_numpy(got).to(cuda_device, non_blocking=non_blocking)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(back, x)


@pytest.mark.gpu
def test_to_host_counts_on_the_card(cuda_device):
    _host_pool.POOL.clear()
    big = torch.ones(BIG // 8 + 24, dtype=torch.float64, device=cuda_device)
    small = torch.ones(1000, dtype=torch.float64, device=cuda_device)
    timer = profiling.StageTimer(cuda_device)
    with timer.running():
        first = _device.to_host(big)
        _device.to_host(small)
        del first
        second = _device.to_host(big)
    none = dict.fromkeys(profiling.COUNTS, 0)
    assert timer.counts() == dict(
        none, d2h_bytes=2 * big.nbytes + small.nbytes,
        d2h_pool_hit_bytes=big.nbytes)
    assert _host_pool.POOL.stats()[big.nbytes] == {"live": 1, "free": 0,
                                                   "high": 1}
    # results below the pool's size never engage it
    small_only = profiling.StageTimer(cuda_device)
    with small_only.running():
        _device.to_host(small)
    assert small_only.counts() == dict(none, d2h_bytes=small.nbytes)
    del second


@pytest.mark.gpu
def test_to_host_on_a_side_stream(cuda_device):
    x = torch.randn(BIG // 8, dtype=torch.float64, device=cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        for _ in range(3):
            y = x * 3.0 + 1.0
            got = _device.to_host(y)
            assert np.array_equal(got, (x * 3.0 + 1.0).cpu().numpy())


@pytest.mark.gpu
def test_shared_buffers_read_zero_on_the_card(cuda_device):
    """Answers held and answers released, as the benchmark keeps them:
    released blocks are recycled, and ``perfbench.check.shared_buffers``
    finds no answer sharing memory with an earlier one; each held answer
    keeps its own values."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench import check

    _host_pool.POOL.clear()
    shape = (256, BIG // 256 // 8 + 8)
    held, kept = [], {}
    timer = profiling.StageTimer(cuda_device)
    with timer.running():
        for i in range(10):
            result = torch.full(shape, float(i), dtype=torch.float64,
                                device=cuda_device)
            answer = _device.to_host(result)
            refs = [weakref.ref(answer)]
            if i % 3 == 0:
                kept[i] = answer
            held.append((i, [kept[i]] if i in kept else [], refs))
            del answer
    assert timer.counts()["d2h_pool_hit_bytes"] > 0
    assert check.shared_buffers(held) == []
    for i, answer in kept.items():
        assert np.all(answer == float(i))
    nbytes = shape[0] * shape[1] * 8
    stats = _host_pool.POOL.stats()[nbytes]
    assert stats["live"] == len(kept)
    assert stats["live"] + stats["free"] == stats["high"]

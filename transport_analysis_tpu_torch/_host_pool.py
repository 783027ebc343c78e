"""Page-locked host memory: recycled blocks for results copied back
from a card, and the arrays of in-memory trajectories locked in place.

A copy from the card into a fresh pageable array runs at the pace of
the host's first touch of each 4 KiB page (about 2 GB/s on the H100's
host); into page-locked memory the copy engine moves it at the bus's
rate (about 54 GB/s). :class:`HostBlockPool` hands out numpy arrays
that are views of page-locked blocks and takes a block back once the
array handed out on it, and every view of that array, is collected:
the array's owner carries a finalizer, so a live answer never shares
its memory with a later one.

Blocks are keyed by their exact byte size. A block is made only when
none of its size is free, and before it is made the free blocks given
back longest ago are freed until the others, live and free, fit in the
most bytes of arrays that were live at once. So a caller who holds
every result holds no page-locked memory beyond the results themselves,
and one who lets results go keeps at most the most it held at once and
the last block made, whatever their sizes. The new block's own room
keeps two sizes that take turns, as two analyses of one selection do,
from freeing each other's blocks while the most live at once still
grows.

The arrays of an in-memory trajectory that a run copies to a card
whole, from the trajectory's second run on a card (``models.base``),
are page-locked in place, each whole and once (:class:`ReaderStores`),
so that their copies cross by DMA where they would have crossed through
CUDA's pageable staging buffers (about 6 GB/s on the H100's host); they
are unregistered when the trajectory is collected.
"""

from __future__ import annotations

import collections
import mmap
import threading
import weakref

import numpy as np
import torch

from .utils.profiling import count, span

# Results below this size keep the pageable copy: up to it, glibc's
# allocator hands a result recycled heap memory (its mmap threshold
# grows to 32 MiB), so the pageable copy runs at 8-11 GB/s and costs
# less than a new page-locked block's registration (PERF.md §6).
POOL_MIN_BYTES = 32 << 20


class Block:
    """``nbytes`` of host memory at address ``ptr``; ``memory`` is what
    backs it (an anonymous mapping)."""

    __slots__ = ("nbytes", "ptr", "memory")

    def __init__(self, nbytes: int, ptr: int, memory):
        self.nbytes, self.ptr, self.memory = nbytes, ptr, memory


def map_block(nbytes: int) -> Block:
    """A new anonymous mapping of ``nbytes``, page-aligned, its pages
    made present by the kernel in one pass (``MAP_POPULATE``): left to
    the registration, page by page, a block past 2 GiB took twice as
    long as the pageable copy it replaces (PERF.md §6)."""
    memory = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE
                       | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    ptr = np.frombuffer(memory, dtype=np.uint8, count=1).ctypes.data
    return Block(nbytes, ptr, memory)


def unmap_block(block: Block) -> None:
    block.memory.close()


def register(ptr: int, nbytes: int) -> None:
    """Page-lock ``nbytes`` of host memory at ``ptr`` for every card
    (``cudaHostRegisterPortable``); raises where the runtime refuses.
    One registration for a whole range: a copy that crosses from one
    registered range into another fails."""
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 1))


def unregister(ptr: int) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(ptr))


def pinned_block(nbytes: int) -> Block:
    """A new mapping of ``nbytes`` page-locked for every card
    (:func:`register`), so a result of any card lands there by DMA."""
    block = map_block(nbytes)
    try:
        register(block.ptr, nbytes)
    except BaseException:
        unmap_block(block)
        raise
    return block


def unpin_block(block: Block) -> None:
    unregister(block.ptr)
    unmap_block(block)


class _Owner:
    """The base of one handed-out array: every view of the array keeps
    it alive, and its finalizer gives the block back."""

    __slots__ = ("__array_interface__", "__weakref__")


class HostBlockPool:
    """Host blocks recycled by exact size; thread-safe.

    ``allocate(nbytes) -> Block`` makes a block on a miss (inside a
    ``ta.d2h.alloc`` span), ``free(block)`` returns one to the OS: on a
    miss, for the bound on the bytes held, and in :meth:`clear`. A block
    given back by a finalizer waits in a queue until the next
    :meth:`take` or :meth:`stats`, so a finalizer takes no lock,
    whichever thread or collection runs it."""

    def __init__(self, allocate=pinned_block, free=unpin_block):
        self._allocate = allocate
        self._free_block = free
        self._lock = threading.Lock()
        self._returned = collections.deque()
        # free blocks, the one given back longest ago first
        self._free: list[Block] = []
        self._live: collections.Counter = collections.Counter()
        self._high: collections.Counter = collections.Counter()
        self._live_bytes = 0
        self.high_bytes = 0     # the most bytes live at once

    def _drain(self) -> None:
        while self._returned:
            block = self._returned.popleft()
            self._live[block.nbytes] -= 1
            self._live_bytes -= block.nbytes
            self._free.append(block)

    def _over_bound(self, live: int) -> list:
        """Free blocks, longest given back first, whose release brings
        ``live`` bytes and the free ones down to :attr:`high_bytes`."""
        held = live + sum(b.nbytes for b in self._free)
        evicted = []
        while self._free and held > self.high_bytes:
            evicted.append(self._free.pop(0))
            held -= evicted[-1].nbytes
        return evicted

    def take(self, nbytes: int) -> tuple[Block, bool]:
        """A block of exactly ``nbytes``, and whether it was recycled."""
        with self._lock:
            self._drain()
            block = next((b for b in reversed(self._free)
                          if b.nbytes == nbytes), None)
            if block is not None:
                self._free.remove(block)
            self._live[nbytes] += 1
            self._high[nbytes] = max(self._high[nbytes], self._live[nbytes])
            self._live_bytes += nbytes
            self.high_bytes = max(self.high_bytes, self._live_bytes)
            evicted = [] if block is not None else self._over_bound(
                self._live_bytes - nbytes)
        if block is not None:
            return block, True
        try:
            with span("ta.d2h.alloc"):
                for old in evicted:
                    self._free_block(old)
                return self._allocate(nbytes), False
        except BaseException:
            with self._lock:
                self._live[nbytes] -= 1
                self._live_bytes -= nbytes
            raise

    def array(self, block: Block, shape, dtype, strides) -> np.ndarray:
        """A writable array of ``dtype`` over ``block`` (``strides`` in
        bytes); the block comes back once it and its views are gone."""
        owner = _Owner()
        owner.__array_interface__ = {
            "data": (block.ptr, False), "shape": tuple(shape),
            "typestr": np.dtype(dtype).str, "strides": tuple(strides),
            "version": 3}
        out = np.asarray(owner)
        weakref.finalize(owner, self._returned.append, block)
        return out

    def copy_back(self, result: torch.Tensor) -> np.ndarray:
        """``result`` (on a card) as a numpy array in a block, laid out
        as ``result.cpu()`` lays it out; one DMA on the result's stream,
        waited for (a result that is not dense goes through a dense
        temporary on the card first, as in ``.cpu()``). Its bytes count
        as ``d2h_pool_hit_bytes`` where the block was recycled (0 on a
        miss)."""
        layout = torch.empty_like(result, device="meta")
        itemsize = result.element_size()
        dtype = torch.empty((), dtype=result.dtype).numpy().dtype
        nbytes = result.nbytes
        block, hit = self.take(nbytes)
        try:
            out = self.array(block, layout.shape, dtype,
                             [s * itemsize for s in layout.stride()])
        except BaseException:
            self._returned.append(block)
            raise
        torch.from_numpy(out).copy_(result)
        count("d2h_pool_hit_bytes", nbytes if hit else 0)
        return out

    def stats(self) -> dict:
        """nbytes -> {"live", "free", "high"}: the blocks of each size
        handed out, free, and the most live at once."""
        with self._lock:
            self._drain()
            free = collections.Counter(b.nbytes for b in self._free)
            return {n: {"live": self._live[n], "free": free[n],
                        "high": self._high[n]}
                    for n in sorted(self._high)}

    def held_bytes(self) -> int:
        """Bytes of every block the pool made and has not freed."""
        return sum(n * (s["live"] + s["free"])
                   for n, s in self.stats().items())

    def clear(self) -> None:
        """Free every free block and forget the high water marks."""
        with self._lock:
            self._drain()
            blocks, self._free = self._free, []
            self._high = collections.Counter(
                {n: k for n, k in self._live.items() if k > 0})
            self.high_bytes = self._live_bytes
        for block in blocks:
            self._free_block(block)


def file_backed(array: np.ndarray) -> bool:
    """Whether ``array``'s memory is a mapping (``np.memmap``, ``mmap``),
    as of a file that ``np.load(..., mmap_mode=...)`` opened."""
    while isinstance(array, np.ndarray):
        if isinstance(array, np.memmap):
            return True
        array = array.base
    if isinstance(array, memoryview):   # np.frombuffer's base
        array = array.obj
    return isinstance(array, mmap.mmap)


class ReaderStores:
    """The arrays of one in-memory trajectory that are page-locked in
    place, each whole and at most once; thread-safe. ``runs`` counts the
    runs on a card that read the trajectory (:meth:`count_run`).
    :func:`reader_stores` gives a trajectory's, and unregisters them
    (:meth:`release`) when it is collected."""

    __slots__ = ("runs", "_state", "_lock")

    def __init__(self):
        self.runs = 0
        # the address of each array tried: True page-locked, False refused
        self._state: dict[int, bool] = {}
        self._lock = threading.Lock()

    def count_run(self) -> int:
        """Count one more run; the runs counted, this one included."""
        with self._lock:
            self.runs += 1
            return self.runs

    def pin(self, array: np.ndarray) -> None:
        """Page-lock ``array`` whole (:func:`register`) in a
        ``ta.h2d.register`` span, its bytes counted as the run's
        ``h2d_register_bytes``, unless it was tried before, or is not
        C-contiguous, is under ``POOL_MIN_BYTES`` or is a file's mapping
        (whose pages registering would read and lock in full). A refused
        registration leaves it pageable, raises nothing and is not tried
        again."""
        if (not array.flags.c_contiguous or array.nbytes < POOL_MIN_BYTES
                or file_backed(array)):
            return
        ptr = array.ctypes.data
        with self._lock:
            if ptr in self._state:
                return
            with span("ta.h2d.register"):
                try:
                    register(ptr, array.nbytes)
                except RuntimeError:
                    self._state[ptr] = False
                    return
            self._state[ptr] = True
        count("h2d_register_bytes", array.nbytes)

    def pinned(self) -> list[int]:
        """The addresses of the arrays page-locked, in the order they
        were."""
        with self._lock:
            return [ptr for ptr, ok in self._state.items() if ok]

    def release(self) -> None:
        """Unregister every array page-locked. Run by the trajectory's
        finalizer, when no run holds the trajectory, so no :meth:`pin`
        runs beside it, and without the lock, which a collection may find
        held by the thread it interrupts."""
        for ptr, ok in self._state.items():
            if ok:
                unregister(ptr)
        self._state.clear()


_READERS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_READERS_LOCK = threading.Lock()


def reader_stores(reader) -> ReaderStores:
    """The :class:`ReaderStores` of ``reader``, made at the first call;
    the reader's collection releases it (at exit, the process's teardown
    does). The reader holds its arrays, so their memory outlives it."""
    with _READERS_LOCK:
        stores = _READERS.get(reader)
        if stores is None:
            stores = _READERS[reader] = ReaderStores()
            weakref.finalize(reader, stores.release).atexit = False
    return stores


# the process's pool for results copied back by ``_device.to_host``
POOL = HostBlockPool()

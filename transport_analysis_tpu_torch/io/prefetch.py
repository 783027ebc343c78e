"""Host-side prefetch: decode trajectory blocks on a background thread
while the device computes.

Counterpart of ``transport_analysis_tpu/io/prefetch.py``. A producer
thread runs ``read_frames_batch`` for upcoming frame blocks (the native
C++ decode for TRR) and hands the decoded numpy batches through a bounded
queue, so the host decode of block k + 1 overlaps the device work on
block k. The producer only decodes: it makes no CUDA call, and every copy
to the card happens on the consuming thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np


def iter_frame_blocks(frames: Sequence[int], block_size: int):
    """Split a frame-index selection into contiguous blocks."""
    frames = np.asarray(frames)
    for lo in range(0, len(frames), block_size):
        yield frames[lo:lo + block_size]


class BatchPrefetcher:
    """Iterate decoded frame batches with background prefetch.

    Parameters
    ----------
    reader : ProtoReader
    blocks : iterable of frame-index arrays
    depth : queue depth (decoded blocks buffered ahead), default 2.

    Iteration yields the dicts ``read_frames_batch`` returns. An exception
    in the producer is raised to the consumer once the blocks before it
    have been yielded. An iterator abandoned part way leaves its daemon
    producer blocked on the full queue until the process exits.
    """

    _SENTINEL = object()

    def __init__(self, reader, blocks: Iterable, depth: int = 2):
        self._reader = reader
        self._blocks = list(blocks)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._error = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    def _produce(self):
        try:
            for block in self._blocks:
                self._queue.put(self._reader.read_frames_batch(block))
        except BaseException as err:  # raised again on the consumer
            self._error = err
        finally:
            self._queue.put(self._SENTINEL)

    def __len__(self):
        return len(self._blocks)

    def __iter__(self) -> Iterator[dict]:
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self._queue.get()
            if item is self._SENTINEL:
                if self._error is not None:
                    raise self._error
                return
            yield item


def prefetch_batches(reader, frames, block_size: int = 4096,
                     depth: int = 2) -> BatchPrefetcher:
    """Prefetching iterator over ``frames`` in blocks of ``block_size``."""
    return BatchPrefetcher(
        reader, iter_frame_blocks(frames, block_size), depth=depth
    )

"""The one generator of requests: a workload file's analyses over its
frame blocks, in a closed loop with one client.

A workload file names its ``analyses`` (each a ``kind``, ``vacf`` or
``helfand``, with the selection and arguments the user passes) and its
``frames``: ``{"block": B}`` runs each analysis over consecutive B-frame
blocks of the trajectory, ``{"block": null}`` over all of it. The seed
orders the blocks; every seed runs the same blocks and analyses, so the
work of a request never depends on it.
"""

from __future__ import annotations

import itertools

import numpy as np


def blocks(traffic: dict, n_frames: int) -> list[tuple[int, int]]:
    """(start, stop) of each frame block the workload runs over."""
    size = traffic["frames"]["block"] or n_frames
    if size > n_frames:
        raise ValueError(f"a block of {size} frames in a trajectory of "
                         f"{n_frames}")
    return [(s, s + size) for s in range(0, n_frames - size + 1, size)]


def requests(traffic: dict, n_frames: int, seed: int):
    """Endless (analysis index, start, stop): the blocks in an order drawn
    from the seed, each block taking every analysis in the file's order,
    then the same order again."""
    spans = blocks(traffic, n_frames)
    order = np.random.default_rng([int(seed), 1]).permutation(len(spans))
    for b in itertools.cycle(order):
        for ai in range(len(traffic["analyses"])):
            yield ai, spans[b][0], spans[b][1]

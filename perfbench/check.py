"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``reference.py``) works out each distinct (analysis, frame
block) that the window ran, a block of particles at a time, from the raw
arrays the benchmark made. Every request is held against it:

* ``<kind>_series``: max |Δ| / max |ref| of the particle mean over every
  lag (``results.timeseries``);
* ``vacf_d``: |Δ| / |ref| of the Green–Kubo diffusivity from
  ``self_diffusivity_gk()``;
* ``helfand_eta``: |Δ| of the fitted slope ``results.viscosity`` over
  the slope that would carry the reference's largest |value| in the fit
  window (a, b) across it, max |ref[a:b]| / (b − a). The slope itself
  lies near 0 on these trajectories, whose Helfand function levels off
  after a few τ, so an error relative to it swings by orders of
  magnitude from seed to seed;

and the requests kept by a seeded reservoir sample (``SAMPLE`` of each
analysis) over every particle and lag as well:

* ``<kind>_particles``: max |Δ| / max |ref| of the per-particle values
  (``vacf_by_particle``, ``visc_by_particle``).

Each number is the largest over the requests, and each has its limit in
the workload file's ``limits``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import reference, work

SAMPLE = 2
SCALAR = {"vacf": "d", "helfand": "eta"}


class Reservoir:
    """A uniform sample of ``size`` items from a stream, drawn from the
    seed; the items that fall out are released."""

    def __init__(self, size: int, seed: int, stream: int):
        self.size = size
        self.seen = 0
        self.items = []
        self._rng = np.random.default_rng([int(seed), 2, stream])

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            slot = int(self._rng.integers(0, self.seen + 1))
            if slot < self.size:
                self.items[slot] = item
        self.seen += 1


def shared_buffers(held: list) -> list:
    """Indices of the answers whose arrays share memory with an earlier
    answer's: a request answered from an earlier one's buffers, as a
    result cache would answer a repeated request, has not done its work.
    ``held`` is (index, arrays, weak references) of each answer in turn:
    the arrays the harness keeps, and weak references to those it lets
    go, alive only while something else (such as that cache) holds
    them."""
    seen, found = [], []
    for index, kept, refs in held:
        arrays = list(kept) + [r() for r in refs]
        arrays = [a for a in arrays if isinstance(a, np.ndarray)]
        if any(np.may_share_memory(a, b) for a in arrays for b in seen):
            found.append(index)
        seen.extend(arrays)
    return found


def rel(got, ref) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return float("inf")
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    return float(err / scale) if np.isfinite(err) else float("inf")


def reference_run(analysis: dict, system: dict, config: dict, start: int,
                  stop: int, samples: list, device) -> dict:
    """The reference of one analysis over frames [start, stop): its mean
    over the particles and its scalar, with each sampled answer's
    ``particles`` error filled in as the particle blocks go by."""
    kind = analysis["kind"]
    idx = reference.select(config, analysis["select"])
    _, masses = reference.atom_table(config)
    n, n_lags = work.request_shape(analysis.get("max_lag"), start, stop)
    p, d = len(idx), system["velocities"].shape[-1]
    total = torch.zeros(n_lags, dtype=torch.float64, device=device)
    errs = [0.0] * len(samples)
    # the program's sampled per-particle values, copied to the device once
    got = [torch.from_numpy(np.ascontiguousarray(s["particles"],
                                                 dtype=np.float64))
           .to(device) if s["particles"].shape == (n_lags, p) else None
           for s in samples]
    scale = 0.0
    vel = system["velocities"]
    pos = system["positions"]
    denom = (2.0 * reference.BOLTZMANN_KJ
             * reference.box_volume(system["dimensions"])
             * analysis.get("temp_avg", 0.0))
    for lo, hi in reference.particle_blocks(p, n, d):
        atoms = idx[lo:hi]
        v = reference.take(vel, start, stop, atoms)
        if kind == "vacf":
            block = reference.vacf_particles(v, n_lags, device)
        else:
            block = reference.helfand_particles(
                masses[atoms], v, reference.take(pos, start, stop, atoms),
                n_lags, denom, device)
        total += block.sum(dim=1)
        scale = max(scale, float(block.abs().max()))
        for j, g in enumerate(got):
            diff = (float("inf") if g is None
                    else float((g[:, lo:hi] - block).abs().max()))
            errs[j] = max(errs[j], diff if math.isfinite(diff)
                          else float("inf"))
    del got
    series = (total / p).cpu().numpy()
    if kind == "vacf":
        scalar = reference.green_kubo(series, system["dt"], d)
        scalar_scale = abs(scalar)
    else:
        a, b = analysis["linear_fit_window"]
        scalar = reference.helfand_slope(series, n, (a, b))
        scalar_scale = float(np.abs(series[a:b]).max()) / (b - a)
    return {"series": series, "scalar": scalar,
            "scalar_scale": scalar_scale,
            "particles": [e / scale for e in errs]}


def compare(answers: list, samples: dict, traffic: dict, system: dict,
            config: dict, device) -> dict:
    """The compared numbers of the window's answers, each the largest
    over its requests, and the indices of the requests whose own numbers
    pass their limits: {"numbers": {name: value}, "failed": [index]}."""
    limits = traffic["limits"]
    numbers = {}
    failed = set()
    keys = sorted({(a["analysis"], a["start"], a["stop"]) for a in answers})
    for ai, start, stop in keys:
        analysis = traffic["analyses"][ai]
        kind = analysis["kind"]
        picked = [s for s in samples.get(ai, [])
                  if (s["start"], s["stop"]) == (start, stop)]
        ref = reference_run(analysis, system, config, start, stop, picked,
                            device)
        for s, err in zip(picked, ref["particles"]):
            name = f"{kind}_particles"
            numbers[name] = max(numbers.get(name, 0.0), err)
            if not err <= limits[name]:
                failed.add(s["index"])
        for a in answers:
            if (a["analysis"], a["start"], a["stop"]) != (ai, start, stop):
                continue
            for name, err in (
                    (f"{kind}_series", rel(a["series"], ref["series"])),
                    (f"{kind}_{SCALAR[kind]}",
                     abs(a["scalar"] - ref["scalar"])
                     / ref["scalar_scale"])):
                numbers[name] = max(numbers.get(name, 0.0), err)
                if not err <= limits[name]:
                    failed.add(a["index"])
    return {"numbers": numbers, "failed": sorted(failed)}

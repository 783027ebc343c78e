"""Trajectory of a configuration's species: molecules on a lattice of the
box (triclinic where the configuration's angles say so),
Ornstein–Uhlenbeck velocities at the temperature with correlation time
``tau_ps``, positions integrated from them, float32.

A frozen copy of ``ec_system`` in ``chip_smoke.py`` at commit
9de1e251565c3cb324bee311820446c2df28e3a3, rewritten to draw on the card
from the seed with one ``torch.Generator`` in a few large calls: the
recursion v[f] = θ·v[f−1] + sqrt(1 − θ²)·σ·ξ[f], θ = exp(−Δt/τ), as the
stationary filter sqrt(1 − θ²)·σ·Σ_{k<K} θ^k·ξ[f − k], cut where θ^K
falls under 2^-30 (under float32's rounding), and positions as the
running sum x[f] = x[0] + Δt·Σ_{k<f} v[k].
"""

from __future__ import annotations

import math

import numpy as np
import torch

KB_KJ = 0.008314462159   # kJ/(mol·K)
TAIL = 2.0 ** -30        # the filter's last weight lies under this


def topology(config: dict) -> dict:
    """Per-atom names, resnames, resids and masses, and each atom's
    residue index, in the order of the configuration's species."""
    names, resnames, resids, masses, resindex = [], [], [], [], []
    residue = 0
    for species in config["species"]:
        for _ in range(species["count"]):
            for name, mass, _ in species["atoms"]:
                names.append(name)
                resnames.append(species["resname"])
                resids.append(residue + 1)
                masses.append(mass)
                resindex.append(residue)
            residue += 1
    return {"names": np.asarray(names), "resnames": np.asarray(resnames),
            "resids": np.asarray(resids), "masses": np.asarray(masses),
            "resindex": np.asarray(resindex), "n_residues": residue}


def filter_taps(dt: float, tau: float) -> np.ndarray:
    """θ^k for k < K, the first K with θ^K < TAIL."""
    theta = math.exp(-dt / tau)
    k = max(1, math.ceil(math.log(TAIL) / math.log(theta)))
    return theta ** np.arange(k)


def dimensions(config: dict) -> list[float]:
    """The box as MDAnalysis gives it: [a, b, c, α, β, γ], Å and degrees;
    a cubic box where the configuration names no angles."""
    edge = float(config["box_A"])
    angles = config.get("box_angles_deg", [90.0, 90.0, 90.0])
    return [edge, edge, edge] + [float(a) for a in angles]


def box_vectors(dims: list[float]) -> np.ndarray:
    """(3, 3) rows a, b, c of the box: a along x, b in the xy plane."""
    a, b, c = dims[:3]
    cos = [0.0 if x == 90.0 else math.cos(math.radians(x))
           for x in dims[3:]]
    sin_g = math.sqrt(1.0 - cos[2] ** 2)
    cy = (cos[0] - cos[1] * cos[2]) / sin_g
    return np.array([[a, 0.0, 0.0],
                     [b * cos[2], b * sin_g, 0.0],
                     [c * cos[1], c * cy,
                      c * math.sqrt(1.0 - cos[1] ** 2 - cy ** 2)]])


def lattice_positions(config: dict, gen: torch.Generator,
                      device) -> torch.Tensor:
    """(n_atoms, 3) float32 first frame: each molecule's template at a
    site of a side³ lattice of the box, shifted along each box vector by
    a uniform draw in [lo, spacing + hi) Å (``lattice_jitter_A`` = [lo,
    hi], spacing = edge/side, the sites' distance along a box vector)."""
    n_mol = sum(s["count"] for s in config["species"])
    side = 1
    while side ** 3 < n_mol:
        side += 1
    edge = config["box_A"]
    spacing = edge / side
    lo, hi = config["lattice_jitter_A"]
    grid = torch.arange(side, dtype=torch.float64, device=device) * spacing
    frac = torch.cartesian_prod(grid, grid, grid)[:n_mol]
    frac += lo + (spacing + hi - lo) * torch.rand(
        (n_mol, 3), generator=gen, dtype=torch.float64, device=device)
    cells = torch.from_numpy(box_vectors(dimensions(config))).to(device)
    sites = (frac / edge) @ cells
    offsets = torch.tensor(
        [off for s in config["species"] for _ in range(s["count"])
         for _, _, off in s["atoms"]], dtype=torch.float64, device=device)
    per_mol = torch.tensor(
        [len(s["atoms"]) for s in config["species"]
         for _ in range(s["count"])], device=device)
    return (torch.repeat_interleave(sites, per_mol, dim=0)
            + offsets).float()


def generate(config: dict, seed: int, device) -> dict:
    """The configuration's trajectory on ``device`` from ``seed``, copied
    to C-contiguous float32 host arrays (N, n_atoms, 3): positions,
    velocities; with the box's ``dimensions`` and the frame spacing."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    top = topology(config)
    n = config["n_frames"]
    dt = config["dt_ps"]
    n_atoms = len(top["masses"])
    pos0 = lattice_positions(config, gen, device)
    taps = filter_taps(dt, config["tau_ps"])
    k = len(taps)
    theta = taps[1] if k > 1 else 0.0
    sigma = torch.from_numpy(np.sqrt(
        100.0 * KB_KJ * config["temperature_K"] / top["masses"])
        * math.sqrt(1.0 - theta * theta)).float().to(device)

    noise = torch.randn((n + k - 1, n_atoms, 3), generator=gen,
                        dtype=torch.float32, device=device)
    vel = noise[k - 1:].clone()
    for j in range(1, k):
        vel.add_(noise[k - 1 - j:k - 1 - j + n], alpha=float(taps[j]))
    del noise
    vel *= sigma[None, :, None]
    pos = torch.empty_like(vel)
    pos[0] = pos0
    torch.cumsum(vel[:-1], dim=0, out=pos[1:])
    pos[1:] *= dt
    pos[1:] += pos0
    out = {"positions": pos.cpu().numpy(), "velocities": vel.cpu().numpy(),
           "dimensions": dimensions(config), "dt": float(dt),
           "topology": top}
    del pos, vel
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return out

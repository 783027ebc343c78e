"""The plain reference of the analyses the cells run.

Per-particle velocity autocorrelation and Helfand function, their means
over the particles, the Green–Kubo integral and the Helfand fit, in
float64 with ``torch.fft``, a block of particles at a time so that it
fits beside nothing else on the card. It works out again everything the
program derives: the selection and the masses from the configuration,
m·v·x from the raw float32 arrays, the box volume from the box's edges
and angles.

The Helfand form is a frozen copy of ``einstein_oracle`` and
``helfand_oracle`` in ``chip_smoke.py`` at commit
9de1e251565c3cb324bee311820446c2df28e3a3 (NumPy there, torch here; the
same Kneller identity on centered series). The VACF is the
Wiener–Khinchin autocorrelation over 1/(N − lag), the Green–Kubo
integral the trapezoid rule over the lag times, divided by d; the fit is
the least-squares slope of the Helfand function over lag times
``arange(1, N)[a:b]`` for the window (a, b), as upstream
``ViscosityHelfand`` fits it. Imports neither the program nor JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# kJ/(mol·K), MDAnalysis's ``constants["Boltzmann_constant"]``
BOLTZMANN_KJ = 0.008314462159
# float64 values of one particle block's transform (sizes the blocks)
BLOCK_VALUES = 50_000_000


def box_volume(dimensions) -> float:
    """Å³ of a box [a, b, c, α, β, γ] (Å, degrees):
    a·b·c·sqrt(1 − cos²α − cos²β − cos²γ + 2·cosα·cosβ·cosγ)."""
    a, b, c = (float(x) for x in dimensions[:3])
    ca, cb, cg = (0.0 if float(x) == 90.0 else np.cos(np.radians(x))
                  for x in dimensions[3:6])
    return float(a * b * c * np.sqrt(1.0 - ca * ca - cb * cb - cg * cg
                                     + 2.0 * ca * cb * cg))


def atom_table(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """(resnames, masses) of every atom, in the configuration's order."""
    resnames, masses = [], []
    for species in config["species"]:
        for _ in range(species["count"]):
            for _, mass, _ in species["atoms"]:
                resnames.append(species["resname"])
                masses.append(mass)
    return np.asarray(resnames), np.asarray(masses, dtype=np.float64)


def select(config: dict, selection: str) -> np.ndarray:
    """Atom indices of ``"all"`` or ``"resname <name>"``."""
    resnames, _ = atom_table(config)
    words = selection.split()
    if words == ["all"]:
        return np.arange(len(resnames))
    if len(words) == 2 and words[0] == "resname":
        return np.flatnonzero(resnames == words[1])
    raise ValueError(f"the reference selects 'all' or 'resname X', not "
                     f"{selection!r}")


def take(arr: np.ndarray, start: int, stop: int,
         atoms: np.ndarray) -> np.ndarray:
    """Frames [start, stop) of the ``atoms`` of an (N, n_atoms, 3) array,
    C-contiguous: a slice where the atoms are consecutive."""
    if len(atoms) and np.array_equal(atoms, np.arange(atoms[0],
                                                      atoms[0] + len(atoms))):
        return arr[start:stop, atoms[0]:atoms[0] + len(atoms)]
    return np.take(arr[start:stop], atoms, axis=1)


def _autocorr(x: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ_d Σ_i x[i, p, d]·x[i + lag, p, d] for lags < n_lags, (n_lags, p),
    by transforms zero-padded past 2N − 1."""
    n = x.shape[0]
    m = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(x, n=m, dim=0)
    power = (f.real * f.real + f.imag * f.imag).sum(-1)
    del f
    return torch.fft.irfft(power, n=m, dim=0)[:n_lags]


def vacf_particles(v: np.ndarray, n_lags: int, device) -> torch.Tensor:
    """(n_lags, p) VACF of an (N, p, d) float32 velocity block."""
    x = torch.from_numpy(np.ascontiguousarray(v)).to(device).double()
    n = x.shape[0]
    lags = torch.arange(n_lags, device=device, dtype=torch.float64)
    return _autocorr(x, n_lags) / (n - lags)[:, None]


def helfand_particles(masses: np.ndarray, v: np.ndarray, x: np.ndarray,
                      n_lags: int, denom: float, device) -> torch.Tensor:
    """(n_lags, p) Helfand function of m·v·x, components averaged, over
    ``denom`` = 2·k_B·V·T; lag 0 is 0."""
    a = (torch.from_numpy(masses).to(device)[None, :, None]
         * torch.from_numpy(np.ascontiguousarray(v)).to(device).double()
         * torch.from_numpy(np.ascontiguousarray(x)).to(device).double())
    a -= a.mean(dim=0, keepdim=True)
    n, p, d = a.shape
    corr = _autocorr(a, n_lags)
    sq = (a * a).sum(-1)
    del a
    css = torch.cumsum(sq, dim=0)
    lags = torch.arange(n_lags, device=device)
    prev = torch.cat([torch.zeros((1, p), dtype=css.dtype, device=device),
                      css[:n_lags - 1]])
    window = css[n - 1 - lags] + css[-1][None] - prev
    out = (window - 2.0 * corr) / ((n - lags) * d).double()[:, None]
    out[0] = 0.0
    return out / denom


def particle_blocks(p: int, n: int, d: int):
    """(lo, hi) blocks of particles whose transforms stay near
    BLOCK_VALUES float64 values."""
    step = max(1, BLOCK_VALUES // (n * d))
    return [(lo, min(p, lo + step)) for lo in range(0, p, step)]


def green_kubo(series: np.ndarray, dt: float, d: int) -> float:
    """∫ C dt / d by the trapezoid rule on evenly spaced lag times."""
    return float(dt * (series.sum() - 0.5 * (series[0] + series[-1])) / d)


def helfand_slope(series: np.ndarray, n_frames: int, window) -> float:
    """Least-squares slope of ``series[a:b]`` against
    ``arange(1, n_frames)[a:b]``."""
    a, b = window
    x = np.arange(1, n_frames, dtype=np.float64)[a:b]
    y = np.asarray(series[a:b], dtype=np.float64)
    dx = x - x.mean()
    return float((dx * (y - y.mean())).sum() / (dx * dx).sum())

"""The reference against the program's CPU path, the control and the
planted faults, at tiny sizes on the CPU (the program's plain versions of
its kernels); the cells themselves on the card (marked ``gpu``)."""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from perfbench_tiny import ROOT, SEED, tiny

from perfbench import harness, reference
from perfbench.harness import build_universe, run_cell

CELLS = ["ec_solvent.fft_blocks", "dhfr_jac.fft_full",
         "ec_solvent.windowed_lag8k"]


def quiet(*args):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_reference_against_the_programs_cpu_path(name):
    """Per particle, every lag: the reference and the program's plain
    CPU path agree to float64 rounding."""
    import transport_analysis_tpu_torch as port

    cell = tiny(name)
    system = cell.generator.generate(cell.config, SEED, "cpu")
    u = build_universe(port, system)
    n = cell.config["n_frames"]
    for analysis in cell.traffic["analyses"]:
        idx = reference.select(cell.config, analysis["select"])
        lags = analysis["max_lag"] or n
        v = system["velocities"][:, idx]
        if analysis["kind"] == "vacf":
            got = port.VelocityAutocorr(
                u.select_atoms(analysis["select"]), fft=analysis["fft"],
                max_lag=analysis["max_lag"], device="cpu").run()
            ref = reference.vacf_particles(v, lags, "cpu").numpy()
            by_particle = got.results.vacf_by_particle
            scalar = reference.green_kubo(ref.mean(1), 1.0, 3)
            assert got.self_diffusivity_gk() == pytest.approx(scalar,
                                                              rel=1e-10)
        else:
            got = port.ViscosityHelfand(
                u.select_atoms(analysis["select"]), temp_avg=300.0,
                linear_fit_window=(10, 40), fft=analysis["fft"],
                max_lag=analysis["max_lag"], device="cpu").run()
            _, masses = reference.atom_table(cell.config)
            denom = (2 * reference.BOLTZMANN_KJ * 300.0
                     * reference.box_volume(system["dimensions"]))
            ref = reference.helfand_particles(
                masses[idx], v, system["positions"][:, idx], lags, denom,
                "cpu").numpy()
            by_particle = got.results.visc_by_particle
            slope = reference.helfand_slope(ref.mean(1), n, (10, 40))
            scale = np.abs(ref.mean(1)[10:40]).max() / 30
            assert abs(got.results.viscosity - slope) < 1e-10 * scale
        assert by_particle.shape == ref.shape
        assert np.abs(by_particle - ref).max() < 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_cell(tiny(name), SEED, 0.3, False, device="cpu",
                      log=quiet)
    assert result["correct"], result["checked"]
    assert result["failed"] == 0
    assert set(result["checked"]) == (set(tiny(name).traffic["limits"])
                                      | {"shared_buffers"})
    assert result["checked"]["shared_buffers"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_float32_fails(name):
    """The control: the program's float32 work mode, the precision below
    the configurations' float64, held to the cell's own limits."""
    result = run_cell(tiny(name), SEED, 0.3, False, device="cpu",
                      dtype="float32", log=quiet)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checked"].values())


def plant(monkeypatch, fault: str):
    """Break the program underneath the harness, where its results are
    produced (each analysis's ``_conclude``)."""
    from transport_analysis_tpu_torch.models import velocityautocorr
    from transport_analysis_tpu_torch.models import viscosity

    first = {}
    for cls in (velocityautocorr.VelocityAutocorr,
                viscosity.ViscosityHelfand):
        conclude = cls._conclude

        def broken(self, conclude=conclude, cls=cls):
            conclude(self)
            res = self.results
            key = "vacf_by_particle" if "vacf_by_particle" in res \
                else "visc_by_particle"
            if fault == "stale":
                # the state left as the first request made it
                first.setdefault(cls, {k: np.copy(v) if hasattr(v, "copy")
                                       else v for k, v in res.items()})
                res.update(first[cls])
            elif fault == "half_batch":
                # half of the particles left out of the mean
                half = res[key].shape[1] // 2
                res.timeseries = res[key][:, :half].mean(axis=1)
            elif fault == "cached":
                # a repeated request answered from the first one's arrays
                key = (cls, self.start, self.stop)
                if key in first:
                    res.update(first[key])
                else:
                    first[key] = dict(res)
            elif fault == "altered":
                # one value of the answer altered where it is produced
                ts = np.array(res.timeseries)
                ts[1] += 1e-6 * np.abs(ts).max()
                res.timeseries = ts
                if "viscosity" in res:
                    res.viscosity *= 1 + 1e-6

        monkeypatch.setattr(cls, "_conclude", broken)


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered",
                                   "cached"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_fails(monkeypatch, name, fault):
    """Each fault that a one-card analysis can have makes ``correct``
    false: a request answered with an earlier request's state, half of
    the particles left out of the mean, an answer altered where it is
    produced, a repeated request answered from a cache of the first
    one's arrays. (No cell exchanges data between cards.)"""
    cell = tiny(name)
    if fault == "stale" and not cell.traffic["frames"]["block"]:
        # one frame range: an earlier request's answer is the right one,
        # so the stale state is the zeros an analysis starts from
        fault = "zeros"
    if fault == "zeros":
        from transport_analysis_tpu_torch.models import velocityautocorr
        from transport_analysis_tpu_torch.models import viscosity

        def skipped(self):
            self.results.timeseries = np.zeros(self.n_frames)
            self.results.viscosity = 0.0
            self.n_lags = self.n_frames
            self._run_called = True

        for cls in (velocityautocorr.VelocityAutocorr,
                    viscosity.ViscosityHelfand):
            monkeypatch.setattr(cls, "_conclude", skipped)
    else:
        plant(monkeypatch, fault)
    # a clock that ticks by call, so that every analysis repeats in the
    # window however busy the machine is
    ticks = itertools.count(0.0, 0.01)
    clock = types.SimpleNamespace(perf_counter=lambda: next(ticks))
    monkeypatch.setattr(harness, "time", clock)
    result = run_cell(cell, SEED, 0.3, False, device="cpu", log=quiet)
    assert result["attempted"] > len(cell.traffic["analyses"])
    assert not result["correct"]
    assert result["failed"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    """A short run of each cell as the benchmark's command starts it,
    correct."""
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        env=dict(os.environ), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checked"]

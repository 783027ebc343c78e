"""The port's fused analysis step and its mesh dry run
(``transport_analysis_tpu_torch.entry``) against the JAX package's
``__graft_entry__.py``, on the same example arguments.

Bound: the JAX dry run's, rtol 1e-10 and atol 1e-12.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as jentry  # noqa: E402
from transport_analysis_tpu_torch import entry  # noqa: E402

RTOL, ATOL = 1e-10, 1e-12
OUTPUTS = ["vacf", "diffusivity", "helfand", "viscosity", "msd"]


@pytest.fixture(scope="module")
def steps():
    """(port outputs on the CPU, JAX outputs) of the step on the example
    arguments."""
    got = entry.analysis_step(*entry.example_args("cpu"))
    want = jentry._analysis_step(*jentry._example_args())
    return got, want


def test_example_args_are_the_jax_packages():
    for got, want in zip(entry.example_args("cpu"), jentry._example_args()):
        assert got.device.type == "cpu" and got.dtype == torch.float64
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("i", range(len(OUTPUTS)), ids=OUTPUTS)
def test_analysis_step_vs_jax(steps, i):
    got, want = steps[0][i], np.asarray(steps[1][i])
    assert tuple(got.shape) == want.shape
    assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_entry_returns_step_and_args():
    fn, args = entry.entry("cpu")
    assert fn is entry.analysis_step
    assert [tuple(a.shape) for a in args] == [(64, 32, 3), (64, 32, 3),
                                              (32,), (64,), (64,)]


def test_example_args_default_to_the_card(monkeypatch):
    """Without a card the default device raises, as the port's defaults
    do; it never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.example_args()
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_cpu(n):
    entry.dryrun_multichip(n, device="cpu")


def test_dryrun_catches_a_wrong_shard(monkeypatch):
    """A sharded step that drifts by 1e-8 fails the dry run."""
    real = entry.map_particles
    monkeypatch.setattr(entry, "map_particles",
                        lambda kernel, series: real(kernel, series)
                        * (1.0 + 1e-8))
    with pytest.raises(AssertionError, match="sharded step"):
        entry.dryrun_multichip(2, device="cpu")


def test_entry_imports_no_jax():
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, transport_analysis_tpu_torch.entry\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'transport_analysis_tpu')]\n"
         "assert not bad, bad"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

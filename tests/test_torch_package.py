"""Packaging and device contracts of transport_analysis_tpu_torch.

The port imports without jax and without nvcc; a CUDA tensor goes to its
kernel or raises, never to the plain version; chip_smoke.py refuses to
run without a card.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch import _build, _device  # noqa: E402
from transport_analysis_tpu_torch.ops import (  # noqa: E402
    cuda_fft, cuda_kneller, cuda_lag)

ROOT = Path(__file__).resolve().parents[1]


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_pulls_in_no_jax():
    res = _python(
        "import sys, transport_analysis_tpu_torch as ta\n"
        "import transport_analysis_tpu_torch.convert\n"
        "import transport_analysis_tpu_torch.velocityautocorr\n"
        "import transport_analysis_tpu_torch.viscosity\n"
        "import transport_analysis_tpu_torch.ops.cuda_lag\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transport_analysis_tpu'"
        " or m.startswith('transport_analysis_tpu.')]\n"
        "assert not bad, bad\n"
        "assert ta.ops.acf_fft and ta.VelocityAutocorr and ta.EinsteinMSD\n"
        "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_exports():
    for name in ("Universe", "AtomGroup", "UpdatingAtomGroup", "NoDataError",
                 "VelocityAutocorr", "ViscosityHelfand", "EinsteinMSD"):
        assert name in ta.__all__
        assert getattr(ta, name) is not None


def test_build_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="", CUDA_PATH="")
    res = _python(
        "import transport_analysis_tpu_torch._build as b\n"
        "print(b.library_path().name)", env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("libta_kernels-")


def test_find_nvcc_reports_missing_toolkit(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_follows_sources(tmp_path, monkeypatch):
    """An edited source gets a new library name, so it is rebuilt."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = _build.library_path()
    assert [s.name for s in _build.sources()] == ["fft.cu", "kneller.cu",
                                                  "lag.cu"]
    (csrc / "kneller.cu").write_text(
        (csrc / "kneller.cu").read_text() + "\n// edited\n")
    assert _build.library_path() != before


def test_build_dir_in_checkout_or_user_cache(tmp_path, monkeypatch):
    """A checkout builds into its own build/torch_kernels; a copy with no
    pyproject.toml beside it (an installed one) into the user's cache."""
    assert _build.build_dir() == ROOT / "build" / "torch_kernels"
    installed = tmp_path / "site-packages" / "transport_analysis_tpu_torch"
    installed.mkdir(parents=True)
    monkeypatch.setattr(_build, "PACKAGE_DIR", installed)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir() == (tmp_path / "cache" / installed.name
                                  / "torch_kernels")
    assert _build.library_path().parent == _build.build_dir()


def test_nvcc_flags_target_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags


@pytest.mark.parametrize("call", [
    lambda: _device.resolve_device("cuda"),
    lambda: ta.ops.acf_fft(np.zeros((8, 2, 3)), device="cuda"),
    lambda: ta.VelocityAutocorr(
        ta.Universe.empty(1, n_frames=2, velocities=True).atoms,
        device="cuda"),
])
def test_cuda_request_without_card_raises(call, monkeypatch):
    """Asking for the card where there is none raises; nothing continues
    on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def test_non_hopper_card_rejected(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        _device.resolve_device("cuda")


def test_default_device_raises_without_card(monkeypatch):
    """The default is the card: with none it raises as "cuda" does, and
    a device the port does not take is still a ValueError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _device.resolve_device(None)
    with pytest.raises(ValueError):
        _device.resolve_device("mps")


@pytest.mark.parametrize("call", [
    lambda: _device.resolve_device(),
    lambda: ta.ops.acf_fft(np.zeros((8, 2, 3))),
    lambda: ta.VelocityAutocorr(
        ta.Universe.empty(1, n_frames=2, velocities=True).atoms),
    lambda: ta.EinsteinMSD(ta.Universe.empty(1, n_frames=2)),
])
def test_default_without_card_raises(call, monkeypatch):
    """With no device= and no card, a numpy-input op and an analysis
    raise; nothing moves to the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


@pytest.mark.parametrize("call", [
    lambda x: ta.ops.acf_fft(x),
    lambda x: ta.ops.acf_windowed(x, max_lag=3),
    lambda x: ta.ops.einstein_difference_fft(x),
])
def test_cpu_tensor_runs_on_cpu_without_device(call, monkeypatch):
    """A CPU tensor keeps its device when no device= is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.from_numpy(np.random.RandomState(1).normal(size=(8, 2, 3)))
    assert call(x).device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda t: cuda_fft.fft_level(t.reshape(1, 4, 2), 8),
    lambda t: cuda_fft.unpack_power_inva(t.reshape(8, 1), 1, 1),
    lambda t: cuda_kneller.kneller_totals(t.real.reshape(4, 2)),
    lambda t: cuda_lag.lag_sums(t.real.reshape(4, 2, 1), 2),
    lambda t: cuda_lag.lag_sums(t.real.reshape(2, 1, 4), 2),
])
def test_kernel_wrappers_never_fall_back(call):
    """A tensor that is not on the CPU goes to the kernel path, which
    takes CUDA tensors only: anything else raises there instead of
    running the plain version."""
    t = torch.zeros(8, dtype=torch.complex128, device="meta")

    def launches():
        return (cuda_fft.fft_level.launches,
                cuda_fft.unpack_power_inva.launches,
                cuda_kneller.kneller_totals.launches,
                cuda_lag.lag_sums.launches)

    before = launches()
    with pytest.raises(ValueError, match="CUDA"):
        call(t)
    assert launches() == before


def test_plain_versions_count_no_launches():
    before = cuda_fft.fft_level.launches
    cuda_fft.fft_forward(torch.ones((16, 2), dtype=torch.complex128))
    assert cuda_fft.fft_level.launches == before


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "is_available() is false" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository the script exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_version_is_the_projects():
    """``__version__`` equals the JAX package's and pyproject.toml's;
    ``__git_revision__`` is the checkout's commit, or None outside git."""
    import tomllib

    import transport_analysis_tpu as jta

    with open(ROOT / "pyproject.toml", "rb") as fh:
        project = tomllib.load(fh)["project"]["version"]
    assert ta.__version__ == jta.__version__ == project
    assert "__version__" in ta.__all__
    assert ta._version.get_versions()["version"] == ta.__version__
    rev = ta.__git_revision__
    assert rev is None or (len(rev) == 40 and int(rev, 16) >= 0)


def test_due_shim():
    """The citation shim, at the reference's ``due`` import path too: a
    no-op without duecredit."""
    from transport_analysis_tpu_torch.due import Doi, due
    from transport_analysis_tpu_torch.utils import due as udue

    assert due is udue.due and Doi is udue.Doi
    due.cite(Doi("10.21105/joss.00877"), description="x", path="y")

    @due.dcite(Doi("10.21105/joss.00877"), description="x", path="y")
    def fn():
        return 1

    assert fn() == 1


def test_new_modules_import_no_jax():
    res = _python(
        "import sys\n"
        "import transport_analysis_tpu_torch as ta\n"
        "import transport_analysis_tpu_torch.due\n"
        "import transport_analysis_tpu_torch.entry\n"
        "import transport_analysis_tpu_torch.utils.profiling\n"
        "import transport_analysis_tpu_torch.parallel.multihost\n"
        "assert ta.__version__ == '0.9.0'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'transport_analysis_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"

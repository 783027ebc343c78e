"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA Hopper card and skips without one; the
file imports no jax, so on a machine with the card and no jax run it as

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Bound: 1e-12 of the maximum, as in the CPU tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from transport_analysis_tpu_torch.models import VelocityAutocorr  # noqa: E402
from transport_analysis_tpu_torch.ops import acf, cuda_fft, cuda_kneller  # noqa: E402
from transport_analysis_tpu_torch import convert  # noqa: E402

TOL = 1e-12
pytestmark = pytest.mark.gpu


def rel(got, ref) -> float:
    got, ref = got.cpu(), ref.cpu()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA Hopper card: run on the H100 with "
                    "python -m pytest tests/test_torch_gpu.py -m gpu "
                    "--noconftest")
    return torch.device("cuda")


def crandn(rng, device, *shape):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.from_numpy(z).to(device)


@pytest.mark.parametrize("m,b", [(2, 3), (16, 5), (4096, 7), (2 ** 16, 3)])
def test_fft_kernels_vs_plain(cuda_device, m, b):
    """K1 (forward L1/L2, inverse B) and K2 against their plain versions
    over the M range the kernels take."""
    rng = np.random.RandomState(m)
    z = crandn(rng, cuda_device, m, b)
    got = cuda_fft.fft_forward(z)
    assert rel(got, torch.fft.fft(z, dim=0)) <= TOL
    P, d = b, 2
    w = (P * d + 1) // 2
    spec = crandn(rng, cuda_device, m, w)
    got = cuda_fft.unpack_power_inva(spec, P, d)
    ref = cuda_fft.unpack_power_inva_plain(spec, P, d)
    assert rel(got, ref) <= TOL
    n1, _ = cuda_fft.split_m(m)
    rows = max(1, n1 // 2)
    assert rel(cuda_fft.fft_level(got, m, +1, n_out=rows),
               cuda_fft.fft_level_plain(ref, m, +1, n_out=rows)) <= TOL


@pytest.mark.parametrize("n,P,d", [(1, 1, 1), (100, 3, 3), (4097, 5, 2)])
def test_autocorrelation_vs_host(cuda_device, n, P, d):
    x = np.random.RandomState(n).normal(0.5, 2.0, (n, P, d))
    got = acf.acf_fft(torch.from_numpy(x).to(cuda_device))
    ref = torch.from_numpy(acf.acf_fft_numpy(x))
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("n,p,d", [(1024, 37, 3), (1000, 5, 3), (7, 2, 1),
                                   (8192, 300, 3)])
def test_kneller_kernels_vs_plain(cuda_device, n, p, d):
    rng = np.random.RandomState(n)
    sq = torch.from_numpy(rng.uniform(0, 2, (n, p))).to(cuda_device)
    corr = torch.from_numpy(rng.normal(size=(n, p))).to(cuda_device)
    tot = cuda_kneller.kneller_totals(sq)
    assert rel(tot, cuda_kneller.kneller_totals_plain(sq)) <= TOL
    got = cuda_kneller.kneller_windows(sq, corr, tot, d)
    assert rel(got, cuda_kneller.kneller_windows_plain(sq, corr, d)) <= TOL
    assert torch.all(got[0] == 0.0)


def test_model_on_card_vs_cpu(cuda_device):
    rng = np.random.RandomState(0)
    vel = rng.normal(0, 10, (300, 4, 3))
    u = convert.universe_from_arrays(4, {"masses": np.ones(4)},
                                     rng.normal(size=(300, 4, 3)),
                                     velocities=vel)
    gpu = VelocityAutocorr(u.atoms, device=cuda_device).run()
    cpu = VelocityAutocorr(u.atoms, device="cpu").run()
    ts_gpu = torch.from_numpy(gpu.results.timeseries)
    assert rel(ts_gpu, torch.from_numpy(cpu.results.timeseries)) <= TOL


def test_deep_range_raises(cuda_device):
    x = torch.zeros((40000, 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        acf.raw_autocorr_sumlast_flat(x, 2, 1)

"""The port's four-step FFT autocorrelation (transport_analysis_tpu_torch/
ops/cuda_fft.py, ops/acf.py) against numpy and the JAX package.

On the CPU every level runs its plain PyTorch version through the same
orchestration the card runs, so these tests check the decomposition, the
index maps and the Hermitian mirror; the CUDA kernels are held against the
same plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py). Bound: 1e-12 of the maximum, the f64 grade of a
length-M transform.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from transport_analysis_tpu.ops import acf as jacf  # noqa: E402
from transport_analysis_tpu_torch.ops import acf, cuda_fft  # noqa: E402

TOL = 1e-12


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("m,b", [(2, 3), (16, 5), (4096, 4), (2 ** 16, 2)])
def test_forward_composition_vs_numpy(m, b):
    z = crandn(np.random.RandomState(m), m, b)
    got = cuda_fft.fft_forward(torch.from_numpy(z))
    assert got.shape == (m, b)
    assert rel(got, np.fft.fft(z, axis=0)) <= TOL


@pytest.mark.parametrize("m", [1, 2, 8, 256, 2 ** 16])
def test_split_m(m):
    """The plan's split of M: at least two levels, as even as the bits
    allow and longer first (M = 1 has no transform to split)."""
    if m == 1:
        with pytest.raises(ValueError):
            cuda_fft.plan_levels(m)
        return
    plan = cuda_fft.plan_levels(m)
    assert np.prod(plan) == m and len(plan) >= 2
    assert all(a in (b, 2 * b) for a, b in zip(plan, plan[1:]))
    assert plan[0] <= 2 * plan[-1]
    assert max(plan) <= cuda_fft.PLAN_LEVEL <= cuda_fft.MAX_LEVEL


def test_split_m_rejects_non_pow2():
    with pytest.raises(ValueError):
        cuda_fft.plan_levels(24)


@pytest.mark.parametrize("m", [2, 8, 64, 2 ** 16])
def test_unit_roots_octant_exact(m):
    """Each component of each table entry within an ulp of 1 of
    exp(-2πi t/M) evaluated in extended precision (a direct np.exp of
    the unreduced angle is off by up to about three ulps at M = 2^16)."""
    t = np.arange(m, dtype=np.longdouble)
    ang = 8 * np.arctan(np.longdouble(1)) * t / m
    got = cuda_fft.unit_roots(m)
    assert got.shape == (m,)
    assert np.abs(got.real - np.cos(ang)).max() <= 2.3e-16
    assert np.abs(got.imag + np.sin(ang)).max() <= 2.3e-16


@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("twiddle", [0, 3])
def test_fft_level_plain_vs_direct_dft(sign, twiddle):
    """out[k, a, c] = tw(k, c) Σ_j x[a, j, c] exp(sign·2πi·jk/n)."""
    a, n, c, m = 2, 8, 6, 64
    x = crandn(np.random.RandomState(7), a, n, c)
    got = cuda_fft.fft_level(torch.from_numpy(x), m, sign,
                             twiddle_cols=twiddle)
    j = np.arange(n)
    k = np.arange(n)
    dft = np.exp(sign * 2j * np.pi * np.outer(k, j) / n)
    ref = np.einsum("kj,ajc->kac", dft, x)
    if twiddle:
        f = np.arange(c) // twiddle
        ref = ref * np.exp(sign * 2j * np.pi * np.outer(k, f) / m)[:, None]
    assert got.shape == (n, a, c)
    assert rel(got, ref) <= TOL


def _unpack_oracle(z, P, d):
    """Direct numpy form of unpack_power_inva: Hermitian split, power
    spectra summed over components, particles (q, q+ph) packed as real
    and imaginary parts, then inverse level A in (dd, k1, q) order."""
    m, w = z.shape
    n2 = cuda_fft.plan_levels(m)[-1]  # K2's top level
    n1 = m // n2
    ph = (P + 1) // 2
    zm = np.conj(z[(-np.arange(m)) % m])
    f1 = (z + zm) / 2
    f2 = (z - zm) / 2j
    power = np.concatenate([np.abs(f1) ** 2, np.abs(f2) ** 2], axis=1)
    psum = power[:, : P * d].reshape(m, P, d).sum(-1) / m
    packed = np.zeros((m, ph), complex)
    packed.real = psum[:, :ph]
    packed.imag[:, : P - ph] = psum[:, ph:]
    dd = np.arange(n2)
    k2 = np.arange(n2)
    k1 = np.arange(n1)
    inner = np.exp(2j * np.pi * np.outer(dd, k2) / n2)
    p3 = packed.reshape(n2, n1, ph)  # (k2, k1, q), k = k2·n1 + k1
    t = np.einsum("dk,kiq->diq", inner, p3)
    return t * np.exp(2j * np.pi * np.outer(dd, k1) / m)[:, :, None]


@pytest.mark.parametrize("support", ["full", "k0", "half", "k1_zero"])
@pytest.mark.parametrize("m,P,d", [(16, 3, 3), (256, 4, 1), (128, 5, 2)])
def test_unpack_power_inva_vs_numpy(support, m, P, d):
    """Spectra living only at k = 0, only at k = M/2, or only on the
    k1 = 0 column (k a multiple of n1) pin the mirror index there."""
    w = (P * d + 1) // 2
    n1 = m // cuda_fft.plan_levels(m)[-1]
    z = crandn(np.random.RandomState(m + P), m, w)
    keep = {
        "full": np.ones(m, bool),
        "k0": np.arange(m) == 0,
        "half": np.arange(m) == m // 2,
        "k1_zero": np.arange(m) % n1 == 0,
    }[support]
    z[~keep] = 0
    got = cuda_fft.unpack_power_inva(torch.from_numpy(z), P, d)
    ref = _unpack_oracle(z, P, d)
    assert got.shape == ref.shape
    assert rel(got, ref) <= TOL


def test_unpack_rejects_mismatched_width():
    with pytest.raises(ValueError):
        cuda_fft.unpack_power_inva(
            torch.zeros((16, 4), dtype=torch.complex128), P=3, d=3)


@pytest.mark.parametrize("n,P,d", [(100, 3, 3), (64, 4, 3), (1, 1, 1),
                                   (33, 5, 1), (513, 2, 2), (257, 7, 3)])
def test_raw_autocorr_sumlast_flat_vs_jax_and_numpy(n, P, d):
    """Odd and even S = P·d (odd S leaves the last packed column's
    imaginary half empty)."""
    x = np.random.RandomState(n * P).normal(0.5, 2.0, (n, P, d))
    got = acf.raw_autocorr_sumlast_flat(
        torch.from_numpy(x.reshape(n, P * d)), P, d).numpy()
    ref_jax = np.asarray(jacf._raw_autocorr_native_sumlast(jnp.asarray(x)))
    ref_np = acf.acf_fft_numpy(x) * (n - np.arange(n))[:, None]
    assert got.shape == (n, P)
    assert rel(got, ref_jax) <= TOL
    assert rel(got, ref_np) <= TOL


@pytest.mark.parametrize("shape", [(50, 4, 3), (129, 3), (16, 1, 2)])
def test_acf_fft_vs_jax(shape):
    x = np.random.RandomState(5).normal(0, 3.0, shape)
    got = acf.acf_fft(x, device="cpu")
    assert got.dtype == torch.float64
    assert rel(got, jacf.acf_fft(jnp.asarray(x))) <= TOL


def test_acf_fft_from_f32_matches_f64_route():
    """f32 samples upcast on the device are exact: the result equals the
    f64 route's on the upcast operand bit for bit, and the JAX package's
    acf_fft_from_f32 within the bound."""
    x32 = np.random.RandomState(9).normal(0, 5.0, (77, 6, 3)).astype(
        np.float32)
    got = acf.acf_fft_from_f32(torch.from_numpy(x32))
    same = acf.acf_fft(torch.from_numpy(x32.astype(np.float64)))
    assert torch.equal(got, same)
    assert rel(got, jacf.acf_fft_from_f32(jnp.asarray(x32))) <= TOL


def test_acf_dtype_contracts():
    """acf_fft takes float64 or float32 (the float32 work mode, float32
    out, as the JAX op); acf_fft_from_f32 float32 samples only."""
    with pytest.raises(TypeError):
        acf.acf_fft(np.zeros((4, 2), np.int32), device="cpu")
    assert acf.acf_fft(np.ones((4, 2), np.float32),
                       device="cpu").dtype == torch.float32
    with pytest.raises(TypeError):
        acf.acf_fft_from_f32(np.zeros((4, 2), np.float64), device="cpu")


def test_fft_level_input_contracts():
    x = torch.zeros((1, 8, 2), dtype=torch.complex128)
    with pytest.raises(TypeError):
        cuda_fft.fft_level(x.real, 16)
    with pytest.raises(ValueError):
        cuda_fft.fft_level(torch.zeros((1, 6, 2), dtype=torch.complex128),
                           12)
    with pytest.raises(ValueError):
        cuda_fft.fft_level(x, 16, twiddle_cols=3)


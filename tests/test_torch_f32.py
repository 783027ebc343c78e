"""The port's float32 work mode (``dtype=np.float32``) against the JAX
package's, on the CPU.

The same inputs, made from a numpy seed, go through the JAX package's
float32 mode and the port's; on the CPU the port's kernels run their plain
versions in float32 / complex64 (the card's instantiations are held
against those in tests/test_torch_gpu.py and chip_smoke.py). Bounds:

* results of the JAX package's dtypes, within 2e-5 of the maximum of its
  float32 output (``F32_TOL``: a few float32 roundings of an N-term sum
  in either package, which sum in different orders);
* the float32 plain versions of K8 against the TPU's float32 kernel
  (``windowed_lag_pallas``, interpret mode) within the same bound;
* against the float64 run, the JAX package's own bars for its fast mode
  (``tests/test_base.py`` ``TestDtypeFastMode``): rtol 1e-4 for the VACF,
  1e-3 for the Helfand function and the MSD.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import transport_analysis_tpu as jta  # noqa: E402
from transport_analysis_tpu import ops as jops  # noqa: E402
from transport_analysis_tpu.ops import acf as jacf  # noqa: E402
from transport_analysis_tpu.ops import einstein as jein  # noqa: E402
from transport_analysis_tpu.ops import pallas_kneller as jpk  # noqa: E402
from transport_analysis_tpu.ops.pallas_lag import windowed_lag_pallas  # noqa: E402
import transport_analysis_tpu_torch as ta  # noqa: E402
from transport_analysis_tpu_torch.ops import (  # noqa: E402
    acf, cuda_fft, cuda_kneller, cuda_lag)

from test_torch_models import port_universe as models_port_universe  # noqa: E402
from test_torch_streaming import arrays, jax_universe, port_universe  # noqa: E402

F32_TOL = 2e-5
N_FRAMES, N_ATOMS = 300, 7


def rel(got, ref) -> float:
    """max|got − ref| / max|ref|, in float64 (complex128 for complex
    values)."""
    got, ref = np.asarray(got), np.asarray(ref)
    wide = (np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref)
            else np.float64)
    got, ref = got.astype(wide), ref.astype(wide)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def f32(shape, seed, loc=0.0, scale=2.0):
    return np.random.RandomState(seed).normal(loc, scale, shape).astype(
        np.float32)


# --- cuda_fft: K1, K2 and K5 in complex64 ---------------------------------


@pytest.mark.parametrize("m,b", [(2, 3), (16, 5), (4096, 4), (2 ** 16, 2)])
def test_fft_forward_complex64_vs_numpy(m, b):
    """K1's plain version in complex64 through every level of the plan:
    complex64 out, within 1e-5 of numpy's complex128 transform."""
    rng = np.random.RandomState(m + b)
    z = (rng.normal(size=(m, b)) + 1j * rng.normal(size=(m, b))).astype(
        np.complex64)
    got = cuda_fft.fft_forward(torch.from_numpy(z))
    assert got.dtype == torch.complex64
    assert rel(got, np.fft.fft(z.astype(np.complex128), axis=0)) <= 1e-5


def test_roots_complex64_rounded_from_float64():
    """The complex64 table is the float64 one rounded once."""
    got = cuda_fft.roots_tensor(4096, torch.device("cpu"), torch.complex64)
    assert got.dtype == torch.complex64
    assert np.array_equal(got.numpy(),
                          cuda_fft.unit_roots(4096).astype(np.complex64))


@pytest.mark.parametrize("n,P,d", [(1, 1, 1), (77, 6, 3), (100, 5, 1),
                                   (513, 3, 5), (1000, 7, 2),
                                   (40000, 3, 3)])
def test_autocorr_power_sum_vs_jax_f32(n, P, d):
    """The slice's transform in the float32 work mode (pack into complex64,
    K1, K2, K1, K5) against the JAX package's float32 raw component-summed
    autocorrelation; 40,000 frames take a five-level plan (the deep
    range)."""
    x = f32((n, P, d), n + P + d)
    got = cuda_fft.autocorr_power_sum(
        torch.from_numpy(x.reshape(n, P * d)), 2 * acf.next_pow_2(n), P, d,
        work_dtype=torch.float32)
    ref = np.asarray(jacf.raw_autocorr_sumlast(jnp.asarray(x)))
    assert ref.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == (n, P)
    assert rel(got, ref) <= F32_TOL


def test_complex64_stages_keep_their_type():
    """K2's and K5's plain versions run in the operand's type: complex64
    in, complex64 (K2) and float32 (K5) out, pack_pairs into complex64 only
    for the float32 work mode."""
    x = torch.from_numpy(f32((20, 6), 1))
    assert cuda_fft.pack_pairs(x, 64).dtype == torch.complex128
    z = cuda_fft.pack_pairs(x, 64, torch.float32)
    assert z.dtype == torch.complex64
    t = cuda_fft.unpack_power_inva(cuda_fft.fft_forward(z), 3, 2)
    assert t.dtype == torch.complex64
    out = cuda_fft.inverse_last_level(t, 8, 3, True)
    assert out.dtype == torch.float32 and out.shape == (8, 3)
    with pytest.raises(TypeError):
        cuda_fft.autocorr_power_sum(x.double(), 64, 3, 2,
                                    work_dtype=torch.float32)


# --- cuda_kneller: K6a and K6b on float32 ---------------------------------


def _centered_f32(n, p, d, seed=5):
    """float32 centered operand, its |a|² sums and its autocorrelation,
    as the float32 work mode forms them."""
    a = f32((n, p, d), seed)
    a -= a.mean(axis=0, keepdims=True)
    sq = np.sum(a * a, axis=-1)
    corr = np.array(jacf.raw_autocorr_sumlast(jnp.asarray(a)))
    return sq, corr


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("n,p,d", [(1024, 37, 3), (1000, 5, 3), (7, 2, 1),
                                   (129, 33, 3)])
def test_assembly_f32_vs_jax_xla(n, p, d, reduce_mode):
    """float32 sq and corr: float32 out, within 2e-5 of the JAX package's
    float32 assembly; lag 0 pinned to 0."""
    sq, corr = _centered_f32(n, p, d)
    got = cuda_kneller.einstein_assembly(
        torch.from_numpy(sq), torch.from_numpy(corr), reduce_mode, d)
    ref = np.asarray(jein._einstein_fft_impl(
        jnp.asarray(sq), reduce_mode, d, jnp.asarray(corr)))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got, ref) <= F32_TOL
    assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
def test_assembly_f32_vs_jax_pallas_interpret(reduce_mode):
    """Against the TPU kernels (compensated float32 pairs, interpret
    mode) on the same float32 inputs."""
    n, p, d = 1024, 37, 3
    assert jpk.supported(n)
    sq, corr = _centered_f32(n, p, d)
    got = cuda_kneller.einstein_assembly(
        torch.from_numpy(sq), torch.from_numpy(corr), reduce_mode, d)
    ref = np.asarray(jpk.einstein_assembly(
        jnp.asarray(sq), jnp.asarray(corr), reduce_mode, d))
    assert rel(got, ref) <= F32_TOL


def test_kneller_f32_totals_stay_float64():
    """K6a's totals of float32 sq are float64 and equal those of the
    upcast; K6b's windows are the float64 windows of the upcast, rounded
    once."""
    sq, corr = _centered_f32(300, 4, 3)
    s32, c32 = torch.from_numpy(sq), torch.from_numpy(corr)
    tot = cuda_kneller.kneller_totals(s32)
    assert tot.dtype == torch.float64
    assert torch.equal(tot, cuda_kneller.kneller_totals(s32.double()))
    got = cuda_kneller.kneller_windows(s32, c32, tot, 3)
    want = cuda_kneller.kneller_windows(s32.double(), c32.double(), tot, 3)
    assert got.dtype == torch.float32
    assert torch.equal(got, want.float())
    with pytest.raises(ValueError):
        cuda_kneller.kneller_windows(s32, c32.double(), tot, 3)


# --- cuda_lag: K8's float32 plain versions against K8a --------------------

LAG_CASES = [  # (shape, max_lag, mode, reduce_mode)
    ((40, 3, 3), None, "acf", "sum"),
    ((40, 3, 3), 10, "acf", "mean"),
    ((40, 3, 3), None, "einstein", "mean"),
    ((40, 3, 3), 17, "einstein", "sum"),
    ((33, 5), 9, "einstein", "mean"),
    ((64, 8, 2), 64, "einstein", "sum"),
    ((50, 4, 5), 20, "acf", "sum"),
    ((50, 4, 5), 20, "einstein", "mean"),
]


@pytest.mark.parametrize("shape,max_lag,mode,reduce_mode", LAG_CASES)
def test_windowed_lag_f32_vs_f32_kernel(shape, max_lag, mode, reduce_mode):
    """float32 operand: float32 results within 2e-5 of the TPU's float32
    kernel (K8a, interpret mode); d = 5 through the component groups."""
    x32 = f32(shape, sum(shape), 0.3, 1.5)
    got = ta.ops.windowed_lag(torch.from_numpy(x32), max_lag, mode,
                              reduce_mode)
    ref = np.asarray(windowed_lag_pallas(x32, max_lag=max_lag, mode=mode,
                                         reduce_mode=reduce_mode))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert got.shape == ref.shape
    assert rel(got, ref) <= F32_TOL
    if mode == "einstein":
        assert torch.all(got[0] == 0.0)


@pytest.mark.parametrize("mode", ["acf", "einstein"])
def test_lag_sums_out_dtype(mode):
    """The float64 work mode's float32 samples: ``out_dtype=float64``
    gives the float64 sums of the exact upcast, bit for bit; a float64
    operand cannot give float32 sums."""
    x32 = torch.from_numpy(f32((60, 4, 3), 2))
    got = cuda_lag.lag_sums(x32, 30, mode, "sum", out_dtype=torch.float64)
    assert torch.equal(got, cuda_lag.lag_sums(x32.double(), 30, mode))
    assert cuda_lag.lag_sums(x32, 30, mode).dtype == torch.float32
    with pytest.raises(TypeError):
        cuda_lag.lag_sums(x32.double(), 30, mode, out_dtype=torch.float32)


# --- the public ops, float32 in, float32 out ------------------------------


@pytest.mark.parametrize("shape", [(200, 7, 3), (97, 4), (150, 5, 2)])
def test_acf_fft_f32_vs_jax(shape):
    x = f32(shape, shape[0])
    got = ta.ops.acf_fft(x, device="cpu")
    ref = np.asarray(jops.acf_fft(jnp.asarray(x)))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got, ref) <= F32_TOL


@pytest.mark.parametrize("shape,max_lag", [((200, 7, 3), None),
                                           ((97, 4), 31)])
def test_acf_windowed_f32_vs_jax(shape, max_lag):
    x = f32(shape, shape[0] + 1)
    got = ta.ops.acf_windowed(x, max_lag=max_lag, device="cpu")
    ref = np.asarray(jops.acf_windowed(jnp.asarray(x), max_lag=max_lag))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got, ref) <= F32_TOL


@pytest.mark.parametrize("reduce_mode", ["mean", "sum"])
@pytest.mark.parametrize("shape", [(200, 7, 3), (120, 4, 5), (97, 4)])
def test_einstein_difference_f32_vs_jax(shape, reduce_mode):
    """FFT and windowed, on series with an offset: the FFT path centers
    in float32 first (JAX ``_center_and_sq_flat``), the windowed path
    differences the raw series."""
    a = (np.random.RandomState(shape[0]).normal(size=shape).cumsum(0)
         + 50.0).astype(np.float32)
    for port_fn, jax_fn in (
            (lambda: ta.ops.einstein_difference_fft(a, reduce_mode,
                                                    device="cpu"),
             lambda: jops.einstein_difference_fft(jnp.asarray(a),
                                                  reduce_mode)),
            (lambda: ta.ops.einstein_difference_windowed(
                a, reduce_mode, 60, device="cpu"),
             lambda: jops.einstein_difference_windowed(
                 jnp.asarray(a), reduce_mode, 60))):
        got, ref = port_fn(), np.asarray(jax_fn())
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        assert rel(got, ref) <= F32_TOL
        assert torch.all(got[0] == 0.0)


def test_msd_fft_f32_vs_jax():
    r = np.random.RandomState(3).normal(size=(120, 6, 3)).cumsum(0).astype(
        np.float32)
    got = ta.ops.msd_fft(r, device="cpu")
    ref = np.asarray(jops.msd_fft(jnp.asarray(r)))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert rel(got, ref) <= F32_TOL


def test_einstein_difference_fft_owned_f32_is_centered_in_place():
    """``einstein_difference_fft_`` takes a float32 operand it owns and
    centers it in place, as it does a float64 one."""
    a = torch.from_numpy(f32((64, 3, 3), 4, 10.0))
    owned = a.clone()
    got = ta.ops.einstein.einstein_difference_fft_(owned, "sum")
    assert got.dtype == torch.float32
    assert torch.allclose(owned.mean(0), torch.zeros(3, 3), atol=1e-5)
    assert torch.equal(got, ta.ops.einstein_difference_fft(a, "sum"))


# --- the models ------------------------------------------------------------

MODELS = {  # name -> (class name, per-particle key, constructor kwargs)
    "vacf": ("VelocityAutocorr", "vacf_by_particle", {}),
    "helfand": ("ViscosityHelfand", "visc_by_particle",
                {"linear_fit_window": (10, 40)}),
    "msd": ("EinsteinMSD", "msds_by_particle", {}),
}
STREAMS = {
    "batch": {},
    "frame_block": {"frame_block": 64},
    "atom_chunk": {"atom_chunk": 3, "checkpoint": "ckpt.npz"},
    "frame": {"engine": "frame"},
}


@pytest.fixture(scope="module")
def system():
    pos, vel, masses = arrays(n_frames=N_FRAMES, n_atoms=N_ATOMS)
    return jax_universe(pos, vel, masses), port_universe(pos, vel, masses)


def _run(pkg, u, name, fft, dtype, stream, tmp_path, tag, **extra):
    cls, _, kwargs = MODELS[name]
    kw = {**kwargs, **STREAMS[stream], **extra}
    if "checkpoint" in kw:
        kw["checkpoint"] = str(tmp_path / f"{tag}-{kw['checkpoint']}")
    return getattr(pkg, cls)(u.atoms, fft=fft, dtype=dtype, **kw).run()


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_f32_vs_jax(system, tmp_path, name, fft, stream):
    """``dtype=np.float32``: the results have the JAX package's dtypes
    (float32, or float64 accumulators for atom chunks) and lie within
    2e-5 of the maximum of its float32 outputs."""
    ju, pu = system
    key = MODELS[name][1]
    j = _run(jta, ju, name, fft, np.float32, stream, tmp_path, "jax")
    p = _run(ta, pu, name, fft, np.float32, stream, tmp_path, "port",
             device="cpu")
    for k in ("timeseries", key):
        got, ref = p.results[k], np.asarray(j.results[k])
        assert got.dtype == ref.dtype, k
        assert got.shape == ref.shape, k
        assert rel(got, ref) <= F32_TOL, k
    if name == "helfand":
        assert abs(p.results.viscosity - float(j.results.viscosity)) <= \
            1e-3 * abs(float(j.results.viscosity))
    if name == "vacf":
        assert abs(p.self_diffusivity_gk() - j.self_diffusivity_gk()) <= \
            1e-4 * abs(j.self_diffusivity_gk())


@pytest.mark.parametrize("fft", [True, False])
@pytest.mark.parametrize("name,rtol", [("vacf", 1e-4), ("helfand", 1e-3),
                                       ("msd", 1e-3)])
def test_model_f32_vs_f64_run(u_random, name, rtol, fft):
    """The float32 run against the port's float64 run of the JAX package's
    ``u_random`` system, to its bars for its fast mode
    (``tests/test_base.py`` ``TestDtypeFastMode``), both algorithms."""
    pu = models_port_universe(u_random)
    cls = getattr(ta, MODELS[name][0])
    a = cls(pu.atoms, fft=fft, device="cpu").run()
    b = cls(pu.atoms, fft=fft, dtype=np.float32, device="cpu").run()
    assert b.results.timeseries.dtype == np.float32
    assert_allclose(b.results.timeseries, a.results.timeseries, rtol=rtol,
                    atol=1e-3 if name == "msd" else 0)


def test_helfand_f32_forms_m_v_x_in_float32(system):
    """The accumulator m·v·x in float32, masses cast to the work dtype
    and multiplied in JAX's order, (m·v)·x."""
    _, pu = system
    visc = ta.ViscosityHelfand(pu.atoms, dtype=np.float32, device="cpu")
    visc.run()
    assert visc._masses.dtype == np.float32
    from transport_analysis_tpu_torch.models.viscosity import HelfandSeries

    pos, vel, masses = arrays(n_frames=N_FRAMES, n_atoms=N_ATOMS)
    series = HelfandSeries(masses.astype(np.float32), vel, pos, "cpu")
    got = series[:, 1:4, :]
    want = (masses.astype(np.float32)[None, 1:4, None] * vel[:, 1:4]) * \
        pos[:, 1:4]
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("cls", ["VelocityAutocorr", "ViscosityHelfand",
                                 "EinsteinMSD"])
def test_work_dtypes(system, cls):
    """float64 and float32 are the work dtypes; anything else raises."""
    _, pu = system
    for dtype in (np.float64, np.float32):
        getattr(ta, cls)(pu.atoms, dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="float64 or float32"):
        getattr(ta, cls)(pu.atoms, dtype=np.float16, device="cpu")


@pytest.mark.parametrize("dtype, types", [
    (np.float64, (torch.float64, torch.complex128)),
    ("float64", (torch.float64, torch.complex128)),
    (torch.float64, (torch.float64, torch.complex128)),
    (torch.complex128, (torch.float64, torch.complex128)),
    (np.float32, (torch.float32, torch.complex64)),
    (torch.float32, (torch.float32, torch.complex64)),
    (torch.complex64, (torch.float32, torch.complex64)),
])
def test_work_types_table(dtype, types):
    """One table names both work types: a numpy dtype or a torch real or
    complex type of either gives its (real, complex) pair."""
    from transport_analysis_tpu_torch._device import work_types

    assert work_types(dtype) == types


@pytest.mark.parametrize("dtype", [np.float16, torch.float16, torch.int32,
                                   "int64"])
def test_work_types_rejects_other_types(dtype):
    from transport_analysis_tpu_torch._device import work_types

    with pytest.raises(TypeError, match="float64 or float32"):
        work_types(dtype)


def test_every_c_entry_has_an_f32_twin():
    """One rule picks the float32 instantiation of every kernel: the
    ``_f32`` twin of its C entry, with the same arguments, chosen from
    the operand's (K8: the output's) type."""
    from transport_analysis_tpu_torch import _build

    base = [name for name in _build.SIGNATURES if not name.endswith("_f32")]
    assert sorted(base) == ["ta_fft_level", "ta_inverse_last_level",
                            "ta_kneller_totals", "ta_kneller_windows",
                            "ta_lag_pair", "ta_lag_sums",
                            "ta_unpack_power_inva"]
    for name in base:
        assert _build.SIGNATURES[name + "_f32"] == _build.SIGNATURES[name]
    src = "".join(path.read_text() for path in _build.sources())
    for name in _build.SIGNATURES:
        assert f"int {name}(" in src
    assert all(_build._float32_mode(t) for t in (torch.float32,
                                                 torch.complex64))
    assert not any(_build._float32_mode(t) for t in (torch.float64,
                                                     torch.complex128))


def test_chunked_f32_resumes_from_checkpoint(system, tmp_path):
    """A float32 chunked VACF interrupted after its first chunk resumes
    from its checkpoint to the uninterrupted result, bit for bit."""
    _, pu = system
    path = str(tmp_path / "vacf.npz")
    full = ta.VelocityAutocorr(pu.atoms, dtype=np.float32, atom_chunk=3,
                               device="cpu").run()
    from transport_analysis_tpu_torch.parallel import streaming

    calls = []
    real = streaming.chunked_per_particle

    def stop_after_one(kernel, *args, **kwargs):
        def once(x):
            if calls:
                raise KeyboardInterrupt
            calls.append(1)
            return kernel(x)
        return real(once, *args, **kwargs)

    # the analyses reach the chunks through models.base
    import transport_analysis_tpu_torch.models.base as bmod
    bmod.chunked_per_particle = stop_after_one
    try:
        with pytest.raises(KeyboardInterrupt):
            ta.VelocityAutocorr(pu.atoms, dtype=np.float32, atom_chunk=3,
                                checkpoint=path, device="cpu").run()
    finally:
        bmod.chunked_per_particle = real
    resumed = ta.VelocityAutocorr(pu.atoms, dtype=np.float32, atom_chunk=3,
                                  checkpoint=path, device="cpu").run()
    assert np.array_equal(resumed.results.vacf_by_particle,
                          full.results.vacf_by_particle)


# --- the device-memory model -----------------------------------------------


def test_chunk_peak_bytes_f32():
    """The float32 work mode reckons half the bytes of every stage and no
    copy beside the float32 chunk, which it centers in place; float64 is
    as before."""
    n, chunk, d = 65536, 100, 3
    s, m, w = d * chunk, 2 * 65536, (d * chunk + 1) // 2
    slack = acf.ALLOCATOR_SLACK
    assert acf.chunk_peak_bytes(n, chunk, d) == (
        12 * n * s + max(8 * n * s + 8 * n * chunk,
                         8 * n * chunk + 32 * m * w) + 32 * m + slack)
    assert acf.chunk_peak_bytes(n, chunk, d, np.float32) == (
        4 * n * s + max(4 * n * s + 4 * n * chunk,
                        4 * n * chunk + 16 * m * w) + 16 * m + slack)
    with pytest.raises(ValueError):
        acf.chunk_peak_bytes(n, chunk, d, np.float16)


@pytest.mark.parametrize("n", [8192, 65536, 2 ** 20])
def test_auto_atom_chunk_f32(n):
    """JAX's signature, ``dtype=``: the float32 chunk is the largest whose
    float32 peak fits, and holds more atoms than the float64 one."""
    budget = 8.0
    c32 = acf.auto_atom_chunk(n, 3, budget, np.float32)
    c64 = acf.auto_atom_chunk(n, 3, budget)
    assert c32 > c64
    assert acf.chunk_peak_bytes(n, c32, 3, np.float32) <= budget * 1e9
    assert acf.chunk_peak_bytes(n, c32 + 1, 3, np.float32) > budget * 1e9
    assert acf.auto_atom_chunk(n, d=3, hbm_budget_gb=budget,
                               dtype=np.float32, device="cpu") == c32

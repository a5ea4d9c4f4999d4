"""Parity of the PyTorch port's core (`amcx_torch`: types, basis, regress,
payoff, oracle, interop) with the JAX package on shared numpy inputs.

Each tolerance is stated with its reason. Both packages run on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import basis as jbasis
from amcx import oracle as joracle
from amcx import payoff as jpayoff
from amcx import regress as jregress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["power", "chebyshev", "legendre", "laguerre", "hermite"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("degree", [0, 2, 4, 7])
@pytest.mark.parametrize("family", FAMILIES)
def test_design_matrix_matches_amcx(family, degree):
    # same recurrences in the same f32 operation order; rtol 1e-6 allows a
    # few ulp where a backend might round an intermediate differently
    x = np.random.default_rng(degree).uniform(-2.0, 2.0, 4096).astype(np.float32)
    ref = np.asarray(jbasis.design_matrix(jnp.asarray(x), family, degree))
    got = at.design_matrix(_t(x), family, degree).numpy()
    assert got.shape == ref.shape == (4096, degree + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_design_matrix_rejects_unknown_family():
    with pytest.raises(ValueError, match="Unknown basis"):
        at.design_matrix(torch.zeros(3), "fourier", 2)


def _spd_system(rank_one: bool):
    rng = np.random.default_rng(7 if rank_one else 3)
    n, k = 2000, 5
    if rank_one:
        A = np.repeat(rng.uniform(0.5, 2.0, (n, 1)), k, axis=1).astype(np.float32)
    else:
        A = rng.normal(size=(n, k)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    G = (A.T.astype(np.float64) @ A).astype(np.float32)
    b = (A.T.astype(np.float64) @ y).astype(np.float32)
    return A, G, b


@pytest.mark.parametrize("rank_one", [False, True], ids=["spd", "rank1"])
def test_pinv_solve_fitted_values(rank_one):
    # compared on fitted values A @ c: on the rank-1 system the coefficient
    # vector is only defined up to the null space, the fit is unique. rtol
    # 1e-4: two f32 eigendecompositions (LAPACK via torch vs XLA) agree to
    # ~cond * eps on the equilibrated system.
    A, G, b = _spd_system(rank_one)
    cj = np.asarray(jregress.pinv_solve(jnp.asarray(G), jnp.asarray(b)))
    ct = at.pinv_solve(_t(G), _t(b)).numpy()
    np.testing.assert_allclose(A @ ct, A @ cj, rtol=1e-4, atol=1e-4 * np.abs(A @ cj).max())


@pytest.mark.parametrize("weights", ["all", "itm", "degenerate"])
def test_fit_continuation_with_coeffs(weights):
    # one regression step on the same inputs; the fitted values carry the
    # pinv f32 noise of the 5x5 solve, so rtol 1e-4 of the fit's scale
    rng = np.random.default_rng(11)
    n = 8192
    s = (100.0 * np.exp(0.2 * rng.normal(size=n))).astype(np.float32)
    y = np.maximum(100.0 - s * np.exp(0.05 * rng.normal(size=n)), 0.0).astype(np.float32)
    if weights == "all":
        w = None
    elif weights == "itm":
        w = (s < 100.0).astype(np.float32)
    else:  # fewer than k+1 weighted points: both fall back to all paths
        w = np.zeros(n, np.float32)
        w[:3] = 1.0
    spec_j = amcx.RegressionSpec(degree=4)
    spec_t = at.RegressionSpec(degree=4)
    fj, cj = jregress.fit_continuation_with_coeffs(
        jnp.asarray(s), jnp.asarray(y), spec_j, None if w is None else jnp.asarray(w))
    ft, ct = at.fit_continuation_with_coeffs(
        _t(s), _t(y), spec_t, None if w is None else _t(w))
    fj = np.asarray(fj)
    assert ft.shape == (n,) and ct.shape == (5,)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-4, atol=1e-4 * np.abs(fj).max())
    assert float(ft.min()) >= 0.0  # Q2 clamp
    unclamped, _ = at.fit_continuation_with_coeffs(
        _t(s), _t(y), spec_t, None if w is None else _t(w), clamp=False)
    ref_fit = np.asarray(jregress.regression_fitted_values(
        jnp.asarray(s), jnp.asarray(y), spec_j, None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(unclamped.numpy(), ref_fit, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_fit).max())


def test_weighted_standardize_matches_amcx():
    # the same f32 reductions; torch and XLA sum in different orders, so
    # rtol 1e-5 (a few hundred ulp of the standardized value)
    rng = np.random.default_rng(5)
    x = rng.normal(100.0, 20.0, 8192).astype(np.float32)
    w = (x < 100.0).astype(np.float32)
    for weights, factor in ((None, 1.0), (w, 2.0)):
        ref = np.asarray(jregress.weighted_standardize(
            jnp.asarray(x), None if weights is None else jnp.asarray(weights), factor))
        got = at.weighted_standardize(_t(x), None if weights is None else _t(weights), factor)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("barrier_type", ["down-in", "up-in", "down-out", "up-out"])
def test_barrier_gate_matches_amcx(barrier_type):
    # boolean running OR: exact
    rng = np.random.default_rng(2)
    paths = (100.0 * np.exp(np.cumsum(0.05 * rng.normal(size=(17, 512)), axis=0))).astype(np.float32)
    level = 90.0 if barrier_type.startswith("down") else 110.0
    ref = np.asarray(jpayoff.barrier_gate(jnp.asarray(paths), level, barrier_type))
    got = at.barrier_gate(_t(paths), level, barrier_type).numpy()
    np.testing.assert_array_equal(got, ref)
    assert at.barrier_gate(_t(paths), None).all()


def test_intrinsic_and_allow_row():
    s = np.linspace(80.0, 120.0, 9).astype(np.float32)
    for opt in ("put", "call"):
        np.testing.assert_array_equal(
            at.intrinsic_value(_t(s), 100.0, opt).numpy(),
            np.asarray(jpayoff.intrinsic_value(jnp.asarray(s), 100.0, opt)))
    np.testing.assert_array_equal(
        at.exercise_allow_row((0, 3, 5), 8).numpy(),
        np.asarray(jpayoff.exercise_allow_row((0, 3, 5), 8)))
    with pytest.raises(ValueError, match="exercise_steps"):
        at.exercise_allow_row((8,), 8)


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("option_type", ["put", "call"])
def test_crr_and_bs_match_amcx(option_type, american):
    # the port computes in float64; amcx's tree in float32 sits 4e-5 (200
    # levels) to 4e-4 (2000) from the exact value, so it runs here in
    # float64 too (jax.enable_x64, scoped): same algorithm and precision,
    # atol 1e-5
    args = (95.0, 100.0, 1.0, 0.03, 0.25)
    f64 = [np.float64(a) for a in args]
    with jax.enable_x64(True):
        ref = float(joracle.crr_price(*f64, 200, q=np.float64(0.01), option_type=option_type,
                                      american=american))
        bs_ref = float(joracle.bs_price(*f64, np.float64(0.01), option_type))
    got = at.crr_price(*args, 200, q=0.01, option_type=option_type, american=american)
    assert abs(got - ref) <= 1e-5, (got, ref)
    assert abs(at.bs_price(*args, 0.01, option_type) - bs_ref) <= 1e-5
    if not american:  # the tree converges to the closed form
        assert abs(at.crr_price(*args, 2000, q=0.01, option_type=option_type) - bs_ref) < 5e-3


def test_crr_2000_flagship_value():
    # the main path's accuracy gate: CRR-2000 American put, S0=K=100,
    # r=1%, sigma=20%, T=1 (7.5127 in amcx's records), against amcx's tree
    # in float64 (atol 1e-5)
    got = at.crr_price(100.0, 100.0, 1.0, 0.01, 0.2, 2000, option_type="put", american=True)
    f64 = [np.float64(a) for a in (100.0, 100.0, 1.0, 0.01, 0.2)]
    with jax.enable_x64(True):
        ref = float(joracle.crr_price(*f64, 2000, option_type="put", american=True))
    assert abs(got - ref) <= 1e-5
    assert abs(got - 7.5127) < 1e-4


def test_norm_cdf():
    x = np.linspace(-4.0, 4.0, 33)
    ref = np.asarray(joracle.norm_cdf(jnp.asarray(x, jnp.float32)))
    got = at.norm_cdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert abs(at.norm_cdf(0.0) - 0.5) < 1e-15


def test_config_from_jax_maps_every_dataclass():
    objs = [
        amcx.MarketParams(95.0, 0.03, 0.25, 0.01),
        amcx.ProductSpec(K=100.0, T=1.0, barrier=80.0, option_type="Call",
                         exercise="American", barrier_type="up-out"),
        amcx.RegressionSpec(basis="legendre", degree=6, scaling=True, regress_on="itm",
                            rcond=1e-7),
        amcx.SimConfig(n_paths=4096, n_steps=10, antithetic=True, backend="pallas"),
        amcx.SimConfig(n_paths=10, n_steps=3),
    ]
    for obj in objs:
        got = at.config_from_jax(obj)
        assert type(got).__name__ == type(obj).__name__
        for f in dataclasses.fields(got):
            want = getattr(obj, f.name)
            if f.name == "backend":
                want = {"xla": "torch", "pallas": "philox"}[want]
            assert getattr(got, f.name) == want, f.name
    jm = amcx.MarketParams(jnp.float32(100.0), jnp.float32(0.01), jnp.float32(0.2))
    assert at.config_from_jax(jm) == at.MarketParams(100.0, np.float32(0.01), np.float32(0.2))
    with pytest.raises(TypeError):
        at.config_from_jax(object())


def test_tensor_from_numpy_roundtrip():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2]
    t = at.tensor_from_numpy(a)
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), a)
    t[0, 0] = -1.0  # a copy: the source array is untouched
    assert a[0, 0] == 0.0


def test_types_validate_like_amcx():
    with pytest.raises(ValueError):
        at.ProductSpec(K=1.0, T=1.0, option_type="straddle")
    with pytest.raises(ValueError):
        at.RegressionSpec(regress_on="otm")
    with pytest.raises(ValueError):
        at.SimConfig(backend="xla")
    with pytest.raises(ValueError):
        at.SimConfig(n_paths=3, antithetic=True)
    assert at.SimConfig(dtype="float64").torch_dtype == torch.float64
    assert at.ProductSpec(K=1.0, T=1.0, exercise="American").is_american


def test_port_imports_without_jax():
    # the port runs where jax is absent: block jax and amcx, import every
    # module of the package, and check that nothing built a kernel
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['amcx'] = None\n"
        "import amcx_torch, amcx_torch.ops, amcx_torch.ops.gbm, "
        "amcx_torch.ops.lsmc_megakernel, amcx_torch.ops._build, amcx_torch.interop\n"
        "from amcx_torch.ops._build import build_info\n"
        "assert build_info['path'] is None\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

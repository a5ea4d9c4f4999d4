"""The port's Greeks (`amcx_torch.greeks`) and oracles (`amcx_torch.oracle`)
against the JAX package and against the closed form.

Oracles run in float64 in the port and in float32 in amcx, so they are held
at rtol 1e-4. The Greeks estimators are held against amcx's formulas on the
same numpy (cf, τ) at rtol 1e-5, and against the Black-Scholes closed form
within 4 Monte-Carlo standard errors of the pathwise estimator.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import greeks as jgreeks
from amcx import oracle as joracle
from amcx.engine import LSMCResult as JResult

M = at.MarketParams(100.0, 0.05, 0.2)
SPEC = at.RegressionSpec(degree=4)


@pytest.mark.parametrize("option_type", ["call", "put"])
@pytest.mark.parametrize("point", [(100.0, 100.0, 1.0, 0.05, 0.2, 0.0),
                                   (90.0, 105.0, 0.5, 0.02, 0.35, 0.03)])
def test_bs_greeks_and_shift_match_amcx(point, option_type):
    want = joracle.bs_greeks(*point, option_type=option_type)
    got = at.bs_greeks(*point, option_type=option_type)
    for name in ("delta", "vega", "rho"):
        np.testing.assert_allclose(got[name], float(want[name]), rtol=1e-4, err_msg=name)
    for down in (True, False):
        np.testing.assert_allclose(at.discrete_barrier_shift(90.0, 0.2, 0.01, down),
                                   float(joracle.discrete_barrier_shift(90.0, 0.2, 0.01, down)),
                                   rtol=1e-6)


BARRIER_POINTS = [("down-in", 90.0), ("down-out", 90.0), ("up-in", 115.0), ("up-out", 130.0)]


@pytest.mark.parametrize("barrier_type,H", BARRIER_POINTS)
def test_barrier_oracles_match_amcx(barrier_type, H):
    # closed form and the 200-level tree, American and European, both
    # option types; rtol 1e-4 (amcx evaluates in f32) with atol 1e-4 for
    # prices that are nearly 0
    args = (100.0, 100.0, 1.0, 0.03, 0.25, H)
    for ot in ("put", "call"):
        want = float(joracle.barrier_price(*args, q=0.01, option_type=ot,
                                           barrier_type=barrier_type))
        got = at.barrier_price(*args, q=0.01, option_type=ot, barrier_type=barrier_type)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"rr {ot}")
        for american in (False, True):
            want = float(joracle.crr_barrier_price(*args, 200, q=0.01, option_type=ot,
                                                   american=american,
                                                   barrier_type=barrier_type))
            got = at.crr_barrier_price(*args, 200, q=0.01, option_type=ot, american=american,
                                       barrier_type=barrier_type)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"crr {ot} american={american}")
    if barrier_type == "down-in":
        assert at.down_in_price(*args, q=0.01, option_type="put") == at.barrier_price(
            *args, q=0.01, option_type="put")
        assert at.crr_down_in_price(*args, 200, 0.01, "put", True) == at.crr_barrier_price(
            *args, 200, 0.01, "put", True)
    with pytest.raises(ValueError, match="barrier_type"):
        at.barrier_price(*args, barrier_type="sideways")


@pytest.fixture(scope="module")
def fused_run():
    """The port's fused engine on amcx's 8192 x 16 paths: an American put
    and its (cf, τ)."""
    paths = np.asarray(amcx.simulate_gbm(jax.random.key(5), amcx.MarketParams(100.0, 0.05, 0.2),
                                         1.0, amcx.SimConfig(n_paths=8192, n_steps=16)))
    prod = at.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american")
    res = at.lsmc_option_pricing_fused(at.tensor_from_numpy(paths, device="cpu"), prod, M.r, SPEC)
    return paths, prod, res


def test_fast_greeks_matches_amcx(fused_run):
    # the same formulas on the same (cf, τ), f32 in both: rtol 1e-5
    _, prod, res = fused_run
    cf, tau = res.cashflows.numpy(), res.exercise_times.numpy()
    jres = JResult(jnp.zeros(()), jnp.zeros(()), jnp.asarray(cf), jnp.asarray(tau), None)
    jm = amcx.MarketParams(100.0, 0.05, 0.2)
    jprod = amcx.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american")
    want = jgreeks.fast_greeks(jres, jm, jprod, 16)
    got = at.fast_greeks(res, M, prod, 16)
    assert set(got) == set(want) == {"delta", "vega", "rho", "dividend_rho", "theta"}
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, err_msg=name)
    barrier = at.ProductSpec(K=100.0, T=1.0, barrier=80.0, option_type="put",
                             exercise="american")
    with pytest.raises(ValueError, match="vanilla"):
        at.fast_greeks(res, M, barrier, 16)


def test_fused_price_diff_backward_matches_amcx(fused_run):
    # the autograd.Function's backward against amcx's _fused_price_diff_bwd
    # on the port's forward (cf, τ): rtol 1e-5; the path cotangent has the
    # same nonzeros, each within 1e-6 (XLA's and torch's f32 exp differ by
    # an ulp)
    paths, _, res = fused_run
    P = at.tensor_from_numpy(paths, device="cpu").requires_grad_(True)
    r, K, dt = (torch.tensor(v, requires_grad=True) for v in (0.05, 100.0, 1.0 / 16))
    spec = at.RegressionSpec(degree=4, regress_on="itm")
    price = at.fused_price_diff(P, r, K, dt, None, 16, -1.0, spec, True)
    assert float(price.detach()) == float(res.price)
    g_paths, g_r, g_K, g_dt = torch.autograd.grad(price, (P, r, K, dt))
    resid = (jnp.float32(0.05), jnp.float32(100.0), jnp.float32(1.0 / 16), None,
             jnp.asarray(res.cashflows.numpy()), jnp.asarray(res.exercise_times.numpy()))
    jspec = amcx.RegressionSpec(degree=4, regress_on="itm")
    want = jgreeks._fused_price_diff_bwd(16, -1.0, jspec, True, "down-in", resid,
                                         jnp.float32(1.0))
    want_paths = np.asarray(want[0])
    np.testing.assert_array_equal(g_paths.numpy() != 0, want_paths != 0)
    np.testing.assert_allclose(g_paths.numpy(), want_paths, rtol=1e-6, atol=0)
    for got, w, name in zip((g_r, g_K, g_dt), want[1:4], ("r", "K", "dt")):
        np.testing.assert_allclose(float(got), float(w), rtol=1e-5, err_msg=name)
    assert int((g_paths != 0).sum()) == int((res.cashflows > 0).sum())  # one per exercised path


def test_xla_greeks_european_call_match_closed_form():
    # autograd through simulate_gbm + backward_induction at 65,536 x 20
    # equals the mean of the per-path pathwise terms of the same paths
    # (rtol 1e-4: f32 against f64), and each Greek lies within 4 of its
    # Monte-Carlo standard errors (per-path sd / sqrt(n)) of Black-Scholes
    n, T, K = 65_536, 1.0, 100.0
    sim = at.SimConfig(n_paths=n, n_steps=20)
    prod = at.ProductSpec(K=K, T=T, option_type="call", exercise="european")
    p, g = at.price_and_greeks(42, M, prod, SPEC, sim, engine="xla", device="cpu")
    S_T = at.simulate_gbm(42, M, T, sim, device="cpu")[-1].double()
    disc, itm = math.exp(-M.r * T), (S_T > K).double()
    W_T = (torch.log(S_T / M.S0) - (M.r - 0.5 * M.sigma ** 2) * T) / M.sigma
    terms = {"delta": disc * itm * S_T / M.S0,
             "vega": disc * itm * S_T * (W_T - M.sigma * T),
             "rho": disc * T * (itm * S_T - torch.clamp_min(S_T - K, 0.0))}
    want = at.bs_greeks(M.S0, K, T, M.r, M.sigma, option_type="call")
    for name, x in terms.items():
        np.testing.assert_allclose(float(g[name]), float(x.mean()), rtol=1e-4, err_msg=name)
        se = float(x.std()) / math.sqrt(n)
        assert abs(float(g[name]) - want[name]) <= 4 * se, (name, float(g[name]), want[name], se)
    assert abs(float(p) - at.bs_price(M.S0, K, T, M.r, M.sigma, option_type="call")) < 0.1
    assert float(g["theta"]) < 0


@pytest.mark.parametrize("engine", ["fused-ad", "fused", "mega"])
def test_kernel_routes_match_xla_greeks(engine):
    # American put at 16,384 x 20. fused-ad and fused are the autodiff
    # estimator on the same paths: amcx's tolerances (tests/test_greeks.py,
    # price rtol 4e-4, Greeks rtol/atol 5e-3). mega fits in the closed-form
    # frame, a slightly different exercise policy on the same paths: price
    # within 0.01 (a fifth of the 16k-path stderr), Greeks rtol 1e-2
    # (measured up to 0.45% over 8 seeds)
    sim = at.SimConfig(n_paths=16_384, n_steps=20)
    prod = at.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american")
    p_x, g_x = at.price_and_greeks(11, M, prod, SPEC, sim, engine="xla", device="cpu")
    p_k, g_k = at.price_and_greeks(11, M, prod, SPEC, sim, engine=engine, device="cpu")
    if engine == "mega":
        assert abs(float(p_k) - float(p_x)) <= 0.01
        for name in ("delta", "vega", "rho"):
            np.testing.assert_allclose(float(g_k[name]), float(g_x[name]), rtol=1e-2,
                                       err_msg=name)
        return
    np.testing.assert_allclose(float(p_k), float(p_x), rtol=4e-4)
    for name in ("delta", "vega", "rho", "dividend_rho", "theta"):
        np.testing.assert_allclose(float(g_k[name]), float(g_x[name]), rtol=5e-3, atol=5e-3,
                                   err_msg=name)


def test_fused_ad_barrier_and_gamma():
    # fused-ad covers barriers (amcx's tolerances: price atol 5e-3, delta
    # atol 1e-2); gamma by central differences of the pathwise delta is
    # positive for a vanilla call
    sim = at.SimConfig(n_paths=16_384, n_steps=20)
    prod = at.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american", barrier=85.0)
    p_x, g_x = at.price_and_greeks(4, M, prod, SPEC, sim, engine="xla", device="cpu")
    p_f, g_f = at.price_and_greeks(4, M, prod, SPEC, sim, engine="fused-ad", device="cpu")
    assert abs(float(p_f) - float(p_x)) <= 5e-3
    assert abs(float(g_f["delta"]) - float(g_x["delta"])) <= 1e-2
    call = at.ProductSpec(K=100.0, T=1.0, option_type="call", exercise="european")
    sim_g = at.SimConfig(n_paths=16_384, n_steps=10)
    assert float(at.gamma_fd(0, M, call, SPEC, sim_g, device="cpu")) > 0


def test_barrier_products_raise_on_fused_and_mega():
    prod = at.ProductSpec(K=100.0, T=1.0, barrier=80.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=64, n_steps=4)
    for engine in ("fused", "mega"):
        with pytest.raises(ValueError, match="vanilla"):
            at.price_and_greeks(0, M, prod, SPEC, sim, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        at.price_and_greeks(0, M, prod, SPEC, sim, engine="tpu", device="cpu")

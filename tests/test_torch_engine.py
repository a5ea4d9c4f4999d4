"""The port's engines against the JAX package on shared paths.

- `amcx_torch.engine.lsmc_option_pricing` (the reference loop engine)
  against `amcx.engine.lsmc_option_pricing`;
- the plain version of the induction kernel
  (`amcx_torch.ops.lsmc_megakernel`) against amcx's mega kernel, which
  conftest's CPU backend runs in Pallas interpret mode.

Paths come from amcx (JAX on the CPU) and reach the port as numpy arrays.

Early exercise makes f32 LSMC chaotic. Two implementations that sum in
different orders agree to ~1e-6 until, at some step t*, one path sits so
close to the exercise boundary that the two disagree on it. That flip
changes the regression target of every later (earlier-in-time) step, more
paths flip, and at 8192 paths the prices end up 1e-3..2e-2 apart (a 1e-7
relative nudge to the closed-form frame moves the 8192 x 16 ITM put by
~6e-3). So an American case with flips is held to:
- the coefficient tolerance on every row the flips cannot reach (t >= t*);
- the price tolerance on the price difference that the paths with
  different exercise decisions do not explain;
- a bound on the number of such paths, which the test counts and reports.
A case without flips, and every European case, is held to all tolerances
directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import engine as jengine
from amcx.ops import lsmc_megakernel as jmega
from amcx.paths import gbm_standardization as j_standardization
from amcx_torch.ops import gbm as tgbm
from amcx_torch.ops import lsmc_megakernel as tmega

S0, R, SIGMA, K = 100.0, 0.01, 0.2, 100.0
JM = amcx.MarketParams(S0, R, SIGMA)


def _jax_paths(n_paths, n_steps, seed):
    return jax.device_get(amcx.simulate_gbm(jax.random.key(seed), JM, 1.0,
                                            amcx.SimConfig(n_paths=n_paths, n_steps=n_steps)))


@pytest.fixture(scope="module")
def paths_8k():
    return _jax_paths(8192, 16, 1)


def _t(a):
    return at.tensor_from_numpy(a)


def _fit_at_zero(c):
    """Chebyshev fit at x = 0 (T_0..T_4 = 1, 0, -1, 0, 1): the only part of
    an all-paths t=0 coefficient row that the rank-1 design defines."""
    return c[..., 0] - c[..., 2] + c[..., 4]


def _first_divergence(dec_j, dec_t):
    """``(t*, n)``: the largest step t* at which the two (n_steps, n_paths)
    exercise decision arrays differ and on how many paths, or (None, 0)."""
    diff = np.asarray(dec_j) != np.asarray(dec_t)
    steps = np.nonzero(diff.any(axis=1))[0]
    if not steps.size:
        return None, 0
    return int(steps.max()), int(diff[steps.max()].sum())


def _hold_pair(what, price_j, price_t, se_j, se_t, coef_j, coef_t, first, v_j, v_t,
               price_tol):
    """Hold an amcx/port pair to the module docstring's rules. ``coef_*``:
    per-step coefficient rows indexed by t; ``first``: `_first_divergence`;
    ``v_*``: per-path discounted values (f64)."""
    t_star, n_first = first
    scale = np.abs(coef_j).max()
    # coefficients: 1e-3 of the largest coefficient (f32 solves of the same
    # moments summed in different orders)
    rows = slice(t_star, None) if t_star is not None else slice(None)
    np.testing.assert_allclose(coef_t[rows], coef_j[rows], rtol=0, atol=1e-3 * scale)
    d_price = float(price_t) - float(price_j)
    if t_star is None:
        assert abs(d_price) <= price_tol, (what, d_price)
        np.testing.assert_allclose(float(se_t), float(se_j), rtol=1e-3)  # f32 sums
        return
    n_paths = v_j.shape[0]
    differ = np.abs(v_t - v_j) > 1e-5 * (1.0 + np.abs(v_j))
    n_diff = int(differ.sum())
    flip_part = float((v_t - v_j)[differ].sum()) / n_paths
    msg = (f"{what}: first decision flip at t={t_star} on {n_first} path(s); {n_diff} of "
           f"{n_paths} paths end with another exercise decision; price |d| "
           f"{abs(d_price):.2e}, of which {abs(flip_part):.2e} from those paths")
    print(msg)
    # where the rows agree to f32 noise only near-ties can flip: a handful
    assert n_first <= 2 + n_paths // 1000, msg
    # the cascade after it stays a minority of paths (measured 1-7% at 8k-16k
    # paths); a wrong exercise rule would move most exercised paths
    assert n_diff <= n_paths // 10, msg
    assert abs(d_price - flip_part) <= price_tol, msg


# ---------------------------------------------------------------------------
# the reference loop engine
# ---------------------------------------------------------------------------

def _engine_pair(paths, option_type, exercise, regress_on, degree=4, barrier=None,
                 exercise_steps=None, antithetic=False):
    kw = dict(K=K, T=1.0, option_type=option_type, exercise=exercise, barrier=barrier)
    common = dict(return_coeffs=True, exercise_steps=exercise_steps, antithetic=antithetic)
    jres = jengine.lsmc_option_pricing(
        jnp.asarray(paths), amcx.ProductSpec(**kw), R,
        amcx.RegressionSpec(degree=degree, regress_on=regress_on), **common)
    tprod = at.ProductSpec(**kw)
    tres = at.lsmc_option_pricing(
        _t(paths), tprod, R, at.RegressionSpec(degree=degree, regress_on=regress_on), **common)
    return jres, tres, tprod


def _hold_engine_pair(what, paths, jres, tres, prod, exercise_steps=None, price_tol=1e-4):
    n_steps = paths.shape[0] - 1
    S = _t(paths)
    ex = at.intrinsic_value(S[:-1], K, prod.option_type)
    gate = at.barrier_gate(S, prod.barrier, prod.barrier_type)[:-1] & (ex > 0)
    if exercise_steps is not None:
        gate &= at.exercise_allow_row(exercise_steps, n_steps)[:-1, None]
    decide = (lambda cont: (gate & (ex > _t(cont)[:-1])).numpy()) if prod.is_american \
        else (lambda cont: np.zeros(gate.shape, bool))
    first = _first_divergence(decide(np.asarray(jres.continuation)),
                              decide(tres.continuation.numpy()))
    dt = 1.0 / n_steps

    def values(res):
        return (np.asarray(res.cashflows, np.float64)
                * np.exp(-R * dt * np.asarray(res.exercise_times, np.float64)))

    _hold_pair(what, jres.price, tres.price, jres.stderr, tres.stderr,
               np.asarray(jres.coeffs), tres.coeffs.numpy(), first,
               values(jres), values(tres), price_tol)


@pytest.mark.parametrize("exercise", ["american", "european"])
@pytest.mark.parametrize("option_type", ["put", "call"])
@pytest.mark.parametrize("regress_on", ["all", "itm"])
def test_lsmc_option_pricing_matches_amcx(paths_8k, regress_on, option_type, exercise):
    # price atol 1e-4 (1e-3 of the 8k-path stderr), stderr rtol 1e-3,
    # coefficients 1e-3 of the largest (module docstring for flips)
    jres, tres, prod = _engine_pair(paths_8k, option_type, exercise, regress_on)
    assert tres.coeffs.shape == (16, 5) and tres.continuation.shape == (17, 8192)
    assert float(tres.continuation[-1].abs().max()) == 0.0  # maturity row zeros
    _hold_engine_pair(f"{regress_on}-{option_type}-{exercise}", paths_8k, jres, tres, prod)


def test_lsmc_option_pricing_flagship_16k():
    # the main path's estimator (auto -> ITM American put) at 16384 x 32
    paths = _jax_paths(16384, 32, 2)
    jres, tres, prod = _engine_pair(paths, "put", "american", "itm")
    _hold_engine_pair("flagship 16384x32", paths, jres, tres, prod)


def test_reference_engine_barrier_and_bermudan_match_amcx(paths_8k):
    # the reference engine carries the barrier gate and the Bermudan
    # schedule that the kernels do not take yet
    jres, tres, prod = _engine_pair(paths_8k, "put", "american", "itm", degree=3,
                                    barrier=90.0)
    _hold_engine_pair("down-in put", paths_8k, jres, tres, prod)
    sched = (0, 4, 8, 12)
    jres, tres, prod = _engine_pair(paths_8k, "put", "american", "all", degree=3,
                                    exercise_steps=sched)
    _hold_engine_pair("bermudan put", paths_8k, jres, tres, prod, exercise_steps=sched)


def test_antithetic_fold_matches_amcx(paths_8k):
    # European (no exercise decisions): the pair-folded stderr is f32 noise
    # apart; and the port's fold is the stderr of the pair means
    jres, tres, _ = _engine_pair(paths_8k, "put", "european", "all", antithetic=True)
    np.testing.assert_allclose(float(tres.stderr), float(jres.stderr), rtol=1e-3)
    assert abs(float(tres.price) - float(jres.price)) <= 1e-4
    disc = (tres.cashflows * torch.exp(-R / 16 * tres.exercise_times)).double()
    pairs = 0.5 * (disc[:4096] + disc[4096:])
    np.testing.assert_allclose(float(tres.stderr), float(pairs.std(unbiased=False)) / 64.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the induction kernel's plain version against amcx's mega kernel
# ---------------------------------------------------------------------------

MEGA_CASES = [(itm, phi, am, frame)
              for itm in (True, False) for phi in (-1.0, 1.0)
              for am in (True, False) for frame in ("closed", "data")]


def _mega_id(case):
    itm, phi, am, frame = case
    return (f"{'itm' if itm else 'all'}-{'put' if phi < 0 else 'call'}-"
            f"{'am' if am else 'eu'}-{frame}")


def _mega_decisions(S, coeffs, mean_t, inv_std_t, phi):
    """(n_steps, n_paths) exercise decisions of the kernel's apply pass
    from coefficient rows, evaluated with one arithmetic for both sides."""
    x = (S[:-1] - mean_t[:-1, None]) * inv_std_t[:-1, None]
    fit = (at.design_matrix(x, "chebyshev", 4) * coeffs[:-1, None, :]).sum(-1)
    ex = torch.clamp_min(phi * (S[:-1] - K), 0.0)
    return (ex > torch.clamp_min(fit, 0.0)).numpy()


@pytest.mark.parametrize("case", MEGA_CASES, ids=_mega_id)
def test_plain_mega_matches_amcx_mega(paths_8k, case):
    # price atol 2e-4, stderr rtol 1e-3, coefficients 1e-3 of the largest
    # (module docstring for flips); both packages get the same f32
    # standardization rows
    itm, phi, american, frame = case
    n_steps = paths_8k.shape[0] - 1
    dt = 1.0 / n_steps
    kw = dict(degree=4, itm_weights=itm, american=american)
    if frame == "closed":
        jm, js = (np.asarray(a) for a in j_standardization(JM, 1.0, n_steps))
    else:
        jm, js = (a.numpy() for a in tmega._data_standardization(_t(paths_8k), K, phi, itm))
    jout = jmega.lsmc_price_megakernel(
        jnp.asarray(paths_8k), K, R, dt, phi, mean_t=jnp.asarray(jm),
        inv_std_t=jnp.asarray(js), return_coeffs=True, return_cf_tau=True, **kw)
    tout = tmega.lsmc_price_megakernel(_t(paths_8k), K, R, dt, phi, mean_t=_t(jm),
                                       inv_std_t=_t(js), return_coeffs=True, **kw)
    jc, tc = np.asarray(jout.coeffs), tout.coeffs.numpy()
    assert tc.shape == jc.shape == (n_steps + 1, 5)
    assert not tc[-1].any() and not jc[-1].any()  # maturity row zeros
    if itm and phi < 0:
        # S0 == K: no path is ITM at t=0, the Gram is exactly 0, and both
        # kernels (deliberately without amcx.regress's fallback) solve it to
        # exactly 0
        assert not tc[0].any() and not jc[0].any()
    elif not itm:
        # all-paths t=0: rank-1 design at x = 0; only the fit there is
        # defined (rtol 1e-4: the ridge-regularised solve of a singular
        # system, f32)
        np.testing.assert_allclose(_fit_at_zero(tc[0]), _fit_at_zero(jc[0]), rtol=1e-4)
        tc, jc = tc[1:], jc[1:]
    S = _t(paths_8k)
    stats = tmega.mega_stats(_t(jm), _t(js), R, dt, n_steps, "cpu")
    c = stats.view(4, n_steps + 1)
    first = (None, 0)
    if american:
        first = _first_divergence(
            _mega_decisions(S, _t(np.asarray(jout.coeffs)), c[0], c[1], phi),
            _mega_decisions(S, tout.coeffs, c[0], c[1], phi))
        if first[0] is not None and not itm:  # the t=0 row was dropped above
            first = (max(first[0] - 1, 0), first[1])
    _, _, V = tmega._mega_reference(S, stats, K, phi, 1e-6, "chebyshev", 4, american, itm)
    tau = _t(jout.exercise_times).long()
    v_amcx = (c[2, 0] * (_t(jout.cashflows) * c[3, tau])).double().numpy()
    v_port = (c[2, 0] * V).double().numpy()
    _hold_pair(_mega_id(case), jout.price, tout.price, jout.stderr, tout.stderr, jc, tc,
               first, v_amcx, v_port, 2e-4)


def test_price_option_mega_on_cpu_launches_no_kernel():
    # a CPU request runs the plain versions; the kernels' launch counters
    # only move where a kernel runs
    tgbm.gbm_paths.launches = 0
    tmega.lsmc_price_megakernel.launches = 0
    res = at.price_option(3, at.MarketParams(S0, R, SIGMA),
                          at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american"),
                          at.RegressionSpec(), at.SimConfig(n_paths=4096, n_steps=8,
                                                            backend="philox"),
                          engine="mega", return_coeffs=True)
    assert tgbm.gbm_paths.launches == 0
    assert tmega.lsmc_price_megakernel.launches == 0
    assert res.coeffs.shape == (9, 5) and not res.coeffs[0].any()
    assert np.isfinite(float(res.price)) and float(res.stderr) > 0


def test_price_option_engines_agree_and_gate_on_crr():
    # the mega route (philox paths, closed-form frame) and the reference
    # engine on the same philox paths price the flagship put within MC noise
    # of the CRR-2000 value
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=16384, n_steps=32, backend="philox")
    mega = at.price_option(5, market, prod, at.RegressionSpec(), sim, engine="mega")
    ref = at.price_option(5, market, prod, at.RegressionSpec(), sim, engine="xla")
    crr = at.crr_price(S0, K, 1.0, R, SIGMA, 2000, option_type="put", american=True)
    se = float(ref.stderr)
    assert abs(float(mega.price) - crr) <= 4 * se + 0.05  # 0.05: 32-date discretisation
    assert abs(float(ref.price) - crr) <= 4 * se + 0.05
    assert abs(float(mega.price) - float(ref.price)) <= 2 * se


def test_unported_routes_raise():
    market = at.MarketParams(S0, R, SIGMA)
    sim = at.SimConfig(n_paths=64, n_steps=4, backend="philox")
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    for engine in ("fused", "fusedpath"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            at.price_option(0, market, prod, sim=sim, engine=engine)
    barrier = at.ProductSpec(K=K, T=1.0, barrier=80.0, option_type="put", exercise="american")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.price_option(0, market, barrier, sim=sim, engine="mega")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.price_option(0, market, prod, sim=sim, engine="mega", exercise_steps=(1, 2))
    with pytest.raises(ValueError, match="engine"):
        at.price_option(0, market, prod, sim=sim, engine="tpu")
    paths = tgbm.gbm_paths(0, S0, R, SIGMA, 0.0, 1.0, 4, 64)
    for kw in (dict(replay_coeffs=np.zeros((4, 5))), dict(return_cf_tau=True),
               dict(antithetic=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmega.lsmc_price_megakernel(paths, K, R, 0.25, -1.0, **kw)
    with pytest.raises(ValueError, match="degree"):
        tmega.lsmc_price_megakernel(paths, K, R, 0.25, -1.0, degree=11)

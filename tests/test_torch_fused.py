"""The port's fused engine (`amcx_torch.engine_pallas`,
`amcx_torch.ops.lsmc_pallas`) against amcx's on shared paths.

amcx's step kernels run in Pallas interpret mode on the CPU (conftest's
backend); the port's wrappers run their plain versions on CPU tensors.
Paths come from `amcx.simulate_gbm` and reach the port as numpy arrays.
American cases are held to the first-flipped-step rules of
`_lsmc_parity` (the port sums the moments in f64 and rounds once, amcx in
f32 in XLA's order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import engine_pallas as jfused
from amcx.ops import lsmc_pallas as jstep
from amcx_torch.ops import lsmc_pallas as tstep
from _lsmc_parity import hold_engine_pair

S0, R, SIGMA, K = 100.0, 0.01, 0.2, 100.0
JM = amcx.MarketParams(S0, R, SIGMA)
N_PATHS, N_STEPS = 8192, 16
RDT = float(np.float32(R / N_STEPS))


def _jax_paths(seed, antithetic=False):
    sim = amcx.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, antithetic=antithetic)
    return jax.device_get(amcx.simulate_gbm(jax.random.key(seed), JM, 1.0, sim))


@pytest.fixture(scope="module")
def paths_8k():
    return _jax_paths(1)


def _t(a):
    return at.tensor_from_numpy(a, device="cpu")


def _rows(a):
    return jnp.asarray(a).reshape(-1, jstep.LANES)


def _one_step(paths, barrier):
    """Step t = 8 of a put: S_t, a carry (cf, τ) with some paths already
    exercised, the knocked row, and the step's standardization."""
    t = 8
    rng = np.random.default_rng(4)
    S = paths[t]
    cf = np.maximum(K - paths[-1], 0.0).astype(np.float32)
    tau = np.full(N_PATHS, float(N_STEPS), np.float32)
    early = rng.random(N_PATHS) < 0.3
    tau[early] = rng.integers(t + 1, N_STEPS, early.sum())
    cf[early] = np.maximum(K - paths[tau[early].astype(int), np.nonzero(early)[0]], 0.0)
    knocked = None
    if barrier:
        knocked = np.asarray(amcx.payoff.barrier_gate(jnp.asarray(paths), 90.0, "down-in"))[t]
    mean, std = np.float32(S.mean()), np.float32(S.std())
    return t, S, cf, tau, knocked, mean, np.float32(1.0) / std


def _stats(t, mean, inv_std, use_w=1.0, allow=1.0):
    stats = np.zeros((4, N_STEPS + 1), np.float32)
    stats[:, t] = (mean, inv_std, use_w, allow)
    return _t(stats)


def _scalars(t, mean, inv_std, use_w=1.0):
    return jnp.asarray([t, RDT, K, mean, inv_std, -1.0, use_w], jnp.float32)


@pytest.mark.parametrize("itm", [True, False], ids=["itm", "all"])
@pytest.mark.parametrize("barrier", [False, True], ids=["vanilla", "knocked"])
def test_plain_step_moments_matches_amcx(paths_8k, barrier, itm):
    # rtol 1e-5 (f32 sums in XLA's order against f64 sums rounded once);
    # atol 1e-6 of the largest moment for sums that cancel to near 0
    t, S, cf, tau, knocked, mean, inv_std = _one_step(paths_8k, barrier)
    j = jstep.step_moments(_scalars(t, mean, inv_std), _rows(S), _rows(cf), _rows(tau),
                           None if knocked is None else _rows(knocked.astype(np.float32)),
                           degree=4, itm_weights=itm, interpret=True)
    got = tstep.step_moments(_stats(t, mean, inv_std), t, _t(S), _t(cf), _t(tau),
                             None if knocked is None else _t(knocked), rdt=RDT, K=K, phi=-1.0,
                             degree=4, itm_weights=itm)
    assert got.shape == (tstep.pack_dim(5),) == (20,) and got.dtype == torch.float32
    j = np.asarray(j)
    np.testing.assert_allclose(got.numpy(), j, rtol=1e-5, atol=1e-6 * np.abs(j).max())


def test_plain_step_moments_degenerate_weight_flag(paths_8k):
    # use_w = 0 fits on all paths although the fit is ITM-weighted
    t, S, cf, tau, knocked, mean, inv_std = _one_step(paths_8k, True)
    kw = dict(rdt=RDT, K=K, phi=-1.0, degree=4)
    off = tstep.step_moments(_stats(t, mean, inv_std, use_w=0.0), t, _t(S), _t(cf), _t(tau),
                             _t(knocked), itm_weights=True, **kw)
    plain = tstep.step_moments(_stats(t, mean, inv_std), t, _t(S), _t(cf), _t(tau), None,
                               itm_weights=False, **kw)
    assert torch.equal(off, plain)


@pytest.mark.parametrize("barrier", [False, True], ids=["vanilla", "knocked"])
def test_plain_step_apply_matches_amcx(paths_8k, barrier):
    # the same coefficients on both sides. The continuation agrees to a few
    # f32 ulp (XLA may contract multiply-adds); the exercise select is exact
    # but on paths whose ex and cont lie within that noise, which are counted
    t, S, cf, tau, knocked, mean, inv_std = _one_step(paths_8k, barrier)
    coeffs = np.asarray([3.0, -4.5, 1.25, 0.5, -0.125], np.float32)
    kn_j = None if knocked is None else _rows(knocked.astype(np.float32))
    cf_j, tau_j, cont_j = (np.asarray(a).reshape(-1) for a in jstep.step_apply(
        _scalars(t, mean, inv_std), jnp.asarray(coeffs), _rows(S), _rows(cf), _rows(tau), kn_j,
        degree=4, emit_surface=True, interpret=True))
    cf_t, tau_t, row = _t(cf), _t(tau), torch.zeros(N_PATHS)
    out = tstep.step_apply(_stats(t, mean, inv_std), t, _t(coeffs), _t(S), cf_t, tau_t,
                           None if knocked is None else _t(knocked), K=K, phi=-1.0, degree=4,
                           surface=row)
    assert out[0] is cf_t and out[1] is tau_t and out[2] is row  # updated in place
    np.testing.assert_allclose(row.numpy(), cont_j, rtol=1e-5, atol=1e-5)
    ex = np.maximum(K - S, 0.0)
    near = (ex > 0) & (np.abs(ex - cont_j) <= 1e-5 * (1.0 + ex))
    differ = (cf_t.numpy() != cf_j) | (tau_t.numpy() != tau_j)
    assert not (differ & ~near).any()
    assert near.sum() <= 4, int(near.sum())
    assert (tau_j == t).sum() > 100  # the select did fire
    # allow_t = 0 (not an exercise date) or select=False: the carry stays
    for stats, select in ((_stats(t, mean, inv_std, allow=0.0), True),
                          (_stats(t, mean, inv_std), False)):
        cf2, tau2 = _t(cf), _t(tau)
        tstep.step_apply(stats, t, _t(coeffs), _t(S), cf2, tau2, K=K, phi=-1.0, degree=4,
                         select=select)
        assert torch.equal(cf2, _t(cf)) and torch.equal(tau2, _t(tau))


def test_pack_dim_and_unpack_moments_roundtrip():
    k = 5
    rng = np.random.default_rng(0)
    Gt = rng.standard_normal((k, k))
    G = ((Gt + Gt.T) / 2).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32)
    packed = np.concatenate([[G[i, j] for i in range(k) for j in range(i, k)], b])
    assert tstep.pack_dim(k) == jstep.pack_dim(k) == packed.size == 20
    G2, b2 = tstep.unpack_moments(_t(packed.astype(np.float32)), k)
    np.testing.assert_array_equal(G2.numpy(), G)
    np.testing.assert_array_equal(b2.numpy(), b)
    Gj, bj = jstep.unpack_moments(jnp.asarray(packed, jnp.float32), k)
    np.testing.assert_array_equal(G2.numpy(), np.asarray(Gj))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(bj))


def test_step_grid_sizing():
    # kernel 4's persistent grid: two blocks a SM, fewer when the paths (4 a
    # thread) fill fewer; its last block sums one partial row per block
    assert tstep.step_blocks(1 << 20, 132) == 264
    assert tstep.step_blocks(131_071, 132) == 128
    assert tstep.step_blocks(100, 132) == 1


@pytest.mark.parametrize("scaling,internal", [(False, True), (True, True), (False, False)])
def test_precompute_standardization_matches_amcx(paths_8k, scaling, internal):
    # f32 sums over 8192 paths in two orders: rtol 1e-5
    w = (paths_8k < K).astype(np.float32)
    for weights in (None, w):
        kw = dict(scaling=scaling, internal_standardize=internal)
        jm, js = jfused.precompute_standardization(
            jnp.asarray(paths_8k), None if weights is None else jnp.asarray(weights),
            amcx.RegressionSpec(**kw))
        tm, ts = at.precompute_standardization(
            _t(paths_8k), None if weights is None else _t(weights), at.RegressionSpec(**kw))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)


# (option_type, exercise, regress_on, barrier, exercise_steps, antithetic): each
# value of each axis at least once
FUSED_CASES = {
    "put-am-itm": ("put", "american", "itm", None, None, False),
    "call-am-all": ("call", "american", "all", None, None, False),
    "put-eu-all": ("put", "european", "all", None, None, False),
    "call-eu-itm": ("call", "european", "itm", None, None, False),
    "down-in-put-am-itm": ("put", "american", "itm", 90.0, None, False),
    "bermudan-put-all": ("put", "american", "all", None, (0, 4, 8, 12), False),
    "antithetic-put-eu-all": ("put", "european", "all", None, None, True),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_backward_induction_fused_matches_amcx(paths_8k, case):
    # price atol 1e-4 (1e-3 of the 8k-path stderr), stderr rtol 1e-3, and
    # the continuation surfaces to 1e-3 of their largest value before the
    # first flipped step (module docstring)
    ot, ex, reg, barrier, sched, anti = FUSED_CASES[case]
    paths = _jax_paths(2, antithetic=True) if anti else paths_8k
    spec = dict(degree=4, regress_on=reg)
    phi = 1.0 if ot == "call" else -1.0
    kw = dict(barrier=barrier, american=ex == "american", return_surface=True,
              exercise_steps=sched, antithetic=anti)
    jres = jfused.backward_induction_fused(jnp.asarray(paths), R, 1.0 / N_STEPS, K, phi,
                                           amcx.RegressionSpec(**spec), **kw)
    tres = at.backward_induction_fused(_t(paths), R, 1.0 / N_STEPS, K, phi,
                                       at.RegressionSpec(**spec), **kw)
    assert tres.continuation.shape == (N_STEPS + 1, N_PATHS)
    assert not tres.continuation[-1].any()  # maturity row zeros
    assert tres.cashflows.shape == tres.exercise_times.shape == (N_PATHS,)
    prod = at.ProductSpec(K=K, T=1.0, barrier=barrier, option_type=ot, exercise=ex)
    hold_engine_pair(case, paths, jres, tres, prod, R, sched, rows="continuation")


def test_price_option_fused_on_cpu():
    # the CPU route runs the plain versions (no launch), prices like the
    # reference engine on the same philox paths within 2 stderr, and both
    # sit within 4 stderr + 0.05 (32-date discretisation) of CRR-2000
    tstep.step_moments.launches = tstep.step_apply.launches = 0
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=16384, n_steps=32, backend="philox")
    fused = at.price_option(5, market, prod, sim=sim, engine="fused", device="cpu")
    ref = at.price_option(5, market, prod, sim=sim, engine="xla", device="cpu")
    assert tstep.step_moments.launches == tstep.step_apply.launches == 0
    assert fused.cashflows.shape == fused.exercise_times.shape == (16384,)
    crr = at.crr_price(S0, K, 1.0, R, SIGMA, 2000, option_type="put", american=True)
    se = float(ref.stderr)
    assert abs(float(fused.price) - float(ref.price)) <= 2 * se
    assert abs(float(fused.price) - crr) <= 4 * se + 0.05
    surf = at.price_option(5, market, prod, sim=sim, engine="fused", return_surface=True,
                          device="cpu")
    assert surf.continuation.shape == (33, 16384)

"""The port's engines against the JAX package on shared paths.

- `amcx_torch.engine.lsmc_option_pricing` (the reference loop engine)
  against `amcx.engine.lsmc_option_pricing`;
- the plain version of the induction kernel
  (`amcx_torch.ops.lsmc_megakernel`) against amcx's mega kernel, which
  conftest's CPU backend runs in Pallas interpret mode.

Paths come from amcx (JAX on the CPU) and reach the port as numpy arrays.

Early exercise makes f32 LSMC chaotic: an American case is held to the
first-flipped-step rules of `_lsmc_parity` (tests/_lsmc_parity.py).
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
from _lsmc_parity import first_divergence as _first_divergence
from _lsmc_parity import hold_engine_pair
from _lsmc_parity import hold_pair as _hold_pair

S0, R, SIGMA, K = 100.0, 0.01, 0.2, 100.0
JM = amcx.MarketParams(S0, R, SIGMA)


def _jax_paths(n_paths, n_steps, seed):
    return jax.device_get(amcx.simulate_gbm(jax.random.key(seed), JM, 1.0,
                                            amcx.SimConfig(n_paths=n_paths, n_steps=n_steps)))


@pytest.fixture(scope="module")
def paths_8k():
    return _jax_paths(8192, 16, 1)


def _t(a):
    return at.tensor_from_numpy(a, device="cpu")


def _fit_at_zero(c):
    """Chebyshev fit at x = 0 (T_0..T_4 = 1, 0, -1, 0, 1): the only part of
    an all-paths t=0 coefficient row that the rank-1 design defines."""
    return c[..., 0] - c[..., 2] + c[..., 4]


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
    hold_engine_pair(what, paths, jres, tres, prod, R, exercise_steps, price_tol)


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
    _, _, V, _, _ = tmega._mega_reference(S, stats, K, phi, 1e-6, "chebyshev", 4, american, itm)
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
                          engine="mega", return_coeffs=True, device="cpu")
    assert tgbm.gbm_paths.launches == 0
    assert tmega.lsmc_price_megakernel.launches == 0
    assert res.coeffs.shape == (9, 5) and not res.coeffs[0].any()
    assert np.isfinite(float(res.price)) and float(res.stderr) > 0


# the closed-form frame's kernel rows have one builder, `closed_form_rows`,
# cached per market and grid: price_option(engine="mega") looks them up
# (two calls, two hits) and prices the bits of the public wrapper given
# the same frame explicitly, with and without the exposure profile
@pytest.mark.parametrize("surface_stats", [False, True])
def test_price_option_mega_reads_the_cached_closed_form_rows(surface_stats):
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    spec = at.RegressionSpec(regress_on="all" if surface_stats else "auto")
    n = 8
    sim = at.SimConfig(n_paths=4096, n_steps=n, backend="philox")
    mean_t, inv_std_t = at.gbm_standardization(market, 1.0, n, device="cpu")
    rows = tmega.closed_form_rows(S0, R, SIGMA, 0.0, 1.0, 1.0 / n, n, torch.device("cpu"))
    assert torch.equal(rows, tmega.mega_stats(mean_t, inv_std_t, R, 1.0 / n, n, "cpu"))
    hits = tmega.closed_form_rows.cache_info().hits
    got = [at.price_option(3, market, prod, spec, sim, engine="mega", device="cpu",
                           surface_stats=surface_stats) for _ in range(2)]
    assert tmega.closed_form_rows.cache_info().hits == hits + 2
    paths = at.simulate_gbm(3, market, 1.0, sim, "cpu")
    want = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / n, -1.0,
                                       itm_weights=not surface_stats, mean_t=mean_t,
                                       inv_std_t=inv_std_t, return_coeffs=True)
    for res in got:
        assert torch.equal(res.price, want.price) and torch.equal(res.stderr, want.stderr)
    if surface_stats:
        profile = at.exposures_from_coeffs(paths, want.coeffs, mean_t, inv_std_t)
        for a, b in zip(got[0].exposures, profile):
            assert torch.equal(a, b)
    else:
        assert got[0].exposures is None


ENTRY_POINTS = {
    "price_option": lambda: at.price_option(
        0, at.MarketParams(S0, R, SIGMA), at.ProductSpec(K=K, T=1.0, option_type="put"),
        sim=at.SimConfig(n_paths=64, n_steps=4)),
    "simulate_gbm": lambda: at.simulate_gbm(0, at.MarketParams(S0, R, SIGMA), 1.0,
                                            at.SimConfig(n_paths=64, n_steps=4)),
    "price_and_greeks": lambda: at.price_and_greeks(
        0, at.MarketParams(S0, R, SIGMA), at.ProductSpec(K=K, T=1.0, option_type="put"),
        sim=at.SimConfig(n_paths=64, n_steps=4)),
    "gamma_fd": lambda: at.gamma_fd(
        0, at.MarketParams(S0, R, SIGMA), at.ProductSpec(K=K, T=1.0, option_type="put"),
        sim=at.SimConfig(n_paths=64, n_steps=4)),
    "gbm_paths": lambda: tgbm.gbm_paths(0, S0, R, SIGMA, 0.0, 1.0, 4, 64),
    "price_max_call": lambda: at.price_max_call(0, [S0, S0], K, 3.0, 0.05, SIGMA, q=0.1,
                                                n_paths=64),
    "tensor_from_numpy": lambda: at.tensor_from_numpy(np.zeros((2, 3), np.float32)),
    "lsmc_price_fusedpath": lambda: at.lsmc_price_fusedpath(0, S0, K, R, SIGMA, 0.25, 4, 64,
                                                            -1.0),
    "price_out_of_sample": lambda: at.price_out_of_sample(
        0, at.MarketParams(S0, R, SIGMA), at.ProductSpec(K=K, T=1.0, option_type="put"),
        sim=at.SimConfig(n_paths=64, n_steps=4), engine="fusedpath"),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    # the card by default: without a card, a call that does not ask for the
    # CPU raises (torch's own error allocating on "cuda") and never carries
    # on quietly on the CPU
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        ENTRY_POINTS[entry]()


def test_price_option_engines_agree_and_gate_on_crr():
    # the mega route (philox paths, closed-form frame) and the reference
    # engine on the same philox paths price the flagship put within MC noise
    # of the CRR-2000 value
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=16384, n_steps=32, backend="philox")
    mega = at.price_option(5, market, prod, at.RegressionSpec(), sim, engine="mega", device="cpu")
    ref = at.price_option(5, market, prod, at.RegressionSpec(), sim, engine="xla", device="cpu")
    crr = at.crr_price(S0, K, 1.0, R, SIGMA, 2000, option_type="put", american=True)
    se = float(ref.stderr)
    assert abs(float(mega.price) - crr) <= 4 * se + 0.05  # 0.05: 32-date discretisation
    assert abs(float(ref.price) - crr) <= 4 * se + 0.05
    assert abs(float(mega.price) - float(ref.price)) <= 2 * se


def test_unported_routes_raise():
    market = at.MarketParams(S0, R, SIGMA)
    sim = at.SimConfig(n_paths=64, n_steps=4, backend="philox")
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.lsmc_price_fusedpath(0, S0, K, torch.full((4,), R), SIGMA, 0.25, 4, 64, -1.0,
                                device="cpu")
    barrier = at.ProductSpec(K=K, T=1.0, barrier=80.0, option_type="put", exercise="american")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.price_option(0, market, barrier, sim=sim, engine="mega", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.price_option(0, market, prod, sim=sim, engine="mega", exercise_steps=(1, 2),
                        device="cpu")
    with pytest.raises(ValueError, match="engine"):
        at.price_option(0, market, prod, sim=sim, engine="tpu", device="cpu")
    with pytest.raises(ValueError, match="coeffs"):
        at.price_option(0, market, prod, sim=sim, engine="fused", return_coeffs=True,
                        device="cpu")
    paths = tgbm.gbm_paths(0, S0, R, SIGMA, 0.0, 1.0, 4, 64, device="cpu")
    for kw in (dict(replay_coeffs=np.zeros((4, 5))), dict(antithetic=True),
               dict(r=torch.full((5,), R))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmega.lsmc_price_megakernel(paths, K, kw.pop("r", R), 0.25, -1.0, **kw)
    with pytest.raises(ValueError, match="degree"):
        tmega.lsmc_price_megakernel(paths, K, R, 0.25, -1.0, degree=11)


# kernel 2's cooperative grid (`_mega_plan`) against an H100-shaped
# occupancy (as tests/test_torch_fusedpath.py's): 132 SMs, 227 KB of shared
# memory a block at most, 1 KB reserved a block, 6 KB of static shared
# memory, registers for 2 blocks of 256 threads an SM; a quad slot holds V,
# S_t and S_{t+1} (48 B a thread)
def _h100_occupancy(smem):
    static = 6 * 1024
    if smem + static > 232_448:
        return 0
    return min(2, 233_472 // (smem + static + 1024))


MEGA_PLAN_CASES = {  # n_paths: (n_blocks, chip_slots, needed)
    "flagship-1M": (1 << 20, (264, 4, 4)),
    "uneven-1000003": (1_000_003, (264, 4, 4)),
    "small-131072": (131_072, (129, 1, 1)),
    "five-paths": (5, (2, 1, 1)),
    "spill-8M": (1 << 23, (264, 8, 32)),
}


@pytest.mark.parametrize("case", sorted(MEGA_PLAN_CASES))
def test_mega_plan_fits_the_card(case):
    # every quad has a slot on a worker block (block 0 solves), the grid is
    # co-resident with its shared memory, and past the chip's shared memory
    # (8M paths) the widest grid keeps what its blocks leave room for
    n_paths, want = MEGA_PLAN_CASES[case]
    n_blocks, chip, needed = tmega._mega_plan(n_paths, 132, _h100_occupancy)
    assert (n_blocks, chip, needed) == want
    assert (n_blocks - 1) * 256 * needed >= -(-n_paths // 4)
    slot = 256 * 16 * 3
    assert _h100_occupancy(chip * slot) * 132 >= n_blocks
    if chip < needed:
        assert _h100_occupancy((chip + 1) * slot) * 132 < n_blocks


def test_mega_plan_raises_when_no_block_fits():
    with pytest.raises(RuntimeError, match="mega kernel fits no two co-resident blocks"):
        tmega._mega_plan(1 << 20, 132, lambda smem: 0)

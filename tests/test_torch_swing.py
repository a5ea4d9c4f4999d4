"""Swing options (`amcx_torch.swing`, `amcx_torch.ops.lsmc_swing`) against the
JAX package on shared paths, and against the exact rights lattice.

- the swing kernel's plain version (``lsmc_price_swing`` on CPU tensors)
  against amcx's swing kernel, which the CPU backend runs in Pallas
  interpret mode (three calls at 8,192 paths x 8 steps): 3 rights with ITM
  weights, forward takes with 2 owed on antithetic paths, and a fully
  forced ladder;
- at one right, the plain version equals the single-option induction's
  plain version to the bit (the estimator amcx documents);
- the reference loop engine against amcx's ``_swing_engine_impl``;
  ``crr_swing_price`` against amcx's;
- the port alone against the lattice: the 2- and 3-rights ladders, a rate
  curve, and the volume contract's decomposition.

Paths: GBM from a seeded numpy generator (S0 = 100, r = 5%, sigma = 25%,
T = 1), handed to both packages; the closed-form frame.

Tolerances, with their reasons:

- kernel vs amcx's kernel: 2 stderr. amcx sums the moments in f32, the
  port in f64 rounded once; a one-ulp change of a moment flips near-tie
  exercise decisions in the ITM-weighted closed-form frame, and the flips
  cascade down the rights. amcx's swing kernel exports no per-step rows,
  so `_lsmc_parity`'s first-flip rules cannot be applied; 2 stderr is the
  f32 exercise-flip band (measured here: 1e-5..2e-3 against stderrs of
  0.06..0.3); the stderrs move with the same flips, rtol 1e-2 (measured
  5e-5). The fully forced ladder takes no decision from a fit: rtol
  1e-5 (f32 against f64 summation);
- the loop engines: rtol 1e-5 on prices and stderrs (both solve by an
  f32 eigendecomposition; measured 2e-7);
- MC against the lattice: 4 stderr + 0.02 (amcx's tests/test_swing.py
  gate: MC noise plus the small LSMC policy bias), 3.5 stderr + 0.02 for
  the forward kind and the contract (amcx's gates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import swing as jswing
from amcx.ops import lsmc_swing as jsw
from amcx.paths import gbm_standardization as j_standardization
from amcx_torch import swing as tswing
from amcx_torch.ops import lsmc_megakernel as tmega
from amcx_torch.ops import lsmc_swing as tsw

S0, R, SIGMA = 100.0, 0.05, 0.25
JM = amcx.MarketParams(S0, R, SIGMA)
TM = at.MarketParams(S0, R, SIGMA)
PUT = at.ProductSpec(K=105.0, T=1.0, option_type="put", exercise="american")


def _gbm(seed, n_paths, n_steps, antithetic=False, r=R):
    """Time-major (n_steps+1, n_paths) f32 GBM paths; ``r`` a scalar or a
    per-step rate curve."""
    rng = np.random.default_rng(seed)
    if antithetic:
        half = rng.standard_normal((n_steps, n_paths // 2)).astype(np.float32)
        z = np.concatenate([half, -half], axis=1)
    else:
        z = rng.standard_normal((n_steps, n_paths)).astype(np.float32)
    dt = 1.0 / n_steps
    r_t = np.broadcast_to(np.asarray(r, np.float64), (n_steps,))[:, None]
    log_inc = ((r_t - 0.5 * SIGMA ** 2) * dt + SIGMA * np.sqrt(dt) * z).astype(np.float32)
    log_rel = np.concatenate([np.zeros((1, n_paths), np.float32),
                              np.cumsum(log_inc, axis=0, dtype=np.float32)])
    return (S0 * np.exp(log_rel)).astype(np.float32)


def _frame(n_steps):
    return tuple(np.array(a) for a in j_standardization(JM, 1.0, n_steps))


KERNEL_CASES = {
    # name: (n_rights, kwargs, antithetic)
    "3-rights-itm": (3, dict(K=105.0, degree=4, itm_weights=True), False),
    "forward-owed-2-antithetic": (3, dict(K=100.0, degree=5, payoff_kind="forward", n_min=2),
                                  True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_swing_plain_matches_amcx_kernel(case):
    n_rights, kw, antithetic = KERNEL_CASES[case]
    kw = dict(kw)
    K = kw.pop("K")
    n_steps = 8
    paths = _gbm(1, 8192, n_steps, antithetic)
    mean_t, inv_std_t = _frame(n_steps)
    jp, js = jsw.lsmc_price_swing(jnp.asarray(paths), K, R, 1.0 / n_steps, -1.0, n_rights,
                                  mean_t=jnp.asarray(mean_t), inv_std_t=jnp.asarray(inv_std_t),
                                  antithetic=antithetic, **kw)
    tp, ts = tsw.lsmc_price_swing(torch.from_numpy(paths), K, R, 1.0 / n_steps, -1.0, n_rights,
                                  mean_t=torch.from_numpy(mean_t),
                                  inv_std_t=torch.from_numpy(inv_std_t), antithetic=antithetic,
                                  **kw)
    assert tp.shape == ts.shape == ()
    assert abs(float(tp) - float(jp)) <= 2.0 * float(js), (float(tp), float(jp), float(js))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-2)


def test_fully_forced_swing_matches_amcx_kernel():
    # n_min = n_rights = every date: each path takes on every date, so no
    # decision depends on a fit and the two kernels agree to summation order
    n_steps = 8
    n = n_steps + 1
    paths = _gbm(2, 8192, n_steps, antithetic=True)
    kw = dict(degree=5, antithetic=True, payoff_kind="forward", n_min=n)
    jp, js = jsw.lsmc_price_swing(jnp.asarray(paths), 100.0, R, 1.0 / n_steps, -1.0, n, **kw)
    tp, ts = tsw.lsmc_price_swing(torch.from_numpy(paths), 100.0, R, 1.0 / n_steps, -1.0, n,
                                  **kw)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


@pytest.mark.parametrize("itm", [True, False])
def test_one_right_equals_single_option_induction(itm):
    # n_rights = 1 is the American rule: the same moments, solve and select
    # as the single-option induction, so the same bits
    n_steps = 16
    paths = torch.from_numpy(_gbm(3, 8192, n_steps))
    mean_t, inv_std_t = (torch.from_numpy(a) for a in _frame(n_steps))
    kw = dict(degree=4, itm_weights=itm, mean_t=mean_t, inv_std_t=inv_std_t)
    single = tmega.lsmc_price_mega_reference(paths, 105.0, R, 1.0 / n_steps, -1.0,
                                             return_stats=True, **kw)
    swing = tsw.lsmc_price_swing(paths, 105.0, R, 1.0 / n_steps, -1.0, 1, **kw)
    assert torch.equal(single[0], swing[0]) and torch.equal(single[1], swing[1])


@pytest.mark.parametrize("case", ["option-3", "forward-owed-2"])
def test_loop_engine_matches_amcx(case):
    n_steps = 8
    if case == "option-3":
        K, n_rights, itm, kind, n_min, degree = 105.0, 3, True, "option", 0, 4
    else:
        K, n_rights, itm, kind, n_min, degree = 100.0, 3, False, "forward", 2, 5
    paths = _gbm(4, 8192, n_steps)
    rdt = float(np.float32(R / n_steps))
    jp, js = jswing._swing_engine_impl(jnp.asarray(paths), jnp.float32(rdt), jnp.float32(K),
                                       -1.0, amcx.RegressionSpec(degree=degree), n_rights, itm,
                                       False, payoff_kind=kind, n_min=n_min)
    tp, ts = tswing._swing_engine_impl(torch.from_numpy(paths), rdt, K, -1.0,
                                       at.RegressionSpec(degree=degree), n_rights, itm, False,
                                       payoff_kind=kind, n_min=n_min)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)


LATTICE_CASES = [
    dict(S0=100.0, K=105.0, T=1.0, r=0.05, sigma=0.25, n_rights=3, n_steps=20, n_sub=25),
    dict(S0=100.0, K=100.0, T=1.0, r=0.05, sigma=0.25, n_rights=2, n_steps=8, n_sub=50,
         option_type="call", payoff_kind="forward", n_min=1),
    dict(S0=100.0, K=100.0, T=1.0, r=np.r_[np.full(4, 0.02), np.full(4, 0.08)], sigma=0.25,
         n_rights=3, n_steps=8, n_sub=20, payoff_kind="forward", n_min=2, q=0.01),
]


@pytest.mark.parametrize("i", range(len(LATTICE_CASES)))
def test_crr_swing_price_matches_amcx(i):
    kw = LATTICE_CASES[i]
    np.testing.assert_allclose(tswing.crr_swing_price(**kw), jswing.crr_swing_price(**kw),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_rights", [2, 3])
def test_swing_ladder_vs_lattice(n_rights):
    # amcx's tests/test_swing.py gate at 65,536 x 20, through both engines
    sim = at.SimConfig(n_paths=65_536, n_steps=20)
    spec = at.RegressionSpec(degree=4, regress_on="itm")
    truth = tswing.crr_swing_price(S0, 105.0, 1.0, R, SIGMA, n_rights, n_steps=20, n_sub=25)
    mega = at.price_swing_option(5, TM, PUT, n_rights, spec, sim, engine="mega", device="cpu")
    err = float(mega.price) - truth
    assert abs(err) < 4.0 * float(mega.stderr) + 0.02, (float(mega.price), truth)
    assert err < 2.0 * float(mega.stderr) + 1e-3  # a lower-bound estimator
    xla = at.price_swing_option(5, TM, PUT, n_rights, spec, sim, engine="xla", device="cpu")
    assert abs(float(xla.price) - float(mega.price)) < 1e-2  # amcx's mega-vs-xla floor


def test_swing_kernel_rate_curve_vs_lattice():
    # a two-regime short rate reaches the kernel as the (n_steps,) curve of
    # its discount rows; the paths carry the same curve
    n_steps = 20
    r_t = np.r_[np.full(n_steps // 2, 0.03), np.full(n_steps // 2, 0.08)]
    paths = torch.from_numpy(_gbm(6, 65_536, n_steps, r=r_t))
    truth = tswing.crr_swing_price(S0, 105.0, 1.0, r_t, SIGMA, 2, n_steps=n_steps, n_sub=25)
    price, stderr = tsw.lsmc_price_swing(paths, 105.0, torch.from_numpy(r_t), 1.0 / n_steps,
                                         -1.0, 2, degree=4, itm_weights=True)
    assert abs(float(price) - truth) < 4.0 * float(stderr) + 0.02, (float(price), truth)
    flat = tsw.swing_stats(torch.zeros(n_steps + 1), torch.ones(n_steps + 1),
                           np.full(n_steps, R), 1.0 / n_steps, n_steps, "cpu")
    scalar = tsw.swing_stats(torch.zeros(n_steps + 1), torch.ones(n_steps + 1), R,
                             1.0 / n_steps, n_steps, "cpu")
    # a flat curve gives the scalar rate's discount rows, to f32 summation
    np.testing.assert_allclose(flat.numpy(), scalar.numpy(), rtol=1e-6)


FSPEC = at.RegressionSpec(degree=5)
FSIM = at.SimConfig(n_paths=131_072, n_steps=8, antithetic=True)


def test_swing_contract_vs_lattice_composition():
    c = at.price_swing_contract(7, TM, 100.0, 1.0, q_take_min=0.5, q_take_max=1.0, Q_min=6.0,
                                Q_max=7.5, option_type="put", spec=FSPEC, sim=FSIM,
                                engine="mega", device="cpu")
    # bang-bang counts: base 9 x 0.5 = 4.5 -> m in [ceil(3), floor(6)] = [3, 6]
    assert (c.m_min, c.m_max) == (3, 6)
    assert isinstance(c, at.SwingContractResult)
    lat_up = tswing.crr_swing_price(100.0, 100.0, 1.0, R, SIGMA, c.m_max, n_steps=8,
                                    n_sub=100, option_type="put", payoff_kind="forward",
                                    n_min=c.m_min)
    composed = 0.5 * c.strip_value + 0.5 * lat_up
    assert abs(c.price - composed) < 3.5 * c.stderr + 0.02, (c.price, composed)
    t = np.arange(9) / 8.0
    np.testing.assert_allclose(c.strip_value, np.sum(100.0 * np.exp(-R * t) - 100.0),
                               rtol=1e-12)
    degenerate = at.price_swing_contract(0, TM, 100.0, 1.0, 1.0, 1.0, Q_min=0.0, Q_max=9.0,
                                         option_type="put", sim=FSIM, device="cpu")
    assert degenerate.stderr == 0.0 and degenerate.m_max == 0


def test_swing_validation_errors():
    sim = at.SimConfig(n_paths=1024, n_steps=4)
    with pytest.raises(ValueError, match="n_rights"):
        at.price_swing_option(0, TM, PUT, 0, sim=sim, device="cpu")
    with pytest.raises(ValueError, match="vanilla"):
        at.price_swing_option(0, TM, at.ProductSpec(K=105.0, T=1.0, barrier=80.0,
                                                    exercise="american"), 2, sim=sim,
                              device="cpu")
    with pytest.raises(ValueError, match="european"):
        at.price_swing_option(0, TM, at.ProductSpec(K=105.0, T=1.0), 2, sim=sim, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        at.price_swing_option(0, TM, PUT, 2, sim=sim, engine="bogus", device="cpu")
    with pytest.raises(ValueError, match="n_min"):
        at.price_swing_option(0, TM, PUT, 2, sim=sim, n_min=3, device="cpu")
    with pytest.raises(ValueError, match="payoff_kind"):
        at.price_swing_option(0, TM, PUT, 2, sim=sim, payoff_kind="swap", device="cpu")
    with pytest.raises(NotImplementedError, match="B1"):
        at.price_swing_option(0, TM, PUT, 2, sim=at.SimConfig(n_paths=1024, n_steps=4,
                                                              antithetic=True,
                                                              backend="philox"),
                              engine="mega", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        at.price_swing_option_curves(0, None, PUT, 2, device="cpu")
    paths = torch.from_numpy(_gbm(0, 1024, 4))
    cap = tsw.SWING_MAX_RIGHTS
    with pytest.raises(ValueError, match=f"cap of {cap}"):
        tsw.lsmc_price_swing(paths, 105.0, R, 0.25, -1.0, cap + 1)
    with pytest.raises(ValueError, match="even"):
        tsw.lsmc_price_swing(paths[:, :1023], 105.0, R, 0.25, -1.0, 2, antithetic=True)
    with pytest.raises(ValueError, match="float32"):
        tsw.lsmc_price_swing(paths.double(), 105.0, R, 0.25, -1.0, 2)
    with pytest.raises(ValueError, match="unreachable"):
        at.price_swing_contract(0, TM, 100.0, 1.0, 0.0, 1.0, Q_min=50.0, Q_max=60.0, sim=FSIM,
                                device="cpu")
    with pytest.raises(ValueError, match="base volume"):
        at.price_swing_contract(0, TM, 100.0, 1.0, 1.0, 1.0, Q_min=0.0, Q_max=2.0, sim=FSIM,
                                device="cpu")
    # a contract whose up-swing needs more rights than the kernel takes
    long_sim = at.SimConfig(n_paths=512, n_steps=cap + 1)
    with pytest.raises(ValueError, match=f"cap of {cap}"):
        at.price_swing_contract(0, TM, 100.0, 1.0, 0.0, 1.0, Q_min=0.0, Q_max=cap + 2.0,
                                option_type="put", sim=long_sim, engine="mega", device="cpu")

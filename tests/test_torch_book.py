"""The strike/maturity book and the CCR exposures against the JAX package on
shared paths.

- `amcx_torch.ops.lsmc_megakernel.lsmc_book_megakernel` on the CPU (the
  book kernel's plain version) against amcx's book kernel, which the CPU
  backend runs in Pallas interpret mode, with the same standardization
  rows: a put ladder, a mixed put/call book with mixed maturities, a shared
  down-in and down-out barrier, and a European antithetic book;
- `amcx_torch.book` (``price_strike_grid``, ``price_mixed_book`` on both
  engines, ``book_ccr_exposures``, ``book_greeks``) against `amcx.book`;
- `amcx_torch.exposures` and the engine's ``surface_stats`` against
  `amcx.exposures` and `amcx.engine`.

Paths: 8,192 × 16 GBM steps (S0 = 100, r = 3%, σ = 20%, T = 1) from a
seeded numpy generator, handed to both packages. dt = 1/16 is a power of
two, so the port's discount rows (f32(r)·f32(dt)) and amcx's book rows
(f32(r·dt)) are equal.

Tolerances: prices 2e-4 (amcx's own kernel-vs-kernel floor, 4e-3 of the
8k-path stderr), stderrs rtol 1e-3 (f32 sums in two orders). An American
option whose exercise decisions part (the f64-once-rounded moments of the
port against amcx's f32 sums) is held to the first-flipped-step rules of
`_lsmc_parity`, its first flipped step found from the two τ planes; cf
planes are equal wherever the τ planes are. Engine against engine on the
same package: mega against xla 3e-3 (strike grids) and 8e-3 (mixed
maturities), amcx's tests' floors (tests/test_book.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import book as jbook
from amcx import engine as jengine
from amcx import exposures as jexp
from amcx.ops import lsmc_megakernel as jmega
from amcx_torch import book as tbook
from amcx_torch import exposures as texp
from amcx_torch.ops import lsmc_megakernel as tmega
from _lsmc_parity import first_divergence_tau, hold_pair

S0, R, SIGMA = 100.0, 0.03, 0.2
N_PATHS, N_STEPS = 8192, 16
DT = 1.0 / N_STEPS
PRICE_TOL = 2e-4
JSPEC = amcx.RegressionSpec(degree=4, regress_on="all")
TSPEC = at.RegressionSpec(degree=4, regress_on="all")
JM = amcx.MarketParams(S0, R, SIGMA)
TM = at.MarketParams(S0, R, SIGMA)


def _gbm(seed, antithetic=False):
    rng = np.random.default_rng(seed)
    if antithetic:
        half = rng.standard_normal((N_STEPS, N_PATHS // 2)).astype(np.float32)
        z = np.concatenate([half, -half], axis=1)
    else:
        z = rng.standard_normal((N_STEPS, N_PATHS)).astype(np.float32)
    inc = np.float32((R - 0.5 * SIGMA ** 2) * DT) + np.float32(SIGMA * np.sqrt(DT)) * z
    logs = np.concatenate([np.zeros((1, N_PATHS), np.float32),
                           np.cumsum(inc, axis=0, dtype=np.float32)])
    return (np.float32(S0) * np.exp(logs)).astype(np.float32)


@pytest.fixture(scope="module")
def paths():
    return _gbm(4)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _np(x):
    return np.asarray(x)


def _values(cf, tau):
    return _np(cf).astype(np.float64) * np.exp(-R * DT * _np(tau).astype(np.float64))


def _hold_book(what, jout, tout, price_tol=PRICE_TOL):
    """Hold two books' ``(prices, stderrs, cf, tau)`` option by option."""
    jp, jse, jcf, jtau = (_np(x) for x in jout)
    tp, tse, tcf, ttau = (_np(x) for x in tout)
    assert tcf.shape == jcf.shape == ttau.shape == (len(jp), N_PATHS)
    for s in range(len(jp)):
        same = jtau[s] == ttau[s]
        np.testing.assert_array_equal(tcf[s][same], jcf[s][same])
        hold_pair(f"{what} option {s}", jp[s], tp[s], jse[s], tse[s], None, None,
                  first_divergence_tau(jtau[s], ttau[s]), _values(jcf[s], jtau[s]),
                  _values(tcf[s], ttau[s]), price_tol)


# (strikes, phi, keywords, antithetic paths)
KERNEL_CASES = {
    "put-ladder": ([85.0, 95.0, 100.0, 115.0], -1.0, {}, False),
    "put-call-mixed-maturity": ([90.0, 100.0, 110.0, 100.0], [-1.0, 1.0, -1.0, 1.0],
                                dict(maturity_steps=(16, 16, 8, 4)), False),
    "down-in-80": ([95.0, 100.0, 105.0], -1.0, dict(barrier=80.0), False),
    "down-out-80": ([95.0, 100.0, 105.0], -1.0,
                    dict(barrier=80.0, barrier_type="down-out"), False),
    "european-call-antithetic": ([90.0, 110.0], 1.0, dict(american=False, antithetic=True),
                                 True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_book_kernel_plain_matches_amcx(paths, case):
    strikes, phi, kw, anti = KERNEL_CASES[case]
    P = _gbm(5, antithetic=True) if anti else paths
    mean_t, inv_std_t = tmega._data_standardization(_t(P), 0.0, 1.0, False)
    if "barrier" in kw:
        # the level knocks a real share of the 8k paths
        knocked = at.barrier_knocked(_t(P), kw["barrier"])[-1].float().mean()
        assert 0.05 < float(knocked) < 0.95
    jout = jmega.lsmc_book_megakernel(
        jnp.asarray(P), strikes, R, DT, jnp.asarray(phi, jnp.float32),
        mean_t=jnp.asarray(mean_t.numpy()), inv_std_t=jnp.asarray(inv_std_t.numpy()),
        interpret=True, return_cf_tau=True, **kw)
    before = tmega.lsmc_book_megakernel.launches
    tout = tmega.lsmc_book_megakernel(_t(P), strikes, R, DT, phi, mean_t=mean_t,
                                      inv_std_t=inv_std_t, return_cf_tau=True, **kw)
    assert tmega.lsmc_book_megakernel.launches == before  # the CPU runs no kernel
    _hold_book(case, jout, tout)
    if "maturity_steps" in kw:
        # τ starts at each option's own maturity; never beyond it
        assert (tout[3].max(dim=1).values.numpy() <= np.asarray(kw["maturity_steps"])).all()
    if anti:
        # European: no decisions, so the pair-folded stderr is f32 noise apart
        # from amcx's and equal to the spread of the pair means
        v = tout[2].double() * torch.exp(-R * DT * tout[3].double())
        pairs = 0.5 * (v[:, :N_PATHS // 2] + v[:, N_PATHS // 2:])
        np.testing.assert_allclose(tout[1].numpy(), (pairs.std(dim=1, unbiased=False)
                                                     / np.sqrt(N_PATHS // 2)).numpy(),
                                   rtol=1e-5)


def test_plain_book_equals_plain_mega_per_strike(paths):
    # strike s of the book computes kernel 2's function (all-paths fit, the
    # same stats): the same f32 products summed in f64, the same factor
    # and back-solve, so the same bits on the CPU
    strikes = [85.0, 100.0, 115.0]
    P = _t(paths)
    mean_t, inv_std_t = tmega._data_standardization(P, 0.0, 1.0, False)
    prices, stderrs = tmega.lsmc_book_megakernel(P, strikes, R, DT, -1.0, mean_t=mean_t,
                                                 inv_std_t=inv_std_t)
    for s, K in enumerate(strikes):
        price, stderr = tmega.lsmc_price_megakernel(P, K, R, DT, -1.0, itm_weights=False,
                                                    mean_t=mean_t, inv_std_t=inv_std_t,
                                                    return_stats=True)
        assert torch.equal(prices[s], price) and torch.equal(stderrs[s], stderr), K


def test_price_strike_grid_matches_amcx(paths):
    strikes = [85.0, 95.0, 100.0, 115.0]
    types = ["put", "put", "call", "call"]
    for otype in ("put", types):
        jx = jbook.price_strike_grid(jnp.asarray(paths), jnp.asarray(strikes), R, 1.0, otype,
                                     True, JSPEC)
        tx = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, otype, True, TSPEC)
        _hold_book(f"xla {otype}", jx, tx)
    # the mega entry: amcx's kernel with its own data stats (compiled for the
    # put-ladder case above), the port's plain book with its own
    jm = jbook.price_strike_grid(jnp.asarray(paths), jnp.asarray(strikes), R, 1.0, "put", True,
                                 JSPEC, engine="mega", return_cf_tau=True)
    tm = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, "put", True, TSPEC, engine="mega",
                                 return_cf_tau=True)
    _hold_book("mega put ladder", jm, tm)
    # the port's mega against its xla book on the same paths
    tx = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, "put", True, TSPEC)
    np.testing.assert_allclose(tm.prices.numpy(), tx.prices.numpy(), atol=3e-3)
    np.testing.assert_allclose(tm.stderrs.numpy(), tx.stderrs.numpy(), rtol=0.03)
    # the "auto" spec resolves to the all-paths fit on both engines
    auto = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, engine="mega")
    assert torch.equal(auto.prices, tm.prices) and auto.cashflows is None
    # a given frame reaches the book kernel
    frame = at.gbm_standardization(TM, 1.0, N_STEPS, device="cpu")
    framed = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, engine="mega",
                                     mean_t=frame[0], inv_std_t=frame[1])
    want = tmega.lsmc_book_megakernel(_t(paths), strikes, R, DT, -1.0, mean_t=frame[0],
                                      inv_std_t=frame[1])
    assert torch.equal(framed.prices, want[0]) and torch.equal(framed.stderrs, want[1])


def test_price_mixed_book_matches_amcx(paths):
    strikes, mats = [90.0, 100.0, 100.0, 110.0], [16, 16, 8, 4]
    jm = jbook.price_mixed_book(jnp.asarray(paths), jnp.asarray(strikes), mats, R, 1.0, "put",
                                True, JSPEC, engine="mega", return_cf_tau=True)
    tm = tbook.price_mixed_book(_t(paths), strikes, mats, R, 1.0, "put", True, TSPEC,
                                engine="mega", return_cf_tau=True)
    _hold_book("mega mixed maturities", jm, tm)
    jx = jbook.price_mixed_book(jnp.asarray(paths), jnp.asarray(strikes), mats, R, 1.0, "put",
                                True, JSPEC)
    tx = tbook.price_mixed_book(_t(paths), strikes, mats, R, 1.0, "put", True, TSPEC)
    assert tx.cashflows is None and tx.prices.shape == (4,)
    # each maturity bucket is the strike grid on the sliced grid, with the
    # first-flip rules of that grid against amcx's
    for m in sorted(set(mats)):
        idx = [i for i, mi in enumerate(mats) if mi == m]
        sub = tbook.price_strike_grid(_t(paths[:m + 1]), [strikes[i] for i in idx], R,
                                      m * DT, "put", True, TSPEC)
        assert torch.equal(tx.prices[idx], sub.prices) and torch.equal(tx.stderrs[idx],
                                                                        sub.stderrs)
    np.testing.assert_allclose(tx.prices.numpy(), _np(jx.prices), atol=5e-3)
    np.testing.assert_allclose(tm.prices.numpy(), tx.prices.numpy(), atol=8e-3)
    np.testing.assert_allclose(tm.stderrs.numpy(), tx.stderrs.numpy(), rtol=0.05)
    # American put values do not fall with maturity on the same paths
    assert float(tm.prices[2]) <= float(tm.prices[1])


def test_book_greeks_matches_amcx(paths):
    strikes = [90.0, 100.0, 110.0]
    jx = jbook.price_strike_grid(jnp.asarray(paths), jnp.asarray(strikes), R, 1.0, "put", True,
                                 JSPEC)
    jg = jbook.book_greeks(jx, JM, jnp.asarray(strikes), 1.0, N_STEPS, "put")
    # the same (cf, τ) rows through the port: fast_greeks' f32 reductions
    same = tbook.BookResult(*(_t(x) for x in jx))
    tg = tbook.book_greeks(same, TM, strikes, 1.0, N_STEPS, "put")
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), _np(jg[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # the mega book's cf/τ planes give the ladder of the xla book
    tm = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, "put", True, TSPEC, engine="mega",
                                 return_cf_tau=True)
    tx = tbook.price_strike_grid(_t(paths), strikes, R, 1.0, "put", True, TSPEC)
    gm = tbook.book_greeks(tm, TM, strikes, 1.0, N_STEPS, "put")
    gx = tbook.book_greeks(tx, TM, strikes, 1.0, N_STEPS, "put")
    np.testing.assert_allclose(gm["delta"].numpy(), gx["delta"].numpy(), atol=1e-2)
    d = gx["delta"].numpy()
    assert (d < 0).all() and (np.diff(d) < 0).all()
    # the planes reprice each option
    for s in range(3):
        np.testing.assert_allclose(float(_values(tm.cashflows[s], tm.exercise_times[s]).mean()),
                                   float(tm.prices[s]), atol=2e-5)
    with pytest.raises(ValueError, match="cashflow"):
        tbook.book_greeks(tbook.price_strike_grid(_t(paths), strikes, R, 1.0, engine="mega"),
                          TM, strikes, 1.0, N_STEPS)


# ---------------------------------------------------------------------------
# exposures
# ---------------------------------------------------------------------------

def test_compute_ccr_exposures_matches_amcx():
    # one shared surface with NaN and inf entries and an all-NaN step:
    # percentiles equal to the bit (the same f32 interpolation of the same
    # sorted values), EPE rtol 1e-6 (f32 sums in two orders)
    rng = np.random.default_rng(7)
    surf = rng.lognormal(0.0, 1.0, (6, 1001)).astype(np.float32)
    surf[1, ::7] = np.nan
    surf[2, ::3] = np.inf
    surf[3, :] = np.nan
    surf[4, 1:] = np.nan
    want = jexp.compute_ccr_exposures(jnp.asarray(surf))
    got = texp.compute_ccr_exposures(_t(surf))
    np.testing.assert_array_equal(got.pfe5.numpy(), _np(want.pfe5))
    np.testing.assert_array_equal(got.pfe95.numpy(), _np(want.pfe95))
    np.testing.assert_allclose(got.epe.numpy(), _np(want.epe), rtol=1e-6)
    assert bool(torch.isnan(got.epe[3])) and bool(torch.isnan(got.pfe5[3]))


def test_cva_matches_amcx():
    epe = np.abs(np.random.default_rng(8).normal(1.0, 0.3, N_STEPS + 1)).astype(np.float32)
    epe[5] = np.nan
    ene = (0.5 * epe[::-1]).copy()
    hazard = np.linspace(0.01, 0.05, N_STEPS).astype(np.float32)
    for h in (0.02, hazard):
        np.testing.assert_allclose(float(texp.cva_from_epe(_t(epe), 1.0, R, h)),
                                   float(jexp.cva_from_epe(jnp.asarray(epe), 1.0, R, h)),
                                   rtol=1e-6)
        got = texp.bilateral_cva(_t(epe), _t(ene), 1.0, R, h, 0.01, 0.4, 0.3)
        want = jexp.bilateral_cva(jnp.asarray(epe), jnp.asarray(ene), 1.0, R, h, 0.01, 0.4, 0.3)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   rtol=1e-5)
    # no own default: the counterparty leg is the unilateral CVA
    bcva, cva_leg, dva_leg = texp.bilateral_cva(_t(epe), _t(ene), 1.0, R, 0.02, 0.0)
    assert float(dva_leg) == 0.0
    np.testing.assert_allclose(float(cva_leg), float(texp.cva_from_epe(_t(epe), 1.0, R, 0.02)),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError, match="A15"):
        texp.distributed_percentiles(_t(epe), [5.0, 95.0], "paths")


def test_exposures_from_coeffs_matches_amcx(paths):
    # the same coefficient rows and frame in both: profiles to f32 noise
    # (amcx evaluates the fit by a matrix-vector product, the port by
    # elementwise sums)
    market = at.MarketParams(S0, R, SIGMA)
    mean_t, inv_std_t = at.gbm_standardization(market, 1.0, N_STEPS, device="cpu")
    res = tmega.lsmc_price_megakernel(_t(paths), 100.0, R, DT, -1.0, itm_weights=False,
                                      mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True)
    got = texp.exposures_from_coeffs(_t(paths), res.coeffs, mean_t, inv_std_t)
    want = jexp.exposures_from_coeffs(jnp.asarray(paths), jnp.asarray(res.coeffs.numpy()),
                                      jnp.asarray(mean_t.numpy()),
                                      jnp.asarray(inv_std_t.numpy()))
    for f in ("epe", "pfe5", "pfe95"):
        np.testing.assert_allclose(getattr(got, f).numpy(), _np(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert float(got.epe[-1]) == 0.0 and got.epe.shape == (N_STEPS + 1,)


def test_surface_stats_matches_amcx(paths):
    # a European put (no exercise feedback): the port's streaming profile
    # against amcx's (f32 fits of the same moments: rtol 1e-4) and against
    # compute_ccr_exposures of its own dense surface (the same values)
    prod_kw = dict(K=100.0, T=1.0, option_type="put", exercise="european")
    want = jengine.lsmc_option_pricing(jnp.asarray(paths), amcx.ProductSpec(**prod_kw), R,
                                       JSPEC, return_surface=False, surface_stats=True).exposures
    res = at.lsmc_option_pricing(_t(paths), at.ProductSpec(**prod_kw), R, TSPEC,
                                 return_surface=True, surface_stats=True)
    own = texp.compute_ccr_exposures(res.continuation)
    for f in ("epe", "pfe5", "pfe95"):
        got = getattr(res.exposures, f).numpy()
        np.testing.assert_allclose(got, _np(getattr(want, f)), rtol=1e-4, atol=1e-5, err_msg=f)
        np.testing.assert_allclose(got, getattr(own, f).numpy(), rtol=1e-6, err_msg=f)
    assert float(res.exposures.pfe95[-1]) == 0.0
    assert at.lsmc_option_pricing(_t(paths), at.ProductSpec(**prod_kw), R, TSPEC,
                                  return_surface=False).exposures is None


def test_book_ccr_exposures_matches_amcx(paths):
    # a European long/short pair (no exercise feedback): the netted profile
    # and ENE against amcx's (rtol 1e-4 on f32 fits); netting lowers EPE
    strikes, weights = [95.0, 105.0], [1.0, -1.0]
    jccr, jene, jprices = jbook.book_ccr_exposures(jnp.asarray(paths), jnp.asarray(strikes),
                                                   jnp.asarray(weights), R, 1.0, "put", False,
                                                   JSPEC, return_ene=True)
    tccr, tene, tprices = tbook.book_ccr_exposures(_t(paths), strikes, weights, R, 1.0, "put",
                                                   False, TSPEC, return_ene=True)
    for f in ("epe", "pfe5", "pfe95"):
        np.testing.assert_allclose(getattr(tccr, f).numpy(), _np(getattr(jccr, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(tene.numpy(), _np(jene), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tprices.numpy(), _np(jprices), atol=PRICE_TOL)
    gross, _ = tbook.book_ccr_exposures(_t(paths), strikes, [1.0, 1.0], R, 1.0, "put", False,
                                        TSPEC)
    assert (tccr.epe[1:-1] <= gross.epe[1:-1] + 1e-6).all()
    short, _ = tbook.book_ccr_exposures(_t(paths), [100.0], [-1.0], R, 1.0, "put", True, TSPEC)
    np.testing.assert_allclose(short.epe[:-1].numpy(), 0.0, atol=1e-6)


def test_book_rejects_what_it_does_not_take(paths):
    P = _t(paths)
    itm = at.RegressionSpec(degree=4, regress_on="itm")
    with pytest.raises(ValueError, match="itm_weights"):
        tbook.price_strike_grid(P, [100.0], R, 1.0, spec=itm, engine="mega")
    with pytest.raises(ValueError, match="itm_weights"):
        tbook.price_mixed_book(P, [100.0], [8], R, 1.0, spec=itm, engine="mega")
    with pytest.raises(ValueError, match="maturity_steps"):
        tbook.price_mixed_book(P, [100.0, 90.0], [16], R, 1.0)
    with pytest.raises(ValueError, match="1[.][.]16"):
        tbook.price_mixed_book(P, [100.0], [17], R, 1.0, engine="mega")
    with pytest.raises(ValueError, match="engine"):
        tbook.price_strike_grid(P, [100.0], R, 1.0, engine="tpu")
    with pytest.raises(ValueError, match="frame"):
        tbook.price_strike_grid(P, [100.0], R, 1.0, mean_t=P[:, 0], inv_std_t=P[:, 0])
    with pytest.raises(ValueError, match="put|call"):
        tbook.price_strike_grid(P, [100.0], R, 1.0, option_type="straddle")
    with pytest.raises(NotImplementedError, match="A15"):
        tmega.lsmc_book_megakernel(P, [100.0], R, DT, -1.0, axis_name="paths")
    with pytest.raises(ValueError, match="1[.][.]64"):
        tmega.lsmc_book_megakernel(P, np.linspace(80.0, 120.0, 65), R, DT, -1.0)
    with pytest.raises(ValueError, match="even"):
        tmega.lsmc_book_megakernel(P[:, :-1], [100.0], R, DT, -1.0, antithetic=True)


def test_book_grid_sizing():
    # kernel 3's persistent grid: two blocks a SM, fewer for few paths; the
    # one-block solve sums one partial row per block
    assert tmega.book_blocks(1 << 20, 132) == 264
    assert tmega.book_blocks(1_001, 132) == 4
    assert tmega.book_blocks(1, 132) == 1

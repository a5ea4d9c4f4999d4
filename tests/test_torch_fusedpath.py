"""The zero-path-memory route: `amcx_torch.ops.lsmc_fusedpath` (kernel 6's
plain version), ``price_option(engine="fusedpath")`` and
`amcx_torch.policy`, against the JAX package on the CPU.

amcx's fusedpath kernel runs here in Pallas interpret mode, whose PRNG stub
gives zero bits: u = 1, so r = 0 and ξ ≡ 0, every path is the deterministic
forward curve. The port's plain version takes ``normals=`` returning zeros
for those comparisons. With the Philox stream, the port's regenerated paths
(`fusedpath_paths_reference`) are priced by amcx's mega kernel (interpret
mode) and by the port's plain fusedpath, and held to the first-flipped-step
rules of `_lsmc_parity` (amcx sums its moments in f32).
"""

import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import policy as jpolicy
from amcx.ops import lsmc_fusedpath as jfp
from amcx.ops import lsmc_megakernel as jmega
from amcx_torch import policy as tpolicy
from amcx_torch.ops import lsmc_fusedpath as tfp
from _lsmc_parity import first_divergence_tau, hold_pair

N_PATHS = 8192
# the zero-noise market of tests/test_fusedpath.py, on 20 steps of dt = 0.05:
# S_t = 100·e^{-0.045·t·dt} first falls to 97 or below at step 14
ZERO_ARGS = (0, 100.0, 100.0, 0.0, 0.3, 0.05, 20, N_PATHS, -1.0)
# the flagship market on 20 steps
S0, K, R, SIGMA, N_STEPS = 100.0, 100.0, 0.01, 0.2, 20
DT = 1.0 / N_STEPS
PRICE_TOL = 2e-4


def _zeros(t):
    return torch.zeros(N_PATHS)


def _np(x):
    return np.asarray(x)


def _values(out, r, dt):
    return (_np(out.cashflows).astype(np.float64)
            * np.exp(-r * dt * _np(out.exercise_times).astype(np.float64)))


ZERO_CASES = {"vanilla": {}, "down-out-97": dict(barrier=97.0, barrier_type="down-out")}


@pytest.fixture(scope="module")
def zero_noise():
    """amcx's interpret-mode fusedpath (ξ ≡ 0) and the port's plain version
    fed zeros, per case, with cf/τ and coefficients."""
    kw = dict(return_cf_tau=True, return_coeffs=True)
    return {case: (jfp.lsmc_price_fusedpath(*ZERO_ARGS, **kw, **extra),
                   tfp.lsmc_price_fusedpath_reference(*ZERO_ARGS, **kw, **extra, device="cpu",
                                                      normals=_zeros))
            for case, extra in ZERO_CASES.items()}


@pytest.mark.parametrize("case", sorted(ZERO_CASES))
def test_zero_noise_plain_matches_amcx_interpret(zero_noise, case):
    # one path repeated 8192 times: prices within 1e-5 relative (amcx's f32
    # sums against f64), identical cf/τ planes. The Gram is rank one, so the
    # coefficients are set by the ridge and by rounding (amcx's f32 factor
    # gives NaN rows on some steps): hold the fitted continuation on the
    # curve itself, where amcx's is finite, to 1e-4 relative
    j, t = zero_noise[case]
    np.testing.assert_allclose(float(t.price), float(j.price), rtol=1e-5)
    np.testing.assert_array_equal(t.cashflows.numpy(), _np(j.cashflows))
    np.testing.assert_array_equal(t.exercise_times.numpy(), _np(j.exercise_times))
    assert t.coeffs.shape == (21, 5) and bool(torch.isfinite(t.coeffs).all())
    assert not t.coeffs[20].any()
    # W ≡ 0: the spot of step t is 100·e^{drift_dt·t}
    drift_dt = torch.tensor((0.0 - 0.5 * 0.3 ** 2) * 0.05, dtype=torch.float32)
    curve = 100.0 * torch.exp(drift_dt * torch.arange(21, dtype=torch.float32))
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(100.0, 0.0, 0.3), 1.0, 20,
                                               device="cpu")
    cols = at.design_matrix((curve - mean_t) * inv_std_t, "chebyshev", 4).double().numpy()
    fit_j = (cols * _np(j.coeffs).astype(np.float64)).sum(axis=1)
    fit_t = (cols * t.coeffs.double().numpy()).sum(axis=1)
    finite = np.isfinite(fit_j)
    assert finite.sum() >= 15
    np.testing.assert_allclose(fit_t[finite], fit_j[finite], rtol=1e-4, atol=1e-6)


def test_zero_noise_gate_identities():
    # tests/test_fusedpath.py's identities on the port alone (50 steps of
    # dt = 0.02, r = 0, σ = 0.3): every path is the curve
    # S_t = 100·e^{-0.045·t·dt}
    args = (0, 100.0, 100.0, 0.0, 0.3, 0.02, 50, N_PATHS, -1.0)

    def price(**kw):
        return float(tfp.lsmc_price_fusedpath_reference(*args, device="cpu", normals=_zeros,
                                                        **kw))

    van = price()
    assert van > 4.0  # the put is in the money at T on the falling curve
    # never-touched barriers: the gate is open for -out, shut for -in
    assert price(barrier=1e-6, barrier_type="down-out") == van
    assert price(barrier=1e-6, barrier_type="down-in") == 0.0
    assert price(barrier=101.0, barrier_type="up-out") == van
    assert price(barrier=101.0, barrier_type="up-in") == 0.0
    # knocked at t = 0 by S0 itself
    assert price(barrier=150.0, barrier_type="down-in") == van
    assert price(barrier=150.0, barrier_type="down-out") == 0.0
    assert price(barrier=100.0, barrier_type="up-in") == van
    # crossed at step 34: the down-out exercises at step 33, just above it
    out = tfp.lsmc_price_fusedpath_reference(*args, barrier=97.0, barrier_type="down-out",
                                             return_cf_tau=True, device="cpu",
                                             normals=_zeros)
    assert bool((out.exercise_times == 33.0).all())
    np.testing.assert_allclose(float(out.price), 100.0 - 100.0 * np.exp(-0.045 * 33 * 0.02),
                               atol=1e-3)
    assert price(barrier=97.0, barrier_type="down-in") == van


# amcx's mega kernel on the port's regenerated Philox paths: (keywords of
# both, antithetic)
SHARED_CASES = {
    "itm": (dict(itm_weights=True), False),
    "all-paths": (dict(itm_weights=False), False),
    "itm-antithetic": (dict(itm_weights=True), True),
    "down-in-97": (dict(itm_weights=True, barrier=97.0), False),
}


def _rows(coeffs):
    """Coefficient rows with the t = 0 row replaced by its fitted value: at
    t = 0 every path sits at S0 (x̂ = 0), the Gram is rank one and only
    the fit at x̂ = 0 is determined."""
    rows = np.array(coeffs, dtype=np.float64)
    at_zero = at.design_matrix(torch.zeros(1), "chebyshev", 4).double().numpy()[0]
    rows[0] = np.eye(rows.shape[1])[0] * float(at_zero @ rows[0])
    return rows


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_shared_paths_plain_matches_amcx_mega(case):
    kw, anti = SHARED_CASES[case]
    seed = 41
    out = tfp.fusedpath_paths_reference(seed, S0, R, SIGMA, DT, N_STEPS, N_PATHS,
                                        antithetic=anti, barrier=kw.get("barrier"))
    paths = out if kw.get("barrier") is None else out[0]
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, N_STEPS,
                                               device="cpu")
    j = jmega.lsmc_price_megakernel(paths.numpy(), K, R, DT, -1.0, mean_t=mean_t.numpy(),
                                    inv_std_t=inv_std_t.numpy(), antithetic=anti,
                                    return_cf_tau=True, return_coeffs=True, **kw)
    t = tfp.lsmc_price_fusedpath_reference(seed, S0, K, R, SIGMA, DT, N_STEPS, N_PATHS, -1.0,
                                           antithetic=anti, return_cf_tau=True,
                                           return_coeffs=True, device="cpu", **kw)
    assert int((t.exercise_times < N_STEPS).sum()) > N_PATHS // 10
    hold_pair(case, j.price, t.price, j.stderr, t.stderr, _rows(j.coeffs), _rows(t.coeffs),
              first_divergence_tau(_np(j.exercise_times), t.exercise_times.numpy()),
              _values(j, R, DT), _values(t, R, DT), PRICE_TOL)


def test_regenerated_bridge_law():
    # W_t from the regenerated spots: Var(W_t) = t·dt, Cov(W_2, W_6) = 2·dt
    # (200k paths: rtol 2e-2 and 5e-2 are > 5 standard errors)
    n, steps, dt = 200_000, 8, 0.125
    paths = tfp.fusedpath_paths_reference(3, 100.0, 0.0, 0.2, dt, steps, n).double()
    drift_dt = (0.0 - 0.5 * 0.2 ** 2) * dt
    t = torch.arange(steps + 1, dtype=torch.float64)[:, None]
    W = (torch.log(paths / 100.0) - drift_dt * t) / 0.2
    assert bool((paths[0] == 100.0).all())
    for s in (1, 4, 8):
        np.testing.assert_allclose(float(W[s].var()), s * dt, rtol=2e-2)
    np.testing.assert_allclose(float(torch.mean(W[2] * W[6])), 2 * dt, rtol=5e-2)
    # antithetic: the mirrored half draws the exact negation, and its spots
    # are the mirror S0²·e^{2·drift·t}/S up to f32 rounding
    z = tfp.fusedpath_normals(3, 5, 1024, antithetic=True)
    assert torch.equal(z[512:], -z[:512]) and torch.equal(z[:512], tfp.fusedpath_normals(3, 5, 512))
    anti = tfp.fusedpath_paths_reference(3, 100.0, 0.0, 0.2, dt, steps, 1024,
                                         antithetic=True).double()
    mirror = 100.0 ** 2 * torch.exp(2 * drift_dt * t) / anti[:, :512]
    torch.testing.assert_close(anti[:, 512:], mirror, rtol=2e-6, atol=0)


@pytest.mark.parametrize("kw", [{}, dict(barrier=97.0, barrier_type="down-out")],
                         ids=["vanilla", "down-out-97"])
def test_replay_own_policy_and_cf_tau_identity(kw):
    args = (5, S0, K, R, SIGMA, DT, N_STEPS, N_PATHS, -1.0)
    fit = tfp.lsmc_price_fusedpath_reference(*args, itm_weights=True, return_cf_tau=True,
                                             return_coeffs=True, device="cpu", **kw)
    # the planes reprice the price (Q5 discounting): f64 against f64 sums of
    # the same f32 values, rtol 1e-6
    np.testing.assert_allclose(float(_values(fit, R, DT).mean()), float(fit.price), rtol=1e-6)
    assert bool((fit.cashflows >= 0).all()) and int((fit.exercise_times < N_STEPS).sum()) > 0
    # the fit's own seed and coefficients: the same decisions, the same price
    for coeffs in (fit.coeffs, fit.coeffs[:N_STEPS]):
        replay = tfp.lsmc_price_fusedpath_reference(*args, replay_coeffs=coeffs,
                                                    return_cf_tau=True, device="cpu", **kw)
        np.testing.assert_allclose(float(replay.price), float(fit.price), rtol=1e-6)
        assert torch.equal(replay.exercise_times, fit.exercise_times)


def test_reprice_with_coeffs_matches_amcx():
    # amcx's forward walk and the port's on the same numpy paths, frame and
    # coefficients (no regression): equal τ planes, price within 1e-6
    paths = tfp.fusedpath_paths_reference(6, S0, R, SIGMA, DT, N_STEPS, N_PATHS)
    fit = tfp.lsmc_price_fusedpath_reference(7, S0, K, R, SIGMA, DT, N_STEPS, N_PATHS, -1.0,
                                             itm_weights=True, return_coeffs=True,
                                             device="cpu")
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, N_STEPS,
                                               device="cpu")
    sched = tuple(range(0, N_STEPS, 3))
    spec_j, spec_t = amcx.RegressionSpec(degree=4), at.RegressionSpec(degree=4)
    for barrier, steps in ((None, None), (95.0, sched)):
        jprod = amcx.ProductSpec(K=K, T=1.0, barrier=barrier, option_type="put",
                                 exercise="american", barrier_type="down-out")
        tprod = at.ProductSpec(K=K, T=1.0, barrier=barrier, option_type="put",
                               exercise="american", barrier_type="down-out")
        j = jpolicy.reprice_with_coeffs(paths.numpy(), fit.coeffs.numpy(), jprod, R,
                                        mean_t.numpy(), inv_std_t.numpy(), spec_j,
                                        exercise_steps=steps)
        t = tpolicy.reprice_with_coeffs(paths, fit.coeffs, tprod, R, mean_t, inv_std_t, spec_t,
                                        exercise_steps=steps)
        np.testing.assert_array_equal(t.exercise_times.numpy(), _np(j.exercise_times))
        np.testing.assert_array_equal(t.cashflows.numpy(), _np(j.cashflows))
        np.testing.assert_allclose(float(t.price), float(j.price), rtol=1e-6)
        np.testing.assert_allclose(float(t.stderr), float(j.stderr), rtol=1e-5)


def test_price_out_of_sample_on_cpu():
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="philox")
    spec = at.RegressionSpec(degree=4)
    replay_kw = dict(degree=4, return_stats=True, device="cpu")
    for engine in ("mega", "fusedpath"):
        oos = at.price_out_of_sample(9, market, prod, spec, sim, engine=engine,
                                     replay_engine="fusedpath", replay_blocks=2, device="cpu")
        # the fit draws on the seed itself
        fit = at.price_option(9, market, prod, spec, sim, engine=engine, return_coeffs=True,
                              device="cpu")
        assert torch.equal(oos.fit.price, fit.price) and torch.equal(oos.fit.coeffs, fit.coeffs)
        # block b replays on seed + 1 + b: two blocks are the mean of the two
        # single-block replays (f32 mean of two prices)
        blocks = [tfp.lsmc_price_fusedpath(9 + 1 + b, S0, K, R, SIGMA, DT, N_STEPS, N_PATHS,
                                           -1.0, replay_coeffs=fit.coeffs, **replay_kw)
                  for b in range(2)]
        np.testing.assert_allclose(float(oos.oos.price),
                                   0.5 * (float(blocks[0][0]) + float(blocks[1][0])), rtol=1e-6)
        np.testing.assert_allclose(float(oos.oos.stderr),
                                   np.hypot(float(blocks[0][1]), float(blocks[1][1])) / 2,
                                   rtol=1e-5)
        # seeds disjoint from the fit's: the replay prices other paths
        assert float(oos.oos.price) != float(fit.price)
        # the torch walk on seed + 1's paths (routed "xla" fits go to mega)
        walk = at.price_out_of_sample(9, market, prod, spec, sim, engine=engine, device="cpu")
        paths = at.simulate_gbm(10, market, 1.0, sim, device="cpu")
        mean_t, inv_std_t = at.gbm_standardization(market, 1.0, N_STEPS, device="cpu")
        ref = at.reprice_with_coeffs(paths, fit.coeffs, prod, R, mean_t, inv_std_t, spec)
        assert torch.equal(walk.oos.price, ref.price)
        assert float(walk.oos.price) < float(walk.fit.price) + 4 * float(walk.fit.stderr)
    xla = at.price_out_of_sample(9, market, prod, spec, sim, engine="xla", device="cpu")
    assert torch.equal(xla.fit.price, at.price_option(9, market, prod, spec, sim, engine="mega",
                                                      device="cpu").price)


def test_price_option_fusedpath_route():
    # price_option(engine="fusedpath") is the kernel's wrapper with amcx's
    # arguments: the integer seed, the ITM fit ("auto"), cf/τ, coefficients
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS)
    res = at.price_option(3, market, prod, at.RegressionSpec(), sim, engine="fusedpath",
                          return_cf_tau=True, return_coeffs=True, device="cpu")
    ref = tfp.lsmc_price_fusedpath(3, S0, K, R, SIGMA, DT, N_STEPS, N_PATHS, -1.0,
                                   itm_weights=True, return_cf_tau=True, return_coeffs=True,
                                   device="cpu")
    for a, b in zip((res.price, res.stderr, res.cashflows, res.exercise_times, res.coeffs), ref):
        assert torch.equal(a, b)
    crr = at.crr_price(S0, K, 1.0, R, SIGMA, 2000, option_type="put", american=True)
    assert abs(float(res.price) - crr) <= 4 * float(res.stderr) + 0.05  # 20-date grid
    g = at.fast_greeks(res, market, prod, N_STEPS)
    assert all(np.isfinite(float(v)) for v in g.values())


# the fusedpath's frame and discount rows come from the one cached builder
# (`closed_form_rows`) on its own key (T = dt·n_steps): the rows of the
# explicit frame, bit for bit, and the prices of kernel 2's plain version
# on the regenerated paths in that frame
@pytest.mark.parametrize("q", [0.0, 0.03])
def test_fusedpath_reads_the_cached_closed_form_rows(q):
    from amcx_torch.ops import lsmc_megakernel as tmega

    n_paths = 2048
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA, q), DT * N_STEPS,
                                               N_STEPS, device="cpu")
    rows = tmega.closed_form_rows(S0, R, SIGMA, q, DT * N_STEPS, DT, N_STEPS,
                                  torch.device("cpu"))
    assert torch.equal(rows, tmega.mega_stats(mean_t, inv_std_t, R, DT, N_STEPS, "cpu"))
    hits = tmega.closed_form_rows.cache_info().hits
    args = (3, S0, K, R, SIGMA, DT, N_STEPS, n_paths, -1.0)
    got = [tfp.lsmc_price_fusedpath(*args, q=q, itm_weights=True, return_stats=True,
                                    device="cpu") for _ in range(2)]
    assert tmega.closed_form_rows.cache_info().hits == hits + 2
    paths = tfp.fusedpath_paths_reference(3, S0, R, SIGMA, DT, N_STEPS, n_paths, q=q)
    want = tmega.lsmc_price_mega_reference(paths, K, R, DT, -1.0, itm_weights=True,
                                           mean_t=mean_t, inv_std_t=inv_std_t,
                                           return_stats=True)
    for price, stderr in got:
        assert torch.equal(price, want[0]) and torch.equal(stderr, want[1])


def test_fusedpath_rejects_what_it_does_not_take():
    args = (0, S0, K, R, SIGMA, DT, N_STEPS, 64, -1.0)
    with pytest.raises(ValueError, match="barrier_type"):
        tfp.lsmc_price_fusedpath(*args, barrier=80.0, barrier_type="sideways", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tfp.lsmc_price_fusedpath(0, S0, K, R, torch.full((N_STEPS,), SIGMA), DT, N_STEPS, 64,
                                 -1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        tfp.lsmc_price_fusedpath(*args, axis_name="paths", axis_size=2, device="cpu")
    with pytest.raises(ValueError, match="replay_coeffs"):
        tfp.lsmc_price_fusedpath(*args, replay_coeffs=torch.zeros((N_STEPS, 3)), device="cpu")
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=64, n_steps=N_STEPS)
    with pytest.raises(ValueError, match="no dense surface"):
        at.price_option(0, market, prod, sim=sim, engine="fusedpath", return_surface=True,
                        device="cpu")
    with pytest.raises(TypeError, match="integer seed"):
        at.price_option(torch.Generator(), market, prod, sim=sim, engine="fusedpath",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="B2 options / A8"):
        at.price_out_of_sample(0, market, prod, sim=sim, replay_engine="mega", device="cpu")
    with pytest.raises(ValueError, match="replay_blocks"):
        at.price_out_of_sample(0, market, prod, sim=sim, replay_blocks=2, device="cpu")
    barrier = at.ProductSpec(K=K, T=1.0, barrier=80.0, option_type="put", exercise="american")
    with pytest.raises(ValueError, match="barriers"):
        at.price_out_of_sample(0, market, barrier, sim=sim, engine="fusedpath",
                               replay_engine="fusedpath", device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        tpolicy.valuation_interval(0, market, prod)


# kernel 6's cooperative grid (`_fusedpath_plan`) against an H100-shaped
# occupancy: 132 SMs, 228 KB of shared memory an SM with 1 KB reserved a
# block, 227 KB a block at most, 6 KB of static shared memory, and
# registers for 2 blocks of 256 threads an SM
N_SMS = 132


def _occupancy(smem):
    static = 6 * 1024
    if smem + static > 232_448:
        return 0
    return min(2, 233_472 // (smem + static + 1024))


PLAN_CASES = {  # (n_paths, antithetic, barrier): (n_blocks, chip_slots, needed)
    "flagship-1M": ((1 << 20, False, False), (264, 4, 4)),
    "antithetic-1M": ((1 << 20, True, False), (264, 4, 4)),
    "barrier-1M": ((1 << 20, False, True), (264, 4, 4)),
    "uneven-1000004": ((1_000_004, False, False), (264, 4, 4)),
    "small-131072": ((131_072, False, False), (129, 1, 1)),
    "one-quad": ((4, False, False), (2, 1, 1)),
    "one-pair": ((8, True, True), (2, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_fusedpath_plan_keeps_every_quad_on_chip(case):
    (n_paths, antithetic, barrier), want = PLAN_CASES[case]
    n_blocks, chip, needed = tfp._fusedpath_plan(n_paths, antithetic, barrier, N_SMS,
                                                 _occupancy)
    assert (n_blocks, chip, needed) == want
    qpu = 2 if antithetic else 1
    # every unit has a slot on a worker block (block 0 solves), and the grid
    # is co-resident with its shared memory
    assert (n_blocks - 1) * 256 * (needed // qpu) >= n_paths // (4 * qpu)
    assert _occupancy(chip * 256 * 16 * (5 if barrier else 4)) * N_SMS >= n_blocks


@pytest.mark.parametrize("antithetic, barrier", [(False, False), (True, True)])
def test_fusedpath_plan_spills_past_shared_memory(antithetic, barrier):
    # 16M paths need more slots than shared memory holds: the widest grid
    # keeps as many as still fit two blocks an SM, the rest go to the
    # global planes
    slot = 256 * 16 * (5 if barrier else 4)
    n_blocks, chip, needed = tfp._fusedpath_plan(1 << 24, antithetic, barrier, N_SMS,
                                                 _occupancy)
    assert n_blocks == 264 and 0 < chip < needed and chip % (2 if antithetic else 1) == 0
    assert _occupancy(chip * slot) == 2 and _occupancy((chip + 2) * slot) < 2
    assert (n_blocks - 1) * 256 * needed * 4 >= 1 << 24


def test_fusedpath_plan_raises_when_no_block_fits():
    with pytest.raises(RuntimeError, match="fits no two co-resident blocks"):
        tfp._fusedpath_plan(1 << 20, False, False, N_SMS, lambda smem: 0)

"""The port's multi-asset slice (`amcx_torch.basis` cross terms,
`amcx_torch.paths.simulate_gbm_multi`, `amcx_torch.models.maxcall`,
`amcx_torch.ops.maxcall_pallas`, `amcx_torch.ops.lsmc_ma_mega`) against the
JAX package on shared paths.

Paths come from amcx's `simulate_gbm_multi` (JAX on the CPU) and reach the
port as numpy arrays; amcx's kernels run in Pallas interpret mode, as its
own tests run them. The port's kernel wrappers run their plain versions on
CPU tensors. Early exercise makes f32 LSMC chaotic, so an engine pair with
exercise flips is held to the first-flipped-step rules of `_lsmc_parity`.
The configuration is the Andersen-Broadie max-call: S0 = K = 100,
r = 5%, q = 10%, sigma = 20%, T = 3, 9 exercise dates, cut to 8,192 paths.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import basis as jbasis
from amcx import engine as jengine
from amcx.models import maxcall as jmaxcall
from amcx.ops import lsmc_ma_mega as jmamega
from amcx.ops import maxcall_pallas as jma
from amcx_torch import basis as tbasis
from amcx_torch.models import maxcall as tmaxcall
from amcx_torch.ops import gbm_multi as tgm
from amcx_torch.ops import lsmc_ma_mega as tmamega
from amcx_torch.ops import maxcall_pallas as tma
from amcx_torch.ops.lsmc_pallas import unpack_moments
import _ma_crafted as crafted
from _lsmc_parity import first_divergence, hold_pair

K, T, R, SIGMA, Q = 100.0, 3.0, 0.05, 0.2, 0.10
N_PATHS, N_STEPS = 8192, 9
DT = T / N_STEPS
RDT = float(np.float32(np.float32(R) * np.float32(DT)))
FAMILIES = ["power", "chebyshev", "legendre", "laguerre", "hermite"]
JSPEC = amcx.RegressionSpec(basis="chebyshev", degree=2)
TSPEC = at.RegressionSpec(basis="chebyshev", degree=2)


def _jax_paths(n_assets, seed=0, antithetic=False, n_paths=N_PATHS):
    sim = amcx.SimConfig(n_paths=n_paths, n_steps=N_STEPS, antithetic=antithetic)
    return np.asarray(amcx.simulate_gbm_multi(jax.random.key(seed), jnp.full((n_assets,), 100.0),
                                              R, SIGMA, T, sim, q=Q))


@pytest.fixture(scope="module")
def paths2():
    return _jax_paths(2)


@pytest.fixture(scope="module")
def paths5():
    return _jax_paths(5)


def _t(a):
    return at.tensor_from_numpy(a, device="cpu")


def _values(cf, tau):
    return np.asarray(cf, np.float64) * np.exp(-R * DT * np.asarray(tau, np.float64))


def _hold_carry_pair(what, jres, tres, price_tol, se_rtol):
    """An amcx/port pair of kernel-engine runs with cf/τ carries: decisions
    read from τ (exercised at t ⟺ τ = t); no per-step rows are exported."""
    tau_j, tau_t = np.asarray(jres[3]), tres[3].numpy()
    steps = np.arange(N_STEPS)[:, None]
    first = first_divergence(tau_j[None] == steps, tau_t[None] == steps)
    empty = np.zeros((N_STEPS, 1))
    hold_pair(what, jres[0], tres[0], jres[1], tres[1], empty, empty, first,
              _values(jres[2], tau_j), _values(tres[2], tau_t), price_tol)
    np.testing.assert_allclose(float(tres[1]), float(jres[1]), rtol=se_rtol)


# ---------------------------------------------------------------------------
# basis, payoffs, paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["total", "separable"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("n_assets", [2, 3, 5])
def test_multi_asset_basis_matches_amcx(n_assets, degree, mode):
    # index sets exact (the kernels read their column order from this
    # table); columns rtol 1e-6: the same recurrences and products in the
    # same f32 order
    idx = tbasis._multi_index_set(n_assets, degree, mode)
    assert idx == jbasis._multi_index_set(n_assets, degree, mode)
    assert at.n_multi_terms(n_assets, degree, mode) == jbasis.n_multi_terms(n_assets, degree,
                                                                            mode) == len(idx)
    if len(idx) <= tma.MAX_COLS:
        p = tma.ma_params(n_assets, "chebyshev", degree, mode, True, "maxcall", K, 1.0)
        assert p.n_cols == len(idx)
        assert [tuple(p.alpha[c][:n_assets]) for c in range(len(idx))] == idx
    else:
        with pytest.raises(ValueError, match="columns"):
            tma.ma_params(n_assets, "chebyshev", degree, mode, True, "maxcall", K, 1.0)
    X = np.random.default_rng(n_assets * 10 + degree).uniform(-2.0, 2.0, (512, n_assets))
    X = X.astype(np.float32)
    for family in FAMILIES:
        ref = np.asarray(jbasis.multi_asset_design_matrix(jnp.asarray(X), family, degree, mode))
        got = at.multi_asset_design_matrix(_t(X), family, degree, mode).numpy()
        assert got.shape == ref.shape == (512, len(idx))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=family)


def _planes(n_assets, seed):
    return np.random.default_rng(seed).uniform(60.0, 140.0, (n_assets, 4096)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(tma.PAYOFF_KINDS))
def test_payoff_kinds_match_amcx(kind):
    # exact on random positive planes: the same f32 operations in amcx's
    # order. geobasket's log/exp are XLA's and torch's own f32 routines,
    # which differ by a few ulp of the basket level (~100, ulp 7.6e-6)
    # before the strike cancels it: atol 1e-4 there
    pl = _planes(3, 1)
    phi = -1.0 if kind in ("first", "spread") else 1.0
    weights = (0.5, 0.3, 0.2) if kind in ("basket", "geobasket") else None
    strike = 10.0 if kind == "spreadk" else K
    ref = np.asarray(jma._payoff_for([jnp.asarray(p) for p in pl], strike, kind, phi, weights))
    got = tma._payoff_for([_t(p) for p in pl], strike, kind, phi, weights).numpy()
    assert (ref > 0).sum() > 100
    if kind == "geobasket":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, ref)
    if kind == "maxcall":
        S = np.moveaxis(pl, 0, -1)
        np.testing.assert_array_equal(at.max_call_payoff(_t(S), K).numpy(),
                                      np.asarray(amcx.max_call_payoff(jnp.asarray(S), K)))


def test_simulate_gbm_multi_statistics(paths5):
    # the torch RNG differs from amcx's: gates are statistical. E[S_T] per
    # asset within 4 stderr of S0 e^{(r-q)T} and of amcx's mean; the
    # correlation of the pooled log-increments (73,728 pairs, stderr ~0.003)
    # within 0.02 of corr = 0.5
    sim = at.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS)
    corr = np.array([[1.0, 0.5], [0.5, 1.0]])
    S = at.simulate_gbm_multi(3, [100.0, 100.0], R, SIGMA, T, sim, q=Q, corr=corr,
                              device="cpu").double()
    assert S.shape == (N_STEPS + 1, N_PATHS, 2) and bool(torch.all(S[0] == 100.0))
    ST = S[-1]
    want = 100.0 * np.exp((R - Q) * T)
    for a in range(2):
        se = float(ST[:, a].std()) / np.sqrt(N_PATHS)
        assert abs(float(ST[:, a].mean()) - want) < 4 * se
        js = paths5[-1, :, a].astype(np.float64)
        assert abs(float(ST[:, a].mean()) - js.mean()) < 4 * np.sqrt(se ** 2 + js.var() / N_PATHS)
    inc = torch.log(S[1:] / S[:-1]).reshape(-1, 2)
    assert abs(float(torch.corrcoef(inc.T)[0, 1]) - 0.5) < 0.02
    # independent assets by default
    S5 = at.simulate_gbm_multi(4, [100.0] * 5, R, SIGMA, T, sim, q=Q, device="cpu").double()
    inc5 = torch.log(S5[1:] / S5[:-1]).reshape(-1, 5)
    off = torch.corrcoef(inc5.T) - torch.eye(5, dtype=torch.float64)
    assert float(off.abs().max()) < 0.02


def test_simulate_gbm_multi_antithetic_and_autograd():
    # antithetic: path i + n/2 mirrors path i, so their log-increments
    # around the drift are negated (atol 2e-6: f32 log of f32 paths);
    # autograd in S0 against a central difference of the European max-call
    # value under the same seed (rtol 1e-3: the f32 rounding of the bumped
    # paths and the few paths whose max or strike crossing moves inside
    # the bump)
    sim = at.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, antithetic=True)
    S = at.simulate_gbm_multi(5, [100.0, 100.0], R, SIGMA, T, sim, q=Q, device="cpu")
    la = torch.log(S[1:] / S[:-1]).double()
    drift = (R - Q - 0.5 * SIGMA ** 2) * DT
    h = N_PATHS // 2
    np.testing.assert_allclose((la[:, :h] - drift).numpy(), -(la[:, h:] - drift).numpy(),
                               atol=2e-6)
    sim = at.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS)
    S0 = torch.tensor([100.0, 100.0], requires_grad=True)

    def euro(s0):
        S_T = at.simulate_gbm_multi(6, s0, R, SIGMA, T, sim, q=Q, device="cpu")[-1]
        return np.exp(-R * T) * torch.mean(at.max_call_payoff(S_T, K).double())

    (grad,) = torch.autograd.grad(euro(S0), S0)
    bump = 1e-2
    for a in range(2):
        e = torch.zeros(2)
        e[a] = bump
        fd = (float(euro(S0.detach() + e)) - float(euro(S0.detach() - e))) / (2 * bump)
        assert abs(float(grad[a]) - fd) <= 1e-3 * abs(fd), (a, float(grad[a]), fd)


def _chain_before_the_kernel(seed, S0, r, sigma, T, sim, q=None, corr=None):
    """`simulate_gbm_multi` on the CPU as the port ran it before the paths
    had a kernel, line for line: the bits the plain chain must keep."""
    device = torch.device("cpu")
    dtype = sim.torch_dtype
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=dtype, device=device))
    n_assets = S0.shape[0]
    n_steps, n_paths = sim.n_steps, sim.n_paths

    def vec(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device), (n_assets,))

    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    if sim.antithetic:
        half = torch.randn((n_steps, n_paths // 2, n_assets), generator=generator, dtype=dtype,
                           device=device)
        Z = torch.cat([half, -half], dim=1)
    else:
        Z = torch.randn((n_steps, n_paths, n_assets), generator=generator, dtype=dtype,
                        device=device)
    W = Z
    if corr is not None:
        L = torch.linalg.cholesky(torch.as_tensor(corr, dtype=dtype, device=device))
        cols = []
        for b in range(n_assets):
            w_b = Z[..., 0] * L[b, 0]
            for a in range(1, b + 1):
                w_b = w_b + Z[..., a] * L[b, a]
            cols.append(w_b)
        W = torch.stack(cols, dim=-1)
    r, sigma, q = vec(r), vec(sigma), vec(0.0 if q is None else q)
    dt = torch.as_tensor(T, dtype=dtype, device=device) / n_steps
    drift = (r - q - 0.5 * sigma ** 2) * dt
    log_inc = drift + (sigma * torch.sqrt(dt)) * W
    log_rel = torch.cat([torch.zeros((1, n_paths, n_assets), dtype=dtype, device=device),
                         torch.cumsum(log_inc, dim=0)], dim=0)
    return S0 * torch.exp(log_rel)


# (n_assets, corr, antithetic, S0 needs grad, the chain asked for)
CHAIN_CASES = {
    "5-identity": (5, None, False, False, False),
    "3-corr": (3, [[1.0, 0.5, 0.2], [0.5, 1.0, 0.3], [0.2, 0.3, 1.0]], False, False, False),
    "5-antithetic": (5, None, True, False, False),
    "2-corr-grad": (2, [[1.0, 0.5], [0.5, 1.0]], False, True, False),
    "2-corr-grad-asked": (2, [[1.0, 0.5], [0.5, 1.0]], False, True, True),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_simulate_gbm_multi_on_cpu_keeps_the_chain(case):
    # the CPU takes the plain chain, as does differentiable=True (what
    # max_call_greeks asks for): no launch, the bits of the chain before the
    # kernel, differentiable where an input needs grad
    n_assets, corr, antithetic, grad, asked = CHAIN_CASES[case]
    sim = at.SimConfig(n_paths=1_026, n_steps=N_STEPS, antithetic=antithetic)
    S0 = torch.linspace(90.0, 110.0, n_assets).requires_grad_(grad)
    before = tgm.gbm_multi_paths.launches
    got = at.simulate_gbm_multi(8, S0, R, SIGMA, T, sim, q=Q, corr=corr, device="cpu",
                                differentiable=asked)
    want = _chain_before_the_kernel(8, S0, R, SIGMA, T, sim, q=Q, corr=corr)
    assert tgm.gbm_multi_paths.launches == before
    assert torch.equal(got, want)
    assert (got.grad_fn is not None) == grad


# markets whose dt = T / n_steps is the same under the CPU's f32 division
# and the card's product with the f32 reciprocal (the next test covers a
# T where the two differ)
ROW_MARKETS = {
    "maxcall-5": ([100.0] * 5, 0.05, 0.2, 0.10, 3.0, 9),
    "per-asset": ([90.0, 100.0, 110.0], [0.01, 0.03, 0.05], [0.15, 0.25, 0.4], None, 1.0, 100),
    "cpu-tensors": (torch.tensor([95.0, 105.0]), torch.tensor(0.02), 0.3,
                    torch.tensor([0.0, 0.01]), torch.tensor(2.0), 8),
}


@pytest.mark.parametrize("case", sorted(ROW_MARKETS))
def test_gbm_multi_host_rows_equal_the_chains_rows(case):
    S0, r, sigma, q, T_, n_steps = ROW_MARKETS[case]
    rows = tgm.host_rows(S0, r, sigma, q, T_, n_steps)
    want = torch.stack(tgm._chain_rows(S0, r, sigma, q, T_, n_steps, torch.float32, "cpu"))
    assert rows.dtype == np.float32 and rows.flags.c_contiguous
    np.testing.assert_array_equal(rows.view(np.uint32), want.numpy().view(np.uint32))


def test_gbm_multi_host_rows_divide_as_the_card_does():
    # at T = 1.457604143493508 and 9 steps the CPU's f32 quotient and the
    # card's product T * f32(1/9) differ in the last place: the rows take
    # the card's dt (tests/test_torch_cuda.py holds them to the card's chain)
    T_, n = 1.457604143493508, 9
    dt_card = torch.tensor(T_) * (torch.tensor(1.0) / n)
    assert float(torch.tensor(T_) / n) != float(dt_card)
    rows = tgm.host_rows(100.0, R, SIGMA, Q, T_, n)
    want = torch.stack(tgm._chain_rows(100.0, R, SIGMA, Q, dt_card, 1, torch.float32, "cpu"))
    np.testing.assert_array_equal(rows.view(np.uint32), want.numpy().view(np.uint32))


def _meta(shape, **kw):
    return torch.empty(shape, device="meta", **kw)


# the kernel's wrapper on tensors off the CPU (meta tensors here): what
# the kernel cannot take raises, before any launch, with no fallback
REFUSED = {
    "non-contiguous": (lambda: _meta((N_STEPS, 5, 64)).transpose(1, 2), {}, "contiguous"),
    "float64": (lambda: _meta((N_STEPS, 64, 5), dtype=torch.float64), {}, "float32"),
    "9-assets": (lambda: _meta((N_STEPS, 64, 9)), {}, "1..8 assets"),
    "device-scalar": (lambda: _meta((N_STEPS, 64, 5)), {"sigma": _meta(())}, "host value"),
    "grad-scalar": (lambda: _meta((N_STEPS, 64, 5)),
                    {"S0": torch.full((5,), 100.0, requires_grad=True)}, "host value"),
    "not-cuda": (lambda: _meta((N_STEPS, 64, 5)), {}, "runs on 'cpu' or 'cuda'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_gbm_multi_paths_refuses_what_the_kernel_cannot_take(case):
    make, kw, match = REFUSED[case]
    Z = make()
    args = {**dict(S0=[100.0] * Z.shape[-1], r=R, sigma=SIGMA, q=Q, T=T), **kw}
    before = tgm.gbm_multi_paths.launches
    with pytest.raises(ValueError, match=match):
        tgm.gbm_multi_paths(Z, **args)
    assert tgm.gbm_multi_paths.launches == before


# ---------------------------------------------------------------------------
# the step kernels' plain versions against amcx's kernels (interpret mode)
# ---------------------------------------------------------------------------

def _one_step(paths, t, sorted_basis, kind, phi, strike):
    """Step t of a basket: the asset planes, a (cf, τ) carry with some paths
    exercised at later steps, and the step's standardization."""
    n_assets = paths.shape[-1]
    rng = np.random.default_rng(t)
    pl = [p for p in np.moveaxis(paths, -1, 0)]  # A x (T+1, n)
    pay = np.asarray(jma._payoff_for([jnp.asarray(p) for p in pl], strike, kind, phi))
    tau = np.full(N_PATHS, float(N_STEPS), np.float32)
    early = rng.random(N_PATHS) < 0.3
    tau[early] = rng.integers(t + 1, N_STEPS, early.sum())
    cf = pay[tau.astype(int), np.arange(N_PATHS)].astype(np.float32)
    mean, inv_std = (np.asarray(v) for v in jmaxcall.maxcall_standardization(
        jnp.asarray(paths), "sorted" if sorted_basis else "total"))
    planes = np.ascontiguousarray(np.moveaxis(paths[t], -1, 0))  # (A, n)
    return planes, cf, tau, mean[t], inv_std[t], n_assets


def _scalars(t, mean, inv_std, strike):
    return jnp.asarray(np.concatenate([[t, RDT, strike], mean, inv_std, [1.0]]), jnp.float32)


def _stats(t, mean, inv_std, allow=1.0):
    A = mean.shape[0]
    stats = np.zeros((2 * A + 3, N_STEPS + 1), np.float32)
    stats[:A, t], stats[A:2 * A, t], stats[-1, t] = mean, inv_std, allow
    return _t(stats)


def _rows(a):
    return jnp.asarray(a).reshape(-1, 512)


# (n_assets, basis_mode, itm_weights, payoff_kind, phi, weights, direct_y,
# strike): each value of each axis at least once; one 5-asset case (m = 21)
STEP_CASES = {
    "5-sorted-itm-maxcall": (5, "sorted", True, "maxcall", 1.0, None, False, K),
    "2-total-all-basket": (2, "total", False, "basket", 1.0, (0.6, 0.4), False, K),
    "2-separable-itm-maxcall": (2, "separable", True, "maxcall", 1.0, None, False, K),
    "2-sorted-itm-first-put": (2, "sorted", True, "first", -1.0, None, False, K),
    "2-total-itm-second": (2, "total", True, "second", 1.0, None, False, K),
    "2-total-itm-spread-direct-y": (2, "total", True, "spread", -1.0, None, True, K),
    "2-sorted-itm-spreadk": (2, "sorted", True, "spreadk", 1.0, None, False, 5.0),
    "2-sorted-all-geobasket": (2, "sorted", False, "geobasket", 1.0, None, False, K),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_plain_ma_step_kernels_match_amcx(paths2, paths5, case):
    # moments: rtol 1e-5 on the packed vector (amcx sums in f32 in XLA's
    # order, the port in f64 rounded once), atol 1e-6 of the largest entry
    # for sums that cancel to near 0. apply, with coefficients solved from
    # these moments: the same exercise decisions (τ) except on paths within
    # 1e-5 of the boundary, and the same cf - exact, but for the baskets to
    # atol 1e-4 (a few ulp of the basket level: amcx's interpreted kernel
    # contracts the weighted sum into FMAs, and geobasket's log/exp are
    # another library's)
    n_assets, bmode, itm, kind, phi, weights, direct_y, strike = STEP_CASES[case]
    paths = paths5 if n_assets == 5 else paths2
    t = 5
    sorted_basis = bmode == "sorted"
    mode = "total" if sorted_basis else bmode
    planes, cf, tau, mean, inv_std, A = _one_step(paths, t, sorted_basis, kind, phi, strike)
    m = at.n_multi_terms(A, 2, mode)
    common = dict(basis="chebyshev", degree=2, mode=mode, sorted_basis=sorted_basis,
                  payoff_kind=kind, phi=phi, weights=weights)
    jw = None if weights is None else tuple(weights)
    jkw = dict(common, weights=jw, n_assets=A, interpret=True)
    jplanes = jnp.asarray(planes).reshape(A, -1, 512)
    j = np.asarray(jma.ma_step_moments(_scalars(t, mean, inv_std, strike), jplanes, _rows(cf),
                                       _rows(tau), itm_weights=itm, direct_y=direct_y, **jkw))
    got = tma.ma_step_moments(_stats(t, mean, inv_std), t, _t(planes), _t(cf), _t(tau), rdt=RDT,
                              K=strike, itm_weights=itm, direct_y=direct_y, **common)
    assert got.shape == (tma.ma_pack_dim(m),) == j.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), j, rtol=1e-5, atol=1e-6 * np.abs(j).max())

    coeffs = at.pinv_solve(*unpack_moments(got, m))
    cf_j, tau_j = (np.asarray(a).reshape(-1) for a in jma.ma_step_apply(
        _scalars(t, mean, inv_std, strike), jnp.asarray(coeffs.numpy()), jplanes, _rows(cf),
        _rows(tau), **jkw))
    cf_t, tau_t = _t(cf), _t(tau)
    out = tma.ma_step_apply(_stats(t, mean, inv_std), t, coeffs, _t(planes), cf_t, tau_t,
                            K=strike, **common)
    assert out[0] is cf_t and out[1] is tau_t  # updated in place
    cols = tma._columns(list(_t(planes)), _stats(t, mean, inv_std), t, "chebyshev", 2, mode,
                        sorted_basis)
    cont = torch.clamp_min(tma._fitted(cols, coeffs), 0.0).numpy()
    ex = tma._payoff_for(list(_t(planes)), strike, kind, phi, weights).numpy()
    near = (ex > 0) & (np.abs(ex - cont) <= 1e-5 * (1.0 + ex))
    same = tau_t.numpy() == tau_j
    assert not (~same & ~near).any()
    np.testing.assert_allclose(cf_t.numpy()[same], cf_j[same], rtol=0,
                               atol=1e-4 if kind in ("basket", "geobasket") else 0.0)
    assert (tau_j == t).sum() > 10  # the select did fire
    # allow_t = 0 (not an exercise date): the carry stays
    cf2, tau2 = _t(cf), _t(tau)
    tma.ma_step_apply(_stats(t, mean, inv_std, allow=0.0), t, coeffs, _t(planes), cf2, tau2,
                      K=strike, **common)
    assert torch.equal(cf2, _t(cf)) and torch.equal(tau2, _t(tau))


# ---------------------------------------------------------------------------
# the engines against amcx's on shared paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("basis_mode,n_assets", [
    pytest.param("sorted", 2, id="sorted"), pytest.param("separable", 2, id="separable"),
    pytest.param("sorted", 5, id="sorted-5-assets")])
def test_fused_maxcall_matches_amcx(paths2, paths5, basis_mode, n_assets):
    # price within 2.5e-3 and stderr rtol 0.05 (tests/test_maxcall.py's
    # fused-vs-xla gates), under the first-flipped-step rules; at 5 assets
    # the slice's configuration (m = 21, the 21 x 21 solve between kernels)
    paths = {2: paths2, 5: paths5}[n_assets]
    jres = jmaxcall.backward_induction_fused_maxcall(jnp.asarray(paths), K, R, DT, JSPEC,
                                                     basis_mode)
    tres = tmaxcall.backward_induction_fused_maxcall(_t(paths), K, R, DT, TSPEC, basis_mode)
    assert tres.cashflows.shape == tres.exercise_times.shape == (N_PATHS,)
    assert int((tres.exercise_times < N_STEPS).sum()) > N_PATHS // 10
    _hold_carry_pair(f"fused {basis_mode} {n_assets} assets", jres, tres, 2.5e-3, 0.05)


# (n_assets, payoff_kind, keywords, antithetic paths)
MEGA_CASES = {
    "maxcall-5-sorted-cf-tau": (5, "maxcall", dict(sorted_basis=True, return_cf_tau=True), False),
    "maxcall-sorted-cf-tau": (2, "maxcall", dict(sorted_basis=True, return_cf_tau=True), False),
    "basket-itm-antithetic": (2, "basket", dict(itm_weights=True, antithetic=True,
                                                weights=(0.7, 0.3)), True),
    "geobasket-put": (2, "geobasket", dict(phi=-1.0), False),
}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_plain_ma_mega_matches_amcx(paths2, paths5, case):
    # price within 1e-3 (tests/test_ma_mega.py's mega-vs-fused gate) under
    # the first-flipped-step rules where the cf/τ planes are exported, and
    # the port's mega within 2e-3 of its own fused engine (the same gate
    # between amcx's two kernel routes); at 5 assets the slice's m = 21
    # in-kernel solve, and the routes within 5e-3 (chip_smoke.py's gate):
    # there the f32 ridge Cholesky and the fused route's pinv flip near-tie
    # decisions, and amcx's own two routes end 2.6e-3 apart on these paths
    n_assets, kind, kw, anti = MEGA_CASES[case]
    paths = _jax_paths(2, seed=1, antithetic=True) if anti else {2: paths2, 5: paths5}[n_assets]
    kw = dict(kw, payoff_kind=kind, degree=2, exercise_from_step=1)
    jout = jmamega.lsmc_price_ma_mega(jnp.asarray(paths), K, R, DT,
                                      **dict(kw, weights=kw.get("weights")))
    tout = tmamega.lsmc_price_ma_mega(_t(paths), K, R, DT, **kw)
    if kw.get("return_cf_tau"):
        _hold_carry_pair(case, jout, tout, 1e-3, 1e-3)
        v = _values(tout[2], tout[3])
        np.testing.assert_allclose(v.mean(), float(tout[0]), rtol=1e-5)
    else:
        assert abs(float(tout[0]) - float(jout[0])) <= 1e-3
        np.testing.assert_allclose(float(tout[1]), float(jout[1]), rtol=1e-3)
    spec = at.RegressionSpec(basis="chebyshev", degree=2,
                             regress_on="itm" if kw.get("itm_weights") else "all")
    fused = tmaxcall.backward_induction_fused_maxcall(
        _t(paths), K, R, DT, spec, "sorted" if kw.get("sorted_basis") else "total",
        payoff_kind=kind, phi=kw.get("phi", 1.0), weights=kw.get("weights"))
    assert abs(float(fused.price) - float(tout[0])) <= (5e-3 if n_assets == 5 else 2e-3)


@pytest.mark.parametrize("n_assets", [2, 5])
def test_xla_maxcall_matches_amcx(paths2, paths5, n_assets):
    # the reference loop engine with the cross-term fit on amcx's paths:
    # price within 2.5e-3, coefficient rows to 1e-3 of the largest before
    # the first flipped step (decisions from each side's surface)
    paths = paths5 if n_assets == 5 else paths2
    kw = dict(american=True, return_surface=True, fit_fn_returns_coeffs=True,
              return_coeffs=True, exercise_from_step=1)
    jres = jengine.backward_induction(
        jnp.asarray(paths), jnp.ones(paths.shape[:2], bool), R, DT,
        lambda S: amcx.max_call_payoff(S, K), JSPEC,
        fit_fn=partial(jmaxcall.max_call_fit, mode="sorted"), **kw)
    S = _t(paths)
    tres = at.backward_induction(
        S, torch.ones(paths.shape[:2], dtype=torch.bool), R, DT,
        lambda s: at.max_call_payoff(s, K), TSPEC,
        fit_fn=partial(tmaxcall.max_call_fit, mode="sorted"), **kw)
    m = at.n_multi_terms(n_assets, 2, "total")
    assert tres.coeffs.shape == (N_STEPS, m) and tres.continuation.shape == (N_STEPS + 1, N_PATHS)
    ex = at.max_call_payoff(S[:-1], K)
    allow = (torch.arange(N_STEPS) >= 1)[:, None]

    def decide(cont):
        return ((ex > 0) & (ex > _t(np.asarray(cont))[:-1]) & allow).numpy()

    first = first_divergence(decide(jres.continuation), decide(tres.continuation))
    hold_pair(f"xla {n_assets} assets", jres.price, tres.price, jres.stderr, tres.stderr,
              np.asarray(jres.coeffs)[1:], tres.coeffs.numpy()[1:],
              (None if first[0] is None else first[0] - 1, first[1]),
              _values(jres.cashflows, jres.exercise_times),
              _values(tres.cashflows, tres.exercise_times), 2.5e-3)
    # the regressor hook: sorting the state before a total-degree fit is
    # the sorted fit, to the bit
    reg = at.backward_induction(
        S, torch.ones(paths.shape[:2], dtype=torch.bool), R, DT,
        lambda s: at.max_call_payoff(s, K), TSPEC,
        regressor=lambda s: torch.sort(s, dim=-1, descending=True).values,
        fit_fn=partial(tmaxcall.max_call_fit, mode="total"), **kw)
    assert torch.equal(reg.price, tres.price) and torch.equal(reg.coeffs, tres.coeffs)
    # the custom-fit hooks: values-only fits cannot export coefficients
    with pytest.raises(ValueError, match="return_coeffs"):
        at.backward_induction(S, torch.ones(paths.shape[:2], dtype=torch.bool), R, DT,
                              lambda s: at.max_call_payoff(s, K), TSPEC,
                              fit_fn=tmaxcall.max_call_fit_values, return_coeffs=True)


def _assert_frame_matches_amcx(paths, mode, frame=None):
    """The port's frame (f64 sums rounded once) against amcx's (f32 sums)
    on the same numpy paths: rtol 1e-5 on the means, 1e-4 on 1/std."""
    if frame is None:
        frame = jmaxcall.maxcall_standardization(jnp.asarray(paths), mode)
    mean, inv_std = tmaxcall.maxcall_standardization(_t(paths), mode)
    assert mean.dtype == inv_std.dtype == torch.float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(frame[0]), rtol=1e-5)
    np.testing.assert_allclose(inv_std.numpy(), np.asarray(frame[1]), rtol=1e-4)


@pytest.mark.parametrize("mode", ["sorted", "total"])
@pytest.mark.parametrize("n_assets", [1, 2, 5])
def test_maxcall_standardization_matches_amcx(n_assets, mode):
    _assert_frame_matches_amcx(_jax_paths(n_assets, seed=13, n_paths=2048), mode)


def _frame_numpy(paths, sort):
    """A float64 numpy transcription of the frame: the values sorted
    descending, S1 and S2 in f64, mean and 1/std in f64, rounded once."""
    x = np.sort(paths, axis=-1)[..., ::-1] if sort else paths
    x = x.astype(np.float64)
    n = x.shape[1]
    mean = x.sum(axis=1) / n
    var = np.maximum((x * x).sum(axis=1) / n - mean * mean, 0.0)
    inv_std = 1.0 / np.maximum(np.sqrt(var), 1e-6)
    return mean.astype(np.float32), inv_std.astype(np.float32)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_frame_is_f64_rounded_once(sort):
    # the plain frame and ma_inputs' stats rows on the CPU: the numpy
    # transcription's f32 bits (step 0's equal spots: var 0, 1/std 1e6)
    paths = _jax_paths(3, seed=14, n_paths=3001)
    mean, inv_std = tmaxcall.maxcall_standardization(_t(paths), "sorted" if sort else "total")
    want_mean, want_inv = _frame_numpy(paths, sort)
    np.testing.assert_array_equal(mean.numpy(), want_mean)
    np.testing.assert_array_equal(inv_std.numpy(), want_inv)
    assert float(inv_std[0, 0]) == 1e6
    tma.ma_prepare.launches = 0
    planes, stats = tma.ma_inputs(_t(paths), R, DT, sorted_basis=sort, exercise_from_step=1)
    assert tma.ma_prepare.launches == 0  # the plain version on a CPU tensor
    np.testing.assert_array_equal(planes.numpy(), np.ascontiguousarray(paths.transpose(0, 2, 1)))
    np.testing.assert_array_equal(stats[:3].numpy(), want_mean.T)
    np.testing.assert_array_equal(stats[3:6].numpy(), want_inv.T)


@pytest.mark.parametrize("exercise", ["from-1", "steps"])
def test_ma_stats_discount_rows_keep_their_bits(exercise):
    # c_t and 1/c_t against the formula the rows were first built by (f32
    # device scalars r and dt times the remaining steps), the exercise row
    # against the schedule, in ma_stats and in the rows ma_inputs builds
    f32 = torch.float32
    rem = N_STEPS - torch.arange(N_STEPS + 1, dtype=f32)
    r_rem = torch.tensor(R, dtype=f32) * torch.tensor(DT, dtype=f32) * rem
    if exercise == "steps":
        kw, allow = dict(exercise_steps=(2, 4, 7)), at.exercise_allow_row((2, 4, 7), N_STEPS, f32)
    else:
        kw, allow = dict(exercise_from_step=1), (torch.arange(N_STEPS + 1) >= 1).to(f32)
    mean_t, inv_std_t = torch.zeros(N_STEPS + 1, 2), torch.ones(N_STEPS + 1, 2)
    stats = tma.ma_stats(mean_t, inv_std_t, R, DT, allow)
    _, built = tma.ma_inputs(torch.ones(N_STEPS + 1, 64, 2), R, DT, sorted_basis=True, **kw)
    for rows in (stats, built):
        assert rows.shape == (7, N_STEPS + 1) and rows.dtype == f32
        assert torch.equal(rows[4], torch.exp(-r_rem)) and torch.equal(rows[5], torch.exp(r_rem))
        assert torch.equal(rows[6], allow)


def test_reprice_with_amcx_coefficients():
    # the exercise policy carried across: amcx's exported coefficient rows
    # and standardization frame, replayed by the port on fresh paths, give
    # amcx's out-of-sample price (atol 1e-4: the same f32 rule, but the
    # two packages' f32 exp/matmul may round a near-tie decision apart)
    key = jax.random.key(11)
    jres, fit_paths = jmaxcall.price_max_call(key, [100.0] * 5, K, T, R, SIGMA, q=Q,
                                              n_paths=N_PATHS, return_coeffs=True,
                                              return_paths=True)
    frame = jmaxcall.maxcall_standardization(fit_paths, "sorted")
    fresh = _jax_paths(5, seed=12)
    jout = jmaxcall.reprice_max_call_with_coeffs(jnp.asarray(fresh), jres, frame, K, T, R, JSPEC)
    coeffs = _t(np.asarray(jres.coeffs))
    tframe = tuple(_t(np.asarray(f)) for f in frame)
    tres = at.LSMCResult(None, None, None, None, None, coeffs=coeffs)
    tout = at.reprice_max_call_with_coeffs(_t(fresh), tres, tframe, K, T, R, TSPEC)
    assert abs(float(tout.price) - float(jout.price)) <= 1e-4
    np.testing.assert_allclose(float(tout.stderr), float(jout.stderr), rtol=1e-3)
    # the port's own frame equals amcx's
    _assert_frame_matches_amcx(np.asarray(fit_paths), "sorted", frame)
    with pytest.raises(ValueError, match="return_coeffs"):
        at.reprice_max_call_with_coeffs(_t(fresh), at.LSMCResult(None, None, None, None, None),
                                        tframe, K, T, R, TSPEC)


def test_price_max_call_routes_on_cpu():
    # the entry point on the CPU (its own torch paths, returned): the three
    # engines on the same paths - mega within 2e-3 of fused, xla within one
    # stderr of fused - no kernel launched, and the 2-asset price within
    # 0.35 of the Andersen-Broadie 13.90 (tests/test_maxcall.py's gate)
    tmamega.lsmc_price_ma_mega.launches = 0
    tma.ma_step_moments.launches = tma.ma_step_apply.launches = 0
    args = (7, [100.0, 100.0], K, T, R, SIGMA)
    kw = dict(q=Q, n_paths=N_PATHS, return_paths=True, device="cpu")
    fused, paths = at.price_max_call(*args, engine="fused", **kw)
    mega, paths_m = at.price_max_call(*args, engine="mega", **kw)
    xla, paths_x = at.price_max_call(*args, **kw)
    assert torch.equal(paths, paths_m) and torch.equal(paths, paths_x)
    assert tmamega.lsmc_price_ma_mega.launches == 0
    assert tma.ma_step_moments.launches == tma.ma_step_apply.launches == 0
    assert abs(float(mega.price) - float(fused.price)) <= 2e-3
    assert abs(float(xla.price) - float(fused.price)) <= float(fused.stderr)
    assert abs(float(xla.price) - 13.90) <= 0.35
    with pytest.raises(ValueError, match="price-only"):
        at.price_max_call(*args, engine="fused", return_coeffs=True, device="cpu")
    with pytest.raises(ValueError, match="engine"):
        at.price_max_call(*args, engine="tpu", device="cpu")
    with pytest.raises(ValueError, match="corr"):
        at.price_max_call(*args, corr=np.eye(3), device="cpu")


def test_max_call_greeks_match_common_random_numbers():
    # autograd through the xla route: symmetric deltas, positive vega, and
    # the delta sum against a central difference of the port's own price
    # under common random numbers (bump both assets by 0.5; atol 0.03, the
    # gate of tests/test_maxcall.py)
    kw = dict(q=Q, n_paths=16_384, spec=at.RegressionSpec(degree=3), device="cpu")
    p, g = at.max_call_greeks(4, [100.0, 100.0], K, T, R, SIGMA, **kw)
    d = g["delta"].numpy()
    assert d.shape == (2,) and abs(d[0] - d[1]) <= 0.02 and 0.0 < d.sum() < 2.0
    assert float(g["vega"]) > 0
    h = 0.5
    up = at.price_max_call(4, [100.0 + h] * 2, K, T, R, SIGMA, **kw)
    dn = at.price_max_call(4, [100.0 - h] * 2, K, T, R, SIGMA, **kw)
    fd = (float(up.price) - float(dn.price)) / (2 * h)
    assert abs(d.sum() - fd) <= 0.03, (d.sum(), fd)
    assert abs(float(p) - float(at.price_max_call(4, [100.0] * 2, K, T, R, SIGMA,
                                                  **kw).price)) == 0.0


def test_unported_ma_mega_options_raise(paths2):
    S = _t(paths2[:, :1024])
    for kw in (dict(barrier=90.0), dict(discount_planes=torch.ones(N_STEPS, 1024)),
               dict(axis_name="paths"), dict(r=torch.full((N_STEPS,), R))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmamega.lsmc_price_ma_mega(S, K, kw.pop("r", R), DT, **kw)
    with pytest.raises(ValueError, match="payoff_kind"):
        tmamega.lsmc_price_ma_mega(S, K, R, DT, payoff_kind="rainbow")
    with pytest.raises(ValueError, match="two planes"):
        tma.ma_params(1, "chebyshev", 2, "total", False, "spread", K, 1.0)


@pytest.mark.parametrize("m", [1, 6, 21, 25, 29, 32])
def test_ma_moments_grid_sizing(m):
    # kernels 7 and 8 sum the upper 8 x 8 tiles (I <= J) of X^T X, X = [c w |
    # y w | 0] padded to ceil((m + 1) / 8) blocks: lane l of a warp holds
    # D[l // 4][2 (l % 4) + e] of each tile (ma_moments.cuh store_tiles),
    # and every packed sum (a Gram pair i <= j < m or a rhs entry (i, m)) is
    # held by exactly one lane. The grid is one block of 16 warps an SM,
    # never more than the 512-path tiles
    n_cb = (m + 8) // 8
    assert 8 * n_cb >= m + 1 > 8 * (n_cb - 1)
    held = []
    for I in range(n_cb):
        for J in range(I, n_cb):
            for lane in range(32):
                for e in range(2):
                    i, j = 8 * I + lane // 4, 8 * J + 2 * (lane % 4) + e
                    if i < m and i <= j <= m:
                        held.append((i, j))
    want = [(i, j) for i in range(m) for j in range(i, m)] + [(i, m) for i in range(m)]
    assert sorted(held) == sorted(want) and len(want) == tma.ma_pack_dim(m)
    assert tma.ma_moments_blocks(1 << 20, 132) == 132
    assert tma.ma_moments_blocks(100, 132) == 1
    assert tma.ma_moments_blocks(512 * 7 + 1, 132) == 8
    assert tma.ma_moments_blocks(1, 132) == 1


@pytest.mark.parametrize("direct_y", [False, True], ids=["discounted-y", "direct-y"])
@pytest.mark.parametrize("itm", [False, True], ids=["all", "itm"])
def test_plain_ma_moments_are_exact_products(itm, direct_y):
    # the plain moments of kernels 7 and 8: each sum an f64 sum of the exact
    # products of the f32 columns (and of w y), rounded once to f32, bit for
    # bit numpy's float64 sum of the same products
    rng = np.random.default_rng(19)
    n, A, t = 3_001, 3, 4
    planes = (100.0 * np.exp(0.2 * rng.standard_normal((A, n)))).astype(np.float32)
    mean = planes.mean(axis=1).astype(np.float32)
    inv_std = (1.0 / planes.std(axis=1)).astype(np.float32)
    cf = np.maximum(planes.max(axis=0) - K, 0.0).astype(np.float32)
    tau = rng.integers(t + 1, N_STEPS + 1, n).astype(np.float32)
    stats = _stats(t, mean, inv_std)
    kw = dict(K=K, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    got = tma.ma_step_moments(stats, t, _t(planes), _t(cf), _t(tau), rdt=RDT, itm_weights=itm,
                              direct_y=direct_y, **kw)
    P = list(_t(planes))
    cols = tma._columns(P, stats, t, "chebyshev", 2, "total", True)
    y = _t(cf) if direct_y else _t(cf) * torch.exp(-RDT * (_t(tau) - float(t)))
    w = (tma._payoff_for(P, K, "maxcall") > 0.0).to(torch.float32) if itm else None
    want = crafted.exact_moments_numpy(cols, y, w)
    assert got.shape == want.shape == (tma.ma_pack_dim(len(cols)),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("itm", [False, True], ids=["all", "itm"])
def test_plain_ma_moments_tell_exact_from_f32_products(itm):
    # the crafted step of _ma_crafted: the plain version (kernel 8's, and
    # through _moments_from_cols kernel 7's) gives the exact products' sums,
    # which differ from the f32 products' in the rhs entry Σ x y
    x, stats, y = crafted.step_inputs(2_053, 1_031, 517, "cpu")
    got = tma.ma_step_moments(stats, 0, x, y, torch.zeros_like(y), rdt=0.0, itm_weights=itm,
                              direct_y=True, **crafted.STEP_KW)
    cols = tma._columns(list(x), stats, 0, "power", 1, "total", False)
    w = (tma._payoff_for(list(x), crafted.STRIKE, "first") > 0.0).to(torch.float32) if itm \
        else None
    exact = crafted.exact_moments_numpy(cols, y, w)
    f32 = crafted.f32_product_moments(cols, y, w).numpy()
    np.testing.assert_array_equal(got.numpy(), exact)
    assert got.numpy()[-1] != f32[-1]
    step_packed = torch.stack(tma._moments_from_cols(cols, y, w))
    assert torch.equal(step_packed, got)


def test_moments_sass_model_counts_the_tensor_core_loop():
    # chip_smoke.py's count of the moments' tensor-core loop in a SASS
    # listing: the innermost loop with DMMA at 3 column blocks (3 loads, 3
    # widenings and 6 DMMA a k-step of 4 paths), here unrolled twice, gives
    # 24 widenings and 1.5 DMMA a path-step; the outer tile loop and the
    # 5-block loop (5 loads, 15 DMMA a k-step) are not it
    import chip_smoke

    def ins(addr, text):
        return f"        /*{addr:04x}*/                   {text} ;"

    lines = ["        Function : _ZN12_GLOBAL__N_119ma_mega_step_kernelILi5ELb0EEEvPKf"]
    addr = 0x10
    lines.append(ins(addr, "MOV R1, c[0x0][0x28]"))
    outer = addr = addr + 0x10
    for blocks, dmma in ((3, 6), (5, 15)):
        start = addr = addr + 0x10
        for _ in range(2):
            for r in range(blocks):
                lines.append(ins(addr, f"LDS R{2 + r}, [R40+{hex(0x480 * r)}]"))
                addr += 0x10
                lines.append(ins(addr, f"F2F.F64.F32 R{20 + 2 * r}, R{2 + r}"))
                addr += 0x10
            for _ in range(dmma):
                lines.append(ins(addr, "DMMA.8x8x4 R60, R20, R22, R60"))
                addr += 0x10
        lines.append(ins(addr, f"@P0 BRA {hex(start)}"))
        addr += 0x10
    lines.append(ins(addr, f"@P1 BRA {hex(outer)}"))
    lines.append(ins(addr + 0x10, "EXIT"))
    model = chip_smoke.moments_model("\n".join(lines))
    assert set(model) == {"ma_mega"}
    got = model["ma_mega"]
    assert (got["loads"], got["widen"], got["dmma"]) == (6, 6, 12)
    assert got["widenings_per_path_step"] == 24.0 and got["dmma_per_path_step"] == 1.5

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode). This file imports no jax, so on a machine with
a card and without jax it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -p no:cacheprovider
"""

import math

import pytest
import torch

import amcx_torch as at
from amcx_torch import engine_pallas as tfused
from amcx_torch.ops import gbm as tgbm
from amcx_torch.ops import lsmc_megakernel as tmega
from amcx_torch.ops import lsmc_pallas as tstep

pytestmark = pytest.mark.cuda

S0, R, SIGMA, K = 100.0, 0.01, 0.2, 100.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_pathgen_kernel_matches_plain(cuda_device):
    # the kernel runs a sequential f32 log-sum; the plain version a
    # torch.cumsum: same uniforms bit for bit, rtol 1e-5 covers the rounding
    # of 100 summed increments
    n, T = 65_536, 100
    before = tgbm.gbm_paths.launches
    k = tgbm.gbm_paths(11, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    p = tgbm.gbm_paths_reference(11, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    torch.cuda.synchronize()
    assert tgbm.gbm_paths.launches == before + 1
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0)


@pytest.mark.parametrize("itm,american", [(True, True), (False, True), (True, False)])
def test_induction_kernel_matches_plain(cuda_device, itm, american):
    # kernel and plain version sum the moments in f64 and round once, and
    # the kernel is built without FMA contraction: identical bits, twice
    n, T = 131_072, 100
    paths = tgbm.gbm_paths(1, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T,
                                               device=cuda_device)
    kw = dict(itm_weights=itm, american=american, mean_t=mean_t, inv_std_t=inv_std_t,
              return_coeffs=True)
    before = tmega.lsmc_price_megakernel.launches
    ker = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, -1.0, **kw)
    again = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, -1.0, **kw)
    ref = tmega.lsmc_price_mega_reference(paths, K, R, 1.0 / T, -1.0, **kw)
    torch.cuda.synchronize()
    assert tmega.lsmc_price_megakernel.launches == before + 2
    for out in (again, ref):
        assert torch.equal(ker.price, out.price) and torch.equal(ker.stderr, out.stderr)
        assert torch.equal(ker.coeffs, out.coeffs)
    if itm:
        assert not ker.coeffs[0].any()  # S0 == K: the t=0 Gram is exactly 0


@pytest.mark.parametrize("basis,degree", [("legendre", 3), ("laguerre", 3), ("hermite", 3),
                                          ("power", 0), ("chebyshev", 10)])
def test_induction_kernel_other_bases(cuda_device, basis, degree):
    # other families and degrees, data-frame standardization, a European
    # call (no exercise feedback, so f32 rounding differences stay small):
    # price atol 2e-4 (far inside the 65k-path stderr), coefficients 1e-3
    # of the largest. At t=0 no path is ITM, the data frame puts S0 at
    # x = 1e8, and a degree >= 5 basis overflows: that row is NaN in both
    # (as in amcx's kernel), and NaN-equal is required there.
    n, T = 65_536, 50
    paths = tgbm.gbm_paths(2, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    kw = dict(basis=basis, degree=degree, itm_weights=True, american=False,
              return_coeffs=True)
    ker = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, 1.0, **kw)
    ref = tmega.lsmc_price_mega_reference(paths, K, R, 1.0 / T, 1.0, **kw)
    torch.cuda.synchronize()
    assert abs(float(ker.price) - float(ref.price)) <= 2e-4
    assert bool(torch.isfinite(ref.coeffs[1:]).all())
    scale = float(ref.coeffs[1:].abs().max())
    torch.testing.assert_close(ker.coeffs, ref.coeffs, rtol=0, atol=1e-3 * scale,
                               equal_nan=True)


def test_main_path_on_card(cuda_device):
    # the flagship route end to end at 131k x 100: both kernels launch,
    # and the price sits within 4 stderr + 0.005 of CRR-2000
    tgbm.gbm_paths.launches = 0
    tmega.lsmc_price_megakernel.launches = 0
    res = at.price_option(
        17, at.MarketParams(S0, R, SIGMA),
        at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american"),
        at.RegressionSpec(basis="chebyshev", degree=4),
        at.SimConfig(n_paths=131_072, n_steps=100, backend="philox"),
        engine="mega", device=cuda_device)
    price, stderr = float(res.price), float(res.stderr)
    assert tgbm.gbm_paths.launches == 1 and tmega.lsmc_price_megakernel.launches == 1
    crr = at.crr_price(S0, K, 1.0, R, SIGMA, 2000, option_type="put", american=True)
    assert math.isfinite(price) and stderr > 0
    assert abs(price - crr) <= 4 * stderr + 0.005


def test_wrappers_reject_bad_inputs_on_card(cuda_device):
    paths = tgbm.gbm_paths(3, S0, R, SIGMA, 0.0, 1.0, 4, 1024, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tmega.lsmc_price_megakernel(paths.double(), K, R, 0.25, -1.0)
    with pytest.raises(ValueError, match="n_paths"):
        tgbm.gbm_paths(3, S0, R, SIGMA, 0.0, 1.0, 4, 0, device=cuda_device)


FUSED_CARD_CASES = {
    # (regress_on, engine keywords)
    "barrier": ("itm", dict(barrier=90.0)),
    "schedule": ("all", dict(exercise_steps=tuple(range(0, 100, 10)))),
    "surface": ("itm", dict(return_surface=True)),
}


@pytest.mark.parametrize("case", sorted(FUSED_CARD_CASES))
def test_fused_step_kernels_match_plain(cuda_device, case):
    # kernels 4+5 through the fused engine at 131k x 100 against the plain
    # versions on the same card: f64 moments rounded once, -fmad=false and
    # the same pinv_solve on the same device, so identical bits, twice
    n, T = 131_072, 100
    paths = tgbm.gbm_paths(5, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    regress_on, kw = FUSED_CARD_CASES[case]
    spec = at.RegressionSpec(degree=4, regress_on=regress_on)
    before = (tstep.step_moments.launches, tstep.step_apply.launches)
    ker = at.backward_induction_fused(paths, R, 1.0 / T, K, -1.0, spec, **kw)
    again = at.backward_induction_fused(paths, R, 1.0 / T, K, -1.0, spec, **kw)
    ref = tfused.backward_induction_fused_reference(paths, R, 1.0 / T, K, -1.0, spec, **kw)
    torch.cuda.synchronize()
    assert (tstep.step_moments.launches, tstep.step_apply.launches) == (
        before[0] + 2 * T, before[1] + 2 * T)
    assert int((ker.exercise_times < T).sum()) > n // 10  # early exercise happened
    for out in (again, ref):
        for a, b in zip(ker[:5], out[:5]):
            assert (a is None and b is None) or torch.equal(a, b)
    if case == "surface":
        assert ker.continuation.shape == (T + 1, n) and not ker.continuation[-1].any()


def test_induction_kernel_cf_tau_planes_match_plain(cuda_device):
    # kernel 2's cf/tau planes: the same select as its V carry, identical
    # bits to the plain version; the planes reprice the kernel's price
    # (rtol 1e-5: f64 sums of two f32 roundings of each path's value)
    n, T = 131_072, 100
    paths = tgbm.gbm_paths(6, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T,
                                               device=cuda_device)
    kw = dict(itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t, return_cf_tau=True)
    ker = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, -1.0, **kw)
    ref = tmega.lsmc_price_mega_reference(paths, K, R, 1.0 / T, -1.0, **kw)
    plain = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, -1.0, itm_weights=True,
                                        mean_t=mean_t, inv_std_t=inv_std_t)
    torch.cuda.synchronize()
    assert ker.coeffs is None and ker.cashflows.shape == ker.exercise_times.shape == (n,)
    assert torch.equal(ker.price, plain[0])  # the planes leave V's arithmetic alone
    for a, b in zip(ker[:4], ref[:4]):
        assert torch.equal(a, b)
    v = ker.cashflows.double() * torch.exp(-R / T * ker.exercise_times.double())
    torch.testing.assert_close(float(v.mean()), float(ker.price), rtol=1e-5, atol=0)


def test_fused_price_diff_on_card(cuda_device):
    # the autograd.Function on card paths: its gradient equals the backward
    # formula evaluated on the CPU from the card's (cf, tau) (rtol 1e-6 on
    # the path cotangent: the card's and the CPU's f32 exp may differ by an
    # ulp; rtol 1e-5 on the scalars, f32 means in two orders)
    n, T = 131_072, 100
    dt = 1.0 / T
    paths = tgbm.gbm_paths(7, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    spec = at.RegressionSpec(degree=4, regress_on="itm")
    P = paths.clone().requires_grad_(True)
    r, K_, dt_ = (torch.tensor(v, requires_grad=True) for v in (R, K, dt))
    price = at.fused_price_diff(P, r, K_, dt_, None, T, -1.0, spec, True)
    g_paths, g_r, g_K, g_dt = torch.autograd.grad(price, (P, r, K_, dt_))
    res = at.backward_induction_fused(paths, R, dt, K, -1.0, spec)
    cf, tau = res.cashflows.cpu(), res.exercise_times.cpu()
    r32, dt32 = torch.tensor(R), torch.tensor(dt)
    disc = torch.exp(-r32 * dt32 * tau)
    ex = cf > 0.0
    want = torch.zeros((T + 1, n))
    want[tau.long(), torch.arange(n)] = torch.where(ex, (1.0 / n) * (disc * -1.0), 0.0)
    g_cpu = g_paths.cpu()
    assert torch.equal(g_cpu != 0, want != 0)
    torch.testing.assert_close(g_cpu, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(g_r, torch.mean(-dt32 * tau * cf * disc), rtol=1e-5, atol=0)
    torch.testing.assert_close(g_K, torch.mean(torch.where(ex, disc, 0.0)), rtol=1e-5, atol=0)
    torch.testing.assert_close(g_dt, torch.mean(-r32 * tau * cf * disc), rtol=1e-5, atol=0)

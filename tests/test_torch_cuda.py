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
from amcx_torch.ops import gbm as tgbm
from amcx_torch.ops import lsmc_megakernel as tmega

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

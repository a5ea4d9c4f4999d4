"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips where no card is present (the
kernels have no CPU mode). This file imports no jax, so on a machine with
a card and without jax it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest -p no:cacheprovider
"""

import hashlib
import math

import numpy as np
import pytest
import torch

import _ma_crafted as crafted
import amcx_torch as at
from amcx_torch import engine_pallas as tfused
from amcx_torch import tracing
from amcx_torch.models import maxcall as tmaxcall
from amcx_torch.ops import ccr_exposures as tccr
from amcx_torch.ops import gbm as tgbm
from amcx_torch.ops import gbm_multi as tgm
from amcx_torch.ops import lsmc_ma_mega as tmamega
from amcx_torch.ops import lsmc_fusedpath as tfp
from amcx_torch.ops import lsmc_megakernel as tmega
from amcx_torch.ops import lsmc_pallas as tstep
from amcx_torch.ops import lsmc_swing as tsw
from amcx_torch.ops import maxcall_pallas as tma
from amcx_torch.ops import sobol_pallas as tsp

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


# sha256 of kernel 1's path array at seed 20261016, 65,536 x 100 (S0 = 100,
# r = 1%, sigma = 20%, T = 1), written by the one-path-a-thread kernel that
# the redesign replaced, on an NVIDIA H100 80GB HBM3: the redesign keeps its
# bits
PATHGEN_SHA256_65536x100 = "5c85fb24ec8457c2038ec1df78c029e1a67c42d0833a5b20e6ae6140591a3675"


def test_pathgen_kernel_keeps_its_bits(cuda_device):
    paths = tgbm.gbm_paths(20261016, S0, R, SIGMA, 0.0, 1.0, 100, 65_536, device=cuda_device)
    again = tgbm.gbm_paths(20261016, S0, R, SIGMA, 0.0, 1.0, 100, 65_536, device=cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(paths, again)
    digest = hashlib.sha256(paths.cpu().numpy().tobytes()).hexdigest()
    assert digest == PATHGEN_SHA256_65536x100


# odd shapes: 1, 3 and 5 paths (the scalar instance, a masked last group),
# 65,537 paths (one path past a group), a tail quad of 1 or 3 steps and 1,000
# steps; the rtol of test_pathgen_kernel_matches_plain (the plain version's
# cumsum order), measured within it at 1,000 steps
@pytest.mark.parametrize("n_paths", [1, 3, 5, 65_537])
@pytest.mark.parametrize("n_steps", [1, 3, 5, 1000])
def test_pathgen_kernel_odd_shapes_match_plain(cuda_device, n_paths, n_steps):
    k = tgbm.gbm_paths(12, S0, R, SIGMA, 0.0, 1.0, n_steps, n_paths, device=cuda_device)
    p = tgbm.gbm_paths_reference(12, S0, R, SIGMA, 0.0, 1.0, n_steps, n_paths,
                                 device=cuda_device)
    torch.cuda.synchronize()
    assert k.shape == (n_steps + 1, n_paths)
    torch.testing.assert_close(k, p, rtol=1e-5, atol=0)


def test_pathgen_entry_refuses_a_plan_that_misses_or_overruns(cuda_device):
    # the C entry takes the launch plan's fields: a group too many or too
    # few, the 16-byte instance on unaligned rows, a tail of 4 steps or
    # another block size is refused (cudaErrorInvalidValue) before any
    # launch; one block, each thread striding over the groups, writes the
    # plan's bits
    n_paths, n_steps = 4097, 5
    plan = tgbm._gbm_plan(n_paths, n_steps)
    out = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=cuda_device)
    S0_, drift_dt, vol_sdt = tgbm._increments(100.0, 0.01, 0.2, 0.0, 1.0, n_steps)

    def call(p):
        return tgbm._gbm_fn()(out.data_ptr(), 7, 0, n_paths, p.n_groups, p.full_quads, p.tail,
                              int(p.scalar), p.threads, p.grid, S0_, drift_dt, vol_sdt, None)

    for bad in (plan._replace(n_groups=plan.n_groups + 1),
                plan._replace(n_groups=plan.n_groups - 1), plan._replace(scalar=False),
                plan._replace(tail=4), plan._replace(threads=128)):
        assert call(bad) == 1, bad
    assert call(plan) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tgbm.gbm_paths_reference(7, 100.0, 0.01, 0.2, 0.0, 1.0,
                                                             n_steps, n_paths,
                                                             device=cuda_device),
                               rtol=1e-5, atol=0)
    first = out.clone()
    out.fill_(float("nan"))
    assert call(plan._replace(grid=1)) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, first)


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


def _mega_equal_to_plain(dev, paths, phi, kw, calls=2):
    # kernel 2 against its plain version on the same card paths: identical
    # bits (a NaN coefficient row, where the data frame overflows a high
    # degree at t = 0, NaN in both), one wrapper call a pricing, and a rerun
    # identical
    before = tmega.lsmc_price_megakernel.launches
    runs = [tmega.lsmc_price_megakernel(paths, K, R, 0.01, phi, **kw) for _ in range(calls)]
    ref = tmega.lsmc_price_mega_reference(paths, K, R, 0.01, phi, **kw)
    torch.cuda.synchronize()
    assert tmega.lsmc_price_megakernel.launches == before + calls
    ker = runs[0]
    assert math.isfinite(float(ker.price)) and float(ker.stderr) > 0
    for out in (*runs[1:], ref):
        for a, b in zip(ker, out):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    return ker


@pytest.mark.parametrize("degree", range(11))
@pytest.mark.parametrize("basis", ["power", "chebyshev", "legendre", "laguerre", "hermite"])
def test_induction_kernel_every_basis_and_degree(cuda_device, basis, degree):
    # the cooperative kernel at every k = 1..11 and basis, ITM American put
    # in the closed-form frame with cf/tau and coefficients, 20,003 paths (the
    # last quad masked) x 20 steps
    paths = tgbm.gbm_paths(40 + degree, S0, R, SIGMA, 0.0, 0.2, 20, 20_003, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 0.2, 20,
                                               device=cuda_device)
    kw = dict(basis=basis, degree=degree, itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t,
              return_cf_tau=True, return_coeffs=True)
    ker = _mega_equal_to_plain(cuda_device, paths, -1.0, kw)
    assert bool((ker.exercise_times < 20).any())


MEGA_FIT_CASES = {
    # (phi, keywords): the data frame (a NaN t = 0 row at degree >= 5), an
    # all-paths fit, a European (regression for the export only), a call
    "data-frame-degree-5": (-1.0, dict(degree=5, itm_weights=True)),
    "data-frame-degree-10-all": (-1.0, dict(degree=10)),
    "all-paths-cf-tau": (-1.0, dict(return_cf_tau=True)),
    "european-itm": (-1.0, dict(itm_weights=True, american=False)),
    "call-itm-cf-tau": (1.0, dict(itm_weights=True, return_cf_tau=True)),
}


@pytest.mark.parametrize("n", [131_071, 131_072])
@pytest.mark.parametrize("case", sorted(MEGA_FIT_CASES))
def test_induction_kernel_fits_match_plain(cuda_device, case, n):
    phi, kw = MEGA_FIT_CASES[case]
    paths = tgbm.gbm_paths(9, S0, R, SIGMA, 0.0, 1.0, 100, n, device=cuda_device)
    ker = _mega_equal_to_plain(cuda_device, paths, phi, dict(kw, return_coeffs=True))
    if kw.get("degree", 4) >= 5 and kw.get("itm_weights"):
        assert bool(ker.coeffs[0].isnan().all())  # no path is ITM at t = 0: a NaN fit


def test_induction_kernel_unaligned_paths(cuda_device):
    # a contiguous path tensor at a storage offset of one float: no row is
    # 16-byte aligned, so every load is one a path
    n, T = 131_072, 100
    src = tgbm.gbm_paths(10, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    flat = torch.empty(1 + (T + 1) * n, device=cuda_device)
    paths = flat[1:].view(T + 1, n)
    paths.copy_(src)
    assert paths.is_contiguous() and paths.data_ptr() % 16 != 0
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T,
                                               device=cuda_device)
    kw = dict(itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t, return_cf_tau=True,
              return_coeffs=True)
    ker = _mega_equal_to_plain(cuda_device, paths, -1.0, kw)
    aligned = tmega.lsmc_price_megakernel(src, K, R, 0.01, -1.0, **kw)
    for a, b in zip(ker, aligned):
        assert torch.equal(a, b)


@pytest.mark.parametrize("degree", [4, 10])
def test_induction_kernel_global_planes_match_plain(cuda_device, degree, monkeypatch):
    # every quad past the first shared-memory slot goes through the global
    # planes (the path that large n_paths take), 1,000,003 paths x 20 steps
    plan = tmega._mega_plan

    def one_slot(*args):
        n_blocks, chip, needed = plan(*args)
        return n_blocks, min(chip, 1), needed

    monkeypatch.setattr(tmega, "_mega_plan", one_slot)
    paths = tgbm.gbm_paths(11, S0, R, SIGMA, 0.0, 0.2, 20, 1_000_003, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 0.2, 20,
                                               device=cuda_device)
    _mega_equal_to_plain(cuda_device, paths, -1.0,
                         dict(degree=degree, itm_weights=True, mean_t=mean_t,
                              inv_std_t=inv_std_t, return_cf_tau=True, return_coeffs=True))


def test_induction_kernel_large_n_matches_plain(cuda_device):
    # 8,388,608 paths x 100 steps: more quads than the grid's shared memory
    # holds, so the plan itself sends the rest to the global planes
    paths = tgbm.gbm_paths(12, S0, R, SIGMA, 0.0, 1.0, 100, 1 << 23, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, 100,
                                               device=cuda_device)
    n_blocks, chip, needed = tmega._mega_plan(
        1 << 23, torch.cuda.get_device_properties(0).multi_processor_count,
        lambda smem: tmega._mega_occupancy(4, smem, 0))
    assert chip < needed
    _mega_equal_to_plain(cuda_device, paths, -1.0,
                         dict(itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t,
                              return_cf_tau=True, return_coeffs=True), calls=1)


def test_induction_refused_cooperative_launch_raises(cuda_device, monkeypatch):
    # a grid larger than the card holds at once is refused by the runtime:
    # the wrapper raises, it never runs the pricing another way
    monkeypatch.setattr(tmega, "_mega_plan", lambda *args: (100_000, 1, 1))
    paths = tgbm.gbm_paths(13, S0, R, SIGMA, 0.0, 1.0, 10, 1 << 20, device=cuda_device)
    before = tmega.lsmc_price_megakernel.launches
    with pytest.raises(RuntimeError, match="amcx_lsmc_mega"):
        tmega.lsmc_price_megakernel(paths, K, R, 0.1, -1.0)
    assert tmega.lsmc_price_megakernel.launches == before + 1


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
                                        mean_t=mean_t, inv_std_t=inv_std_t, return_stats=True)
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


# the Andersen-Broadie max-call (S0 = K = 100, r = 5%, q = 10%, sigma = 20%,
# T = 3, 9 exercise dates)
MC = dict(K=100.0, T=3.0, r=0.05, sigma=0.2, q=0.1)
RDT_MC = float(torch.tensor(0.05 / 3.0))  # r * dt, an f32 value


def _offset_row(x, offset):
    """``x`` copied into a fresh buffer at element ``offset``: a contiguous
    tensor of its shape whose base pointer is not 16-byte aligned for an
    offset not a multiple of 16 bytes."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    row = buf[offset:].view(x.shape)
    row.copy_(x)
    return row


# kernel 4 (and kernel 5 on the same rows) at path counts that leave a
# masked tail, every degree class and basis, with and without the knocked
# row, on 16-byte aligned rows and on rows offset by one element
@pytest.mark.parametrize("n", [100, 131_071])
@pytest.mark.parametrize("degree", [0, 4, 10])
@pytest.mark.parametrize("basis", ["power", "chebyshev", "legendre", "laguerre", "hermite"])
def test_step_kernels_shapes_match_plain(cuda_device, basis, degree, n):
    T, t = 20, 7
    paths = tgbm.gbm_paths(17, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T,
                                               device=cuda_device)
    use_w = torch.ones(T + 1, device=cuda_device)
    stats = tstep.step_stats(mean_t, inv_std_t, use_w, use_w)
    S_t = paths[t].contiguous()
    cf = torch.clamp_min(K - paths[-1], 0.0)
    tau = torch.full((n,), float(T), device=cuda_device)
    tau[::3] = float(t + 2)
    knocked = paths[: t + 1].min(dim=0).values < 95.0
    coeffs = torch.linspace(0.5, -0.2, degree + 1, device=cuda_device)
    mkw = dict(rdt=0.0005, K=K, phi=-1.0, basis=basis, degree=degree)
    akw = dict(K=K, phi=-1.0, basis=basis, degree=degree)
    for offset in (0, 1):
        rows = [_offset_row(x, offset) for x in (S_t, cf, tau)]
        kn_row = _offset_row(knocked, offset)
        assert offset == 0 or rows[0].data_ptr() % 16 != 0
        for kn in (None, kn_row):
            for itm in (False, True):
                before = tstep.step_moments.launches
                ker = tstep.step_moments(stats, t, *rows, kn, itm_weights=itm, **mkw)
                again = tstep.step_moments(stats, t, *rows, kn, itm_weights=itm, **mkw)
                ref = tstep.step_moments_reference(stats, t, *rows, kn, itm_weights=itm, **mkw)
                torch.cuda.synchronize()
                assert tstep.step_moments.launches == before + 2
                assert ker.shape == (tstep.pack_dim(degree + 1),)
                assert torch.equal(ker, again) and torch.equal(ker, ref)
            out_k = [x.clone() for x in rows[1:]] + [torch.empty_like(rows[0])]
            out_p = [x.clone() for x in rows[1:]] + [torch.empty_like(rows[0])]
            tstep.step_apply(stats, t, coeffs, rows[0], out_k[0], out_k[1], kn,
                             surface=out_k[2], **akw)
            tstep.step_apply_reference(stats, t, coeffs, rows[0], out_p[0], out_p[1], kn,
                                       surface=out_p[2], **akw)
            torch.cuda.synchronize()
            for a, b in zip(out_k, out_p):
                assert torch.equal(a, b)


# kernel 5 on its edges: every row (S_t, cf, tau, knocked, surface) offset
# by one element from a 16-byte base and n_paths no multiple of 4 (the
# one-access-a-path fallback and the masked tail), a step that is no
# exercise date with and without a surface row (the early return: cf and
# tau untouched), the surface alone (select=False) and NaN coefficients (no
# path exercises, the surface NaN); each against the plain version, to the
# bit
STEP_APPLY_CASES = {
    # (n_paths, row offset, allow_t at t, select, surface, NaN coefficients)
    "unaligned-rows": (131_071, 1, 1.0, True, True, False),
    "ragged-aligned": (131_073, 0, 1.0, True, True, False),
    "off-date-surface": (131_072, 0, 0.0, True, True, False),
    "off-date-no-surface": (131_072, 0, 0.0, True, False, False),
    "surface-only": (131_071, 1, 1.0, False, True, False),
    "nan-coefficients": (131_072, 0, 1.0, True, True, True),
}


@pytest.mark.parametrize("case", sorted(STEP_APPLY_CASES))
def test_step_apply_cases_match_plain(cuda_device, case):
    n, offset, allow, select, with_surface, nan = STEP_APPLY_CASES[case]
    T, t = 20, 7
    paths = tgbm.gbm_paths(23, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T,
                                               device=cuda_device)
    ones = torch.ones(T + 1, device=cuda_device)
    allow_t = ones.clone()
    allow_t[t] = allow
    stats = tstep.step_stats(mean_t, inv_std_t, ones, allow_t)
    cf = torch.clamp_min(K - paths[-1], 0.0)
    tau = torch.full((n,), float(T), device=cuda_device)
    knocked = paths[: t + 1].min(dim=0).values < 95.0
    coeffs = torch.tensor([4.0, -3.0, 1.0, 0.5, -0.25], device=cuda_device)
    if nan:
        coeffs[2] = float("nan")
    S_t = _offset_row(paths[t], offset)
    kn = _offset_row(knocked, offset)
    assert offset == 0 or S_t.data_ptr() % 16 != 0
    outs = []
    for apply_ in (tstep.step_apply, tstep.step_apply_reference):
        cf_x, tau_x = _offset_row(cf, offset), _offset_row(tau, offset)
        row = _offset_row(torch.full((n,), -1.0, device=cuda_device), offset)
        apply_(stats, t, coeffs, S_t, cf_x, tau_x, kn, K=K, phi=-1.0, select=select,
               surface=row if with_surface else None)
        outs.append((cf_x, tau_x, row))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    cf_k, tau_k, row_k = outs[0]
    exercised = int((tau_k == t).sum())
    if allow == 0.0 or not select or nan:
        assert torch.equal(cf_k, cf) and torch.equal(tau_k, tau) and exercised == 0
    else:
        assert exercised > 0
    if not with_surface:
        assert bool((row_k == -1.0).all())
    elif nan:
        assert bool(row_k.isnan().all())
    else:
        assert bool(torch.isfinite(row_k).all()) and bool((row_k >= 0).all())


@pytest.mark.parametrize("n", [131_071, 131_072])
def test_fused_launcher_matches_public_wrapper(cuda_device, n):
    # the fused loop's launcher (a plan of whole planes, then t and the
    # coefficients) against the public wrapper on each step's rows, on a
    # Bermudan down-in put with a surface: at n = 131,071 the rows past the
    # first are not 16-byte aligned, so alignment is decided each launch
    T = 50
    paths = tgbm.gbm_paths(29, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    spec = at.RegressionSpec(degree=4, regress_on="itm")
    kw = dict(barrier=95.0, barrier_type="down-in", exercise_steps=tuple(range(0, T, 5)),
              return_surface=True)
    before = tstep.step_apply.launches
    ker = at.backward_induction_fused(paths, R, 1.0 / T, K, -1.0, spec, **kw)
    torch.cuda.synchronize()
    assert tstep.step_apply.launches == before + T

    def public(stats, paths_, cf, tau, knocked, *, surface, **akw):
        def launch(t, coeffs):
            tstep.step_apply(stats, t, coeffs, paths_[t], cf, tau, knocked[t],
                             surface=surface[t], **akw)
        return launch

    rows = tfused._induction(tstep.step_moments, public, paths, R, 1.0 / T, K, -1.0, spec,
                             95.0, "down-in", True, True, None, tuple(range(0, T, 5)), False)
    ref = tfused.backward_induction_fused_reference(paths, R, 1.0 / T, K, -1.0, spec, **kw)
    torch.cuda.synchronize()
    assert int((ker.exercise_times < T).sum()) > 0
    for out in (rows, ref):
        for a, b in zip(ker[:5], out[:5]):
            assert torch.equal(a, b)


def test_step_moments_on_two_streams(cuda_device):
    # the kernel's ticket and partial rows are kept per stream: calls on a
    # side stream and on the default stream, unsynchronized between them,
    # each equal the plain version
    n, T, t = 131_072, 20, 9
    paths = tgbm.gbm_paths(19, S0, R, SIGMA, 0.0, 1.0, T, n, device=cuda_device)
    ones = torch.ones(T + 1, device=cuda_device)
    stats = tstep.step_stats(paths.mean(dim=1), 1.0 / paths.std(dim=1).clamp_min(1e-6), ones,
                             ones)
    cf = torch.clamp_min(K - paths[-1], 0.0)
    tau = torch.full((n,), float(T), device=cuda_device)
    kw = dict(rdt=0.0005, K=K, phi=-1.0, itm_weights=True)
    ref = tstep.step_moments_reference(stats, t, paths[t], cf, tau, **kw)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = []
    with torch.cuda.stream(side):
        outs += [tstep.step_moments(stats, t, paths[t], cf, tau, **kw) for _ in range(4)]
    outs += [tstep.step_moments(stats, t, paths[t], cf, tau, **kw) for _ in range(4)]
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, ref)


def _basket_paths(device, n, n_assets, seed, antithetic=False):
    sim = at.SimConfig(n_paths=n, n_steps=9, antithetic=antithetic)
    return at.simulate_gbm_multi(seed, [100.0] * n_assets, MC["r"], MC["sigma"], MC["T"], sim,
                                 q=MC["q"], device=device)


@pytest.mark.parametrize("n", [8_192, 131_072])
@pytest.mark.parametrize("itm", [False, True], ids=["all", "itm"])
def test_ma_step_kernels_match_plain(cuda_device, n, itm):
    # kernels 8+9 at 5 assets, m = 21: one step, then the whole fused
    # induction, against the plain versions on the same card - f64 moments
    # rounded once, -fmad=false and the same pinv_solve: identical bits
    paths = _basket_paths(cuda_device, n, 5, 21)
    spec = at.RegressionSpec(basis="chebyshev", degree=2, regress_on="itm" if itm else "all")
    mean_t, inv_std_t = tma.maxcall_standardization(paths, "sorted")
    stats = tma.ma_stats(mean_t, inv_std_t, MC["r"], 1.0 / 3.0, torch.ones(10, device=cuda_device))
    planes = paths.permute(0, 2, 1).contiguous()
    cf = tma._payoff_for(list(planes[9]), 100.0, "maxcall")
    tau = torch.full((n,), 9.0, device=cuda_device)
    kw = dict(K=100.0, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    before = (tma.ma_step_moments.launches, tma.ma_step_apply.launches)
    packed = tma.ma_step_moments(stats, 5, planes[5], cf, tau, rdt=RDT_MC, itm_weights=itm, **kw)
    ref = tma.ma_step_moments_reference(stats, 5, planes[5], cf, tau, rdt=RDT_MC,
                                        itm_weights=itm, **kw)
    coeffs = at.pinv_solve(*tstep.unpack_moments(ref, 21))
    cf_k, tau_k, cf_p, tau_p = cf.clone(), tau.clone(), cf.clone(), tau.clone()
    tma.ma_step_apply(stats, 5, coeffs, planes[5], cf_k, tau_k, **kw)
    tma.ma_step_apply_reference(stats, 5, coeffs, planes[5], cf_p, tau_p, **kw)
    torch.cuda.synchronize()
    assert (tma.ma_step_moments.launches, tma.ma_step_apply.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    assert packed.shape == (252,) and torch.equal(packed, ref)
    assert torch.equal(cf_k, cf_p) and torch.equal(tau_k, tau_p) and bool((tau_k == 5).any())
    ker = tmaxcall.backward_induction_fused_maxcall(paths, 100.0, 0.05, 1.0 / 3.0, spec)
    again = tmaxcall.backward_induction_fused_maxcall(paths, 100.0, 0.05, 1.0 / 3.0, spec)
    plain = tmaxcall.backward_induction_fused_maxcall_reference(paths, 100.0, 0.05, 1.0 / 3.0,
                                                                spec)
    torch.cuda.synchronize()
    for out in (again, plain):
        for a, b in zip(ker[:4], out[:4]):
            assert torch.equal(a, b)


# kernel 9 on its edges: 1, 2, 3, 5, 6, 7 and 8 assets, every payoff kind,
# m from 4 to 29, the sorted and plain bases and every basis family; each
# at aligned planes (the 16-byte loads), planes offset by one element and a
# ragged n_paths (one load a path, the masked tail), and on a step that is
# no exercise date (cf and tau untouched); each against the plain version,
# to the bit
MA_APPLY_CASES = {
    # (n_assets, payoff_kind, basis, degree, mode, sorted_basis, phi, strike)
    "1-asset-first": (1, "first", "laguerre", 4, "total", False, 1.0, 100.0),
    "2-assets-second": (2, "second", "power", 3, "total", False, 1.0, 100.0),
    "2-assets-spread": (2, "spread", "hermite", 4, "total", False, 1.0, 100.0),
    "3-assets-spreadk": (3, "spreadk", "legendre", 2, "total", False, 1.0, 2.0),
    "3-assets-geobasket-separable": (3, "geobasket", "chebyshev", 3, "separable", False, 1.0,
                                     100.0),
    "5-assets-maxcall-m21": (5, "maxcall", "chebyshev", 2, "total", True, 1.0, 100.0),
    # a put exercised early despite q > r: deep in the money
    "5-assets-basket-put": (5, "basket", "chebyshev", 2, "total", False, -1.0, 200.0),
    "6-assets-maxcall-m28": (6, "maxcall", "chebyshev", 2, "total", True, 1.0, 100.0),
    "7-assets-basket-m29": (7, "basket", "legendre", 4, "separable", False, 1.0, 100.0),
    "8-assets-maxcall-m25": (8, "maxcall", "chebyshev", 3, "separable", True, 1.0, 100.0),
}


@pytest.mark.parametrize("case", sorted(MA_APPLY_CASES))
def test_ma_step_apply_cases_match_plain(cuda_device, case):
    n_assets, kind, basis, degree, mode, sorted_basis, phi, strike = MA_APPLY_CASES[case]
    t = 4
    kw = dict(K=strike, phi=phi, basis=basis, degree=degree, mode=mode,
              sorted_basis=sorted_basis, payoff_kind=kind)
    m = tma.ma_params(n_assets, basis, degree, mode, sorted_basis, kind, strike, phi).n_cols
    for n, offset, allow in ((131_072, 0, 1.0), (131_072, 1, 1.0), (131_069, 0, 1.0),
                             (131_072, 0, 0.0)):
        paths = _basket_paths(cuda_device, n, n_assets, 37)
        mean_t, inv_std_t = tma.maxcall_standardization(paths, "sorted" if sorted_basis else mode)
        allow_t = torch.ones(10, device=cuda_device)
        allow_t[t] = allow
        stats = tma.ma_stats(mean_t, inv_std_t, MC["r"], 1.0 / 3.0, allow_t)
        planes = paths.permute(0, 2, 1).contiguous()
        cf = tma._payoff_for(list(planes[9]), strike, kind, phi)
        tau = torch.full((n,), 9.0, device=cuda_device)
        packed = tma.ma_step_moments_reference(stats, t, planes[t], cf, tau, rdt=RDT_MC, **kw)
        coeffs = at.pinv_solve(*tstep.unpack_moments(packed, m))
        step = _offset_row(planes[t], offset)
        assert offset == 0 or step.data_ptr() % 16 != 0
        cf_k, tau_k, cf_p, tau_p = cf.clone(), tau.clone(), cf.clone(), tau.clone()
        before = tma.ma_step_apply.launches
        tma.ma_step_apply(stats, t, coeffs, step, cf_k, tau_k, **kw)
        tma.ma_step_apply_reference(stats, t, coeffs, step, cf_p, tau_p, **kw)
        torch.cuda.synchronize()
        assert tma.ma_step_apply.launches == before + 1
        assert torch.equal(cf_k, cf_p) and torch.equal(tau_k, tau_p)
        exercised = int((tau_k == t).sum())
        assert exercised == 0 if allow == 0.0 else exercised > 0, (n, offset, allow, exercised)


def test_ma_step_apply_launcher_matches_public_wrapper(cuda_device):
    # the fused max-call loop's launcher (t and the coefficients) against
    # the public wrapper on each step's planes: 3-asset basket put, ragged
    # n_paths, so every step's planes are unaligned
    n = 131_069
    paths = _basket_paths(cuda_device, n, 3, 41)
    spec = at.RegressionSpec(basis="chebyshev", degree=3, regress_on="itm")
    args = (paths, 100.0, MC["r"], 1.0 / 3.0, spec, "total", 1, "basket", -1.0)

    def public(stats, planes, cf, tau, **akw):
        def launch(t, coeffs):
            tma.ma_step_apply(stats, t, coeffs, planes[t], cf, tau, **akw)
        return launch

    before = tma.ma_step_apply.launches
    ker = tmaxcall.backward_induction_fused_maxcall(*args)
    torch.cuda.synchronize()
    assert tma.ma_step_apply.launches == before + 9
    rows = tmaxcall._fused_maxcall(tma.ma_step_moments, public, *args)
    ref = tmaxcall.backward_induction_fused_maxcall_reference(*args)
    torch.cuda.synchronize()
    assert int((ker.exercise_times < 9).sum()) > 0
    for out in (rows, ref):
        for a, b in zip(ker[:4], out[:4]):
            assert torch.equal(a, b)


# the moments' tiles at the shapes that exercise their edges: X = [c w | y w
# | 0] has m + 1 columns in ceil((m + 1) / 8) blocks of 8, so m = 7 and 8
# (m + 1 = 8 and 9), 15 and 16 (16 and 17) lie on either side of a block
# edge, m = 21 and 22 fill 22 and 23 of 24 columns, m = 25, 28 and 29 take
# four blocks (29 the largest m any basis reaches under MAX_COLS = 32; 24
# and 32 are out of reach); each at a path count below one warp's 32 paths
# and at a ragged one
MA_MOMENTS_CASES = {
    # (n_assets, degree, mode, itm_weights, direct_y)
    "6-assets-m7-itm": (6, 1, "total", True, False),
    "7-assets-m8-all": (7, 1, "total", False, False),
    "4-assets-m15-itm-direct-y": (4, 2, "total", True, True),
    "5-assets-m16-all": (5, 3, "separable", False, False),
    "5-assets-m21-itm": (5, 2, "total", True, False),
    "7-assets-m22-itm": (7, 3, "separable", True, False),
    "6-assets-m28-direct-y": (6, 2, "total", False, True),
    "7-assets-m29-itm-direct-y": (7, 4, "separable", True, True),
    "8-assets-m25-all": (8, 3, "separable", False, False),
}


@pytest.mark.parametrize("n", [100, 131_071])
@pytest.mark.parametrize("case", sorted(MA_MOMENTS_CASES))
def test_ma_step_moments_shapes_match_plain(cuda_device, case, n):
    # exact products of the f32 columns summed in f64 and rounded once, in
    # any fixed order: identical bits to the plain version, and a rerun
    # identical
    n_assets, degree, mode, itm, direct_y = MA_MOMENTS_CASES[case]
    paths = _basket_paths(cuda_device, n, n_assets, 31)
    mean_t, inv_std_t = tma.maxcall_standardization(paths, "sorted")
    stats = tma.ma_stats(mean_t, inv_std_t, MC["r"], 1.0 / 3.0, torch.ones(10, device=cuda_device))
    planes = paths.permute(0, 2, 1).contiguous()
    cf = tma._payoff_for(list(planes[9]), 100.0, "maxcall")
    tau = torch.full((n,), 9.0, device=cuda_device)
    kw = dict(rdt=RDT_MC, K=100.0, basis="chebyshev", degree=degree, mode=mode,
              sorted_basis=True, itm_weights=itm, direct_y=direct_y)
    before = tma.ma_step_moments.launches
    packed = tma.ma_step_moments(stats, 4, planes[4], cf, tau, **kw)
    again = tma.ma_step_moments(stats, 4, planes[4], cf, tau, **kw)
    ref = tma.ma_step_moments_reference(stats, 4, planes[4], cf, tau, **kw)
    torch.cuda.synchronize()
    m = tma.ma_params(n_assets, "chebyshev", degree, mode, True, "maxcall", 100.0, 1.0).n_cols
    assert tma.ma_step_moments.launches == before + 2
    assert packed.shape == (tma.ma_pack_dim(m),) and bool(torch.isfinite(packed).all())
    assert torch.equal(packed, ref) and torch.equal(packed, again)


@pytest.mark.parametrize("case", sorted(MA_MOMENTS_CASES))
def test_ma_mega_kernel_tile_edges_match_plain(cuda_device, case):
    # kernel 7 on the shapes of the moments' tile edges at a ragged path
    # count: the plain version's price, stderr and cf/tau bits, and a rerun's
    n_assets, degree, mode, itm, _ = MA_MOMENTS_CASES[case]
    paths = _basket_paths(cuda_device, 131_071, n_assets, 32)
    args = (paths, 100.0, MC["r"], 1.0 / 3.0)
    kw = dict(degree=degree, mode=mode, sorted_basis=True, itm_weights=itm, exercise_from_step=1,
              return_cf_tau=True)
    ker = tmamega.lsmc_price_ma_mega(*args, **kw)
    again = tmamega.lsmc_price_ma_mega(*args, **kw)
    ref = tmamega.lsmc_price_ma_mega_reference(*args, **kw)
    torch.cuda.synchronize()
    assert math.isfinite(float(ker[0])) and float(ker[1]) > 0
    for out in (again, ref):
        for a, b in zip(ker, out):
            assert torch.equal(a, b)


@pytest.mark.parametrize("itm", [False, True], ids=["all", "itm"])
def test_ma_moments_tell_exact_from_f32_products(cuda_device, itm):
    # the crafted step of _ma_crafted, whose rhs sum Σ x y the f32 products
    # miss by 2^-12 of itself: kernel 8's packed moments and kernel 7's
    # coefficient row are the exact products' (the plain versions'), not
    # the f32 products', at a ragged path count; reruns identical
    x, stats, y = crafted.step_inputs(2_053, 1_031, 517, cuda_device)
    kw = dict(rdt=0.0, itm_weights=itm, direct_y=True, **crafted.STEP_KW)
    packed = tma.ma_step_moments(stats, 0, x, y, torch.zeros_like(y), **kw)
    again = tma.ma_step_moments(stats, 0, x, y, torch.zeros_like(y), **kw)
    ref = tma.ma_step_moments_reference(stats, 0, x, y, torch.zeros_like(y), **kw)
    cols = tma._columns(list(x), stats, 0, "power", 1, "total", False)
    w = (tma._payoff_for(list(x), crafted.STRIKE, "first") > 0.0).to(torch.float32) if itm \
        else None
    f32 = crafted.f32_product_moments(cols, y, w)
    torch.cuda.synchronize()
    assert torch.equal(packed, ref) and torch.equal(packed, again)
    assert not torch.equal(packed, f32) and float(packed[-1]) != float(f32[-1])

    paths = crafted.maturity_paths(2_053, 1_031, 517, cuda_device)
    planes, stats7, cfg = tmamega.prepare(paths, crafted.STRIKE, 0.0, 1.0, payoff_kind="first",
                                          basis="power", degree=1, itm_weights=itm)
    stats7 = stats7.clone()
    stats7[0], stats7[1] = 0.0, 1.0  # the frame: x = s exactly
    coeffs = torch.empty(4, device=cuda_device)  # rows t = 0 (solved) and t = 1 (not)
    coeffs_again = torch.empty(4, device=cuda_device)
    ker = tmamega._ma_mega_cuda(planes, stats7, cfg, False, False, coeffs=coeffs)
    tmamega._ma_mega_cuda(planes, stats7, cfg, False, False, coeffs=coeffs_again)
    plain = tmamega._ma_mega_reference(planes, stats7, cfg, False, False)
    cols = tma._columns(list(planes[0]), stats7, 0, "power", 1, "total", False)
    yv = stats7[2, 0] * tma._payoff_for(list(planes[1]), crafted.STRIKE, "first")
    w = (tma._payoff_for(list(planes[0]), crafted.STRIKE, "first") > 0.0).to(torch.float32) \
        if itm else None
    exact = torch.stack(tmega._solve_equilibrated_ridge(tma._moments_from_cols(cols, yv, w), 2,
                                                        cfg["rcond"]))
    rounded = torch.stack(tmega._solve_equilibrated_ridge(
        list(crafted.f32_product_moments(cols, yv, w)), 2, cfg["rcond"]))
    torch.cuda.synchronize()
    assert torch.equal(coeffs[:2], exact) and torch.equal(coeffs_again[:2], coeffs[:2])
    assert not torch.equal(rounded, exact)
    assert torch.equal(ker[0], plain[0])


MA_MEGA_CARD_CASES = {
    # (n_assets, payoff_kind, keywords)
    "maxcall-cf-tau": (5, "maxcall", dict(sorted_basis=True, return_cf_tau=True)),
    "maxcall-itm-antithetic": (5, "maxcall", dict(sorted_basis=True, itm_weights=True,
                                                  antithetic=True)),
    "basket-cf-tau": (5, "basket", dict(return_cf_tau=True)),
    "geobasket-separable": (3, "geobasket", dict(mode="separable", degree=3)),
    # every other payoff kind: the put on asset 0, the fixed-strike call on
    # asset 1, the spreads (m = 6, 10)
    "first-put-itm": (2, "first", dict(phi=-1.0, itm_weights=True, return_cf_tau=True)),
    "second-cf-tau": (2, "second", dict(return_cf_tau=True)),
    "spread": (2, "spread", dict(degree=3)),
    "spreadk-itm": (3, "spreadk", dict(itm_weights=True, degree=1, return_cf_tau=True)),
    # the widest systems any basis reaches under kMaxCols = 32 (four
    # 8-column blocks of X), m = 25 and 29 not multiples of 4, m = 28 one
    "8-assets-m25-itm": (8, "maxcall", dict(sorted_basis=True, mode="separable", degree=3,
                                            itm_weights=True, return_cf_tau=True)),
    "7-assets-m29-dates-off": (7, "basket", dict(mode="separable", degree=4,
                                                 exercise_steps=(2, 4, 7), return_cf_tau=True)),
    "6-assets-m28-antithetic": (6, "maxcall", dict(sorted_basis=True, antithetic=True,
                                                   return_cf_tau=True)),
}


@pytest.mark.parametrize("n", [8_192, 131_072])
@pytest.mark.parametrize("case", sorted(MA_MEGA_CARD_CASES))
def test_ma_mega_kernel_matches_plain(cuda_device, case, n):
    # kernel 7 against its plain version on the same card paths: identical
    # bits (price, stderr and the cf/tau planes), and a rerun identical
    n_assets, kind, kw = MA_MEGA_CARD_CASES[case]
    paths = _basket_paths(cuda_device, n, n_assets, 3, antithetic=kw.get("antithetic", False))
    args = (paths, 100.0, MC["r"], 1.0 / 3.0)
    kw = dict(dict(degree=2, exercise_from_step=1, payoff_kind=kind), **kw)
    before = tmamega.lsmc_price_ma_mega.launches
    ker = tmamega.lsmc_price_ma_mega(*args, **kw)
    again = tmamega.lsmc_price_ma_mega(*args, **kw)
    ref = tmamega.lsmc_price_ma_mega_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tmamega.lsmc_price_ma_mega.launches == before + 2
    assert math.isfinite(float(ker[0])) and float(ker[1]) > 0
    for out in (again, ref):
        for a, b in zip(ker, out):
            assert torch.equal(a, b)


# the kernel that builds the multi-asset inductions' inputs: its planes are
# the transpose's bits and its stats rows the plain version's (f64 sums of
# x and x^2 rounded once), at 1, 2, 5 and 8 assets, sorted and not, at a
# path count with a one-path tail tile (8,193: rows past step 0 are not
# 16-byte aligned at 1 and 2 assets) and at a multiple of the tile
@pytest.mark.parametrize("n", [8_193, 131_072])
@pytest.mark.parametrize("sorted_basis", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("n_assets", [1, 2, 5, 8])
def test_ma_prepare_matches_plain(cuda_device, n_assets, sorted_basis, n):
    paths = _basket_paths(cuda_device, n, n_assets, 43)
    allow = (torch.arange(10, device=cuda_device) >= 1).to(torch.float32)
    before = tma.ma_prepare.launches
    planes, stats = tma.ma_prepare(paths, MC["r"], 1.0 / 3.0, allow, sorted_basis=sorted_basis)
    ref_planes, ref_stats = tma.ma_prepare_reference(paths, MC["r"], 1.0 / 3.0, allow,
                                                     sorted_basis=sorted_basis)
    torch.cuda.synchronize()
    assert tma.ma_prepare.launches == before + 1
    assert torch.equal(planes, paths.permute(0, 2, 1).contiguous())
    assert torch.equal(planes, ref_planes)
    assert stats.shape == (2 * n_assets + 3, 10) and torch.equal(stats, ref_stats)


def test_ma_prepare_makes_no_host_wait(cuda_device):
    # the induction's inputs on the card: one launch, no synchronise and no
    # copy from the host
    paths = _basket_paths(cuda_device, 131_072, 5, 44)
    torch.cuda.synchronize()
    before = tma.ma_prepare.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        planes, stats, _ = tmamega.prepare(paths, 100.0, 0.0437, 1.0 / 3.0, payoff_kind="maxcall",
                                           degree=2, sorted_basis=True, exercise_from_step=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tma.ma_prepare.launches == before + 1
    assert planes.shape == (10, 5, 131_072) and bool(torch.isfinite(stats).all())


def test_price_max_call_mega_keeps_the_plain_bits(cuda_device):
    # the benchmark's route at 131,072 paths: kernel 7 on the kernel-built
    # inputs prices the bits of the plain induction on the plain inputs
    # (the transpose and the torch f64 frame, no ma_prepare launch) of the
    # same paths
    res, paths = at.price_max_call(45, [100.0] * 5, MC["K"], MC["T"], MC["r"], MC["sigma"],
                                   q=MC["q"], n_paths=131_072, engine="mega", return_paths=True,
                                   device=cuda_device)
    before = tma.ma_prepare.launches
    ref = tmamega.lsmc_price_ma_mega_reference(paths, MC["K"], MC["r"], MC["T"] / 9, degree=2,
                                               sorted_basis=True, exercise_from_step=1)
    torch.cuda.synchronize()
    assert tma.ma_prepare.launches == before
    assert torch.equal(res.price, ref[0]) and torch.equal(res.stderr, ref[1])


def test_price_max_call_routes_on_card(cuda_device):
    # the slice's entry point at 131k paths, 2 assets: mega and fused price
    # the same card paths within 5e-3 of each other and within 0.35 of the
    # Andersen-Broadie 13.90; each route launches its kernels
    tmamega.lsmc_price_ma_mega.launches = 0
    tma.ma_step_moments.launches = tma.ma_step_apply.launches = 0
    kw = dict(n_paths=131_072, q=MC["q"], return_paths=True, device=cuda_device)
    args = (7, [100.0, 100.0], MC["K"], MC["T"], MC["r"], MC["sigma"])
    mega, paths = at.price_max_call(*args, engine="mega", **kw)
    fused, paths_f = at.price_max_call(*args, engine="fused", **kw)
    torch.cuda.synchronize()
    assert tmamega.lsmc_price_ma_mega.launches == 1
    assert tma.ma_step_moments.launches == tma.ma_step_apply.launches == 9
    assert torch.equal(paths, paths_f) and paths.shape == (10, 131_072, 2)
    assert abs(float(mega.price) - float(fused.price)) <= 5e-3
    assert abs(float(mega.price) - 13.90) <= 0.35


# the basket pathgen kernel (csrc/gbm_multi.cu) against its plain chain:
# (n_assets, n_paths, corr, antithetic); 4,099 x 5 and 4,099 x 3 floats a
# row are no multiple of 4 (the float-at-a-time instance), 4,099 paths end
# in a part tile
CORR3 = [[1.0, 0.5, 0.2], [0.5, 1.0, 0.3], [0.2, 0.3, 1.0]]
GBM_MULTI_CARD_CASES = {
    "5-identity": (5, 65_536, None, False),
    "3-corr": (3, 65_536, CORR3, False),
    "5-antithetic": (5, 65_536, None, True),
    "5-ragged": (5, 4_099, None, False),
    "3-corr-ragged": (3, 4_099, CORR3, False),
    "1-identity": (1, 65_536, None, False),
    "8-corr": (8, 4_096, (np.eye(8) + 0.4) / 1.4, False),
}


@pytest.mark.parametrize("case", sorted(GBM_MULTI_CARD_CASES))
def test_gbm_multi_kernel_matches_the_chain(cuda_device, case):
    # simulate_gbm_multi launches the kernel once on the draw of its seed,
    # and the paths are the bits of the plain chain on the same normals
    # (expf and torch's CUDA exp agree; products and sums round alone)
    n_assets, n, corr, antithetic = GBM_MULTI_CARD_CASES[case]
    sim = at.SimConfig(n_paths=n, n_steps=9, antithetic=antithetic)
    S0 = [90.0 + 5.0 * a for a in range(n_assets)]
    args = (S0, MC["r"], MC["sigma"], MC["q"], MC["T"], corr)
    before = tgm.gbm_multi_paths.launches
    paths = at.simulate_gbm_multi(46, S0, MC["r"], MC["sigma"], MC["T"], sim, q=MC["q"],
                                  corr=corr, device=cuda_device)
    torch.cuda.synchronize()
    assert tgm.gbm_multi_paths.launches == before + 1
    g = torch.Generator(device=cuda_device)
    g.manual_seed(46)
    if antithetic:
        half = torch.randn((9, n // 2, n_assets), generator=g, device=cuda_device)
        Z = torch.cat([half, -half], dim=1)
    else:
        Z = torch.randn((9, n, n_assets), generator=g, device=cuda_device)
    want = tgm.gbm_multi_paths_reference(Z, *args)
    again = tgm.gbm_multi_paths(Z, *args)
    torch.cuda.synchronize()
    assert paths.shape == (10, n, n_assets) and bool(torch.isfinite(paths).all())
    assert torch.equal(paths, want) and torch.equal(again, want)


@pytest.mark.parametrize("T_", [3.0, 1.457604143493508])
def test_gbm_multi_host_rows_equal_the_card_chains_rows(cuda_device, T_):
    # at T = 1.4576... / 9 steps the CPU's f32 quotient differs from the
    # card's product with the reciprocal: the host rows take the card's
    market = ([95.0, 100.0, 105.0], [0.01, 0.03, 0.05], [0.15, 0.25, 0.4], 0.02, T_, 9)
    want = torch.stack(tgm._chain_rows(*market, torch.float32, cuda_device)).cpu().numpy()
    rows = tgm.host_rows(*market)
    np.testing.assert_array_equal(rows.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [47, 2_147_483_700])
def test_price_max_call_mega_keeps_the_parents_bits(cuda_device, seed):
    # the benchmark's route at 131,072 paths: one pathgen launch, no host
    # wait in the pricing, and the price and stderr of the route before the
    # kernel (the chain's paths of the same draw into kernel 7)
    kw = dict(q=MC["q"], n_paths=131_072, engine="mega", device=cuda_device)
    args = ([100.0] * 5, MC["K"], MC["T"], MC["r"], MC["sigma"])
    at.price_max_call(seed, *args, **kw)  # builds and loads the kernels
    torch.cuda.synchronize()
    before = tgm.gbm_multi_paths.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = at.price_max_call(seed, *args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tgm.gbm_multi_paths.launches == before + 1
    g = torch.Generator(device=cuda_device)
    g.manual_seed(seed)
    Z = torch.randn((9, 131_072, 5), generator=g, device=cuda_device)
    paths = tgm.gbm_multi_paths_reference(Z, [100.0] * 5, MC["r"], MC["sigma"], MC["q"], MC["T"])
    ref = tmamega.lsmc_price_ma_mega(paths, MC["K"], MC["r"], MC["T"] / 9, degree=2,
                                     sorted_basis=True, exercise_from_step=1)
    assert torch.equal(res.price, ref[0]) and torch.equal(res.stderr, ref[1])


def test_gbm_multi_chain_only_on_request(cuda_device):
    # the differentiable chain runs on the card only where its caller asks
    # for it (max_call_greeks), with no launch; elsewhere an input the
    # kernel cannot take (one that needs grad, a device tensor among the
    # scalars, a non-contiguous, float64 or 9-asset Z) raises, with no launch
    sim = at.SimConfig(n_paths=8_192, n_steps=9)
    market = (MC["r"], MC["sigma"], MC["T"], sim)
    before = tgm.gbm_multi_paths.launches
    S0 = torch.full((2,), 100.0, requires_grad=True)
    grad_paths = at.simulate_gbm_multi(48, S0, *market, q=MC["q"], device=cuda_device,
                                       differentiable=True)
    price, greeks = at.max_call_greeks(49, [100.0] * 2, MC["K"], MC["T"], MC["r"], MC["sigma"],
                                       q=MC["q"], n_paths=8_192, device=cuda_device)
    torch.cuda.synchronize()
    assert tgm.gbm_multi_paths.launches == before
    assert grad_paths.grad_fn is not None
    assert bool(torch.isfinite(price)) and greeks["delta"].shape == (2,)
    with pytest.raises(ValueError, match="host value"):
        at.simulate_gbm_multi(48, S0, *market, q=MC["q"], device=cuda_device)
    with pytest.raises(ValueError, match="host value"):
        at.simulate_gbm_multi(48, [100.0] * 2, MC["r"],
                              torch.tensor(MC["sigma"], device=cuda_device), MC["T"], sim,
                              q=MC["q"], device=cuda_device)
    assert tgm.gbm_multi_paths.launches == before
    kernel_paths = at.simulate_gbm_multi(48, [100.0] * 2, *market, q=MC["q"], device=cuda_device)
    assert tgm.gbm_multi_paths.launches == before + 1
    assert torch.equal(kernel_paths, grad_paths.detach())
    Z = torch.randn((9, 1_024, 5), device=cuda_device)
    args = ([100.0] * 5, MC["r"], MC["sigma"], MC["q"], MC["T"])
    for bad, match in ((Z.transpose(0, 1), "contiguous"), (Z.double(), "float32"),
                       (torch.randn((9, 1_024, 9), device=cuda_device), "1..8 assets")):
        with pytest.raises(ValueError, match=match):
            tgm.gbm_multi_paths(bad, *args)
    assert tgm.gbm_multi_paths.launches == before + 1


# kernel 3: the four cases of chip_smoke.py phase 11 (book-16-1M's market,
# S0 = 95, r = 1%, sigma = 20%, T = 1, at 131,072 paths x 100 steps)
BOOK_MARKET = at.MarketParams(95.0, 0.01, 0.2)
BOOK_CARD_CASES = {
    # (strikes, phi, keywords, antithetic torch paths)
    "put-ladder-cf-tau": (torch.linspace(80.0, 120.0, 16), -1.0, dict(return_cf_tau=True),
                          False),
    "put-call": (torch.linspace(85.0, 115.0, 8), torch.tensor([-1.0] * 4 + [1.0] * 4), {},
                 False),
    "down-in-80": (torch.linspace(80.0, 120.0, 16), -1.0, dict(barrier=80.0), False),
    "mixed-maturity-antithetic": (torch.linspace(85.0, 115.0, 4), -1.0,
                                  dict(maturity_steps=(25, 50, 75, 100), antithetic=True,
                                       return_cf_tau=True), True),
}


def _book_paths(device, n, seed, antithetic):
    sim = at.SimConfig(n_paths=n, n_steps=100, backend="torch" if antithetic else "philox",
                       antithetic=antithetic)
    return at.simulate_gbm(seed, BOOK_MARKET, 1.0, sim, device=device)


@pytest.mark.parametrize("case", sorted(BOOK_CARD_CASES))
def test_book_kernel_matches_plain(cuda_device, case):
    # kernel 3 against its plain version on the same card paths: f64 moments
    # rounded once, -fmad=false and the same factor and back-solve order:
    # identical prices, stderrs and cf/tau planes, and a rerun identical
    strikes, phi, kw, antithetic = BOOK_CARD_CASES[case]
    paths = _book_paths(cuda_device, 131_072, 9, antithetic)
    mean_t, inv_std_t = at.gbm_standardization(BOOK_MARKET, 1.0, 100, device=cuda_device)
    args = (paths, strikes, 0.01, 0.01, phi)
    kw = dict(kw, mean_t=mean_t, inv_std_t=inv_std_t)
    before = tmega.lsmc_book_megakernel.launches
    ker = tmega.lsmc_book_megakernel(*args, **kw)
    again = tmega.lsmc_book_megakernel(*args, **kw)
    ref = tmega.lsmc_book_mega_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tmega.lsmc_book_megakernel.launches == before + 2
    assert bool(torch.isfinite(ker[0]).all()) and bool((ker[1] > 0).all())
    for out in (again, ref):
        for a, b in zip(ker, out):
            assert torch.equal(a, b)


# kernel 3's one-pass step at the shapes that exercise its edges: degree 10 x
# 64 strikes (2 options a role, 4 Gram roles, 36 roles in 5 groups), odd
# path counts (scalar loads and stores, a ragged last chunk), and a
# European book whose short maturities run the apply-only pass
BOOK_SHAPE_CASES = {
    # (n_paths, strikes, phi, keywords)
    "degree10-64-strikes": (65_536, torch.linspace(70.0, 130.0, 64), -1.0,
                            dict(degree=10, return_cf_tau=True)),
    "odd-paths-down-in-cf-tau": (131_071, torch.linspace(80.0, 120.0, 16), -1.0,
                                 dict(barrier=80.0, return_cf_tau=True)),
    "odd-paths-put-call-mixed": (1_001, torch.linspace(85.0, 115.0, 6),
                                 torch.tensor([-1.0, 1.0] * 3),
                                 dict(maturity_steps=(10, 100, 40, 100, 70, 100))),
    "european-short-maturities": (131_072, torch.linspace(115.0, 85.0, 5), -1.0,
                                  dict(american=False, maturity_steps=(1, 2, 10, 50, 100),
                                       return_cf_tau=True)),
}


@pytest.mark.parametrize("case", sorted(BOOK_SHAPE_CASES))
def test_book_kernel_shapes_match_plain(cuda_device, case):
    n, strikes, phi, kw = BOOK_SHAPE_CASES[case]
    paths = _book_paths(cuda_device, n, 13, False)
    mean_t, inv_std_t = at.gbm_standardization(BOOK_MARKET, 1.0, 100, device=cuda_device)
    args = (paths, strikes, 0.01, 0.01, phi)
    kw = dict(kw, mean_t=mean_t, inv_std_t=inv_std_t)
    before = tmega.lsmc_book_megakernel.launches
    ker = tmega.lsmc_book_megakernel(*args, **kw)
    again = tmega.lsmc_book_megakernel(*args, **kw)
    ref = tmega.lsmc_book_mega_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tmega.lsmc_book_megakernel.launches == before + 2
    assert bool(torch.isfinite(ker[0]).all()) and bool((ker[1] > 0).all())
    for out in (again, ref):
        for a, b in zip(ker, out):
            assert torch.equal(a, b)


def test_book_kernel_unaligned_paths(cuda_device):
    # paths whose base is offset by one element: the moments' copies take
    # 4 bytes a path (16-byte copies need an aligned row), with the same bits
    n, T = 65_536, 100
    paths = _book_paths(cuda_device, n, 14, False)
    flat = torch.empty(paths.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(T + 1, n)
    shifted.copy_(paths)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    mean_t, inv_std_t = at.gbm_standardization(BOOK_MARKET, 1.0, T, device=cuda_device)
    args = (torch.linspace(80.0, 120.0, 16), 0.01, 0.01, -1.0)
    kw = dict(mean_t=mean_t, inv_std_t=inv_std_t, return_cf_tau=True)
    ker = tmega.lsmc_book_megakernel(shifted, *args, **kw)
    aligned = tmega.lsmc_book_megakernel(paths, *args, **kw)
    ref = tmega.lsmc_book_mega_reference(shifted, *args, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(ker, aligned, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_book_kernel_strike_cap(cuda_device):
    paths = _book_paths(cuda_device, 1024, 3, False)
    with pytest.raises(ValueError, match="1[.][.]64"):
        tmega.lsmc_book_megakernel(paths, torch.linspace(80.0, 120.0, 65), 0.01, 0.01, -1.0)
    prices, _ = tmega.lsmc_book_megakernel(paths, torch.linspace(80.0, 120.0, 64), 0.01, 0.01,
                                           -1.0)
    assert prices.shape == (64,) and bool(torch.isfinite(prices).all())


# kernel 6: the five cases of chip_smoke.py phase 13 (the flagship market,
# S0 = K = 100, r = 1%, sigma = 20%, T = 1, Chebyshev degree 4) at 131,072
# paths x 100 steps
FP_ARGS = (S0, K, R, SIGMA, 0.01, 100)
FP_CARD_CASES = {
    "itm-cf-tau-coeffs": (21, dict(itm_weights=True, return_cf_tau=True, return_coeffs=True)),
    "all-paths": (22, dict(return_coeffs=True)),
    "down-in-90": (23, dict(itm_weights=True, barrier=90.0, return_cf_tau=True,
                            return_coeffs=True)),
    "bermudan-antithetic": (24, dict(itm_weights=True, exercise_steps=tuple(range(0, 100, 10)),
                                     antithetic=True, return_cf_tau=True, return_coeffs=True)),
    "replay": (25, dict(return_cf_tau=True)),
}


@pytest.mark.parametrize("case", sorted(FP_CARD_CASES))
def test_fusedpath_kernel_matches_plain(cuda_device, case):
    # kernel 6 against its plain version on the same seed: the same Philox
    # normals (logf, sqrtf, cosf/sinf of one f32 angle), the same bridge and
    # spot arithmetic under -fmad=false, f64 moments rounded once: identical
    # prices, stderrs, cf/tau planes and coefficients, and a rerun identical
    n = 131_072
    seed, kw = FP_CARD_CASES[case]
    if case == "replay":
        fit = tfp.lsmc_price_fusedpath(21, *FP_ARGS, n, -1.0, itm_weights=True,
                                       return_coeffs=True, device=cuda_device)
        kw = dict(kw, replay_coeffs=fit.coeffs)
    args = (seed, *FP_ARGS, n, -1.0)
    before = tfp.lsmc_price_fusedpath.launches
    ker = tfp.lsmc_price_fusedpath(*args, **kw, device=cuda_device)
    again = tfp.lsmc_price_fusedpath(*args, **kw, device=cuda_device)
    ref = tfp.lsmc_price_fusedpath_reference(*args, **kw, device=cuda_device)
    torch.cuda.synchronize()
    assert tfp.lsmc_price_fusedpath.launches == before + 2
    assert math.isfinite(float(ker.price)) and float(ker.stderr) > 0
    if ker.exercise_times is not None:
        assert int((ker.exercise_times < 100).sum()) > 0  # early exercise happened
    for out in (again, ref):
        for a, b in zip(ker, out):
            assert (a is None and b is None) or torch.equal(a, b)


def test_fusedpath_kernel_matches_kernel_2(cuda_device):
    # the paths kernel 6 regenerates, materialised by the plain recursion,
    # priced by kernel 2 in the same frame with the same discount rows:
    # the same bits as kernel 6 itself
    n = 131_072
    paths = tfp.fusedpath_paths_reference(31, S0, R, SIGMA, 0.01, 100, n, device=cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, 100,
                                               device=cuda_device)
    mega = tmega.lsmc_price_megakernel(paths, K, R, 0.01, -1.0, itm_weights=True,
                                       mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True,
                                       return_cf_tau=True)
    fp = tfp.lsmc_price_fusedpath(31, *FP_ARGS, n, -1.0, itm_weights=True, return_coeffs=True,
                                  return_cf_tau=True, device=cuda_device)
    torch.cuda.synchronize()
    for a, b in zip(mega, fp):
        assert torch.equal(a, b)


FP_DEGREE_CASES = {
    "down-in-90": (26, dict(itm_weights=True, barrier=90.0, return_cf_tau=True,
                            return_coeffs=True)),
    "bermudan-antithetic": (27, dict(itm_weights=True, exercise_steps=tuple(range(0, 100, 10)),
                                     antithetic=True, return_cf_tau=True, return_coeffs=True)),
    "replay": (28, dict(return_cf_tau=True)),
}


def _fusedpath_equal_to_plain(dev, seed, n, kw, n_steps=100):
    args = (seed, S0, K, R, SIGMA, 1.0 / n_steps, n_steps, n, -1.0)
    ker = tfp.lsmc_price_fusedpath(*args, **kw, device=dev)
    ref = tfp.lsmc_price_fusedpath_reference(*args, **kw, device=dev)
    torch.cuda.synchronize()
    assert math.isfinite(float(ker.price)) and float(ker.stderr) > 0
    for a, b in zip(ker, ref):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("degree", [0, 10])
@pytest.mark.parametrize("case", sorted(FP_DEGREE_CASES))
def test_fusedpath_kernel_degrees_match_plain(cuda_device, case, degree):
    # the cooperative kernel at the smallest and the largest degree (one
    # column; 77 moments, a block an SM), 131,072 paths x 100 steps
    seed, kw = FP_DEGREE_CASES[case]
    kw = dict(kw, degree=degree)
    if case == "replay":
        fit = tfp.lsmc_price_fusedpath(21, *FP_ARGS, 131_072, -1.0, itm_weights=True,
                                       degree=degree, return_coeffs=True, device=cuda_device)
        kw = dict(kw, replay_coeffs=fit.coeffs)
    _fusedpath_equal_to_plain(cuda_device, seed, 131_072, kw)


@pytest.mark.parametrize("case", sorted(FP_CARD_CASES))
def test_fusedpath_kernel_global_planes_match_plain(cuda_device, case, monkeypatch):
    # every quad past the first shared-memory slot goes through the global
    # planes (the path that large n_paths take), on 1,000,008 paths (an
    # uneven grid) x 20 steps
    plan = tfp._fusedpath_plan

    def one_slot(*args):
        n_blocks, chip, needed = plan(*args)
        return n_blocks, min(chip, 2 if args[1] else 1), needed

    monkeypatch.setattr(tfp, "_fusedpath_plan", one_slot)
    seed, kw = FP_CARD_CASES[case]
    kw = dict(kw)
    n = 1_000_008
    if "exercise_steps" in kw:
        kw["exercise_steps"] = (0, 5, 10, 15)
    if case == "replay":
        fit = tfp.lsmc_price_fusedpath(21, S0, K, R, SIGMA, 0.05, 20, n, -1.0, itm_weights=True,
                                       return_coeffs=True, device=cuda_device)
        kw = dict(kw, replay_coeffs=fit.coeffs)
    _fusedpath_equal_to_plain(cuda_device, seed, n, kw, n_steps=20)


def test_fusedpath_kernel_large_n_matches_plain(cuda_device):
    # 8,388,608 paths: more quads than the grid's shared memory holds, so the
    # plan itself sends the rest to the global planes
    _fusedpath_equal_to_plain(cuda_device, 29, 1 << 23,
                              dict(itm_weights=True, return_cf_tau=True, return_coeffs=True),
                              n_steps=4)


def test_fusedpath_refused_cooperative_launch_raises(cuda_device, monkeypatch):
    # a grid larger than the card holds at once is refused by the runtime:
    # the wrapper raises, it never runs the pricing another way
    monkeypatch.setattr(tfp, "_fusedpath_plan", lambda *args: (100_000, 1, 1))
    before = tfp.lsmc_price_fusedpath.launches
    with pytest.raises(RuntimeError, match="amcx_lsmc_fusedpath"):
        tfp.lsmc_price_fusedpath(1, *FP_ARGS, 1 << 20, -1.0, device=cuda_device)
    assert tfp.lsmc_price_fusedpath.launches == before + 1


def test_fusedpath_wrapper_rejects_bad_inputs(cuda_device):
    with pytest.raises(TypeError, match="integer seed"):
        tfp.lsmc_price_fusedpath(torch.Generator(), *FP_ARGS, 1024, -1.0, device=cuda_device)
    with pytest.raises(ValueError, match="divisible by 8"):
        tfp.lsmc_price_fusedpath(1, *FP_ARGS, 1028, -1.0, antithetic=True, device=cuda_device)
    with pytest.raises(ValueError, match="divisible by 4"):
        tfp.lsmc_price_fusedpath(1, *FP_ARGS, 1026, -1.0, device=cuda_device)


# kernel 10: the swing induction (3 rights, the published put K = 105, r = 5%,
# sigma = 25%) on 131,072 paths x 50 steps
SW_MARKET = at.MarketParams(100.0, 0.05, 0.25)
SW_CASES = {
    "3-rights-itm": (41, 3, dict(itm_weights=True), False),
    "forward-owed-2-antithetic": (42, 3, dict(payoff_kind="forward", n_min=2, degree=5), True),
    "rate-curve-2-rights": (43, 2, dict(itm_weights=True), False),
}


def _swing_paths(device, seed, n, T, antithetic):
    sim = at.SimConfig(n_paths=n, n_steps=T, antithetic=antithetic)
    return at.simulate_gbm(torch.Generator(device=device).manual_seed(seed), SW_MARKET, 1.0,
                           sim, device)


@pytest.mark.parametrize("case", sorted(SW_CASES))
def test_swing_kernel_matches_plain(cuda_device, case):
    seed, n_rights, kw, antithetic = SW_CASES[case]
    T = 50
    paths = _swing_paths(cuda_device, seed, 131_072, T, antithetic)
    mean_t, inv_std_t = at.gbm_standardization(SW_MARKET, 1.0, T, device=cuda_device)
    r = (torch.tensor([0.03] * (T // 2) + [0.08] * (T // 2), device=cuda_device)
         if case.startswith("rate-curve") else 0.05)
    K = 100.0 if kw.get("payoff_kind") == "forward" else 105.0
    args = (paths, K, r, 1.0 / T, -1.0, n_rights)
    kw = dict(kw, mean_t=mean_t, inv_std_t=inv_std_t, antithetic=antithetic)
    before = tsw.lsmc_price_swing.launches
    ker = tsw.lsmc_price_swing(*args, **kw)
    again = tsw.lsmc_price_swing(*args, **kw)
    ref = tsw.lsmc_price_swing_reference(*args, **kw)
    torch.cuda.synchronize()
    assert tsw.lsmc_price_swing.launches == before + 2
    assert math.isfinite(float(ker[0])) and float(ker[1]) > 0
    for a, b, c in zip(ker, again, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_swing_kernel_one_right_equals_kernel_2(cuda_device):
    T = 100
    paths = _swing_paths(cuda_device, 44, 131_072, T, False)
    mean_t, inv_std_t = at.gbm_standardization(SW_MARKET, 1.0, T, device=cuda_device)
    kw = dict(itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t)
    swing = tsw.lsmc_price_swing(paths, 105.0, 0.05, 1.0 / T, -1.0, 1, **kw)
    single = tmega.lsmc_price_megakernel(paths, 105.0, 0.05, 1.0 / T, -1.0, return_stats=True,
                                         **kw)
    torch.cuda.synchronize()
    assert torch.equal(swing[0], single[0]) and torch.equal(swing[1], single[1])


def test_swing_kernel_rights_cap(cuda_device):
    cap = tsw.SWING_MAX_RIGHTS
    paths = _swing_paths(cuda_device, 45, 65_536, 8, False)
    with pytest.raises(ValueError, match=f"cap of {cap}"):
        tsw.lsmc_price_swing(paths, 100.0, 0.05, 0.125, -1.0, cap + 1)
    kw = dict(degree=10, payoff_kind="forward", n_min=3)
    ker = tsw.lsmc_price_swing(paths, 100.0, 0.05, 0.125, -1.0, cap, **kw)
    ref = tsw.lsmc_price_swing_reference(paths, 100.0, 0.05, 0.125, -1.0, cap, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ker[0], ref[0]) and torch.equal(ker[1], ref[1])


# kernel 10 at path counts that leave a masked tail (antithetic pairs where
# the count is even), 1 to 128 rights, both payoff kinds: the option kind
# with ITM weights at degree 4, the forward kind with owed takes at degree 8
# (K = 9: the Gram split over rows of roles)
@pytest.mark.parametrize("n", [100, 131_071])
@pytest.mark.parametrize("n_rights", [1, 3, 11, 128])
@pytest.mark.parametrize("kind", ["option", "forward"])
def test_swing_kernel_shapes_match_plain(cuda_device, kind, n_rights, n):
    T = 12
    antithetic = n % 2 == 0
    paths = _swing_paths(cuda_device, 46, n, T, antithetic)
    mean_t, inv_std_t = at.gbm_standardization(SW_MARKET, 1.0, T, device=cuda_device)
    if kind == "option":
        K, kw = 105.0, dict(itm_weights=True)
    else:
        K, kw = 100.0, dict(payoff_kind="forward", n_min=min(n_rights, 3), degree=8)
    args = (paths, K, 0.05, 1.0 / T, -1.0, n_rights)
    kw = dict(kw, mean_t=mean_t, inv_std_t=inv_std_t, antithetic=antithetic)
    ker = tsw.lsmc_price_swing(*args, **kw)
    again = tsw.lsmc_price_swing(*args, **kw)
    ref = tsw.lsmc_price_swing_reference(*args, **kw)
    torch.cuda.synchronize()
    assert math.isfinite(float(ker[0]))
    for a, b, c in zip(ker, again, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_swing_kernel_unaligned_paths(cuda_device):
    # paths whose base is offset by one element: every row is read by the
    # 4-byte copies and loads, with the same bits
    n, T = 131_072, 20
    paths = _swing_paths(cuda_device, 47, n, T, False)
    flat = torch.empty(paths.numel() + 1, device=cuda_device)
    shifted = flat[1:].view(T + 1, n)
    shifted.copy_(paths)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    mean_t, inv_std_t = at.gbm_standardization(SW_MARKET, 1.0, T, device=cuda_device)
    kw = dict(itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t)
    ker = tsw.lsmc_price_swing(shifted, 105.0, 0.05, 1.0 / T, -1.0, 3, **kw)
    aligned = tsw.lsmc_price_swing(paths, 105.0, 0.05, 1.0 / T, -1.0, 3, **kw)
    ref = tsw.lsmc_price_swing_reference(shifted, 105.0, 0.05, 1.0 / T, -1.0, 3, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(ker, aligned, ref):
        assert torch.equal(a, b) and torch.equal(a, c)


# kernel 11's bridge order at several step counts up to its cap, 65,536 paths
@pytest.mark.parametrize("n_steps", [1, 7, 20, 225, tsp.BRIDGE_MAX_STEPS])
def test_sobol_bridge_kernel_step_counts_match_plain(cuda_device, n_steps):
    args = (10, 100.0, 0.01, 0.2, 0.0, 1.0, n_steps, 65_536)
    ker = tsp.sobol_gbm_paths(*args, brownian_bridge=True, device=cuda_device)
    ref = tsp.sobol_gbm_paths_reference(*args, brownian_bridge=True, device=cuda_device)
    torch.cuda.synchronize()
    assert ker.shape == (n_steps + 1, 65_536) and bool(torch.isfinite(ker).all())
    assert torch.equal(ker, ref)


# kernel 11: scrambled-Sobol paths, both orders, at 262,144 paths x 100 steps
@pytest.mark.parametrize("bridge", [False, True])
def test_sobol_kernel_matches_plain(cuda_device, bridge):
    args = (9, 100.0, 0.01, 0.2, 0.0, 1.0, 100, 262_144)
    before = tsp.sobol_gbm_paths.launches
    ker = tsp.sobol_gbm_paths(*args, brownian_bridge=bridge, device=cuda_device)
    ref = tsp.sobol_gbm_paths_reference(*args, brownian_bridge=bridge, device=cuda_device)
    torch.cuda.synchronize()
    assert tsp.sobol_gbm_paths.launches == before + 1
    assert ker.shape == (101, 262_144) and bool(torch.isfinite(ker).all())
    assert torch.equal(ker, ref)


# kernel 11's increment order (the tail form only where selected) at step
# counts that fill no chunk of 4 steps, some chunks and a partial one, and
# many
@pytest.mark.parametrize("n_steps", [1, 7, 20, 225, 1000])
def test_sobol_increment_kernel_step_counts_match_plain(cuda_device, n_steps):
    args = (10, 100.0, 0.01, 0.2, 0.0, 1.0, n_steps, 65_536)
    ker = tsp.sobol_gbm_paths(*args, device=cuda_device)
    again = tsp.sobol_gbm_paths(*args, device=cuda_device)
    ref = tsp.sobol_gbm_paths_reference(*args, device=cuda_device)
    torch.cuda.synchronize()
    assert ker.shape == (n_steps + 1, 65_536) and bool(torch.isfinite(ker).all())
    assert torch.equal(ker, ref) and torch.equal(ker, again)


def test_sobol_increment_kernel_every_mantissa(cuda_device):
    # tables whose points cover all 2^23 mantissas the uniform reads
    # (u = g << 16 | i << 7 over 16,384 columns g and 512 lanes i), one
    # step, 2^23 paths: every tail point and every central point the kernel
    # can meet, against the plain version on the same tables
    n = 1 << 23
    u_hi = torch.from_numpy((np.arange(n // 512, dtype=np.uint32) << 16)[None].view(np.int32))
    u_lo = torch.from_numpy((np.arange(512, dtype=np.uint32) << 7)[None].view(np.int32))
    S0_, drift, vol = 100.0, -1e-4, 0.02
    hi, lo = u_hi.to(cuda_device), u_lo.to(cuda_device)
    ker = torch.empty((2, n), dtype=torch.float32, device=cuda_device)
    before = tsp.sobol_gbm_paths.launches
    tsp._launch(hi, lo, None, ker, 1, n, S0_, drift, vol)
    ref = tsp.paths_from_tables_reference(u_hi, u_lo, S0_, drift, vol, 1, n, device=cuda_device)
    torch.cuda.synchronize()
    assert tsp.sobol_gbm_paths.launches == before + 1
    assert torch.equal(ker, ref)


@pytest.mark.parametrize("offset", ["out", "u_lo"])
def test_sobol_increment_kernel_refuses_unaligned_bases(cuda_device, offset):
    # the increment order reads u_lo and writes out in 16-byte accesses: a
    # base one float past an aligned one is refused before any launch, and
    # the next call on aligned tensors still runs and agrees with the plain
    # version (no fault was left on the context)
    n_steps, n_paths = 4, 1024
    hi, lo = tsp._device_tables(5, n_steps, n_paths, cuda_device)
    out = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=cuda_device)
    bad_out = torch.empty(out.numel() + 1, dtype=torch.float32, device=cuda_device)[1:]
    bad_lo = torch.empty(lo.numel() + 1, dtype=torch.int32, device=cuda_device)[1:]
    bad_lo.copy_(lo.flatten())
    args = (hi, bad_lo.view_as(lo), None, out) if offset == "u_lo" else \
        (hi, lo, None, bad_out.view_as(out))
    before = tsp.sobol_gbm_paths.launches
    with pytest.raises(RuntimeError, match="amcx_sobol_gbm_paths: CUDA error"):
        tsp._launch(*args, n_steps, n_paths, 100.0, -1e-4, 0.02)
    tsp._launch(hi, lo, None, out, n_steps, n_paths, 100.0, -1e-4, 0.02)
    ref = tsp.paths_from_tables_reference(hi, lo, 100.0, -1e-4, 0.02, n_steps, n_paths,
                                          device=cuda_device)
    torch.cuda.synchronize()
    assert tsp.sobol_gbm_paths.launches == before + 2
    assert torch.equal(out, ref)


def test_sobol_kernel_cached_seed_copies_nothing(cuda_device):
    # a second call with the same seed finds its tables (and, in bridge
    # order, its schedule) on the card: no host-to-device copy
    from torch.profiler import ProfilerActivity, profile

    args = (31, 100.0, 0.01, 0.2, 0.0, 1.0, 20, 65_536)
    for bridge in (False, True):
        first = tsp.sobol_gbm_paths(*args, brownian_bridge=bridge, device=cuda_device)
        torch.cuda.synchronize()
        hits = tsp._device_tables.cache_info().hits
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            second = tsp.sobol_gbm_paths(*args, brownian_bridge=bridge, device=cuda_device)
            torch.cuda.synchronize()
        assert tsp._device_tables.cache_info().hits == hits + 1
        assert not [e.name for e in prof.events() if "HtoD" in e.name]
        assert torch.equal(first, second)


# a new seed's tables built on the card (sobol_tables_kernel) against the
# host's plain build, bit for bit: one dimension of 512 points, the
# cell's 100 x 2^20, 1,000 steps (with the paths in increment order), a
# ragged 3 x 512 paths and 2^30 paths (u_hi's columns over 512 blocks)
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 4321, 2 ** 41 + 99])
@pytest.mark.parametrize("n_steps, n_paths", [(1, 512), (24, 16_384), (100, 1 << 20),
                                              (1000, 4096), (100, 3 * 512), (2, 1 << 30)])
def test_sobol_table_kernel_matches_plain(cuda_device, seed, n_steps, n_paths):
    before = tsp.sobol_tables.launches
    hi, lo = tsp.sobol_tables(seed, n_steps, n_paths, cuda_device)
    want_hi, want_lo = tsp._direction_tables(seed, n_steps, n_paths)
    torch.cuda.synchronize()
    assert tsp.sobol_tables.launches == before + 1
    assert hi.shape == (n_steps, n_paths // 512) and lo.shape == (n_steps, 512)
    assert np.array_equal(hi.cpu().numpy().view(np.uint32), want_hi)
    assert np.array_equal(lo.cpu().numpy().view(np.uint32), want_lo)
    if n_steps == 1000:
        args = (seed, 100.0, 0.01, 0.2, 0.0, 1.0, n_steps, n_paths)
        ker = tsp.sobol_gbm_paths(*args, device=cuda_device)
        assert torch.equal(ker, tsp.sobol_gbm_paths_reference(*args, device=cuda_device))


def test_sobol_new_seed_builds_on_the_card_without_a_copy(cuda_device):
    # a new seed: one table kernel, one table build, no host-to-device copy
    # and no wait but the test's own synchronise; the same seed again:
    # nothing launched, the same tensors
    from torch.profiler import ProfilerActivity, profile

    n_steps, n_paths, seed = 100, 1 << 20, 2 ** 40 + 21
    tsp._device_tables.cache_clear()
    tsp.sobol_tables(seed + 1, n_steps, n_paths, cuda_device)  # the direction numbers, once
    torch.cuda.synchronize()

    def counts():
        return tsp.sobol_tables.launches, tsp.sobol_gbm_paths.table_builds

    def traced():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tables = tsp._device_tables(seed, n_steps, n_paths, cuda_device)
            torch.cuda.synchronize()
        events = prof.events()
        device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
        return tables, device, host

    before = counts()
    first, device, host = traced()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert [n for n in device if "sobol_tables_kernel" in n] and \
        not [n for n in device if "sobol_tables_kernel" not in n]
    assert not [n for n in device + host if "HtoD" in n or n.startswith("cudaMemcpy")]
    assert not [n for n in host if "Synchronize" in n and n != "cudaDeviceSynchronize"]
    again, device, host = traced()
    assert counts() == (before[0] + 1, before[1] + 1) and not device
    assert again[0] is first[0] and again[1] is first[1]


# price_option(engine="mega") of the flagship put (1M x 100) at seed 2^31 +
# 4321, priced on an NVIDIA H100 80GB HBM3 with the tables the host built
# before the card built them: float.hex of the price and stderr
RQMC_MEGA_BITS = {
    "sobol": ("0x1.e069f40000000p+2", "0x1.183fdc0000000p-7"),
    "sobol-bridge": ("0x1.e075700000000p+2", "0x1.1897ba0000000p-7"),
}


@pytest.mark.parametrize("backend", sorted(RQMC_MEGA_BITS))
def test_rqmc_mega_keeps_the_host_tables_bits(cuda_device, backend):
    sim = at.SimConfig(n_paths=1 << 20, n_steps=100, backend=backend)
    product = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    res = at.price_option(2 ** 31 + 4321, at.MarketParams(S0, R, SIGMA), product,
                          at.RegressionSpec(degree=4), sim, engine="mega", device=cuda_device)
    assert (float(res.price).hex(), float(res.stderr).hex()) == RQMC_MEGA_BITS[backend]


# ---- the CCR exposure kernel (csrc/ccr_exposures.cu) ----

def _ccr_inputs(dev, seed, n, T=100, basis="chebyshev", degree=4):
    # kernel 1's paths, kernel 2's all-paths coefficients, the closed-form frame
    paths = tgbm.gbm_paths(seed, S0, R, SIGMA, 0.0, 1.0, T, n, device=dev)
    mean_t, inv_std_t = at.gbm_standardization(at.MarketParams(S0, R, SIGMA), 1.0, T, device=dev)
    coeffs = tmega.lsmc_price_megakernel(paths, K, R, 1.0 / T, -1.0, basis=basis, degree=degree,
                                         itm_weights=False, mean_t=mean_t, inv_std_t=inv_std_t,
                                         return_coeffs=True).coeffs
    return paths, coeffs, mean_t, inv_std_t


def _bits(x):
    return x.contiguous().view(torch.int32)


def _misled(paths, coeffs, mean_t, inv_std_t, basis, degree):
    # a copy whose first 32,768 paths (the kernel's sample) of each step all
    # take the step's largest finite continuation: the sample's windows then
    # miss the PFE-5 ranks, and every step with well over 32,768 paths and
    # more than one value goes through the kernel's radix passes
    out = paths.clone()
    m = min(paths.shape[1], 32_768)
    for t in range(paths.shape[0] - 1):
        cont = tccr._fit(paths[t], coeffs[t], mean_t[t], inv_std_t[t], basis, degree)
        out[t, :m] = paths[t, torch.argmax(torch.where(torch.isfinite(cont), cont, -torch.inf))]
    return out


def _ccr_equal_to_plain(paths, coeffs, mean_t, inv_std_t, basis="chebyshev", degree=4):
    # the kernel twice, on a copy whose sample misleads its windows (the
    # radix passes) and its plain version (a sort a step): the same bits,
    # NaN included
    misled = _misled(paths, coeffs, mean_t, inv_std_t, basis, degree)
    before = tccr.ccr_exposures.launches
    ker = tccr.ccr_exposures(paths, coeffs, mean_t, inv_std_t, basis, degree)
    again = tccr.ccr_exposures(paths, coeffs, mean_t, inv_std_t, basis, degree)
    fallback = tccr.ccr_exposures(misled, coeffs, mean_t, inv_std_t, basis, degree)
    ref = tccr.ccr_exposures_reference(paths, coeffs, mean_t, inv_std_t, basis, degree)
    ref_misled = tccr.ccr_exposures_reference(misled, coeffs, mean_t, inv_std_t, basis, degree)
    torch.cuda.synchronize()
    assert tccr.ccr_exposures.launches == before + 3
    assert torch.equal(_bits(ker), _bits(again))
    assert torch.equal(_bits(fallback), _bits(ref_misled)), \
        (fallback - ref_misled).abs().nan_to_num(1.0).max()
    assert torch.equal(_bits(ker), _bits(ref)), (ker - ref).abs().nan_to_num(1.0).max()
    return ker


@pytest.mark.parametrize("seed", [20261016, 2 ** 31 + 977])
def test_ccr_kernel_matches_plain_at_full_shape(cuda_device, seed):
    # the cell's shape: 1,048,576 x 100 (t = 0 has every path equal)
    rows = _ccr_equal_to_plain(*_ccr_inputs(cuda_device, seed, 1_048_576))
    assert rows.shape == (3, 101) and not rows[:, 100].any()
    assert bool(torch.isfinite(rows).all())
    assert rows[1, 0] == rows[2, 0] == rows[0, 0]  # one value at t = 0


@pytest.mark.parametrize("n", [1, 2, 3, 21, 131_071])
def test_ccr_kernel_odd_path_counts(cuda_device, n):
    # a masked last quad, one and two values, 21 paths (5% of 20 and 95% of
    # 20 are whole ranks), a chunk that is not full
    _ccr_equal_to_plain(*_ccr_inputs(cuda_device, 5, n, T=50))


@pytest.mark.parametrize("basis,degree", [("power", 0), ("legendre", 3), ("laguerre", 3),
                                          ("hermite", 3), ("chebyshev", 10)])
def test_ccr_kernel_other_bases(cuda_device, basis, degree):
    _ccr_equal_to_plain(*_ccr_inputs(cuda_device, 6, 65_537, T=20, basis=basis, degree=degree),
                        basis=basis, degree=degree)


def test_ccr_kernel_non_finite_ties_and_unaligned_rows(cuda_device):
    # non-finite spots and a NaN coefficient row are left out (a step with
    # no finite value reads NaN), a zero row makes every value +0.0, a row
    # of half equal spots ties at the selected ranks; rows one float past
    # an aligned base take the one-load-a-path branch
    n, T = 65_537, 12
    paths, coeffs, mean_t, inv_std_t = _ccr_inputs(cuda_device, 7, n, T=T)
    paths = paths.clone()
    paths[3, ::7] = float("inf")
    paths[4, 1::5] = float("nan")
    paths[5, : n // 2] = 97.0
    coeffs = coeffs.clone()
    coeffs[6] = float("nan")
    coeffs[7] = 0.0
    coeffs[8, 0] = -0.0
    coeffs[8, 1:] = 0.0
    rows = _ccr_equal_to_plain(paths, coeffs, mean_t, inv_std_t)
    assert bool(torch.isnan(rows[:, 6]).all()) and not rows[:, 7].any()
    buf = torch.empty(paths.numel() + 1, dtype=torch.float32, device=cuda_device)
    shifted = buf[1:].view_as(paths)
    shifted.copy_(paths)
    _ccr_equal_to_plain(shifted, coeffs, mean_t, inv_std_t)


def test_price_option_surface_stats_on_card(cuda_device):
    # the cell's entry at 131k x 100: the price and stderr are the bits of
    # the call without the profile; one profile is one kernel call on the
    # paths and kernel 2's coefficients
    args = (23, at.MarketParams(S0, R, SIGMA),
            at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american"),
            at.RegressionSpec(degree=4, regress_on="all"),
            at.SimConfig(n_paths=131_072, n_steps=100, backend="philox"))
    before = tccr.ccr_exposures.launches
    res = at.price_option(*args, engine="mega", device=cuda_device, surface_stats=True,
                          return_coeffs=True)
    plain = at.price_option(*args, engine="mega", device=cuda_device)
    paths = at.simulate_gbm(23, args[1], 1.0, args[4], cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(args[1], 1.0, 100, device=cuda_device)
    ref = tccr.ccr_exposures_reference(paths, res.coeffs, mean_t, inv_std_t)
    torch.cuda.synchronize()
    assert tccr.ccr_exposures.launches == before + 1
    assert torch.equal(res.price, plain.price) and torch.equal(res.stderr, plain.stderr)
    e = res.exposures
    assert torch.equal(_bits(torch.stack([e.epe, e.pfe5, e.pfe95])), _bits(ref))


def test_put_entries_on_the_cached_closed_form_rows(cuda_device):
    # the put's three entries at 64k x 100, on the rows of the one cached
    # builder: price_option(engine="mega") with and without the exposure
    # profile, and engine="fusedpath", each the bits of its plain version in
    # the explicit closed-form frame; a warm call makes no host wait
    n, steps = 65_536, 100
    market = at.MarketParams(S0, R, SIGMA)
    prod = at.ProductSpec(K=K, T=1.0, option_type="put", exercise="american")
    sim = at.SimConfig(n_paths=n, n_steps=steps, backend="philox")
    calls = {
        "mega": lambda: at.price_option(29, market, prod, at.RegressionSpec(), sim,
                                        engine="mega", device=cuda_device),
        "ccr": lambda: at.price_option(29, market, prod, at.RegressionSpec(regress_on="all"),
                                       sim, engine="mega", device=cuda_device,
                                       surface_stats=True),
        "fusedpath": lambda: at.price_option(29, market, prod, at.RegressionSpec(), sim,
                                             engine="fusedpath", device=cuda_device),
    }
    got = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls.values():
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    paths = at.simulate_gbm(29, market, 1.0, sim, cuda_device)
    mean_t, inv_std_t = at.gbm_standardization(market, 1.0, steps, device=cuda_device)
    for name, itm in (("mega", True), ("ccr", False)):
        ref = tmega.lsmc_price_mega_reference(paths, K, R, 1.0 / steps, -1.0, itm_weights=itm,
                                              mean_t=mean_t, inv_std_t=inv_std_t,
                                              return_coeffs=True)
        assert torch.equal(got[name].price, ref.price)
        assert torch.equal(got[name].stderr, ref.stderr)
    e = got["ccr"].exposures
    profile = tccr.ccr_exposures_reference(paths, ref.coeffs, mean_t, inv_std_t)
    assert torch.equal(_bits(torch.stack([e.epe, e.pfe5, e.pfe95])), _bits(profile))
    price, stderr = tfp.lsmc_price_fusedpath_reference(29, S0, K, R, SIGMA, 1.0 / steps, steps,
                                                       n, -1.0, itm_weights=True,
                                                       return_stats=True, device=cuda_device)
    assert torch.equal(got["fusedpath"].price, price)
    assert torch.equal(got["fusedpath"].stderr, stderr)


def test_analytics_makes_no_host_wait(cuda_device):
    # inside the analytics span: no synchronise and no copy, by the sync
    # debug mode and by the profiler's runtime calls under the span
    from torch.profiler import ProfilerActivity, profile

    inputs = _ccr_inputs(cuda_device, 8, 131_072)
    at.exposures_from_coeffs(*inputs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        at.exposures_from_coeffs(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with tracing.recording(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
        at.exposures_from_coeffs(*inputs)
        torch.cuda.synchronize()
    tracing.drain()
    spans = [e.time_range for e in prof.events() if e.name == tracing.PREFIX + "analytics"
             and e.device_type == torch.autograd.DeviceType.CPU]
    assert len(spans) == 1
    inside = [e.name for e in prof.events()
              if spans[0].start <= e.time_range.start <= spans[0].end
              and (e.name.startswith("cudaMemcpy") or "Synchronize" in e.name)]
    assert not inside, inside

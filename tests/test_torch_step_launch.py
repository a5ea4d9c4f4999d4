"""The host side of the fused step-apply kernels 5 and 9, on the CPU: the
apply grid's sizing, kernel 9's host-packed factor table, the plans the
fused loops validate once and hand to the C entries, and the loops'
launchers on CPU tensors (the plain versions, step by step).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
This file imports no jax.
"""

import numpy as np
import pytest
import torch

from amcx_torch import basis as tbasis
from amcx_torch.ops import lsmc_pallas as tstep
from amcx_torch.ops import maxcall_pallas as tma


def test_apply_grid_sizing():
    # kernel 5's persistent grid: 8 blocks of 256 threads a SM, 4 paths a
    # thread, fewer blocks when the paths fill fewer
    assert tstep.apply_blocks(1 << 20, 132) == 1024
    assert tstep.apply_blocks(1 << 24, 132) == 8 * 132
    assert tstep.apply_blocks(131_071, 132) == 128
    assert tstep.apply_blocks(1025, 132) == 2
    assert tstep.apply_blocks(1, 132) == 1


FACTOR_CASES = [(1, 4, "total"), (2, 3, "total"), (3, 2, "total"), (5, 2, "total"),
                (6, 2, "total"), (4, 4, "total"), (3, 3, "separable"), (7, 4, "separable"),
                (8, 3, "separable"), (5, 0, "total")]


@pytest.mark.parametrize("n_assets,degree,mode", FACTOR_CASES)
def test_factor_words_build_the_columns(n_assets, degree, mode):
    # kernel 9's columns: each word's slots (a D + d - 1, a byte each, 0xff
    # past the last) multiplied left to right give multi_asset_cols' column
    # bits on the same univariate columns
    words = tma.ma_factor_words(n_assets, degree, mode)
    idx = tbasis._multi_index_set(n_assets, degree, mode)
    assert len(words) == len(idx)
    rng = np.random.default_rng(n_assets * 10 + degree)
    xs = [torch.from_numpy(rng.standard_normal(257).astype(np.float32))
          for _ in range(n_assets)]
    uni = [tbasis.basis_cols(x, "chebyshev", degree) for x in xs]
    slots = [uni[a][d] for a in range(n_assets) for d in range(1, degree + 1)]
    want = tbasis.multi_asset_cols(xs, "chebyshev", degree, mode)
    for c, (w, alpha) in enumerate(zip(words, idx)):
        factors = [(w >> (8 * k)) & 0xFF for k in range(4)]
        used = [f for f in factors if f != 0xFF]
        assert factors == used + [0xFF] * (4 - len(used))  # slots first, then padding
        assert used == [a * degree + d - 1 for a, d in enumerate(alpha) if d > 0]
        col = torch.ones(257) if not used else slots[used[0]]
        for f in used[1:]:
            col = col * slots[f]
        assert torch.equal(col, want[c] * torch.ones(257)), (c, alpha)


def test_ma_apply_params_pack_the_factor_words():
    q = tma.ma_apply_params(5, "chebyshev", 2, "total", True, "maxcall", 100.0, 1.0)
    assert q.params.n_cols == 21 and q.params.sorted == 1
    assert list(q.factors[:21]) == tma.ma_factor_words(5, 2, "total")
    assert tma.ma_apply_params(5, "chebyshev", 2, "total", True, "maxcall", 100.0, 1.0) is q


def _put_loop(n=37, T=6, seed=3):
    rng = np.random.default_rng(seed)
    paths = torch.from_numpy(100.0 * np.exp(np.cumsum(
        0.02 * rng.standard_normal((T + 1, n)), axis=0)).astype(np.float32))
    ones = torch.ones(T + 1)
    stats = tstep.step_stats(paths.mean(dim=1), 1.0 / paths.std(dim=1), ones, ones)
    cf = torch.clamp_min(100.0 - paths[-1], 0.0)
    tau = torch.full((n,), float(T))
    knocked = paths.cummin(dim=0).values < 99.0
    surface = torch.zeros((T + 1, n))
    return paths, stats, cf, tau, knocked, surface


def test_apply_plan_packs_the_loop():
    # the plan kernel 5's C entry reads each step: the planes' bases, the
    # carry, the grid and the product, after one validation
    paths, stats, cf, tau, knocked, surface = _put_loop()
    kw = dict(K=95.0, phi=-1.0, basis="legendre", degree=3, select=False)
    plan = tstep._apply_plan(stats, paths, cf, tau, knocked, surface, n_sm=132, **kw)
    assert (plan.paths, plan.cf, plan.tau, plan.knocked, plan.stats, plan.surface) == (
        paths.data_ptr(), cf.data_ptr(), tau.data_ptr(), knocked.data_ptr(), stats.data_ptr(),
        surface.data_ptr())
    assert (plan.n_steps, plan.n_paths, plan.n_blocks, plan.basis, plan.degree, plan.select) == (
        6, 37, 1, tbasis.BASIS_IDS["legendre"], 3, 0)
    assert (plan.strike, plan.phi) == (95.0, -1.0)
    bare = tstep._apply_plan(stats, paths, cf, tau, None, None, n_sm=132, **kw)
    assert bare.knocked is None and bare.surface is None
    bad = [dict(knocked=knocked[0]), dict(surface=surface[0]), dict(paths=paths.T),
           dict(cf=cf.double()), dict(tau=tau[:-1]), dict(paths=paths[:-1])]
    for change in bad:
        args = dict(stats=stats, paths=paths, cf=cf, tau=tau, knocked=knocked, surface=surface)
        args.update(change)
        with pytest.raises(ValueError):
            tstep._apply_plan(n_sm=132, **args, **kw)


def test_ma_apply_plan_packs_the_loop():
    n, T = 29, 9
    planes = torch.rand(T + 1, 3, n) + 99.5
    stats = torch.ones(2 * 3 + 3, T + 1)
    cf, tau = torch.zeros(n), torch.full((n,), float(T))
    kw = dict(K=100.0, phi=1.0, basis="chebyshev", degree=3, mode="total", sorted_basis=False,
              payoff_kind="basket", weights=None)
    plan = tma._ma_apply_plan(stats, planes, cf, tau, n_sm=132, **kw)
    assert (plan.planes, plan.cf, plan.tau, plan.stats) == (
        planes.data_ptr(), cf.data_ptr(), tau.data_ptr(), stats.data_ptr())
    assert (plan.n_steps, plan.n_paths, plan.n_sm) == (T, n, 132)
    assert plan.q.params.n_assets == 3 and plan.q.params.n_cols == 20
    assert list(plan.q.factors[:20]) == tma.ma_factor_words(3, 3, "total")
    for bad in (planes[0], planes[:, :2], planes.transpose(1, 2)):
        with pytest.raises(ValueError):
            tma._ma_apply_plan(stats, bad, cf, tau, n_sm=132, **kw)


@pytest.mark.parametrize("select", [True, False])
def test_apply_launcher_on_cpu_matches_the_rows(select):
    # on CPU tensors the launcher runs the plain version on row t of each
    # plane, as the public wrapper on the step's rows does
    paths, stats, cf, tau, knocked, surface = _put_loop()
    kw = dict(K=100.0, phi=-1.0, basis="chebyshev", degree=2, select=select)
    coeffs = torch.tensor([3.0, -2.0, 0.5])
    cf2, tau2, surface2 = cf.clone(), tau.clone(), surface.clone()
    launch = tstep.step_apply_launcher(stats, paths, cf, tau, knocked, surface=surface, **kw)
    for t in range(5, -1, -1):
        launch(t, coeffs)
        tstep.step_apply(stats, t, coeffs, paths[t], cf2, tau2, knocked[t], surface=surface2[t],
                         **kw)
    for a, b in ((cf, cf2), (tau, tau2), (surface, surface2)):
        assert torch.equal(a, b)
    assert bool((tau < 6).any()) == select


def test_ma_apply_launcher_on_cpu_matches_the_steps():
    rng = np.random.default_rng(5)
    n, T = 41, 9
    planes = torch.from_numpy((100.0 + 10.0 * rng.standard_normal((T + 1, 2, n)))
                              .astype(np.float32))
    stats = tma.ma_stats(planes.mean(dim=2), 1.0 / planes.std(dim=2), 0.05, 1.0 / 3.0,
                         torch.ones(T + 1))
    kw = dict(K=100.0, basis="chebyshev", degree=2, mode="total", sorted_basis=True,
              payoff_kind="maxcall")
    cf = tma._payoff_for(list(planes[T]), 100.0, "maxcall")
    tau = torch.full((n,), float(T))
    cf2, tau2 = cf.clone(), tau.clone()
    coeffs = torch.tensor([1.0, 0.5, -0.25, 0.1, 0.2, -0.3])
    launch = tma.ma_step_apply_launcher(stats, planes, cf, tau, **kw)
    for t in range(T - 1, -1, -1):
        launch(t, coeffs)
        tma.ma_step_apply(stats, t, coeffs, planes[t], cf2, tau2, **kw)
    assert torch.equal(cf, cf2) and torch.equal(tau, tau2) and bool((tau < T).any())

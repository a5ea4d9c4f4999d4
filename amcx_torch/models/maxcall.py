"""Multi-asset Bermudan max-call (port of `amcx.models.maxcall`).

An N-asset correlated GBM basket with payoff ``max(max_i S_i − K, 0)``,
exercisable on a discrete date grid (first date T/n), priced by LSMC on a
cross-term polynomial regression (`amcx_torch.basis.multi_asset_design_matrix`).
The Broadie-Glasserman / Andersen-Broadie benchmark family: S0 = K = 100,
r = 5%, δ = 10%, σ = 20%, ρ = 0, T = 3, 9 exercise dates, with published
values 13.90 (2 assets) and 26.115-26.164 (5 assets).

Three engines, amcx's names:

- ``"xla"``: the reference loop engine `amcx_torch.engine.backward_induction`
  with :func:`max_call_fit` (per-step standardization, the materialized
  ``(n, m)`` design matrix, its Gram by a matrix product in f64 rounded to
  f32 so no TF32 setting can reach it, `pinv_solve`). Differentiable: the
  Greeks run through it.
- ``"fused"``: :func:`backward_induction_fused_maxcall`, the per-step kernels
  8/9 (`amcx_torch.ops.maxcall_pallas`) with the torch `pinv_solve` between
  them.
- ``"mega"``: the induction kernel 7 (`amcx_torch.ops.lsmc_ma_mega`).

The fused and mega engines standardize with :func:`maxcall_standardization`
of the whole path set; the sorted basis spends the budget on the basket's
order statistics, in which a symmetric payoff's continuation lives.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Union

import torch

from .. import tracing
from ..basis import multi_asset_design_matrix, n_multi_terms
from ..engine import LSMCResult, backward_induction
from ..ops.lsmc_pallas import unpack_moments
from ..ops.maxcall_pallas import (_payoff_for, ma_inputs, ma_step_apply_launcher,
                                  ma_step_moments, ma_step_moments_reference,
                                  maxcall_standardization)
from ..paths import simulate_gbm_multi
from ..payoff import max_call_payoff
from ..regress import pinv_solve, reject_axis_name
from ..types import RegressionSpec, SimConfig

__all__ = ["price_max_call", "max_call_fit", "max_call_fit_values", "maxcall_standardization",
           "backward_induction_fused_maxcall", "backward_induction_fused_maxcall_reference",
           "reprice_max_call_with_coeffs", "max_call_greeks"]

_BENCH_SPEC = RegressionSpec(basis="chebyshev", degree=2)


def _standardize_columns(X, weights, eps=1e-6):
    if weights is None:
        mean = torch.mean(X, dim=0)
        var = torch.mean(torch.square(X - mean), dim=0)
    else:
        w = weights[:, None]
        wsum = torch.clamp_min(torch.sum(w), eps)
        mean = torch.sum(w * X, dim=0) / wsum
        var = torch.sum(w * torch.square(X - mean), dim=0) / wsum
    return (X - mean) / torch.clamp_min(torch.sqrt(var), eps)


def max_call_fit(X, y, spec: RegressionSpec, weights=None, axis_name=None,
                 mode: str = "total"):
    """Cross-term continuation fit of ``y`` on the ``(n, n_assets)``
    regressors: ``(clamped fitted values, coeffs)``, the engine's
    ``fit_fn`` with ``fit_fn_returns_coeffs=True``.

    ``mode``: ``"total"``/``"separable"`` cross terms of the (standardized)
    asset values, or ``"sorted"``: total-degree terms of the basket's
    descending order statistics. ``axis_name`` raises (ROADMAP A15).
    """
    reject_axis_name(axis_name, "max_call_fit")
    if mode == "sorted":
        X = torch.sort(X, dim=-1, descending=True).values
        mode = "total"
    Xs = _standardize_columns(X, weights)
    A = multi_asset_design_matrix(Xs, spec.basis, spec.degree, mode)  # (n, m)
    wy = y if weights is None else weights * y
    Aw = A if weights is None else A * weights[:, None]
    A64 = A.double()
    G = (Aw.double().T @ A64).to(A.dtype)
    b = (A64.T @ wy.double()).to(A.dtype)
    coeffs = pinv_solve(G, b, spec.rcond)
    return torch.clamp_min(torch.sum(A * coeffs, dim=-1), 0.0), coeffs


def max_call_fit_values(X, y, spec: RegressionSpec, weights=None, axis_name=None,
                        mode: str = "total"):
    """:func:`max_call_fit`'s fitted values only (engine ``fit_fn`` form)."""
    return max_call_fit(X, y, spec, weights, axis_name, mode)[0]


def _xla_pricing(seed, S0, r, q, sigma, corr, K, T, spec, sim, basis_mode, return_surface,
                 return_coeffs, device, differentiable=False):
    paths = simulate_gbm_multi(seed, S0, r, sigma, T, sim, q=q, corr=corr, device=device,
                               differentiable=differentiable)
    with tracing.span("induction"):
        knocked = torch.ones(paths.shape[:2], dtype=torch.bool, device=paths.device)
        res = backward_induction(
            paths, knocked, r, T / sim.n_steps, lambda S: max_call_payoff(S, K), spec,
            american=True, return_surface=return_surface,
            fit_fn=partial(max_call_fit, mode=basis_mode), fit_fn_returns_coeffs=True,
            return_coeffs=return_coeffs,
            # Bermudan convention: the first exercise date is T/n, not inception
            exercise_from_step=1)
    return res, paths


def _fused_maxcall(moments, apply_launcher, paths_tm, K, r, dt, spec=_BENCH_SPEC,
                   basis_mode="sorted", exercise_from_step=1, payoff_kind="maxcall", phi=1.0,
                   weights=None, *, plain=False):
    sorted_basis = basis_mode == "sorted"
    mode = "total" if sorted_basis else basis_mode
    planes, stats = ma_inputs(paths_tm, r, dt, sorted_basis=sorted_basis, mode=mode,
                              exercise_from_step=exercise_from_step, plain=plain)
    n_steps, n_assets, n_paths = planes.shape[0] - 1, planes.shape[1], planes.shape[2]
    f32, dev = torch.float32, planes.device
    # r·dt in f32, as amcx forms it from its f32 r and dt
    rdt = float(torch.tensor(float(r), dtype=f32) * torch.tensor(float(dt), dtype=f32))
    m = n_multi_terms(n_assets, spec.degree, mode)
    kw = dict(K=float(K), phi=float(phi), basis=spec.basis, degree=spec.degree, mode=mode,
              sorted_basis=sorted_basis, payoff_kind=payoff_kind, weights=weights)
    cf = _payoff_for(list(torch.unbind(planes[n_steps], 0)), float(K), payoff_kind, float(phi),
                     weights)
    tau = torch.full((n_paths,), float(n_steps), dtype=f32, device=dev)
    apply_ = apply_launcher(stats, planes, cf, tau, **kw)
    for t in range(n_steps - 1, -1, -1):
        packed = moments(stats, t, planes[t], cf, tau, rdt=rdt,
                         itm_weights=spec.regress_on == "itm", **kw)
        coeffs = pinv_solve(*unpack_moments(packed, m), spec.rcond)
        apply_(t, coeffs)
    discounted = cf * torch.exp(-rdt * tau)
    price = torch.mean(discounted)
    var = torch.mean(torch.square(discounted - price))
    return LSMCResult(price, torch.sqrt(var) / math.sqrt(n_paths), cf, tau, None)


def backward_induction_fused_maxcall(
    paths_tm: torch.Tensor,
    K,
    r,
    dt,
    spec: RegressionSpec = _BENCH_SPEC,
    basis_mode: str = "sorted",
    exercise_from_step: int = 1,
    payoff_kind: str = "maxcall",
    phi: float = 1.0,
    weights=None,
) -> LSMCResult:
    """Multi-asset LSMC on the fused step kernels.

    ``paths_tm``: ``(n_steps+1, n_paths, n_assets)`` f32. Each backward step
    runs `ma_step_moments` (kernel 8), `pinv_solve` on the unpacked Gram,
    and `ma_step_apply` (kernel 9) on the step's asset-major planes, with
    any of the payoff kinds of `amcx_torch.ops.maxcall_pallas._payoff_for`.
    Returns ``LSMCResult(price, stderr, cashflows, exercise_times, None)``.
    On a CPU tensor the kernels' plain versions run.
    """
    with tracing.span("induction"):
        return _fused_maxcall(ma_step_moments, ma_step_apply_launcher, paths_tm, K, r, dt, spec,
                              basis_mode, exercise_from_step, payoff_kind, phi, weights)


def backward_induction_fused_maxcall_reference(paths_tm: torch.Tensor, *args,
                                               **kwargs) -> LSMCResult:
    """:func:`backward_induction_fused_maxcall` on the step kernels' plain
    versions and the plain inputs, on any device."""
    return _fused_maxcall(ma_step_moments_reference,
                          partial(ma_step_apply_launcher, reference=True), paths_tm, *args,
                          plain=True, **kwargs)


def price_max_call(
    seed: Union[int, torch.Generator],
    S0,
    K,
    T,
    r,
    sigma,
    q=0.0,
    corr=None,
    n_exercise_dates: int = 9,
    n_paths: int = 100_000,
    spec: RegressionSpec = _BENCH_SPEC,
    basis_mode: str = "sorted",
    return_surface: bool = False,
    return_coeffs: bool = False,
    return_paths: bool = False,
    engine: str = "xla",
    device: Union[str, torch.device] = "cuda",
) -> LSMCResult:
    """Price a Bermudan max-call on a ``len(S0)``-asset correlated GBM
    basket, exercisable at ``n_exercise_dates`` equally spaced dates (the
    simulation grid), on ``device``.

    ``engine``: ``"xla"`` (reference loop engine; surface and coefficient
    exports), ``"fused"`` (kernels 8/9) or ``"mega"`` (kernel 7); the
    kernel engines are price-only and run their plain versions on the CPU.
    ``basis_mode``: ``"sorted"``, ``"total"`` or ``"separable"``. ``seed``:
    an integer or a ``torch.Generator`` on ``device``. ``return_paths``
    returns ``(result, paths)``.
    """
    with tracing.span("entry", engine=engine, n_paths=n_paths, n_steps=n_exercise_dates):
        sim = SimConfig(n_paths=n_paths, n_steps=n_exercise_dates)
        device = torch.device(device)
        S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32))
        n_assets = S0.shape[0]
        # corr=None is the identity: the paths skip the correlation products
        if corr is not None and torch.as_tensor(corr).shape != (n_assets, n_assets):
            raise ValueError(f"corr must be ({n_assets}, {n_assets}) to match the {n_assets}-asset "
                             f"basket, got {tuple(torch.as_tensor(corr).shape)}")
        if engine in ("fused", "mega"):
            if return_surface or return_coeffs:
                raise ValueError(f"engine={engine!r} max-call is price-only")
            paths = simulate_gbm_multi(seed, S0, r, sigma, T, sim, q=q, corr=corr, device=device)
            dt = T / sim.n_steps
            if engine == "fused":
                res = backward_induction_fused_maxcall(paths, K, r, dt, spec, basis_mode)
            else:
                from ..ops.lsmc_ma_mega import lsmc_price_ma_mega

                price, stderr = lsmc_price_ma_mega(
                    paths, K, r, dt, phi=1.0, payoff_kind="maxcall", basis=spec.basis,
                    degree=spec.degree, mode="total" if basis_mode == "sorted" else basis_mode,
                    sorted_basis=basis_mode == "sorted", rcond=spec.rcond,
                    itm_weights=spec.regress_on == "itm", exercise_from_step=1,
                    antithetic=sim.antithetic)
                res = LSMCResult(price, stderr, None, None, None)
            return (res, paths) if return_paths else res
        if engine != "xla":
            raise ValueError(f"engine must be 'xla', 'fused', or 'mega', got {engine!r}")
        res, paths = _xla_pricing(seed, S0, r, q, sigma, corr, K, T, spec, sim, basis_mode,
                                  return_surface, return_coeffs, device)
        return (res, paths) if return_paths else res


def reprice_max_call_with_coeffs(
    paths_tm: torch.Tensor,
    result,
    coeff_stats,
    K,
    T,
    r,
    spec: RegressionSpec,
    basis_mode: str = "sorted",
) -> LSMCResult:
    """Forward out-of-sample replay of a frozen max-call exercise rule on
    fresh ``paths_tm`` ``(n_steps+1, N, A)``: the lower-bound edge of the
    Andersen-Broadie bracket.

    The rule is amcx's: the precomputed ``coeff_stats`` frame
    ``(mean_t, inv_std_t)`` (from :func:`maxcall_standardization` of the fit
    paths), the standardized regressors clipped to ±2.5, the total-degree
    basis of the (sorted) basket, first exercise at step 1. ``result``
    carries the ``(n_steps, m)`` coefficient rows
    (``price_max_call(..., return_coeffs=True)``, or amcx's exported rows).
    """
    if result.coeffs is None:
        raise ValueError("run price_max_call with return_coeffs=True")
    n_steps, n_paths = paths_tm.shape[0] - 1, paths_tm.shape[1]
    dtype, dev = paths_tm.dtype, paths_tm.device
    mean_t, inv_std_t = (torch.as_tensor(v, dtype=dtype, device=dev) for v in coeff_stats)
    if mean_t.shape[0] != n_steps + 1:
        raise ValueError("coeff_stats must cover n_steps+1 rows")
    coeffs = torch.as_tensor(result.coeffs, dtype=dtype, device=dev)
    coef_full = torch.cat([coeffs, torch.zeros((1, coeffs.shape[1]), dtype=dtype, device=dev)])
    r_ = torch.as_tensor(r, dtype=dtype, device=dev)
    dt = torch.as_tensor(T / n_steps, dtype=dtype, device=dev)
    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)
    val = torch.zeros((n_paths,), dtype=dtype, device=dev)
    for t in range(1, n_steps + 1):
        S = paths_tm[t]
        h = max_call_payoff(S, K)
        X = torch.sort(S, dim=-1, descending=True).values if basis_mode == "sorted" else S
        xh = torch.clamp((X - mean_t[t]) * inv_std_t[t], -2.5, 2.5)
        A = multi_asset_design_matrix(xh, spec.basis, spec.degree, "total")
        cont = torch.clamp_min(torch.sum(A * coef_full[t], dim=-1), 0.0)
        ex = (h > 0.0) if t >= n_steps else (h > 0.0) & (h > cont)
        stop = alive & ex
        tt = torch.tensor(float(t), dtype=dtype, device=dev)
        val = torch.where(stop, torch.exp(-r_ * dt * tt) * h, val)
        alive = alive & ~stop
    price = torch.mean(val)
    stderr = torch.std(val, correction=0) / math.sqrt(n_paths)
    return LSMCResult(price, stderr, None, None, None)


def max_call_greeks(
    seed: Union[int, torch.Generator],
    S0,
    K,
    T,
    r,
    sigma,
    q=0.0,
    corr=None,
    n_exercise_dates: int = 9,
    n_paths: int = 100_000,
    spec: RegressionSpec = _BENCH_SPEC,
    basis_mode: str = "sorted",
    device: Union[str, torch.device] = "cuda",
):
    """Pathwise basket Greeks of the Bermudan max-call: per-asset deltas,
    vega and rho by torch autograd through the ``"xla"`` pipeline (the
    fixed-boundary pathwise estimator: exercise decisions enter only
    through boolean masks).

    Returns ``(price, {"delta": (n_assets,), "vega": 0-d, "rho": 0-d})``.
    """
    S0_t = torch.atleast_1d(torch.as_tensor(S0, dtype=torch.float32)).clone().requires_grad_(True)
    sig = torch.tensor(float(sigma), requires_grad=True)
    rr = torch.tensor(float(r), requires_grad=True)
    sim = SimConfig(n_paths=n_paths, n_steps=n_exercise_dates)
    res, _ = _xla_pricing(seed, S0_t, rr, float(q), sig, corr, float(K), float(T), spec, sim,
                          basis_mode, False, False, device, differentiable=True)
    delta, vega, rho = torch.autograd.grad(res.price, (S0_t, sig, rr))
    return res.price.detach(), {"delta": delta, "vega": vega, "rho": rho}

"""Pathwise Greeks (port of `amcx.greeks`).

The estimator is the standard *pathwise* LSMC Greek: differentiate the
discounted cashflows along each path while holding the exercise rule
fixed. In the reference engine that holds by construction: the
continuation fit only enters through the boolean exercise mask, which
carries no gradient, so ``torch.autograd`` of the price *is* the
fixed-exercise pathwise estimator (first-order optimality of the boundary
makes the neglected term second-order for American options).

Routes (``price_and_greeks(engine=...)``):

- ``"xla"``: autograd through `amcx_torch.paths.simulate_gbm` (the
  ``"torch"`` simulator; a ``"philox"`` request is swapped, as amcx swaps
  ``"pallas"``) and `amcx_torch.engine.backward_induction`. Any product.
- ``"fused"``: the fused engine's kernels, then :func:`fast_greeks` in
  closed form from its ``(cashflows, exercise_times)``. Vanilla GBM only.
- ``"fused-ad"``: :func:`fused_price_diff`, a `torch.autograd.Function`
  whose forward runs the fused kernels and whose backward rebuilds the
  sparse path cotangent from ``(cf, τ)``; autograd then runs through the
  differentiable path generator only. Barriers and any differentiable
  dynamics.
- ``"mega"``: the induction kernel with its cf/τ planes, then
  :func:`fast_greeks`. Vanilla GBM only.

Barrier products: the knock indicator is boolean, so pathwise barrier
Greeks omit the knock-probability sensitivity (the standard limitation).
Gamma: the pathwise second derivative of a kinked payoff is zero almost
everywhere; :func:`gamma_fd` differences the pathwise delta under common
random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from .engine import lsmc_option_pricing, price_option, resolve_regression_spec
from .engine_pallas import backward_induction_fused, lsmc_option_pricing_fused
from .paths import simulate_gbm
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = ["price_and_greeks", "fast_greeks", "fused_price_diff", "gamma_fd"]


class _FusedPriceDiff(torch.autograd.Function):
    """Fused-engine price with the fixed-boundary pathwise backward of
    amcx's ``_fused_price_diff_bwd``, in plain torch (amcx's backward is
    XLA, not a kernel)."""

    @staticmethod
    def forward(ctx, paths_tm, r, K, dt, barrier, n_steps, phi, spec, american, barrier_type):
        res = backward_induction_fused(paths_tm.detach(), r, dt, K, phi, spec, barrier=barrier,
                                       barrier_type=barrier_type, american=american)
        ctx.save_for_backward(r, K, dt, res.cashflows, res.exercise_times)
        ctx.n_steps, ctx.phi, ctx.has_barrier = n_steps, phi, barrier is not None
        return res.price

    @staticmethod
    def backward(ctx, g):
        r, K, dt, cf, tau = ctx.saved_tensors
        n_steps, phi = ctx.n_steps, ctx.phi
        dev = cf.device
        r_, dt_ = r.to(dev, cf.dtype), dt.to(dev, cf.dtype)
        n = cf.shape[0]
        disc = torch.exp(-r_ * dt_ * tau)
        exercised = cf > 0.0
        # ∂price/∂S_{t,i} = (1/n)·disc_i·φ·1[τ_i = t ∧ exercised_i]: one
        # nonzero per path, at its exercise step
        cot_paths = torch.zeros((n_steps + 1, n), dtype=cf.dtype, device=dev)
        val = torch.where(exercised, (g / n) * (disc * phi), 0.0)
        cot_paths[tau.long(), torch.arange(n, device=dev)] = val
        # direct sensitivities of mean(cf·e^{−r·dt·τ}) to r, K, dt
        cot_r = g * torch.mean(-dt_ * tau * cf * disc)
        cot_K = g * torch.mean(torch.where(exercised, -phi * disc, 0.0))
        cot_dt = g * torch.mean(-r_ * tau * cf * disc)
        # no pathwise knock sensitivity (boolean indicator)
        cot_barrier = torch.zeros((), dtype=cf.dtype) if ctx.has_barrier else None
        return (cot_paths, cot_r.to(r.device), cot_K.to(K.device), cot_dt.to(dt.device),
                cot_barrier, None, None, None, None, None)


def fused_price_diff(paths_tm, r, K, dt, barrier, n_steps: int, phi: float,
                     spec: RegressionSpec, american: bool, barrier_type: str = "down-in"):
    """LSMC price from the fused engine, differentiable in ``(paths_tm, r,
    K, dt)``.

    The forward runs `amcx_torch.engine_pallas.backward_induction_fused`
    on the detached paths (the step kernels on the card). With the
    boundary fixed, ``price = mean(cf·e^{−r·dt·τ})``, so the backward needs
    no pass through the induction: the path cotangent is sparse, one
    nonzero per exercised path, ``disc·φ/n`` at its exercise step, and
    gradients flow onward through whatever differentiable generator made
    the paths. Scalars may be floats or 0-d tensors.
    """
    as_t = lambda v: torch.as_tensor(v, dtype=paths_tm.dtype)  # noqa: E731
    return _FusedPriceDiff.apply(paths_tm, as_t(r), as_t(K), as_t(dt),
                                 None if barrier is None else as_t(barrier), n_steps, phi,
                                 spec, american, barrier_type)


def _autograd_greeks(price_fn, market: MarketParams, T, dtype):
    """Price and its gradient in (S0, σ, r, q, T) as amcx's greek names."""
    leaves = [torch.tensor(float(v), dtype=dtype, requires_grad=True)
              for v in (market.S0, market.sigma, market.r, market.q, T)]
    p = price_fn(*leaves)
    delta, vega, rho, dq, dT = torch.autograd.grad(p, leaves)
    # theta = −dP/dT (time decay as calendar time passes)
    return p.detach(), {"delta": delta, "vega": vega, "rho": rho, "dividend_rho": dq,
                        "theta": -dT}


def _torch_sim(sim: SimConfig) -> SimConfig:
    return dataclasses.replace(sim, backend="torch") if sim.backend != "torch" else sim


def price_and_greeks(
    seed: Union[int, torch.Generator],
    market: MarketParams,
    product: ProductSpec,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    engine: str = "xla",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LSMC price plus pathwise delta/vega/rho/dividend-rho/theta.

    ``engine``: ``"xla"``, ``"fused"``, ``"fused-ad"`` or ``"mega"`` (module
    docstring). ``"fused"`` and ``"mega"`` take vanilla products only and
    raise ``ValueError`` on a barrier. ``seed`` as in
    `amcx_torch.engine.price_option`; the ``"xla"`` and ``"fused-ad"``
    routes simulate with the ``"torch"`` backend.
    """
    spec = resolve_regression_spec(spec, product, q=market.q)
    if engine in ("mega", "fused") and product.has_barrier:
        raise ValueError(
            f"engine={engine!r} Greeks cover vanilla products; barrier products need "
            "the autodiff estimator (engine='xla' or 'fused-ad')")
    if engine == "mega":
        res = price_option(seed, market, product, spec, sim, engine="mega", return_cf_tau=True,
                           device=device)
        return res.price, fast_greeks(res, market, product, sim.n_steps)
    if engine == "fused":
        paths = simulate_gbm(seed, market, product.T, sim, device)
        res = lsmc_option_pricing_fused(paths, product, market.r, spec)
        return res.price, fast_greeks(res, market, product, sim.n_steps)
    if engine not in ("xla", "fused-ad"):
        raise ValueError(
            f"engine must be 'xla', 'fused', 'fused-ad' or 'mega', got {engine!r}")
    sim = _torch_sim(sim)
    phi = 1.0 if product.option_type == "call" else -1.0

    def price(S0, sigma, r, q, T):
        paths = simulate_gbm(seed, MarketParams(S0, r, sigma, q), T, sim, device)
        if engine == "fused-ad":
            return fused_price_diff(paths, r, product.K, T / sim.n_steps, product.barrier,
                                    sim.n_steps, phi, spec, product.is_american,
                                    product.barrier_type)
        prod = dataclasses.replace(product, T=T)
        return lsmc_option_pricing(paths, prod, r, spec, return_surface=False).price

    return _autograd_greeks(price, market, product.T, sim.torch_dtype)


def fast_greeks(result, market: MarketParams, product: ProductSpec,
                n_steps: int) -> Dict[str, torch.Tensor]:
    """Pathwise delta/vega/rho/dividend-rho/theta from a finished engine
    run, without autodiff.

    For GBM the path derivatives have closed forms (``dS_t/dS0 = S_t/S0``,
    ``dS_t/dσ = S_t (W_t − σt)``, ``dS_t/dr = S_t·t``), and the exercise-time
    spot is recoverable from the undiscounted cashflow (``S_τ = K + φ·cf``
    on exercised paths). So the fixed-boundary pathwise estimator is a
    reduction over ``(cashflows, exercise_times)`` of any engine's output.
    Vanilla products only.
    """
    if product.has_barrier:
        raise ValueError("fast_greeks covers vanilla products; use price_and_greeks")
    cf, tau = result.cashflows, result.exercise_times
    dtype, dev = cf.dtype, cf.device

    def t_(v):
        return torch.as_tensor(float(v), dtype=dtype, device=dev)

    T, r, q, sigma, S0 = (t_(v) for v in (product.T, market.r, market.q, market.sigma,
                                          market.S0))
    dt = T / n_steps
    phi = 1.0 if product.option_type == "call" else -1.0

    tau_y = tau * dt
    disc = torch.exp(-r * tau_y)
    exercised = cf > 0
    S_tau = torch.where(exercised, t_(product.K) + phi * cf, 0.0)
    dpay_dS = torch.where(exercised, phi, 0.0)  # payoff slope at exercise

    n = cf.shape[0]
    delta = torch.sum(disc * dpay_dS * S_tau / S0) / n
    # σW_τ = ln(S_τ/S0) − (r−q−σ²/2)τ  ⇒ dS/dσ = S(W − στ)
    log_rel = torch.where(exercised, torch.log(torch.clamp_min(S_tau, 1e-30) / S0), 0.0)
    drift = r - q - 0.5 * sigma ** 2
    W = (log_rel - drift * tau_y) / sigma
    dS_dsigma = S_tau * (W - sigma * tau_y)
    vega = torch.sum(disc * dpay_dS * dS_dsigma) / n
    # rho: payoff sensitivity through the drift + the discount factor
    rho = torch.sum(disc * (dpay_dS * S_tau * tau_y - tau_y * cf)) / n
    # dividend rho: d ln S_τ / dq = −τ_y
    div_rho = torch.sum(disc * dpay_dS * S_tau * (-tau_y)) / n
    # theta = −dP/dT with the exercise step index fixed (as autograd through
    # the pipeline: T enters via dt = T/n and the √dt Brownian scaling): with
    # a = r−q−σ²/2 and L = ln(S_τ/S0), dS_τ/dT = S_τ·(a·τ_y + L)/(2T) and
    # d(disc)/dT = −r·(τ_y/T)·disc
    dP_dT = torch.sum(
        disc * (dpay_dS * S_tau * (drift * tau_y + log_rel) / (2.0 * T)
                - r * (tau_y / T) * cf)) / n
    return {"delta": delta, "vega": vega, "rho": rho, "dividend_rho": div_rho,
            "theta": -dP_dT}


def gamma_fd(
    seed: Union[int, torch.Generator],
    market: MarketParams,
    product: ProductSpec,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    rel_bump: float = 1e-2,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Gamma as a central finite difference of the pathwise delta under
    common random numbers (the same integer seed both sides)."""
    h = market.S0 * rel_bump
    up = dataclasses.replace(market, S0=market.S0 + h)
    dn = dataclasses.replace(market, S0=market.S0 - h)
    _, g_up = price_and_greeks(seed, up, product, spec, sim, device=device)
    _, g_dn = price_and_greeks(seed, dn, product, spec, sim, device=device)
    return (g_up["delta"] - g_dn["delta"]) / (2.0 * h)

"""Longstaff-Schwartz backward induction (port of `amcx.engine`).

:func:`backward_induction` is a reversed Python loop that mirrors amcx's
``lax.scan`` step for step; it is the port's in-package reference engine
(``engine="xla"`` keeps amcx's name, so callers switch packages without
renaming). ``engine="mega"`` runs the pathgen and induction kernels of
`amcx_torch.ops`; ``engine="fused"`` the per-step kernels of
`amcx_torch.engine_pallas`.

Behavioural parity points (amcx's SURVEY quirks):

- Q1: the regression fits on all paths unless ``regress_on="itm"``;
- Q2: the continuation is clamped at zero before the exercise comparison;
- Q3: t=0 is part of the loop (rank-1 design, pseudo-inverse solve);
- Q4: barrier products pay and exercise only where the gate is open;
- Q5: the cashflow carry stores undiscounted exercise values; regression
  targets discount from the stored exercise time τ back to t, the price
  from τ to 0;
- Q6: European products still run the regression every step but never
  exercise early;
- Q7: never-exercised paths keep τ = n_steps with their maturity cashflow.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional, Union

import torch

from . import tracing
from .exposures import _profile, exposures_from_coeffs, step_profile
from .payoff import barrier_gate, exercise_allow_row, payoff_fn_for
from .regress import fit_continuation_with_coeffs, reject_axis_name
from .types import SOBOL_BACKENDS, MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = ["LSMCResult", "backward_induction", "lsmc_option_pricing", "price_option",
           "q0_call_advisory", "resolve_regression_spec"]


def resolve_regression_spec(
    spec: RegressionSpec,
    product: ProductSpec,
    q=None,
    for_surface: bool = False,
) -> RegressionSpec:
    """Resolve ``regress_on="auto"`` per product, as amcx does:

    - explicit ``"all"``/``"itm"`` pass through;
    - European, or a caller that wants the continuation surface → ``"all"``;
    - American → ``"itm"``, and for a call with a zero dividend yield ``q``
      the degree is raised to at least 6.
    """
    if spec.regress_on != "auto":
        return spec
    if not product.is_american or for_surface:
        return dataclasses.replace(spec, regress_on="all")
    degree = spec.degree
    if product.option_type == "call" and q is not None and float(q) == 0.0:
        degree = max(degree, 6)
    return dataclasses.replace(spec, regress_on="itm", degree=degree)


class LSMCResult(NamedTuple):
    """Engine output: ``price`` and its Monte-Carlo ``stderr``; the
    ``cashflows``/``exercise_times`` carry; the dense ``(n_steps+1,
    n_paths)`` ``continuation`` surface when asked (zeros at maturity);
    ``exposures``, the per-step EPE/PFE profile
    (`amcx_torch.exposures.CCRExposures`) when run with ``surface_stats``;
    per-step ``coeffs``."""

    price: torch.Tensor
    stderr: torch.Tensor
    cashflows: Optional[torch.Tensor]
    exercise_times: Optional[torch.Tensor]
    continuation: Optional[torch.Tensor]
    exposures: Optional[object] = None
    coeffs: Optional[torch.Tensor] = None


def backward_induction(
    paths_tm: torch.Tensor,
    knocked_tm: torch.Tensor,
    r,
    dt,
    payoff: Callable[[torch.Tensor], torch.Tensor],
    spec: RegressionSpec,
    regressor: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    american: bool = True,
    return_surface: bool = True,
    fit_fn: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    surface_stats: bool = False,
    return_coeffs: bool = False,
    exercise_from_step: int = 0,
    fit_fn_returns_coeffs: bool = False,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """Generic LSMC backward induction on time-major state, ``(n_steps+1,
    n_paths)`` or ``(n_steps+1, n_paths, n_assets)``, with the
    ``(n_steps+1, n_paths)`` ``knocked_tm`` exercise gate (all-True for
    vanilla).

    ``regressor`` maps the state to the regression variable (identity by
    default). ``fit_fn(x, y, spec, weights)`` replaces the univariate fit
    and returns the clamped fitted values, or ``(fitted, coeffs)`` when
    ``fit_fn_returns_coeffs`` (the multi-asset cross-term fit,
    `amcx_torch.models.maxcall.max_call_fit`). ``exercise_from_step`` is
    the earliest step that may exercise (Bermudan benchmarks use 1);
    ``exercise_steps`` restricts early exercise to those step indices;
    ``antithetic`` folds each path i with its mirror i + n/2 before the
    variance, so the stderr is that of the pair means. The per-step
    coefficient rows (``return_coeffs``) are ``(n_steps, n_coeffs)``, as
    amcx exports them. ``surface_stats`` fills ``exposures`` with each
    step's EPE, PFE-5 and PFE-95 of the clamped continuation (exact,
    sort-based, EPE summed in f64; the maturity row is zero) without
    keeping the surface (`amcx_torch.exposures.step_profile`).
    ``axis_name`` (amcx's sharded path axis) raises (ROADMAP A15).
    """
    reject_axis_name(axis_name, "backward_induction")
    n_steps = paths_tm.shape[0] - 1
    n_paths = paths_tm.shape[1]
    dtype, device = paths_tm.dtype, paths_tm.device
    r = torch.as_tensor(r, dtype=dtype, device=device)
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    if return_coeffs and fit_fn is not None and not fit_fn_returns_coeffs:
        raise ValueError("return_coeffs requires the default univariate fitter or a "
                         "custom fit_fn declared with fit_fn_returns_coeffs=True")
    custom_fit = fit_fn is not None and not fit_fn_returns_coeffs
    if fit_fn is None:
        fit_fn = fit_continuation_with_coeffs

    # maturity leg: intrinsic where the gate is open; τ = n_steps (Q7)
    cashflows = torch.where(knocked_tm[n_steps], payoff(paths_tm[n_steps]),
                            torch.zeros((n_paths,), dtype=dtype, device=device))
    tau = torch.full((n_paths,), float(n_steps), dtype=dtype, device=device)
    allowed = None
    if exercise_steps is not None:
        allowed = exercise_allow_row(exercise_steps, n_steps, device=device)
    ts = torch.arange(n_steps, dtype=dtype, device=device)
    conts, coefs, rows = [None] * n_steps, [None] * n_steps, [None] * n_steps
    for step in range(n_steps - 1, -1, -1):
        S_t, knocked_t, t = paths_tm[step], knocked_tm[step], ts[step]
        # regression target: each cashflow discounted from τ back to t (Q5)
        y = cashflows * torch.exp(-r * dt * (tau - t))
        x = S_t if regressor is None else regressor(S_t)
        ex = payoff(S_t)
        weights = None  # Q1: fit on all paths
        if spec.regress_on == "itm":
            weights = (ex > 0).to(dtype) * knocked_t.to(dtype)
        if custom_fit:
            cont, coef = fit_fn(x, y, spec, weights), None  # clamped at 0 (Q2)
        else:
            cont, coef = fit_fn(x, y, spec, weights)
        if american:
            exercise = knocked_t & (ex > 0) & (ex > cont)
            if exercise_from_step > 0:
                exercise = exercise & (t >= exercise_from_step)
            if allowed is not None:
                exercise = exercise & allowed[step]
            cashflows = torch.where(exercise, ex, cashflows)
            tau = torch.where(exercise, t, tau)
        coefs[step] = coef
        if return_surface:
            conts[step] = cont
        if surface_stats:
            rows[step] = step_profile(cont)

    discounted = cashflows * torch.exp(-r * dt * tau)
    if antithetic:
        half = n_paths // 2
        stat = 0.5 * (discounted[:half] + discounted[half:])
    else:
        stat = discounted
    n_stat = float(stat.shape[0])
    price = torch.mean(stat)
    var = torch.mean(torch.square(stat - price))
    stderr = torch.sqrt(var) / torch.sqrt(torch.tensor(n_stat, dtype=dtype, device=device))

    surface = None
    if return_surface:
        surface = torch.cat([torch.stack(conts),
                             torch.zeros((1, n_paths), dtype=dtype, device=device)])
    return LSMCResult(price, stderr, cashflows, tau, surface,
                      exposures=_profile(rows, dtype, device) if surface_stats else None,
                      coeffs=torch.stack(coefs) if return_coeffs else None)


def lsmc_option_pricing(
    paths_tm: torch.Tensor,
    product: ProductSpec,
    r,
    spec: RegressionSpec = RegressionSpec(),
    return_surface: bool = True,
    axis_name: Optional[str] = None,
    surface_stats: bool = False,
    return_coeffs: bool = False,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """Price a (possibly barrier) put/call from pre-simulated time-major
    paths; ``dt = T / n_steps`` comes from the path grid. ``surface_stats``:
    the per-step EPE/PFE profile in ``exposures`` (see
    :func:`backward_induction`). ``axis_name`` raises (ROADMAP A15)."""
    reject_axis_name(axis_name, "lsmc_option_pricing")
    n_steps = paths_tm.shape[0] - 1
    dt = product.T / n_steps
    spec = resolve_regression_spec(spec, product,
                                   for_surface=return_surface or surface_stats)
    with tracing.span("induction"):
        knocked = barrier_gate(paths_tm, product.barrier, product.barrier_type)
        return backward_induction(
            paths_tm, knocked, r, dt, payoff_fn_for(product), spec,
            american=product.is_american,
            return_surface=return_surface,
            return_coeffs=return_coeffs,
            exercise_steps=exercise_steps,
            antithetic=antithetic,
            surface_stats=surface_stats,
        )


def q0_call_advisory(market: MarketParams, product: ProductSpec,
                     spec: RegressionSpec) -> Optional[str]:
    """Warning text for an American call with q = 0 priced with the
    all-paths regression, whose noise triggers spurious early exercise deep
    in the money; ``None`` otherwise."""
    if (product.option_type == "call" and product.is_american
            and float(market.q) == 0.0 and spec.regress_on == "all"
            and not product.has_barrier):
        return (
            "American call with q=0 and regress_on='all': early exercise is "
            "never optimal, but all-paths regression noise can trigger it "
            "deep ITM. Recommended: RegressionSpec(regress_on='itm', "
            "degree>=6), or price the European equivalent."
        )
    return None


def price_option(
    seed: Union[int, torch.Generator],
    market: MarketParams,
    product: ProductSpec,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    return_surface: bool = False,
    engine: str = "xla",
    exercise_steps=None,
    return_cf_tau: bool = False,
    return_coeffs: bool = False,
    device: Union[str, torch.device] = "cuda",
    surface_stats: bool = False,
) -> LSMCResult:
    """Simulate → price on ``device``.

    ``engine``: ``"xla"`` (the reference loop engine of this module),
    ``"fused"`` (the per-step moments/apply kernels), ``"mega"`` (the
    induction kernel) or ``"fusedpath"`` (the induction kernel that
    regenerates its own Philox paths, `amcx_torch.ops.lsmc_fusedpath`: no
    path array, barriers through the first-crossing plane; it refuses the
    Sobol backends, whose points it cannot regenerate); the kernels run
    their plain versions on the CPU. ``seed``: an integer (every engine) or
    a ``torch.Generator`` (``"torch"`` backend). ``sim.backend`` picks the
    paths of the other engines (`amcx_torch.paths.simulate_gbm`).
    ``return_coeffs`` fills ``coeffs`` ("xla", "mega", "fusedpath");
    ``return_cf_tau`` fills ``cashflows``/``exercise_times`` for "mega" and
    "fusedpath" ("xla" and "fused" always return them). ``surface_stats``
    fills ``exposures`` with the per-step EPE/PFE-5/PFE-95 profile of the
    continuation ("xla": :func:`backward_induction`'s; "mega": the induction
    kernel's coefficients through `amcx_torch.exposures_from_coeffs`, the
    price and stderr the same bits as without it); ``regress_on="auto"``
    then fits on all paths.
    """
    with tracing.span("entry", engine=engine, n_paths=sim.n_paths, n_steps=sim.n_steps):
        return _price_option(seed, market, product, spec, sim, return_surface, engine,
                             exercise_steps, return_cf_tau, return_coeffs, device, surface_stats)


def _price_option(seed, market, product, spec, sim, return_surface, engine, exercise_steps,
                  return_cf_tau, return_coeffs, device, surface_stats) -> LSMCResult:
    from .paths import simulate_gbm

    if surface_stats and engine in ("fused", "fusedpath"):
        raise ValueError(f"engine={engine!r} has no surface_stats; use 'mega' or 'xla'")
    spec = resolve_regression_spec(spec, product, q=market.q,
                                   for_surface=return_surface or surface_stats)
    advisory = q0_call_advisory(market, product, spec)
    if advisory is not None:
        warnings.warn(advisory, stacklevel=3)  # the caller of price_option
    if exercise_steps is not None:
        exercise_steps = tuple(int(i) for i in exercise_steps)
    if engine == "fused":
        from .engine_pallas import lsmc_option_pricing_fused

        if return_coeffs:
            raise ValueError("engine='fused' does not export coeffs; use 'xla' or 'mega'")
        paths = simulate_gbm(seed, market, product.T, sim, device)
        return lsmc_option_pricing_fused(paths, product, market.r, spec,
                                         return_surface=return_surface,
                                         exercise_steps=exercise_steps,
                                         antithetic=sim.antithetic)
    if engine == "fusedpath":
        from .ops.lsmc_fusedpath import lsmc_price_fusedpath

        if sim.backend in SOBOL_BACKENDS:
            raise ValueError(
                f"engine='fusedpath' regenerates Philox paths and cannot price backend="
                f"{sim.backend!r}; use engine='mega', 'fused' or 'xla'")
        if return_surface:
            raise ValueError(
                "engine='fusedpath' stores no paths, so no dense surface; use "
                "return_coeffs=True + amcx_torch.exposures_from_coeffs on any same-law paths")
        out = lsmc_price_fusedpath(
            seed, market.S0, product.K, market.r, market.sigma, product.T / sim.n_steps,
            sim.n_steps, sim.n_paths, 1.0 if product.option_type == "call" else -1.0,
            q=market.q, basis=spec.basis, degree=spec.degree, rcond=spec.rcond,
            american=product.is_american, itm_weights=spec.regress_on == "itm",
            antithetic=sim.antithetic, return_stats=True, exercise_steps=exercise_steps,
            return_cf_tau=return_cf_tau, return_coeffs=return_coeffs,
            barrier=product.barrier, barrier_type=product.barrier_type, device=device)
        if return_cf_tau or return_coeffs:
            return LSMCResult(out.price, out.stderr, out.cashflows, out.exercise_times, None,
                              coeffs=out.coeffs)
        return LSMCResult(out[0], out[1], None, None, None)
    if engine == "mega":
        from .ops.lsmc_megakernel import _price_rows, closed_form_rows

        if return_surface:
            raise ValueError(
                "engine='mega' is price-only for dense surfaces; use 'fused' or 'xla'")
        n_steps = sim.n_steps
        paths = simulate_gbm(seed, market, product.T, sim, device)
        with tracing.span("entry.frame"):
            stats = closed_form_rows(float(market.S0), float(market.r), float(market.sigma),
                                     float(market.q), float(product.T), product.T / n_steps,
                                     n_steps, paths.device)
        out = _price_rows(
            paths, stats, product.K, 1.0 if product.option_type == "call" else -1.0,
            basis=spec.basis, degree=spec.degree, rcond=spec.rcond,
            american=product.is_american, barrier=product.barrier,
            barrier_type=product.barrier_type, itm_weights=spec.regress_on == "itm",
            exercise_steps=exercise_steps, return_cf_tau=return_cf_tau,
            return_coeffs=return_coeffs or surface_stats, antithetic=sim.antithetic,
        )
        if not (return_cf_tau or return_coeffs or surface_stats):
            return LSMCResult(out[0], out[1], None, None, None)
        exposures = None
        if surface_stats:
            mean_t, inv_std_t = stats.view(4, n_steps + 1)[:2]
            exposures = exposures_from_coeffs(paths, out.coeffs, mean_t, inv_std_t, spec.basis,
                                              spec.degree)
        return LSMCResult(out.price, out.stderr, out.cashflows, out.exercise_times, None,
                          exposures=exposures, coeffs=out.coeffs if return_coeffs else None)
    if engine != "xla":
        raise ValueError(f"engine must be 'xla', 'fused', 'mega', or 'fusedpath', got {engine!r}")
    paths = simulate_gbm(seed, market, product.T, sim, device)
    return lsmc_option_pricing(paths, product, market.r, spec,
                               return_surface=return_surface,
                               surface_stats=surface_stats,
                               return_coeffs=return_coeffs,
                               exercise_steps=exercise_steps,
                               antithetic=sim.antithetic)

"""Longstaff-Schwartz backward induction (port of `amcx.engine`).

:func:`backward_induction` is a reversed Python loop that mirrors amcx's
``lax.scan`` step for step; it is the port's in-package reference engine
(``engine="xla"`` keeps amcx's name, so callers switch packages without
renaming). ``engine="mega"`` runs the pathgen and induction kernels of
`amcx_torch.ops`.

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

from .payoff import barrier_gate, exercise_allow_row, payoff_fn_for
from .regress import fit_continuation_with_coeffs
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

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
    ``exposures`` (not ported yet, always None); per-step ``coeffs``."""

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
    american: bool = True,
    return_surface: bool = True,
    return_coeffs: bool = False,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """Generic LSMC backward induction on time-major ``(n_steps+1,
    n_paths)`` state, with the ``knocked_tm`` exercise gate (all-True for
    vanilla). ``exercise_steps`` restricts early exercise to those step
    indices (Bermudan); ``antithetic`` folds each path i with its mirror
    i + n/2 before the variance, so the stderr is that of the pair means.
    The per-step coefficient rows (``return_coeffs``) are ``(n_steps,
    degree+1)``, as amcx exports them. amcx's ``regressor``,
    ``exercise_from_step`` and ``fit_fn`` hooks serve its multi-asset
    engines and come with them (ROADMAP A11).
    """
    n_steps = paths_tm.shape[0] - 1
    n_paths = paths_tm.shape[1]
    dtype, device = paths_tm.dtype, paths_tm.device
    r = torch.as_tensor(r, dtype=dtype, device=device)
    dt = torch.as_tensor(dt, dtype=dtype, device=device)

    # maturity leg: intrinsic where the gate is open; τ = n_steps (Q7)
    cashflows = torch.where(knocked_tm[n_steps], payoff(paths_tm[n_steps]),
                            torch.zeros((n_paths,), dtype=dtype, device=device))
    tau = torch.full((n_paths,), float(n_steps), dtype=dtype, device=device)
    allowed = None
    if exercise_steps is not None:
        allowed = exercise_allow_row(exercise_steps, n_steps, device=device)
    ts = torch.arange(n_steps, dtype=dtype, device=device)
    conts, coefs = [None] * n_steps, [None] * n_steps
    for step in range(n_steps - 1, -1, -1):
        S_t, knocked_t, t = paths_tm[step], knocked_tm[step], ts[step]
        # regression target: each cashflow discounted from τ back to t (Q5)
        y = cashflows * torch.exp(-r * dt * (tau - t))
        ex = payoff(S_t)
        weights = None  # Q1: fit on all paths
        if spec.regress_on == "itm":
            weights = (ex > 0).to(dtype) * knocked_t.to(dtype)
        cont, coef = fit_continuation_with_coeffs(S_t, y, spec, weights)
        if american:
            exercise = knocked_t & (ex > 0) & (ex > cont)
            if allowed is not None:
                exercise = exercise & allowed[step]
            cashflows = torch.where(exercise, ex, cashflows)
            tau = torch.where(exercise, t, tau)
        coefs[step] = coef
        if return_surface:
            conts[step] = cont

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
                      coeffs=torch.stack(coefs) if return_coeffs else None)


def lsmc_option_pricing(
    paths_tm: torch.Tensor,
    product: ProductSpec,
    r,
    spec: RegressionSpec = RegressionSpec(),
    return_surface: bool = True,
    return_coeffs: bool = False,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """Price a (possibly barrier) put/call from pre-simulated time-major
    paths; ``dt = T / n_steps`` comes from the path grid."""
    n_steps = paths_tm.shape[0] - 1
    dt = product.T / n_steps
    spec = resolve_regression_spec(spec, product, for_surface=return_surface)
    knocked = barrier_gate(paths_tm, product.barrier, product.barrier_type)
    return backward_induction(
        paths_tm, knocked, r, dt, payoff_fn_for(product), spec,
        american=product.is_american,
        return_surface=return_surface,
        return_coeffs=return_coeffs,
        exercise_steps=exercise_steps,
        antithetic=antithetic,
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
    device: Union[str, torch.device] = "cpu",
) -> LSMCResult:
    """Simulate → price on ``device``.

    ``engine``: ``"xla"`` (the reference loop engine of this module) or
    ``"mega"`` (the pathgen and induction kernels; plain versions on the
    CPU). ``"fused"`` and ``"fusedpath"`` are not ported yet. ``seed``: an
    integer (either simulator) or a ``torch.Generator`` (``"torch"``
    backend). ``return_coeffs`` fills ``coeffs``.
    """
    from .paths import gbm_standardization, simulate_gbm

    spec = resolve_regression_spec(spec, product, q=market.q, for_surface=return_surface)
    advisory = q0_call_advisory(market, product, spec)
    if advisory is not None:
        warnings.warn(advisory, stacklevel=2)
    if exercise_steps is not None:
        exercise_steps = tuple(int(i) for i in exercise_steps)
    if engine == "fused":
        raise NotImplementedError(
            "engine='fused' is not ported yet (ROADMAP A7 / B3)")
    if engine == "fusedpath":
        raise NotImplementedError(
            "engine='fusedpath' is not ported yet (ROADMAP A10 / B5)")
    if engine == "mega":
        from .ops.lsmc_megakernel import lsmc_price_megakernel

        if return_surface:
            raise ValueError(
                "engine='mega' is price-only for dense surfaces; use engine='xla'")
        n_steps = sim.n_steps
        mean_t, inv_std_t = gbm_standardization(market, product.T, n_steps, device=device)
        paths = simulate_gbm(seed, market, product.T, sim, device)
        out = lsmc_price_megakernel(
            paths, product.K, market.r, product.T / n_steps,
            1.0 if product.option_type == "call" else -1.0,
            basis=spec.basis, degree=spec.degree, rcond=spec.rcond,
            american=product.is_american, barrier=product.barrier,
            itm_weights=spec.regress_on == "itm",
            mean_t=mean_t, inv_std_t=inv_std_t,
            exercise_steps=exercise_steps, return_cf_tau=return_cf_tau,
            return_coeffs=return_coeffs, antithetic=sim.antithetic,
        )
        if return_coeffs:
            return LSMCResult(out.price, out.stderr, None, None, None, coeffs=out.coeffs)
        return LSMCResult(out[0], out[1], None, None, None)
    if engine != "xla":
        raise ValueError(f"engine must be 'xla', 'fused', 'mega', or 'fusedpath', got {engine!r}")
    paths = simulate_gbm(seed, market, product.T, sim, device)
    return lsmc_option_pricing(paths, product, market.r, spec,
                               return_surface=return_surface,
                               return_coeffs=return_coeffs,
                               exercise_steps=exercise_steps,
                               antithetic=sim.antithetic)

"""Out-of-sample policy replay: fit the exercise rule once, reprice fresh
paths (port of `amcx.policy`).

An in-sample LSMC price carries foresight bias: the coefficients were fit
on the paths they price. The two-pass estimator fits the per-step
coefficients on one path set and replays the frozen rule (exercise at the
first step where intrinsic beats the clamped fitted continuation) on an
independent set; the replayed price is a lower bound of the exact one.

A forward first-hit walk and a backward fixed-policy overwrite give the
same cashflows, so the zero-path-memory kernel replays by skipping its
regression (``lsmc_price_fusedpath(replay_coeffs=...)``);
:func:`reprice_with_coeffs` is the torch walk on given paths.

The coefficients are weights on the standardized regressor
``x̂ = (S_t − mean_t)·inv_std_t``; a replay uses the frame of its fit. The
mega and fusedpath fits use the closed-form GBM frame
(`amcx_torch.gbm_standardization`), which the market parameters give again.

Seeds: amcx splits one JAX key into fit and pricing streams. Here the fit
draws on ``seed`` and the pricing pass on ``seed + 1``, block b of a
chained fusedpath replay on ``seed + 1 + b``: disjoint integer seeds within
one call (and the fusedpath stream is keyed apart from the pathgen's).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from .basis import basis_cols
from .engine import LSMCResult, price_option, resolve_regression_spec
from .ops.lsmc_fusedpath import lsmc_price_fusedpath
from .paths import gbm_standardization, simulate_gbm
from .payoff import barrier_gate, exercise_allow_row
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = ["reprice_with_coeffs", "price_out_of_sample", "OOSResult", "valuation_interval"]


def reprice_with_coeffs(
    paths_tm: torch.Tensor,
    coeffs: torch.Tensor,
    product: ProductSpec,
    r,
    mean_t: torch.Tensor,
    inv_std_t: torch.Tensor,
    spec: RegressionSpec = RegressionSpec(),
    exercise_steps=None,
    antithetic: bool = False,
    axis_name: Optional[str] = None,
) -> LSMCResult:
    """Replay a frozen exercise policy on (fresh) paths, with no regression.

    Walks the time-major ``(n_steps+1, n_paths)`` paths forward and
    exercises at the first step where intrinsic beats the clamped fitted
    continuation ``max(Σ_a c_{t,a} B_a(x̂_t), 0)`` and the knock gate is
    open (amcx's Q1-Q7 rules); alive gated paths pay intrinsic at maturity.
    ``coeffs``: ``(n_steps, k)`` or ``(n_steps+1, k)`` (a maturity row is
    ignored); ``mean_t``/``inv_std_t``: the fit's frame, length
    ``n_steps+1``. Runs where the paths lie. ``axis_name`` (sharded paths)
    is not ported (ROADMAP A15).
    """
    if axis_name is not None:
        raise NotImplementedError("reprice_with_coeffs over sharded paths (axis_name) is not "
                                  "ported yet (ROADMAP A15)")
    n_steps, n_paths = paths_tm.shape[0] - 1, paths_tm.shape[1]
    dtype, dev = paths_tm.dtype, paths_tm.device
    coeffs = torch.as_tensor(coeffs, dtype=dtype, device=dev)
    if coeffs.shape[0] == n_steps + 1:
        coeffs = coeffs[:n_steps]  # the exported zero maturity row
    mean_t = torch.as_tensor(mean_t, dtype=dtype, device=dev)
    inv_std_t = torch.as_tensor(inv_std_t, dtype=dtype, device=dev)
    knocked = barrier_gate(paths_tm, product.barrier, product.barrier_type)
    allowed = None
    if exercise_steps is not None:
        allowed = exercise_allow_row(exercise_steps, n_steps).tolist()
    phi = 1.0 if product.option_type == "call" else -1.0
    K = torch.tensor(product.K, dtype=dtype, device=dev)
    r_ = torch.as_tensor(r, dtype=dtype, device=dev)
    dt = torch.tensor(product.T / n_steps, dtype=dtype, device=dev)

    def payoff(S):
        return torch.clamp_min(phi * (S - K), 0.0)

    cf = torch.zeros((n_paths,), dtype=dtype, device=dev)
    tau = torch.full((n_paths,), float(n_steps), dtype=dtype, device=dev)
    alive = torch.ones((n_paths,), dtype=torch.bool, device=dev)
    if product.is_american:
        for t in range(n_steps):
            S = paths_tm[t]
            ex = payoff(S)
            cols = basis_cols((S - mean_t[t]) * inv_std_t[t], spec.basis, spec.degree)
            fitted = cols[0] * coeffs[t, 0]
            for a in range(1, len(cols)):
                fitted = fitted + cols[a] * coeffs[t, a]
            hit = alive & knocked[t] & (ex > torch.clamp_min(fitted, 0.0))  # Q2
            if allowed is not None and not allowed[t]:
                hit = torch.zeros_like(hit)
            cf = torch.where(hit, ex, cf)
            tau = torch.where(hit, float(t), tau)
            alive = alive & ~hit
    # maturity leg: still-alive gated paths pay intrinsic at T (Q4/Q7)
    cf = torch.where(alive & knocked[n_steps], payoff(paths_tm[n_steps]), cf)
    discounted = cf * torch.exp(-r_ * dt * tau)
    stat = discounted
    if antithetic:
        half = n_paths // 2
        stat = 0.5 * (discounted[:half] + discounted[half:])
    price = torch.mean(stat)
    var = torch.mean(torch.square(stat - price))
    stderr = torch.sqrt(var) / torch.sqrt(torch.tensor(float(stat.shape[0]), dtype=dtype,
                                                        device=dev))
    return LSMCResult(price, stderr, cf, tau, None)


class OOSResult(NamedTuple):
    """Fit + out-of-sample replay pair: ``fit`` is the in-sample run (with
    ``coeffs``), ``oos`` the replay on the independent paths. ``oos.price``
    is the lower bound to quote; ``fit.price − oos.price`` estimates the
    one-pass estimator's foresight bias."""

    fit: LSMCResult
    oos: LSMCResult


def price_out_of_sample(
    seed: int,
    market: MarketParams,
    product: ProductSpec,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    engine: str = "mega",
    exercise_steps=None,
    n_fit_paths: Optional[int] = None,
    replay_engine: Optional[str] = None,
    replay_blocks: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> OOSResult:
    """Two-pass Longstaff-Schwartz on ``device``: fit on ``seed``, reprice
    on ``seed + 1`` (module docstring).

    ``engine``: the fit, ``"mega"`` or ``"fusedpath"`` (``"xla"`` is routed
    to mega, as amcx does: its per-step data frame is not exported).
    ``n_fit_paths``: fit on fewer paths than the pricing pass.
    ``replay_engine``: ``None``/``"xla"``, the torch walk of
    :func:`reprice_with_coeffs` on ``simulate_gbm`` paths; ``"fusedpath"``,
    the zero-path-memory replay on paths the kernel regenerates, chained
    over ``replay_blocks`` independent ``sim.n_paths`` blocks (block b on
    seed ``seed + 1 + b``; the price is the mean of the block prices, the
    stderr √Σse²/B). ``"mega"`` waits for kernel 2's replay mode (ROADMAP
    B2 options / A8).
    """
    # resolve "auto" here so the replay rebuilds its columns with the
    # degree the fit solved
    spec = resolve_regression_spec(spec, product, q=market.q)
    if engine not in ("mega", "fusedpath", "xla"):
        raise ValueError(f"unsupported fit engine {engine!r}")
    if engine == "xla":
        engine = "mega"
    if replay_engine == "mega":
        raise NotImplementedError("replay_engine='mega' is not ported yet: kernel 2 has no "
                                  "replay mode (ROADMAP B2 options / A8)")
    if replay_engine not in (None, "xla", "fusedpath"):
        raise ValueError(f"unsupported replay engine {replay_engine!r}")
    if replay_blocks != 1 and replay_engine != "fusedpath":
        raise ValueError("replay_blocks > 1 requires replay_engine='fusedpath' (the "
                         "zero-path-memory block route)")
    if replay_blocks < 1:
        raise ValueError(f"replay_blocks must be >= 1, got {replay_blocks}")
    if replay_engine == "fusedpath" and product.has_barrier:
        raise ValueError("fusedpath replay does not support barriers")
    fit_sim = sim if n_fit_paths is None else dataclasses.replace(sim, n_paths=n_fit_paths)
    fit = price_option(seed, market, product, spec, fit_sim, engine=engine,
                       exercise_steps=exercise_steps, return_coeffs=True, device=device)
    if replay_engine == "fusedpath":
        blocks = [lsmc_price_fusedpath(
            seed + 1 + b, market.S0, product.K, market.r, market.sigma,
            product.T / sim.n_steps, sim.n_steps, sim.n_paths,
            1.0 if product.option_type == "call" else -1.0, q=market.q, basis=spec.basis,
            degree=spec.degree, rcond=spec.rcond, american=product.is_american,
            antithetic=sim.antithetic, return_stats=True, exercise_steps=exercise_steps,
            replay_coeffs=fit.coeffs, device=device) for b in range(replay_blocks)]
        prices = torch.stack([p for p, _ in blocks])
        variances = torch.stack([se * se for _, se in blocks])
        # iid blocks: the variance of the mean of B block means is the mean
        # block variance over B
        price = torch.sum(prices) / replay_blocks
        stderr = torch.sqrt(torch.sum(variances)) / replay_blocks
        return OOSResult(fit, LSMCResult(price, stderr, None, None, None))
    mean_t, inv_std_t = gbm_standardization(market, product.T, sim.n_steps, device=device)
    paths = simulate_gbm(seed + 1, market, product.T, sim, device)
    oos = reprice_with_coeffs(paths, fit.coeffs, product, market.r, mean_t, inv_std_t, spec,
                              exercise_steps=exercise_steps, antithetic=sim.antithetic)
    return OOSResult(fit, oos)


def valuation_interval(
    seed,
    market: MarketParams,
    product: ProductSpec,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    engine: str = "mega",
    n_fit_paths: Optional[int] = None,
    replay_engine: Optional[str] = None,
    n_dual_paths: int = 4096,
    n_inner: int = 32,
    nested: bool = True,
    device="cuda",
):
    """amcx's fit → [out-of-sample lower bound, Andersen-Broadie dual upper
    bound]; its dual bound (`amcx/dual.py`) is not ported yet (ROADMAP A8)."""
    raise NotImplementedError("valuation_interval needs the dual upper bound of amcx/dual.py, "
                              "which is not ported yet (ROADMAP A8)")

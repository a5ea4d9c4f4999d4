"""Backward induction driven by the fused step kernels (port of
`amcx.engine_pallas`).

Each backward step is two passes over the step's rows,
`amcx_torch.ops.lsmc_pallas.step_moments` and ``step_apply``, with the tiny
solve between them in plain torch (`unpack_moments` +
`amcx_torch.regress.pinv_solve`, as amcx leaves it to XLA). The engine
serves the univariate family: vanilla and barrier (all four knock
variants) puts/calls, Bermudan schedules, dense continuation surfaces and
antithetic pair folding.

The per-step standardization statistics (weighted mean/std of the
regressor, SURVEY Q1 + the reference's scaling semantics) do not depend on
the recursion, so they are computed for every step at once before the
loop (:func:`precompute_standardization`) and reach the kernels as a
device array: the host loop never reads a value back.

On a CUDA tensor the step functions launch their kernels; on a CPU tensor
they run their plain versions. :func:`backward_induction_fused_reference`
runs the plain versions on any device (the card's check compares the two).
amcx's ``n_paths % 4096`` rule is dropped: any ``n_paths`` works.
``axis_name`` (sharded moments) raises: it waits for ROADMAP A15.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from . import tracing
from .engine import LSMCResult, resolve_regression_spec
from .ops.lsmc_pallas import (
    step_apply_launcher,
    step_moments,
    step_moments_reference,
    step_stats,
    unpack_moments,
)
from .payoff import barrier_gate, exercise_allow_row, intrinsic_value
from .regress import pinv_solve, reject_axis_name
from .types import ProductSpec, RegressionSpec

__all__ = ["precompute_standardization", "backward_induction_fused",
           "backward_induction_fused_reference", "lsmc_option_pricing_fused"]


def precompute_standardization(paths_tm: torch.Tensor, weights_tm, spec: RegressionSpec,
                               eps: float = 1e-6, axis_name: Optional[str] = None):
    """Per-step (weighted) mean and ``1/(factor·std)`` over the path axis,
    for every time step at once. Without ``scaling`` or
    ``internal_standardize`` the frame is the identity (mean 0, 1/std 1).
    ``axis_name`` raises (ROADMAP A15)."""
    reject_axis_name(axis_name, "precompute_standardization")
    if not (spec.scaling or spec.internal_standardize):
        n1 = paths_tm.shape[0]
        return (torch.zeros(n1, dtype=paths_tm.dtype, device=paths_tm.device),
                torch.ones(n1, dtype=paths_tm.dtype, device=paths_tm.device))
    n = paths_tm.shape[1]
    if weights_tm is None:
        mean = torch.sum(paths_tm, dim=1) / n
        var = torch.sum(torch.square(paths_tm - mean[:, None]), dim=1) / n
    else:
        wsum = torch.clamp_min(torch.sum(weights_tm, dim=1), eps)
        mean = torch.sum(weights_tm * paths_tm, dim=1) / wsum
        var = torch.sum(weights_tm * torch.square(paths_tm - mean[:, None]), dim=1) / wsum
    std = torch.clamp_min(torch.sqrt(var), eps)
    factor = spec.scaling_factor if spec.scaling else 1.0
    return mean, 1.0 / (factor * std)


def backward_induction_fused(
    paths_tm: torch.Tensor,
    r,
    dt,
    K,
    phi: float,
    spec: RegressionSpec,
    barrier=None,
    barrier_type: str = "down-in",
    american: bool = True,
    return_surface: bool = False,
    axis_name: Optional[str] = None,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """Fused-kernel LSMC for a single-asset put (``phi=-1``) or call
    (``phi=+1``) on time-major ``(n_steps+1, n_paths)`` f32 paths.

    ``exercise_steps``: optional Bermudan schedule; the regression still
    runs every step (Q6: the surface feeds exposures), only the select is
    gated. ``antithetic``: paths pair i with i + n_paths/2 and are folded
    before the variance, so the stderr is that of the pair means. Returns
    ``LSMCResult(price, stderr, cashflows, exercise_times, continuation)``;
    the surface is ``(n_steps+1, n_paths)`` with a zero maturity row.
    ``axis_name`` raises (ROADMAP A15).
    """
    return _induction(step_moments, step_apply_launcher, paths_tm, r, dt, K, phi, spec, barrier,
                      barrier_type, american, return_surface, axis_name, exercise_steps,
                      antithetic)


def backward_induction_fused_reference(paths_tm: torch.Tensor, *args, **kwargs) -> LSMCResult:
    """:func:`backward_induction_fused` on the step kernels' plain versions,
    on any device."""
    return _induction(step_moments_reference,
                      functools.partial(step_apply_launcher, reference=True), paths_tm, *args,
                      **kwargs)


def _induction(moments, apply_launcher, paths_tm, r, dt, K, phi, spec, barrier=None,
               barrier_type="down-in", american=True, return_surface=False,
               axis_name=None, exercise_steps=None, antithetic=False):
    reject_axis_name(axis_name, "backward_induction_fused")
    if paths_tm.ndim != 2 or paths_tm.shape[0] < 2 or paths_tm.dtype != torch.float32:
        raise ValueError(
            f"paths must be time-major (n_steps+1, n_paths) float32, got "
            f"{tuple(paths_tm.shape)} {paths_tm.dtype}")
    paths = paths_tm.contiguous()
    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    dtype, device = paths.dtype, paths.device
    # r·dt rounded once to f32, as amcx's jnp.asarray(r * dt, dtype)
    rdt = float(torch.as_tensor(r * dt, dtype=dtype))
    K, phi = float(K), float(phi)
    degree = spec.degree
    itm = spec.regress_on == "itm"

    knocked = None if barrier is None else barrier_gate(paths, float(barrier), barrier_type)
    weights = None
    use_w_t = torch.ones(n_steps + 1, dtype=dtype, device=device)
    if itm:
        w = intrinsic_value(paths, K, "call" if phi > 0 else "put") > 0
        if knocked is not None:
            w = w & knocked
        w = w.to(dtype)
        # degenerate-weight fallback, as amcx.regress._fit: a step whose
        # ITM∧knocked mass is below k+1 points fits (and standardizes) on
        # all paths instead of solving a zero Gram
        use_w_t = (torch.sum(w, dim=1) >= float(degree + 2)).to(dtype)
        weights = torch.where(use_w_t[:, None] > 0, w, 1.0)
        del w
    mean_t, inv_std_t = precompute_standardization(paths, weights, spec)
    del weights
    allow_t = (torch.ones(n_steps + 1, dtype=dtype, device=device) if exercise_steps is None
               else exercise_allow_row(exercise_steps, n_steps, dtype=dtype, device=device))
    stats = step_stats(mean_t, inv_std_t, use_w_t, allow_t)

    cf = torch.clamp_min(phi * (paths[n_steps] - K), 0.0)
    if knocked is not None:
        cf = torch.where(knocked[n_steps], cf, 0.0)
    tau = torch.full((n_paths,), float(n_steps), dtype=dtype, device=device)
    surface = (torch.zeros((n_steps + 1, n_paths), dtype=dtype, device=device)
               if return_surface else None)
    common = dict(K=K, phi=phi, basis=spec.basis, degree=degree)
    # European without a surface: the regression runs (Q6) and nothing
    # reads its fit
    apply_ = (apply_launcher(stats, paths, cf, tau, knocked, select=american, surface=surface,
                             **common) if american or return_surface else None)
    for t in range(n_steps - 1, -1, -1):
        kn_t = None if knocked is None else knocked[t]
        packed = moments(stats, t, paths[t], cf, tau, kn_t, rdt=rdt, itm_weights=itm, **common)
        G, b = unpack_moments(packed, degree + 1)
        coeffs = pinv_solve(G, b, spec.rcond)
        if apply_ is not None:
            apply_(t, coeffs)

    discounted = cf * torch.exp(-rdt * tau)
    if antithetic:
        half = n_paths // 2
        stat = 0.5 * (discounted[:half] + discounted[half:])
    else:
        stat = discounted
    price = torch.mean(stat)
    var = torch.mean(torch.square(stat - price))
    stderr = torch.sqrt(var) / math.sqrt(stat.shape[0])
    return LSMCResult(price, stderr, cf, tau, surface)


def lsmc_option_pricing_fused(
    paths_tm: torch.Tensor,
    product: ProductSpec,
    r,
    spec: RegressionSpec = RegressionSpec(),
    return_surface: bool = False,
    axis_name: Optional[str] = None,
    exercise_steps=None,
    antithetic: bool = False,
) -> LSMCResult:
    """`amcx_torch.engine.lsmc_option_pricing`'s signature on the fused
    step kernels. ``axis_name`` raises (ROADMAP A15)."""
    reject_axis_name(axis_name, "lsmc_option_pricing_fused")
    n_steps = paths_tm.shape[0] - 1
    spec = resolve_regression_spec(spec, product, for_surface=return_surface)
    with tracing.span("induction"):
        return backward_induction_fused(
            paths_tm, r, product.T / n_steps, product.K,
            1.0 if product.option_type == "call" else -1.0, spec,
            barrier=product.barrier, barrier_type=product.barrier_type,
            american=product.is_american, return_surface=return_surface,
            exercise_steps=exercise_steps, antithetic=antithetic)

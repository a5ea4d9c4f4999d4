"""Weighted least squares via normal equations (port of `amcx.regress`).

Per time step: form the tiny Gram system ``G = AᵀWA`` and moment vector
``b = AᵀWy`` by elementwise multiply-and-sum over paths, solve it with a
column-equilibrated eigendecomposition pseudo-inverse (``lstsq``-like
minimum-norm behaviour on the rank-1 t=0 design), and return fitted values
``A @ c``. Everything stays in float32; the Gram is never a matrix product,
so TF32 cannot reach it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .basis import design_matrix
from .types import RegressionSpec

__all__ = [
    "pinv_solve",
    "weighted_standardize",
    "fit_continuation",
    "fit_continuation_with_coeffs",
    "regression_fitted_values",
]


def pinv_solve(G: torch.Tensor, b: torch.Tensor, rcond: float = 1e-6) -> torch.Tensor:
    """Minimum-norm solve of the symmetric PSD system ``G c = b``.

    Column-equilibrated first (``D G D`` with ``D = diag(G)^{-1/2}``);
    eigenvalues at or below ``rcond * max|eig|`` are treated as zero.
    """
    tiny = torch.finfo(G.dtype).tiny
    dg = torch.diagonal(G)
    d = torch.where(dg > 0, torch.rsqrt(torch.clamp_min(dg, tiny)), torch.zeros_like(dg))
    Gs = G * d[:, None] * d[None, :]
    bs = b * d
    w, V = torch.linalg.eigh(Gs)
    wmax = torch.clamp_min(torch.max(torch.abs(w)), tiny)
    inv_w = torch.where(w > rcond * wmax, 1.0 / w, torch.zeros_like(w))
    # tiny (k, k) products: plain elementwise sums keep them in full f32
    Vt_b = (V * bs[:, None]).sum(dim=0)
    return d * (V * (inv_w * Vt_b)[None, :]).sum(dim=1)


def reject_axis_name(axis_name: Optional[str], what: str) -> None:
    """Raise for a sharded-path-axis call: amcx's ``axis_name`` collective
    mode is kept in the port's signatures but waits for ROADMAP A15."""
    if axis_name is not None:
        raise NotImplementedError(
            f"{what} over a sharded path axis (axis_name) is not ported yet (ROADMAP A15)")


def weighted_standardize(
    x: torch.Tensor,
    weights: Optional[torch.Tensor],
    scaling_factor: float = 1.0,
    eps: float = 1e-6,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Affine-standardize ``x`` with (weighted) mean/std:
    ``(x - mean) / (factor * max(std, eps))``. ``axis_name`` raises
    (ROADMAP A15)."""
    reject_axis_name(axis_name, "weighted_standardize")
    ones = torch.ones_like(x) if weights is None else weights
    wsum = torch.clamp_min(torch.sum(ones), eps)
    mean = torch.sum(ones * x) / wsum
    var = torch.sum(ones * torch.square(x - mean)) / wsum
    std = torch.clamp_min(torch.sqrt(var), eps)
    return (x - mean) / (scaling_factor * std)


def regression_fitted_values(
    x: torch.Tensor,
    y: torch.Tensor,
    spec: RegressionSpec,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted-OLS fitted values of ``y`` on the polynomial basis of ``x``,
    evaluated at every point (zero-weight points included)."""
    return _fit(x, y, weights, spec)[0]


def _fit(x, y, weights, spec: RegressionSpec):
    if weights is not None:
        # Degenerate-weight fallback: with fewer than k+1 effective points
        # the weighted fit is meaningless (its zero Gram would solve to
        # all-zero coefficients, which replayed elsewhere fabricate
        # cont = 0); fall back to the unweighted fit. Applied before the
        # standardization so frame and fit stay consistent.
        wsum = torch.sum(weights)
        weights = torch.where(wsum >= float(spec.degree + 2), weights,
                              torch.ones_like(weights))
    if spec.scaling:
        xs = weighted_standardize(x, weights, spec.scaling_factor)
    elif spec.internal_standardize:
        xs = weighted_standardize(x, weights, 1.0)
    else:
        xs = x
    A = design_matrix(xs, spec.basis, spec.degree)  # (n, k)
    wy = y if weights is None else weights * y
    Aw = A if weights is None else A * weights[:, None]
    G = torch.sum(Aw[:, :, None] * A[:, None, :], dim=0)
    b = torch.sum(A * wy[:, None], dim=0)
    coeffs = pinv_solve(G, b, spec.rcond)
    return torch.sum(A * coeffs[None, :], dim=-1), coeffs


def fit_continuation(
    s_t: torch.Tensor,
    discounted_cashflows: torch.Tensor,
    spec: RegressionSpec,
    weights: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Continuation-value estimate at one time step, clamped at zero.
    ``axis_name`` raises (ROADMAP A15)."""
    reject_axis_name(axis_name, "fit_continuation")
    fitted, _ = _fit(s_t, discounted_cashflows, weights, spec)
    return torch.clamp_min(fitted, 0.0)


def fit_continuation_with_coeffs(
    s_t: torch.Tensor,
    discounted_cashflows: torch.Tensor,
    spec: RegressionSpec,
    weights: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    clamp: bool = True,
):
    """Like :func:`fit_continuation` but also returns the ``(degree+1,)``
    solved coefficients. ``clamp=False`` skips the zero floor (signed
    cashflows, where flooring would disable out-of-the-money exercise).
    ``axis_name`` raises (ROADMAP A15)."""
    reject_axis_name(axis_name, "fit_continuation_with_coeffs")
    fitted, coeffs = _fit(s_t, discounted_cashflows, weights, spec)
    if clamp:
        fitted = torch.clamp_min(fitted, 0.0)
    return fitted, coeffs

"""Plain Longstaff-Schwartz backward induction, the yardstick of every route.

Written from the method, not from the program: float64 paths, a design
matrix of Chebyshev polynomials of a standardized regressor, a weighted
least-squares fit by the normal equations solved in float64, exercise where
the immediate payoff exceeds the continuation clamped at zero, and the
cashflow carried with its exercise step. ``dtype`` is the precision of the
per-path arithmetic (float64 for the reference, bfloat16 for the control);
the sums and the solve stay in float64.

Solvers, as the configuration names them:

- ``ridge``: equilibrate the Gram (D G D, D = diag(G)^-1/2), add ``rcond``
  to its diagonal, solve, then refine twice against the un-ridged system;
- ``pinv``: equilibrate, then the eigen-decomposition's pseudo-inverse with
  eigenvalues at or below ``rcond`` times the largest treated as zero.

Frames (the standardization of the regressor):

- ``closed_form``: E[S_t] = S0 e^{(r-q)t}, Var[S_t] = S0^2 e^{2(r-q)t}(e^{sigma^2 t} - 1);
- ``data``: the mean and standard deviation of each step's paths;
- ``sorted_data``: the basket's descending order statistics, each column
  standardized by its own mean and standard deviation per step.

The standard deviation is clamped at 1e-6 in every frame.
"""

from __future__ import annotations

import itertools

import torch

_F64 = torch.float64
_EPS = 1e-6


def chebyshev(x: torch.Tensor, degree: int) -> list:
    """T_0 .. T_degree of ``x`` by the three-term recurrence."""
    cols = [torch.ones_like(x)]
    if degree >= 1:
        cols.append(x)
    for _ in range(2, degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return cols


def total_degree_indices(n_vars: int, degree: int) -> list:
    """Every multi-index over ``n_vars`` variables of total degree <= ``degree``."""
    return [a for a in itertools.product(range(degree + 1), repeat=n_vars) if sum(a) <= degree]


def design(xs: list, degree: int) -> torch.Tensor:
    """``(n, m)`` design of products of the variables' Chebyshev columns over
    every multi-index of total degree <= ``degree``."""
    uni = [chebyshev(x, degree) for x in xs]
    cols = []
    for alpha in total_degree_indices(len(xs), degree):
        col = uni[0][alpha[0]]
        for a in range(1, len(xs)):
            if alpha[a]:
                col = col * uni[a][alpha[a]]
        cols.append(col)
    return torch.stack(cols, dim=1)


def _equilibrate(G):
    dg = torch.diagonal(G)
    d = torch.where(dg > 0, 1.0 / torch.sqrt(torch.clamp_min(dg, 1e-300)), 0.0)
    return d, G * d[:, None] * d[None, :]


def solve(G: torch.Tensor, b: torch.Tensor, solver: str, rcond: float) -> torch.Tensor:
    """Coefficients of the normal equations ``G c = b`` (float64)."""
    d, Gs = _equilibrate(G)
    bs = b * d
    if solver == "pinv":
        w, V = torch.linalg.eigh(Gs)
        wmax = torch.clamp_min(torch.max(torch.abs(w)), 1e-300)
        inv_w = torch.where(w > rcond * wmax, 1.0 / w, 0.0)
        return d * (V @ (inv_w * (V.T @ bs)))
    if solver == "ridge":
        L = torch.linalg.cholesky(Gs + rcond * torch.eye(G.shape[0], dtype=G.dtype,
                                                         device=G.device))
        c = torch.cholesky_solve(bs[:, None], L)[:, 0]
        for _ in range(2):
            c = c + torch.cholesky_solve((bs - Gs @ c)[:, None], L)[:, 0]
        return d * c
    raise ValueError(f"unknown solver {solver!r}")


def frame(paths: torch.Tensor, spec: dict, market: dict, T: float):
    """Per-step ``(mean, 1/std)`` of the regressor, each ``(n_steps + 1, n_vars)``."""
    n_steps = paths.shape[0] - 1
    kind = spec["frame"]
    if kind == "closed_form":
        t = torch.arange(n_steps + 1, dtype=_F64, device=paths.device) * (T / n_steps)
        growth = torch.exp((market["r"] - market.get("q", 0.0)) * t)
        mean = market["S0"] * growth
        var = (market["S0"] * growth) ** 2 * torch.expm1(market["sigma"] ** 2 * t)
        return mean[:, None], 1.0 / torch.clamp_min(torch.sqrt(var), _EPS)[:, None]
    x = paths.to(_F64)
    if x.ndim == 2:
        x = x[..., None]
    if kind == "sorted_data":
        x = torch.sort(x, dim=-1, descending=True).values
    elif kind != "data":
        raise ValueError(f"unknown frame {kind!r}")
    mean = torch.mean(x, dim=1)
    std = torch.sqrt(torch.mean(torch.square(x - mean[:, None, :]), dim=1))
    return mean, 1.0 / torch.clamp_min(std, _EPS)


def payoff(S: torch.Tensor, product: dict) -> torch.Tensor:
    kind, K = product["payoff"], product["K"]
    if kind == "put":
        return torch.clamp_min(K - S, 0.0)
    if kind == "call":
        return torch.clamp_min(S - K, 0.0)
    if kind == "maxcall":
        return torch.clamp_min(torch.max(S, dim=-1).values - K, 0.0)
    raise ValueError(f"unknown payoff {kind!r}")


def induction(paths: torch.Tensor, product: dict, market: dict, spec: dict,
              dtype=_F64) -> dict:
    """Price by backward induction on ``paths`` ``(n_steps + 1, n_paths[, n_assets])``.

    ``product``: ``payoff``, ``K``, ``T`` and ``exercise_from_step`` (the first
    step that may exercise). ``spec``: ``degree``, ``weights`` (``itm`` or
    ``all``), ``solver``, ``rcond``, ``frame``. Returns float64 ``price`` and
    ``stderr`` (0-d).
    """
    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    T = product["T"]
    rdt = market["r"] * T / n_steps
    mean, inv_std = frame(paths, spec, market, T)
    S_all = paths.to(dtype)
    cf = payoff(S_all[n_steps], product)
    tau = torch.full((n_paths,), float(n_steps), dtype=_F64, device=paths.device)
    for t in range(n_steps - 1, product.get("exercise_from_step", 0) - 1, -1):
        S = S_all[t]
        ex = payoff(S, product)
        if spec["frame"] == "sorted_data":
            S = torch.sort(S, dim=-1, descending=True).values
        x = S if S.ndim == 2 else S[:, None]
        xs = [((x[:, a] - mean[t, a].to(dtype)) * inv_std[t, a].to(dtype))
              for a in range(x.shape[1])]
        A = design(xs, spec["degree"])
        y = cf.to(_F64) * torch.exp(-rdt * (tau - t))
        A64 = A.to(_F64)
        w = (ex > 0).to(_F64) if spec["weights"] == "itm" else torch.ones_like(y)
        Aw = A64 * w[:, None]
        coef = solve(Aw.T @ A64, Aw.T @ y, spec["solver"], spec["rcond"])
        cont = torch.clamp_min(A @ coef.to(dtype), 0.0)
        exercise = ex > cont
        cf = torch.where(exercise, ex, cf)
        tau = torch.where(exercise, float(t), tau)
    v = cf.to(_F64) * torch.exp(-rdt * tau)
    price = torch.mean(v)
    return {"price": price, "stderr": torch.sqrt(torch.mean(torch.square(v - price)) / n_paths)}

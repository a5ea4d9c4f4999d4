"""The counterparty-credit-risk exposure profile of an American option by
plain backward induction, the yardstick of the CCR routes.

Written from the reference's method (american_monte_carlo.py:400-414,
``compute_ccr_exposures``, over the continuation of the all-paths fit,
:127-131), not from the program: the induction of
:func:`perfbench.reference.lsmc.induction` (its frame, Chebyshev design,
solver and payoff) with its own fits and exercise, which also records each
step's clamped continuation C_t = max(fit, 0) and reduces it at once:

- EPE, the mean of C_t over the paths;
- PFE-5 and PFE-95, the 5th and 95th percentiles of C_t by a sort and
  linear interpolation between the order statistics around
  q (n - 1) / 100 (``np.percentile``'s default).

``dtype`` is the precision of the per-path arithmetic (float64 for the
reference, bfloat16 for the control); the sums, the solve and the
percentiles' interpolation stay in float64. The maturity date's entries are
zero, as the program records them.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import lsmc

_F64 = torch.float64


def _percentile(srt: torch.Tensor, q: float) -> torch.Tensor:
    pos = q / 100.0 * (srt.shape[0] - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, srt.shape[0] - 1)
    return srt[lo] + (pos - lo) * (srt[hi] - srt[lo])


def induction_profile(paths: torch.Tensor, product: dict, market: dict, spec: dict,
                      dtype=_F64) -> dict:
    """Price and profile by backward induction on ``paths`` ``(n_steps + 1,
    n_paths)``; ``product`` and ``spec`` as :func:`lsmc.induction` takes
    them. Returns float64 ``price`` and ``stderr`` (0-d) and ``epe``,
    ``pfe5``, ``pfe95`` (``(n_steps + 1,)``, on the paths' device)."""
    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    T = product["T"]
    rdt = market["r"] * T / n_steps
    mean, inv_std = lsmc.frame(paths, spec, market, T)
    S_all = paths.to(dtype)
    cf = lsmc.payoff(S_all[n_steps], product)
    tau = torch.full((n_paths,), float(n_steps), dtype=_F64, device=paths.device)
    rows = torch.zeros((3, n_steps + 1), dtype=_F64, device=paths.device)
    for t in range(n_steps - 1, -1, -1):
        S = S_all[t]
        ex = lsmc.payoff(S, product)
        x = (S - mean[t, 0].to(dtype)) * inv_std[t, 0].to(dtype)
        A = lsmc.design([x], spec["degree"])
        y = cf.to(_F64) * torch.exp(-rdt * (tau - t))
        A64 = A.to(_F64)
        w = (ex > 0).to(_F64) if spec["weights"] == "itm" else torch.ones_like(y)
        Aw = A64 * w[:, None]
        coef = lsmc.solve(Aw.T @ A64, Aw.T @ y, spec["solver"], spec["rcond"])
        cont = torch.clamp_min(A @ coef.to(dtype), 0.0)
        srt = torch.sort(cont.to(_F64)).values
        rows[:, t] = torch.stack([torch.mean(srt), _percentile(srt, 5.0),
                                  _percentile(srt, 95.0)])
        if t >= product.get("exercise_from_step", 0):
            exercise = ex > cont
            cf = torch.where(exercise, ex, cf)
            tau = torch.where(exercise, float(t), tau)
    v = cf.to(_F64) * torch.exp(-rdt * tau)
    price = torch.mean(v)
    return {"price": price, "stderr": torch.sqrt(torch.mean(torch.square(v - price)) / n_paths),
            "epe": rows[0], "pfe5": rows[1], "pfe95": rows[2]}

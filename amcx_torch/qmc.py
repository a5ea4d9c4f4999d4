"""Quasi-Monte Carlo path generation from scrambled Sobol points (port of
`amcx.qmc`).

GBM paths driven by a scrambled Sobol low-discrepancy sequence instead of
pseudo-random normals: one Sobol dimension per time step (per time step
and asset for baskets), Owen-scrambled by the seed. For smooth payoffs the
error decays close to O(n⁻¹) rather than O(n^-1/2); the exercise rule of an
American option is not smooth, so its gain is smaller. Use power-of-two
path counts (Sobol balance).

Here the points and their inverse-CDF normals come from scipy on the host
(f64, cast to f32) and the rest runs in torch on ``device``;
`amcx_torch.ops.sobol_pallas.simulate_gbm_qmc_device` generates the points
on the card instead (kernel 11). The Brownian-bridge product ``W = B·Z``
is taken in f64 and rounded once, so no TF32 setting can reach it. scipy
is imported inside the functions, never when the package is imported.
"""

from __future__ import annotations

from collections import deque
from typing import Union

import numpy as np
import torch

from .types import MarketParams, SimConfig

__all__ = ["sobol_normals", "simulate_gbm_qmc", "simulate_gbm_multi_qmc",
           "brownian_bridge_matrix"]


def brownian_bridge_matrix(n_steps: int, dt: float) -> np.ndarray:
    """The ``(n_steps, n_steps)`` f64 construction matrix B with ``W = B @
    Z``: Sobol dimension 0 drives W_T, dimension 1 the midpoint, then
    recursive bisection (Moskowitz & Caflisch 1996), so the best-distributed
    coordinates carry the coarse path structure. Rows are steps 1..n_steps
    (W_0 = 0); ``B @ B.T`` is the Brownian covariance ``min(t_i, t_j)``."""
    rows = {0: np.zeros(n_steps), n_steps: np.zeros(n_steps)}
    rows[n_steps][0] = np.sqrt(n_steps * dt)
    j = 1
    todo = deque([(0, n_steps)])
    while todo:
        left, right = todo.popleft()
        if right - left < 2:
            continue
        m = (left + right) // 2
        w = (rows[left] * ((right - m) / (right - left))
             + rows[right] * ((m - left) / (right - left)))
        w[j] = np.sqrt((m - left) * (right - m) / (right - left) * dt)
        rows[m] = w
        j += 1
        todo.append((left, m))
        todo.append((m, right))
    return np.stack([rows[i] for i in range(1, n_steps + 1)])


def sobol_normals(seed: int, n_steps: int, n_paths: int) -> np.ndarray:
    """Scrambled-Sobol standard normals, time-major ``(n_steps, n_paths)``
    f32: one dimension per step, Owen-scrambled with ``seed``, the inverse
    normal CDF in f64 on the host."""
    from scipy.stats import norm, qmc

    eng = qmc.Sobol(d=n_steps, scramble=True, seed=int(seed))
    u = np.clip(eng.random(n_paths), 1e-12, 1.0 - 1e-12)  # (n_paths, n_steps)
    return np.ascontiguousarray(norm.ppf(u).astype(np.float32).T)


def _bridge_product(B: np.ndarray, Z: torch.Tensor) -> torch.Tensor:
    """``B @ Z`` over the leading (time) axis of Z, in f64, rounded once to
    Z's dtype."""
    B64 = torch.as_tensor(B, dtype=torch.float64, device=Z.device)
    return torch.tensordot(B64, Z.double(), dims=1).to(Z.dtype)


def simulate_gbm_qmc(seed: int, market: MarketParams, T, sim: SimConfig,
                     brownian_bridge: bool = False,
                     device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """GBM paths from scrambled-Sobol increments on ``device``, time-major
    ``(n_steps+1, n_paths)`` like `amcx_torch.paths.simulate_gbm`.
    ``brownian_bridge`` orders the Sobol dimensions by the bridge
    construction (:func:`brownian_bridge_matrix`) instead of one per step.
    ``sim.antithetic`` raises: Sobol points have no antithetic mirror."""
    if sim.antithetic:
        raise ValueError("scrambled-Sobol paths have no antithetic mirror; "
                         "use SimConfig(antithetic=False)")
    device = torch.device(device)
    dtype = sim.torch_dtype
    Z = torch.as_tensor(sobol_normals(seed, sim.n_steps, sim.n_paths), device=device).to(dtype)
    S0, r, q, sigma, T_ = (torch.as_tensor(v, dtype=dtype, device=device)
                           for v in (market.S0, market.r, market.q, market.sigma, T))
    dt = T_ / sim.n_steps
    drift = (r - q - 0.5 * sigma ** 2) * dt
    if brownian_bridge:
        W = _bridge_product(brownian_bridge_matrix(sim.n_steps, float(T) / sim.n_steps), Z)
        t_idx = torch.arange(1, sim.n_steps + 1, dtype=dtype, device=device)[:, None]
        log_rel = drift * t_idx + sigma * W
    else:
        log_rel = torch.cumsum(drift + sigma * torch.sqrt(dt) * Z, dim=0)
    log_rel = torch.cat([torch.zeros((1, sim.n_paths), dtype=dtype, device=device), log_rel])
    return S0 * torch.exp(log_rel)


def simulate_gbm_multi_qmc(seed: int, S0, r, sigma, T, sim: SimConfig, q=0.0, corr=None,
                           brownian_bridge: bool = False,
                           device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Correlated multi-asset GBM from scrambled-Sobol points, time-major
    ``(n_steps+1, n_paths, n_assets)`` (the `simulate_gbm_multi` layout).

    One Sobol dimension per (step, asset), time-major, so
    ``brownian_bridge`` gives the lowest dimensions to the coarse time
    structure of every asset; the assets are then correlated by the
    Cholesky factor of ``corr`` (f64, rounded once). ``sim.antithetic``
    raises."""
    if sim.antithetic:
        raise ValueError("scrambled-Sobol paths have no antithetic mirror; "
                         "use SimConfig(antithetic=False)")
    device = torch.device(device)
    dtype = sim.torch_dtype
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=dtype, device=device))
    A = S0.shape[0]

    def vec(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device), (A,))

    rv, qv, sv = vec(r), vec(q), vec(sigma)
    Z = torch.as_tensor(sobol_normals(seed, sim.n_steps * A, sim.n_paths),
                        device=device).to(dtype).reshape(sim.n_steps, A, sim.n_paths)
    if corr is not None:
        chol = torch.linalg.cholesky(torch.as_tensor(corr, dtype=torch.float64, device=device))
        Z = torch.einsum("ab,tbn->tan", chol, Z.double()).to(dtype)
    dt = torch.as_tensor(T, dtype=dtype, device=device) / sim.n_steps
    drift = (rv - qv - 0.5 * sv * sv) * dt  # (A,)
    if brownian_bridge:
        W = _bridge_product(brownian_bridge_matrix(sim.n_steps, float(T) / sim.n_steps), Z)
        t_idx = torch.arange(1, sim.n_steps + 1, dtype=dtype, device=device)[:, None, None]
        log_rel = drift[None, :, None] * t_idx + sv[None, :, None] * W
    else:
        log_rel = torch.cumsum(drift[None, :, None] + sv[None, :, None] * torch.sqrt(dt) * Z,
                               dim=0)
    log_rel = torch.cat([torch.zeros((1, A, sim.n_paths), dtype=dtype, device=device),
                         log_rel])
    return torch.movedim(S0[None, :, None] * torch.exp(log_rel), 1, 2)

"""GBM path simulation (port of `amcx.paths`).

Layout is time-major ``(n_steps+1, n_paths)``: the backward induction reads
one contiguous row per step, and on the GPU neighbouring threads read
neighbouring addresses of that row. `to_path_major` converts to the
reference's path-major layout.

Two simulators, selected by ``SimConfig.backend``:

- ``"torch"``: ``torch.randn`` from a ``torch.Generator`` seeded with the
  caller's integer seed, then the log-space cumulative sum of exact GBM
  increments (amcx's ``"xla"`` simulator);
- ``"philox"``: the counter-based Philox4x32-10 pathgen of
  `amcx_torch.ops.gbm` (a CUDA kernel on the card, its plain version on the
  CPU), amcx's ``"pallas"`` counterpart. Its random numbers are a
  documented pure function of (seed, path, step), not the TPU's.
"""

from __future__ import annotations

from typing import Union

import torch

from .types import MarketParams, SimConfig

__all__ = [
    "simulate_gbm",
    "to_path_major",
    "brownian_normals",
    "gbm_standardization",
]


def to_path_major(paths_tm: torch.Tensor) -> torch.Tensor:
    """(n_steps+1, n_paths, ...) -> (n_paths, n_steps+1, ...) reference layout."""
    return torch.swapaxes(paths_tm, 0, 1)


def gbm_standardization(market: MarketParams, T, n_steps: int,
                        dtype=torch.float32, device=None):
    """Closed-form per-step standardization statistics for GBM spot paths:
    ``(mean_t, 1/std_t)`` with ``E[S_t] = S0 e^{(r−q)t}`` and
    ``Var[S_t] = S0² e^{2(r−q)t}(e^{σ²t} − 1)``, in ``dtype`` with amcx's
    operation order. At t=0 the variance is 0 and the clamped 1/std
    multiplies an exactly-zero deviation.
    """
    t = torch.arange(n_steps + 1, dtype=dtype, device=device) * (
        torch.tensor(T, dtype=dtype, device=device) / n_steps)
    growth = torch.exp((market.r - market.q) * t)
    mean = market.S0 * growth
    var = (market.S0 * growth) ** 2 * torch.expm1(market.sigma ** 2 * t)
    return mean, 1.0 / torch.clamp_min(torch.sqrt(var), 1e-6)


def brownian_normals(generator: torch.Generator, n_steps: int, n_paths: int,
                     dtype=torch.float32, antithetic: bool = False,
                     device=None) -> torch.Tensor:
    """Standard-normal increments, time-major ``(n_steps, n_paths)``; with
    ``antithetic`` the second half of the path axis negates the first."""
    if antithetic:
        half = torch.randn((n_steps, n_paths // 2), generator=generator,
                           dtype=dtype, device=device)
        return torch.cat([half, -half], dim=1)
    return torch.randn((n_steps, n_paths), generator=generator, dtype=dtype,
                       device=device)


def _simulate_gbm_torch(generator, market, T, sim: SimConfig, device):
    dtype = sim.torch_dtype
    n_steps, n_paths = sim.n_steps, sim.n_paths
    S0, r, sigma, q, T_ = (torch.tensor(v, dtype=dtype, device=device)
                           for v in (market.S0, market.r, market.sigma, market.q, T))
    dt = T_ / n_steps
    Z = brownian_normals(generator, n_steps, n_paths, dtype, sim.antithetic, device)
    drift = (r - q - 0.5 * sigma ** 2) * dt
    log_inc = drift + sigma * torch.sqrt(dt) * Z
    log_rel = torch.cumsum(log_inc, dim=0)
    log_rel = torch.cat([torch.zeros((1, n_paths), dtype=dtype, device=device),
                         log_rel], dim=0)
    return S0 * torch.exp(log_rel)


def simulate_gbm(
    seed: Union[int, torch.Generator],
    market: MarketParams,
    T,
    sim: SimConfig,
    device: Union[str, torch.device] = "cpu",
) -> torch.Tensor:
    """Simulate GBM paths on ``device``; returns time-major
    ``(n_steps+1, n_paths)``.

    ``seed``: an integer in [0, 2⁶⁴) for either backend, or (``"torch"``
    backend only) a ``torch.Generator`` on ``device``.
    """
    device = torch.device(device)
    if sim.backend == "philox":
        from .ops.gbm import gbm_paths

        if isinstance(seed, torch.Generator):
            raise TypeError("the philox backend takes an integer seed, not a Generator")
        if sim.antithetic:
            raise NotImplementedError(
                "antithetic philox paths are not ported yet (ROADMAP B1 options)")
        if sim.dtype != "float32":
            raise ValueError("the philox pathgen emits float32 paths")
        return gbm_paths(seed, market.S0, market.r, market.sigma, market.q, T,
                         sim.n_steps, sim.n_paths, device=device)
    if isinstance(seed, torch.Generator):
        generator = seed
    else:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(seed))
    return _simulate_gbm_torch(generator, market, T, sim, device)

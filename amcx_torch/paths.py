"""GBM path simulation (port of `amcx.paths`).

Layout is time-major ``(n_steps+1, n_paths)``: the backward induction reads
one contiguous row per step, and on the GPU neighbouring threads read
neighbouring addresses of that row. `to_path_major` converts to the
reference's path-major layout.

Three simulators, selected by ``SimConfig.backend``:

- ``"torch"``: ``torch.randn`` from a ``torch.Generator`` seeded with the
  caller's integer seed, then the log-space cumulative sum of exact GBM
  increments (amcx's ``"xla"`` simulator);
- ``"philox"``: the counter-based Philox4x32-10 pathgen of
  `amcx_torch.ops.gbm` (a CUDA kernel on the card, its plain version on the
  CPU), amcx's ``"pallas"`` counterpart. Its random numbers are a
  documented pure function of (seed, path, step), not the TPU's;
- ``"sobol"`` / ``"sobol-bridge"``: scrambled-Sobol points from scipy's
  direction numbers, a new scramble per seed, through
  `amcx_torch.ops.sobol_pallas.sobol_gbm_paths` (kernel 11 on the card, its
  plain version on the CPU), one Sobol dimension a step or in
  Brownian-bridge order (amcx's ``simulate_gbm_qmc_device``).
"""

from __future__ import annotations

from typing import Union

import torch

from . import tracing
from .ops.gbm_multi import gbm_multi_paths, gbm_multi_paths_reference
from .ops.lsmc_megakernel import closed_form_frame
from .types import SOBOL_BACKENDS, MarketParams, SimConfig

__all__ = [
    "simulate_gbm",
    "simulate_gbm_multi",
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
    multiplies an exactly-zero deviation. The kernels' routes read these
    rows from `amcx_torch.ops.lsmc_megakernel.closed_form_rows`, built once
    per market and grid.
    """
    return closed_form_frame(market.S0, market.r, market.sigma, market.q, T, n_steps, dtype,
                             device)


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
    # as_tensor keeps a tensor's autograd graph: the paths are
    # differentiable in S0, r, sigma, q and T (amcx_torch.greeks)
    S0, r, sigma, q, T_ = (torch.as_tensor(v, dtype=dtype, device=device)
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
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Simulate GBM paths on ``device``; returns time-major
    ``(n_steps+1, n_paths)``.

    ``seed``: an integer in [0, 2⁶⁴) for every backend, or (``"torch"``
    backend only) a ``torch.Generator`` on ``device``.
    """
    with tracing.span("pathgen"):
        device = torch.device(device)
        if sim.backend != "torch" and isinstance(seed, torch.Generator):
            raise TypeError(f"the {sim.backend} backend takes an integer seed, not a Generator")
        if sim.backend in SOBOL_BACKENDS:
            from .ops.sobol_pallas import sobol_gbm_paths

            return sobol_gbm_paths(seed, market.S0, market.r, market.sigma, market.q, T,
                                   sim.n_steps, sim.n_paths,
                                   brownian_bridge=sim.backend == "sobol-bridge", device=device)
        if sim.backend == "philox":
            from .ops.gbm import gbm_paths

            if sim.antithetic:
                raise NotImplementedError(
                    "antithetic philox paths are not ported yet (ROADMAP B1 options)")
            if sim.dtype != "float32":
                raise ValueError("the philox pathgen emits float32 paths")
            return gbm_paths(seed, market.S0, market.r, market.sigma, market.q, T,
                             sim.n_steps, sim.n_paths, device=device)
        return _simulate_gbm_torch(_generator(seed, device), market, T, sim, device)


def _generator(seed, device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


def simulate_gbm_multi(
    seed: Union[int, torch.Generator],
    S0,
    r,
    sigma,
    T,
    sim: SimConfig,
    q=None,
    corr=None,
    device: Union[str, torch.device] = "cuda",
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """Correlated multi-asset GBM on ``device``, time-major ``(n_steps+1,
    n_paths, n_assets)`` (amcx's ``simulate_gbm_multi``).

    ``corr``: the asset correlation matrix (identity if None), applied by
    its Cholesky factor L as ``W_b = Σ_{a≤b} Z_a L[b, a]`` in elementwise
    f32 products, so no matrix product (and no TF32 setting) reaches the
    paths. ``S0``/``r``/``sigma``/``q`` broadcast per asset. ``seed`` as in
    :func:`simulate_gbm` (the ``"torch"`` simulator; amcx has no kernel
    pathgen for baskets). ``sim.antithetic`` mirrors path i into path
    i + n_paths/2.

    After ``torch.randn`` the paths come from
    :func:`amcx_torch.ops.gbm_multi.gbm_multi_paths`: on the card one launch
    of its kernel (no copy from the host, no synchronise; float32, at most 8
    assets, S0/r/sigma/q/T host values that need no grad, else it raises),
    on the CPU its plain version. ``differentiable=True`` asks for that
    plain version, the chain of torch operations, on any device: the paths
    are then differentiable in tensor inputs (S0, r, sigma, q, T), as
    ``max_call_greeks`` needs.
    """
    with tracing.span("pathgen"):
        device = torch.device(device)
        dtype = sim.torch_dtype
        n_assets = torch.atleast_1d(torch.as_tensor(S0)).shape[0]
        n_steps, n_paths = sim.n_steps, sim.n_paths
        generator = _generator(seed, device)
        if sim.antithetic:
            half = torch.randn((n_steps, n_paths // 2, n_assets), generator=generator, dtype=dtype,
                               device=device)
            Z = torch.cat([half, -half], dim=1)
        else:
            Z = torch.randn((n_steps, n_paths, n_assets), generator=generator, dtype=dtype,
                            device=device)
        if differentiable:
            return gbm_multi_paths_reference(Z, S0, r, sigma, q, T, corr)
        return gbm_multi_paths(Z, S0, r, sigma, q, T, corr)

"""Self-hosted pricing oracles (port of the vanilla engines of `amcx.oracle`).

- :func:`bs_price`: closed-form Black-Scholes-Merton with a continuous
  dividend yield;
- :func:`crr_price`: the Cox-Ross-Rubinstein binomial tree, European or
  American, backward over levels on a fixed-size node vector.

Both compute in float64 on the CPU and return Python floats: they gate
results, so they never need the card. amcx evaluates its tree in float32
and needs `amcx.oracle._expm1_acc` to keep ``p = (a-d)/(u-d)`` accurate
(a ratio of ~1e-3 differences of numbers near 1); in float64 the plain
``expm1`` already carries ~1e-16 relative error, so that helper has no
counterpart here.
"""

from __future__ import annotations

import math

import torch

__all__ = ["norm_cdf", "bs_price", "crr_price"]


def _phi(option_type: str) -> float:
    return -1.0 if option_type.strip().lower() == "put" else 1.0


def norm_cdf(x):
    """Standard normal CDF of a float or tensor (float64 for floats)."""
    if isinstance(x, torch.Tensor):
        return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
    return 0.5 * (1.0 + math.erf(float(x) / math.sqrt(2.0)))


def bs_price(S0, K, T, r, sigma, q=0.0, option_type: str = "call") -> float:
    """Black-Scholes-Merton European price (analytic), in float64."""
    S0, K, T, r, sigma, q = (float(v) for v in (S0, K, T, r, sigma, q))
    phi = _phi(option_type)
    sig = max(sigma * math.sqrt(T), 1e-12)
    d1 = (math.log(S0 / K) + (r - q + 0.5 * sigma ** 2) * T) / sig
    d2 = d1 - sig
    return phi * (S0 * math.exp(-q * T) * norm_cdf(phi * d1)
                  - K * math.exp(-r * T) * norm_cdf(phi * d2))


def crr_price(S0, K, T, r, sigma, n_steps: int = 1000, q=0.0,
              option_type: str = "call", american: bool = False) -> float:
    """Cox-Ross-Rubinstein binomial price in float64 on the CPU."""
    f64 = torch.float64
    S0, K, T, r, sigma, q = (float(v) for v in (S0, K, T, r, sigma, q))
    n_steps = int(n_steps)
    dt = T / n_steps
    x = sigma * math.sqrt(dt)
    em_x, em_mx = math.expm1(x), math.expm1(-x)
    p = (math.expm1((r - q) * dt) - em_mx) / (em_x - em_mx)
    disc = math.exp(-r * dt)
    phi = _phi(option_type)
    j = torch.arange(n_steps + 1, dtype=f64)  # number of up-moves

    def node_spots(level):
        # S at level i, node j = S0 u^j d^(i-j); nodes j > i are padding
        # that the final V[0] never reads
        return S0 * torch.exp((2.0 * j - level) * x)

    V = torch.clamp_min(phi * (node_spots(n_steps) - K), 0.0)
    for level in range(n_steps - 1, -1, -1):
        Vup = torch.cat([V[1:], V[-1:]])
        V = disc * (p * Vup + (1.0 - p) * V)
        if american:
            V = torch.maximum(V, torch.clamp_min(phi * (node_spots(level) - K), 0.0))
    return float(V[0])

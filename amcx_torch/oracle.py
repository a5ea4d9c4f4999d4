"""Self-hosted pricing oracles (port of `amcx.oracle`).

- :func:`bs_price`, :func:`bs_greeks`: closed-form Black-Scholes-Merton
  price and delta/vega/rho with a continuous dividend yield;
- :func:`barrier_price` / :func:`down_in_price`: Reiner-Rubinstein
  European barrier prices (rebate 0, continuous monitoring), with the
  Broadie-Glasserman-Kou :func:`discrete_barrier_shift`;
- :func:`crr_price`: the Cox-Ross-Rubinstein binomial tree, European or
  American, backward over levels on a fixed-size node vector;
- :func:`crr_barrier_price` / :func:`crr_down_in_price`: the same tree
  with barrier monitoring at every level (knock-in by a joint
  vanilla/knock-in recursion).

All compute in float64 on the CPU and return Python floats: they gate
results, so they never need the card. amcx evaluates its tree in float32
and needs `amcx.oracle._expm1_acc` to keep ``p = (a-d)/(u-d)`` accurate
(a ratio of ~1e-3 differences of numbers near 1); in float64 the plain
``expm1`` already carries ~1e-16 relative error, so that helper has no
counterpart here.
"""

from __future__ import annotations

import math

import torch

__all__ = ["norm_cdf", "bs_price", "bs_greeks", "discrete_barrier_shift", "barrier_price",
           "down_in_price", "crr_price", "crr_barrier_price", "crr_down_in_price"]


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


def bs_greeks(S0, K, T, r, sigma, q=0.0, option_type: str = "call") -> dict:
    """Closed-form Black-Scholes-Merton ``{"delta", "vega", "rho"}`` (the
    derivatives of :func:`bs_price` in S0, σ and r), in float64."""
    S0, K, T, r, sigma, q = (float(v) for v in (S0, K, T, r, sigma, q))
    phi = _phi(option_type)
    sig = max(sigma * math.sqrt(T), 1e-12)
    d1 = (math.log(S0 / K) + (r - q + 0.5 * sigma ** 2) * T) / sig
    d2 = d1 - sig
    pdf = math.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
    return {"delta": phi * math.exp(-q * T) * norm_cdf(phi * d1),
            "vega": S0 * math.exp(-q * T) * pdf * math.sqrt(T),
            "rho": phi * K * T * math.exp(-r * T) * norm_cdf(phi * d2)}


def discrete_barrier_shift(barrier, sigma, dt, down: bool = True) -> float:
    """Broadie-Glasserman-Kou continuity correction: the continuously
    monitored barrier equivalent to one monitored every ``dt`` is shifted
    by ``exp(∓0.5826 σ √dt)`` (minus for down barriers)."""
    sign = -1.0 if down else 1.0
    return float(barrier) * math.exp(sign * 0.5826 * float(sigma) * math.sqrt(float(dt)))


def _rr_terms(S0, K, T, r, sigma, H, q, phi, eta):
    """Reiner-Rubinstein/Haug building blocks A, B, C, D (rebate 0)."""
    b = r - q  # cost of carry
    sig = max(sigma * math.sqrt(T), 1e-12)
    mu = (b - 0.5 * sigma ** 2) / max(sigma ** 2, 1e-12)
    x1 = math.log(S0 / K) / sig + (1.0 + mu) * sig
    x2 = math.log(S0 / H) / sig + (1.0 + mu) * sig
    y1 = math.log(H * H / (S0 * K)) / sig + (1.0 + mu) * sig
    y2 = math.log(H / S0) / sig + (1.0 + mu) * sig
    ebrt, ert = math.exp((b - r) * T), math.exp(-r * T)
    pow1, pow2 = (H / S0) ** (2.0 * (mu + 1.0)), (H / S0) ** (2.0 * mu)

    def plain(z):
        return phi * (S0 * ebrt * norm_cdf(phi * z) - K * ert * norm_cdf(phi * z - phi * sig))

    def reflected(z):
        return phi * (S0 * ebrt * pow1 * norm_cdf(eta * z)
                      - K * ert * pow2 * norm_cdf(eta * z - eta * sig))

    return plain(x1), plain(x2), reflected(y1), reflected(y2)


def _barrier_kind(barrier_type: str):
    bt = barrier_type.strip().lower()
    if bt not in ("down-in", "up-in", "down-out", "up-out"):
        raise ValueError(f"barrier_type must be down/up-in/out, got {barrier_type!r}")
    return bt.startswith("down"), bt.endswith("in")


def barrier_price(S0, K, T, r, sigma, barrier, q=0.0, option_type: str = "call",
                  barrier_type: str = "down-in") -> float:
    """Reiner-Rubinstein European barrier price, all four knock variants
    (rebate 0, continuous monitoring), in float64. Knock-outs use in-out
    parity; a spot already beyond the barrier is knocked (in → vanilla,
    out → 0)."""
    S0, K, T, r, sigma, H, q = (float(v) for v in (S0, K, T, r, sigma, barrier, q))
    down, knock_in = _barrier_kind(barrier_type)
    is_call = _phi(option_type) > 0
    A, B, C, D = _rr_terms(S0, K, T, r, sigma, H, q, _phi(option_type), 1.0 if down else -1.0)
    if down:
        ins = (C if K >= H else A - B + D) if is_call else (B - C + D if K >= H else A)
    else:
        ins = (A if K >= H else B - C + D) if is_call else (A - B + D if K >= H else C)
    ins = max(ins, 0.0)
    vanilla = bs_price(S0, K, T, r, sigma, q, option_type)
    if (S0 <= H) if down else (S0 >= H):
        return vanilla if knock_in else 0.0
    return ins if knock_in else max(vanilla - ins, 0.0)


def down_in_price(S0, K, T, r, sigma, barrier, q=0.0, option_type: str = "call") -> float:
    """Reiner-Rubinstein down-and-in European price (rebate 0, continuous
    monitoring)."""
    return barrier_price(S0, K, T, r, sigma, barrier, q, option_type, "down-in")


def _tree(S0, T, r, sigma, n_steps, q):
    """CRR constants ``(p, disc)`` and the node spots of a level."""
    dt = T / n_steps
    x = sigma * math.sqrt(dt)
    em_x, em_mx = math.expm1(x), math.expm1(-x)
    p = (math.expm1((r - q) * dt) - em_mx) / (em_x - em_mx)
    j = torch.arange(n_steps + 1, dtype=torch.float64)  # number of up-moves

    def node_spots(level):
        # S at level i, node j = S0 u^j d^(i-j); nodes j > i are padding
        # that the final V[0] never reads
        return S0 * torch.exp((2.0 * j - level) * x)

    return p, math.exp(-r * dt), node_spots


def _rollback(V, p, disc):
    return disc * (p * torch.cat([V[1:], V[-1:]]) + (1.0 - p) * V)


def crr_price(S0, K, T, r, sigma, n_steps: int = 1000, q=0.0,
              option_type: str = "call", american: bool = False) -> float:
    """Cox-Ross-Rubinstein binomial price in float64 on the CPU."""
    S0, K, T, r, sigma, q = (float(v) for v in (S0, K, T, r, sigma, q))
    n_steps = int(n_steps)
    phi = _phi(option_type)
    p, disc, node_spots = _tree(S0, T, r, sigma, n_steps, q)
    V = torch.clamp_min(phi * (node_spots(n_steps) - K), 0.0)
    for level in range(n_steps - 1, -1, -1):
        V = _rollback(V, p, disc)
        if american:
            V = torch.maximum(V, torch.clamp_min(phi * (node_spots(level) - K), 0.0))
    return float(V[0])


def crr_barrier_price(S0, K, T, r, sigma, barrier, n_steps: int = 1000, q=0.0,
                      option_type: str = "call", american: bool = False,
                      barrier_type: str = "down-in") -> float:
    """CRR binomial barrier price, all four knock variants (rebate 0,
    monitoring at every tree level), in float64 on the CPU. A knock-in
    claim becomes the vanilla where the barrier is touched and is not
    exercised before (SURVEY Q4); a knock-out claim dies there."""
    S0, K, T, r, sigma, H, q = (float(v) for v in (S0, K, T, r, sigma, barrier, q))
    down, knock_in = _barrier_kind(barrier_type)
    n_steps = int(n_steps)
    phi = _phi(option_type)
    p, disc, node_spots = _tree(S0, T, r, sigma, n_steps, q)

    def hit(S):
        return S <= H if down else S >= H

    S_T = node_spots(n_steps)
    payoff_T = torch.clamp_min(phi * (S_T - K), 0.0)
    if knock_in:
        V_van = payoff_T
        V_bar = torch.where(hit(S_T), payoff_T, 0.0)
        for level in range(n_steps - 1, -1, -1):
            S = node_spots(level)
            V_van = _rollback(V_van, p, disc)
            V_bar = _rollback(V_bar, p, disc)
            if american:
                V_van = torch.maximum(V_van, torch.clamp_min(phi * (S - K), 0.0))
            V_bar = torch.where(hit(S), V_van, V_bar)
        return float(V_bar[0])
    V = torch.where(hit(S_T), 0.0, payoff_T)
    for level in range(n_steps - 1, -1, -1):
        S = node_spots(level)
        V = _rollback(V, p, disc)
        if american:
            V = torch.maximum(V, torch.clamp_min(phi * (S - K), 0.0))
        V = torch.where(hit(S), 0.0, V)
    return float(V[0])


def crr_down_in_price(S0, K, T, r, sigma, barrier, n_steps: int = 1000, q=0.0,
                      option_type: str = "call", american: bool = False) -> float:
    """CRR binomial down-and-in price (rebate 0), in float64."""
    return crr_barrier_price(S0, K, T, r, sigma, barrier, n_steps, q, option_type, american,
                             "down-in")

"""The random streams the benchmarked routes draw from, regenerated in plain
torch (in float64 past the uniforms).

Each stream is a published pure function of the seed, so the reference
rebuilds the same paths without reading anything the program made:

- ``philox_gbm``: Philox4x32-10 with key (seed mod 2^32, seed >> 32) and
  counter (j, p, 0, 0); the uniforms ((x >> 8) + 1) 2^-24 of words
  (x0, x1) and (x2, x3) make two Box-Muller pairs, the normals of steps
  4j .. 4j+3 of path p; the spot is S0 exp(cumsum(drift dt + sigma sqrt(dt) z)).
- ``philox_bridge``: the same generator with counter (t, p >> 2, 1, 0), one
  call for the four paths 4q .. 4q+3 of step t; the Brownian motion is
  built backwards, W_T = sqrt(T dt) xi_T and
  W_t = a W_{t+1} + sqrt(dt a) xi_t with a = t / (t + 1).
- ``randn_basket``: ``torch.randn((n_steps, n_paths, n_assets))`` in float32
  from a ``torch.Generator`` on the device seeded with the seed, then
  independent GBM per asset.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_F64 = torch.float64


def _mulhilo(m: int, x: torch.Tensor):
    # 32 x 32 -> 64-bit product in int64 halves, so nothing overflows
    x_lo, x_hi = x & 0xFFFF, x >> 16
    t_lo, t_hi = m * x_lo, m * x_hi
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _M32
    hi = ((t_hi + (t_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    k0, k1 = seed & _M32, seed >> 32
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(words):
    """The four normals of one draw: (r0 cos a0, r0 sin a0, r1 cos a1, r1 sin a1)."""
    u = [((w >> 8) + 1).to(_F64) * 2.0 ** -24 for w in words]
    r0, r1 = torch.sqrt(-2.0 * torch.log(u[0])), torch.sqrt(-2.0 * torch.log(u[2]))
    a0, a1 = 2.0 * math.pi * u[1], 2.0 * math.pi * u[3]
    return r0 * torch.cos(a0), r0 * torch.sin(a0), r1 * torch.cos(a1), r1 * torch.sin(a1)


def _increments(market: dict, T: float, n_steps: int):
    dt = T / n_steps
    return dt, (market["r"] - market.get("q", 0.0) - 0.5 * market["sigma"] ** 2) * dt


def philox_gbm(seed: int, market: dict, T: float, n_steps: int, n_paths: int,
               device) -> torch.Tensor:
    """Spot paths ``(n_steps + 1, n_paths)`` float64 of the ``philox_gbm`` stream."""
    dt, drift_dt = _increments(market, T, n_steps)
    vol = market["sigma"] * math.sqrt(dt)
    p = torch.arange(n_paths, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    log_s = torch.full((n_paths,), math.log(market["S0"]), dtype=_F64, device=device)
    rows = [torch.exp(log_s)]
    for j in range(-(-n_steps // 4)):
        z = _box_muller(philox(torch.full((), j, dtype=torch.int64, device=device), p, zero,
                               zero, seed))
        for zi in z[:n_steps - 4 * j]:
            log_s = log_s + (drift_dt + vol * zi)
            rows.append(torch.exp(log_s))
    return torch.stack(rows)


def philox_bridge_normals(seed: int, t: int, n_paths: int, device) -> torch.Tensor:
    """xi(seed, t, .) of the ``philox_bridge`` stream, ``(n_paths,)`` float64."""
    q = torch.arange(n_paths // 4, dtype=torch.int64, device=device)
    ct = torch.full((), t, dtype=torch.int64, device=device)
    one = torch.ones((), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack(_box_muller(philox(ct, q, one, zero, seed)), dim=1).reshape(-1)


def philox_bridge(seed: int, market: dict, T: float, n_steps: int, n_paths: int,
                  device) -> torch.Tensor:
    """Spot paths ``(n_steps + 1, n_paths)`` float64 of the ``philox_bridge`` stream."""
    if n_paths % 4:
        raise ValueError(f"the bridge stream draws 4 paths a call, got n_paths={n_paths}")
    dt, drift_dt = _increments(market, T, n_steps)
    W = math.sqrt(dt * n_steps) * philox_bridge_normals(seed, n_steps, n_paths, device)
    rows = [None] * (n_steps + 1)
    rows[n_steps] = W
    for t in range(n_steps - 1, -1, -1):
        a = t / (t + 1.0)
        W = a * W + math.sqrt(dt * a) * philox_bridge_normals(seed, t, n_paths, device)
        rows[t] = W
    W = torch.stack(rows)
    steps = torch.arange(n_steps + 1, dtype=_F64, device=device)[:, None]
    return market["S0"] * torch.exp(drift_dt * steps + market["sigma"] * W)


def randn_basket(seed: int, market: dict, T: float, n_steps: int, n_paths: int,
                 device) -> torch.Tensor:
    """Independent GBM paths ``(n_steps + 1, n_paths, n_assets)`` float64 of the
    ``randn_basket`` stream."""
    n_assets = len(market["S0"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn((n_steps, n_paths, n_assets), generator=g, dtype=torch.float32,
                    device=device)
    dt, drift_dt = _increments(market, T, n_steps)
    log_inc = drift_dt + market["sigma"] * math.sqrt(dt) * z.to(_F64)
    del z
    s0 = torch.tensor(market["S0"], dtype=_F64, device=device)
    log_rel = torch.cat([torch.zeros((1, n_paths, n_assets), dtype=_F64, device=device),
                         torch.cumsum(log_inc, dim=0)])
    return s0 * torch.exp(log_rel)


STREAMS = {"philox_gbm": philox_gbm, "philox_bridge": philox_bridge,
           "randn_basket": randn_basket}

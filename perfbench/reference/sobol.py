"""The randomized-QMC stream of the Sobol routes, regenerated in plain
float64 torch from scipy's point set.

``sobol_bridge`` (Chaudhary 2005: LSM on scrambled Sobol points assigned
by the Brownian bridge of Moskowitz and Caflisch 1996):

- the points: ``scipy.stats.qmc.Sobol(d=n_steps, scramble=True,
  seed=seed).random(n_paths)``, Joe-Kuo direction numbers with a linear
  matrix scramble and a digital shift drawn from the seed; ``n_paths`` a
  power of two, so that they are a whole net. Path p is the point of
  natural index p (the digital shift XOR the direction numbers of p's set
  bits): the engine draws in Gray-code order, its k-th point being natural
  index k ^ (k >> 1);
- the uniforms: each coordinate at the midpoint of its cell of 2^-23,
  (floor(x 2^23) + 1/2) 2^-23, the stream's published resolution (it keeps
  every uniform inside (0, 1));
- the normals: z = Phi^-1(u) by ``torch.special.ndtri``;
- the Brownian motion W = B z, with B built here by bisection: dimension 0
  gives W_T = sqrt(T) z_0, then the intervals of the grid are halved level
  by level, left to right, each midpoint m = floor((l + r) / 2) of an
  interval of at least two steps taking the next dimension j:
  W_m = ((t_r - t_m) W_l + (t_m - t_l) W_r) / (t_r - t_l)
  + sqrt((t_m - t_l)(t_r - t_m) / (t_r - t_l)) z_j;
- the spot S_t = S0 exp((r - q - sigma^2 / 2) t + sigma W_t), S_0 = S0.

``dtype`` is the precision of the chain: float64 for the reference; for
the control the normals, W and the spot are each rounded to ``dtype``
before the next stage reads them. The uniforms are the stream's own in
both: bfloat16 holds 2^8 levels below 1, so rounding them would merge the
net's points and put some on 1, where Phi^-1 is infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F64 = torch.float64
_CELL = 2.0 ** 23


def bisection_matrix(n_steps: int, T: float) -> torch.Tensor:
    """``(n_steps, n_steps)`` float64 B with W_{t_1..t_n} = B z (the rows are
    the grid's steps 1..n, W_0 = 0; column j is Sobol dimension j)."""
    dt = T / n_steps
    rows = {0: torch.zeros(n_steps, dtype=_F64), n_steps: torch.zeros(n_steps, dtype=_F64)}
    rows[n_steps][0] = math.sqrt(T)
    level, j = [(0, n_steps)], 1
    while level:
        below = []
        for left, right in level:
            if right - left < 2:
                continue
            m = (left + right) // 2
            tl, tm, tr = left * dt, m * dt, right * dt
            row = (rows[left] * (tr - tm) + rows[right] * (tm - tl)) / (tr - tl)
            row[j] = math.sqrt((tm - tl) * (tr - tm) / (tr - tl))
            rows[m] = row
            j += 1
            below += [(left, m), (m, right)]
        level = below
    if j != n_steps:
        raise AssertionError(f"the bisection used {j} of {n_steps} dimensions")
    return torch.stack([rows[t] for t in range(1, n_steps + 1)])


def sobol_bridge(seed: int, market: dict, T: float, n_steps: int, n_paths: int, device,
                 dtype=_F64) -> torch.Tensor:
    """Spot paths ``(n_steps + 1, n_paths)`` float64 of the ``sobol_bridge``
    stream on ``device``, the stages past the uniforms rounded to ``dtype``."""
    from scipy.stats import qmc

    if n_paths < 1 or n_paths & (n_paths - 1):
        raise ValueError(f"the Sobol stream takes a power-of-two n_paths, got {n_paths}")

    def stage(x):
        return x if dtype == _F64 else x.to(dtype).to(_F64)

    gray = qmc.Sobol(d=n_steps, scramble=True, seed=int(seed)).random(n_paths)
    k = np.arange(n_paths)
    x = np.empty_like(gray)  # (n_paths, n_steps), path-major
    x[k ^ (k >> 1)] = gray
    del gray
    x = torch.from_numpy(x).to(device).T
    u = (torch.floor(x * _CELL) + 0.5) / _CELL
    del x
    z = stage(torch.special.ndtri(u))
    del u
    W = stage(bisection_matrix(n_steps, T).to(device) @ z)
    del z
    drift = market["r"] - market.get("q", 0.0) - 0.5 * market["sigma"] ** 2
    t = torch.arange(1, n_steps + 1, dtype=_F64, device=device)[:, None] * (T / n_steps)
    S = market["S0"] * torch.exp(drift * t + market["sigma"] * W)
    del W
    s0 = torch.full((1, n_paths), float(market["S0"]), dtype=_F64, device=device)
    return stage(torch.cat([s0, S]))

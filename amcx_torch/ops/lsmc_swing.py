"""Swing (multiple-stopping) LSMC on the card: the CUDA kernel's wrapper and
its plain version.

Port of `amcx.ops.lsmc_swing` (``_swing_kernel`` via ``lsmc_price_swing``):
the whole rights ladder of one vanilla payoff, at most one exercise per
date, in one induction. All R regressions of a step share the design
matrix and the weights, so a step sums one Gram and R right-hand-side rows
(P = k(k+1)/2 + R·k moments), factors the Gram once and back-solves R
times, then runs the exercise cascade in DESCENDING k, so ``V[k-1]`` is
read before its own update. ``amcx_torch/csrc/lsmc_swing.cu`` drives
moments → solve → apply kernels per step from a host loop, with kernel 3's
warp-role moments (``csrc/lsmc_roles.cuh``) on the same persistent grid
(see the note at the top of that file).

:func:`_swing_reference` is the plain-torch transcription: the value planes
in time-T units, the explicit-pair moments summed in f64 and rounded once,
the shared equilibrated-ridge factor of `lsmc_megakernel` with R refined
back-solves (vectorised over the rights: the same f32 operations on each
element), the cascade, and the f64 final sums. On the card kernel and plain
version agree to the bit, and at ``n_rights=1`` both equal the single-option
induction (kernel 2) on the same paths and frame.

Differences from amcx: any ``n_paths`` (amcx: a multiple of 4096; an even
count with ``antithetic``); the value plane of zero rights is not stored
(it is identically 0); at most :data:`SWING_MAX_RIGHTS` rights (amcx: 12,
its VMEM budget).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..basis import BASIS_IDS, basis_cols
from .lsmc_megakernel import (MAX_DEGREE, _data_standardization, _factor_equilibrated_ridge,
                              _pairs, _solve_factored, _sum_once_rounded, book_blocks,
                              mega_stats)

__all__ = ["lsmc_price_swing", "lsmc_price_swing_reference", "SWING_MAX_RIGHTS"]

SWING_MAX_RIGHTS = 128  # csrc/lsmc_swing.cu kMaxRights


def _obligations(n_rights: int, n_min: int, kk: int) -> int:
    """Takes still owed while ``kk`` rights remain (``n_rights - kk``
    already exercised)."""
    return max(0, n_min - (n_rights - kk))


def _swing_reference(paths, stats, cfg):
    """Plain-torch swing induction; returns the f32 ``(2,)`` sums of c_0·V^R
    and of its (pair-folded) squares."""
    n_steps = paths.shape[0] - 1
    R, n_min, degree = cfg["n_rights"], cfg["n_min"], cfg["degree"]
    K, phi, forward = cfg["K"], cfg["phi"], cfg["forward"]
    k = degree + 1
    mean_t, inv_std_t, c, inv_c = stats.view(4, n_steps + 1)

    def take(S):
        signed = phi * (S - K)
        return signed if forward else torch.clamp_min(signed, 0.0)

    # maturity: exactly one take; an outstanding obligation forces it
    pay = take(paths[n_steps])
    V = [None] + [pay if _obligations(R, n_min, kk) >= 1 else torch.clamp_min(pay, 0.0)
                  for kk in range(1, R + 1)]
    for t in range(n_steps - 1, -1, -1):
        S = paths[t]
        cols = basis_cols((S - mean_t[t]) * inv_std_t[t], cfg["basis"], degree)
        if cfg["itm_weights"] and not forward:
            w = (phi * (S - K) > 0.0).to(torch.float32)
            cols_w = [col * w for col in cols]
        else:
            w, cols_w = None, cols
        packed = [_sum_once_rounded(cols_w[a] * cols[b]) for a, b in _pairs(k)]
        yw = torch.stack([c[t] * V[kk] for kk in range(1, R + 1)])  # (R, n)
        if w is not None:
            yw = yw * w
        rhs = [torch.sum(cols[a] * yw, dim=1, dtype=torch.float64).to(torch.float32)
               for a in range(k)]
        idx = {p: i for i, p in enumerate(_pairs(k))}
        L, d, Gnr = _factor_equilibrated_ridge(
            lambda i, j: packed[idx[(i, j)] if i <= j else idx[(j, i)]], k, cfg["rcond"])
        coef = _solve_factored(L, d, Gnr, rhs, k)  # k tensors of shape (R,)
        conts = []
        for j in range(R):
            fitted = cols[0] * coef[0][j]
            for a in range(1, k):
                fitted = fitted + cols[a] * coef[a][j]
            # the zero floor only for nonnegative (option) cashflows
            conts.append(fitted if forward else torch.clamp_min(fitted, 0.0))
        ex = take(S)
        itm = ex > 0.0
        dates_remaining = n_steps - t + 1
        for kk in range(R, 0, -1):  # descending: V[kk-1] is read pre-update
            below = conts[kk - 2] if kk >= 2 else 0.0
            hit = ex + below > conts[kk - 1]
            if not forward:
                hit = itm & hit
            owed = _obligations(R, n_min, kk)
            if owed > 0 and dates_remaining <= owed:
                hit = torch.ones_like(hit)
            prev = V[kk - 1] if kk >= 2 else 0.0
            V[kk] = torch.where(hit, ex * inv_c[t] + prev, V[kk])
    v = c[0] * V[R]
    sq = v
    if cfg["antithetic"]:
        half = v.shape[0] // 2
        sq = 0.5 * (v[:half] + v[half:])
    return torch.stack([_sum_once_rounded(v), _sum_once_rounded(sq * sq)])


def _swing_cuda(paths, stats, cfg):
    from . import _build

    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    R, k = cfg["n_rights"], cfg["degree"] + 1
    dev = paths.device
    n_blocks = book_blocks(n_paths, _build.sm_count(dev))  # kernel 3's grid: the same roles
    V = torch.empty((R, n_paths), dtype=torch.float32, device=dev)
    P = k * (k + 1) // 2 + R * k
    partials = torch.empty(n_blocks * max(P, 2), dtype=torch.float64, device=dev)
    coeffs = torch.empty(R * k, dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _swing_fn()(paths.data_ptr(), stats.data_ptr(), V.data_ptr(), partials.data_ptr(),
                     coeffs.data_ptr(), sums.data_ptr(), n_steps, n_paths, n_blocks, R,
                     cfg["n_min"], cfg["degree"], BASIS_IDS[cfg["basis"]],
                     int(cfg["itm_weights"]), int(cfg["forward"]), int(cfg["antithetic"]),
                     cfg["K"], cfg["phi"], cfg["rcond"], stream)
    lsmc_price_swing.launches += 1
    _build.check(rc, "amcx_lsmc_swing")
    return sums


@functools.lru_cache(maxsize=None)
def _swing_fn():
    from . import _build

    Vp, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_lsmc_swing", [Vp] * 6 + [I] * 10 + [F, F, F, Vp])


def swing_stats(mean_t, inv_std_t, r, dt, n_steps: int, device) -> torch.Tensor:
    """The kernel's per-step rows ``[mean_t, inv_std_t, c_t, 1/c_t]``.

    ``r`` a scalar gives `mega_stats`' rows. ``r`` an ``(n_steps,)``
    short-rate curve gives ``c_t = e^{−ρ_t}`` with ρ_t = Σ_{s≥t} f32(r_s·dt)
    accumulated in f32 from the last step back (amcx's reversed cumsum),
    and ρ_T = 0.
    """
    if not (isinstance(r, (torch.Tensor, np.ndarray, list, tuple)) and np.ndim(r) > 0):
        return mega_stats(mean_t, inv_std_t, r, dt, n_steps, device)
    r_np = (r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
            else np.asarray(r)).astype(np.float32).reshape(-1)
    if r_np.shape != (n_steps,):
        raise ValueError(f"a rate curve needs {n_steps} entries, got {r_np.shape[0]}")
    rdt = r_np * np.float32(dt)
    r_rem = np.zeros(n_steps + 1, np.float32)
    acc = np.float32(0.0)
    for t in range(n_steps - 1, -1, -1):
        acc = np.float32(acc + rdt[t])
        r_rem[t] = acc
    r_rem_t = torch.from_numpy(r_rem).to(device)
    f32 = torch.float32
    return torch.cat([torch.as_tensor(mean_t, dtype=f32, device=device).reshape(-1),
                      torch.as_tensor(inv_std_t, dtype=f32, device=device).reshape(-1),
                      torch.exp(-r_rem_t), torch.exp(r_rem_t)])


def lsmc_price_swing(
    paths_tm: torch.Tensor,
    K,
    r,
    dt,
    phi: float,
    n_rights: int,
    basis: str = "chebyshev",
    degree: int = 4,
    rcond: float = 1e-6,
    itm_weights: bool = False,
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
    antithetic: bool = False,
    payoff_kind: str = "option",
    n_min: int = 0,
):
    """Swing price (``n_rights`` exercises of ``φ(S − K)``, at most one per
    date) on time-major ``(n_steps+1, n_paths)`` f32 paths, in one
    induction. amcx's parameters minus ``interpret``.

    Runs where ``paths_tm`` lies: on a CUDA tensor the kernels of
    ``csrc/lsmc_swing.cu`` (or it raises), on a CPU tensor
    :func:`_swing_reference`. ``r``: a scalar or an ``(n_steps,)``
    short-rate curve. ``mean_t``/``inv_std_t``: the standardization
    (all-paths mean and std of the spots, floored at 1e-6, when omitted).
    ``payoff_kind="forward"`` pays signed takes with unclamped
    continuations and no ITM gate; ``n_min`` takes are owed (take-or-pay)
    and forced once the remaining dates run out. ``antithetic`` folds path
    i with i + n_paths/2 before the variance. Returns ``(price, stderr)``
    0-d tensors. ``lsmc_price_swing.launches`` counts kernel launches.
    """
    dev = torch.device(paths_tm.device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_price_swing runs on 'cpu' or 'cuda', got {dev}")
    run = _swing_cuda if dev.type == "cuda" else _swing_reference
    return _price_swing(run, paths_tm, K, r, dt, phi, n_rights, basis, degree, rcond,
                        itm_weights, mean_t, inv_std_t, antithetic, payoff_kind, n_min)


lsmc_price_swing.launches = 0


def lsmc_price_swing_reference(paths_tm: torch.Tensor, *args, **kwargs):
    """:func:`lsmc_price_swing`'s plain version on any device (the card's
    check compares the two on the same CUDA paths)."""
    return _price_swing(_swing_reference, paths_tm, *args, **kwargs)


def _price_swing(run, paths_tm, K, r, dt, phi, n_rights, basis="chebyshev", degree=4,
                 rcond=1e-6, itm_weights=False, mean_t=None, inv_std_t=None,
                 antithetic=False, payoff_kind="option", n_min=0):
    n_rights, n_min = int(n_rights), int(n_min)
    if n_rights < 1:
        raise ValueError("n_rights must be >= 1")
    if n_rights > SWING_MAX_RIGHTS:
        raise ValueError(f"n_rights = {n_rights} exceeds the swing kernel's cap of "
                         f"{SWING_MAX_RIGHTS} rights (kMaxRights of csrc/lsmc_swing.cu)")
    if payoff_kind not in ("option", "forward"):
        raise ValueError(f"unknown payoff_kind {payoff_kind!r}")
    if not 0 <= n_min <= n_rights:
        raise ValueError("need 0 <= n_min <= n_rights")
    basis = basis.strip().lower()
    if basis not in BASIS_IDS:
        raise ValueError(f"Unknown basis type {basis!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree must lie in 0..{MAX_DEGREE}, got {degree}")
    if paths_tm.ndim != 2 or paths_tm.shape[0] < 2 or paths_tm.dtype != torch.float32:
        raise ValueError(
            f"paths must be time-major (n_steps+1, n_paths) float32, got "
            f"{tuple(paths_tm.shape)} {paths_tm.dtype}")
    paths = paths_tm.contiguous()
    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    if n_paths >= 2 ** 31:
        raise ValueError(f"n_paths must be < 2^31, got {n_paths}")
    if n_min > n_steps + 1:
        raise ValueError("n_min exceeds the number of exercise dates")
    if antithetic and n_paths % 2:
        raise ValueError(f"antithetic pair folding needs an even n_paths, got {n_paths}")
    if mean_t is None or inv_std_t is None:
        mean_t, inv_std_t = _data_standardization(paths, 0.0, 1.0, False)
    stats = swing_stats(mean_t, inv_std_t, r, dt, n_steps, paths.device)
    cfg = dict(n_rights=n_rights, n_min=n_min, degree=degree, basis=basis, K=float(K),
               phi=float(phi), rcond=float(rcond), itm_weights=bool(itm_weights),
               forward=payoff_kind == "forward", antithetic=bool(antithetic))
    sums = run(paths, stats, cfg)
    price = sums[0] / n_paths
    n_eff = n_paths // 2 if antithetic else n_paths
    var = torch.clamp_min(sums[1] / n_eff - price * price, 0.0)
    return price, torch.sqrt(var / n_eff)

"""Swing options: LSMC with multiple exercise rights (port of `amcx.swing`).

A swing option grants ``n_rights`` exercises of the same vanilla payoff, at
most one per exercise date. With ``V^k`` the value holding k rights, the
dynamic program exercises at t where ``payoff_t + C^{k-1}_t > C^k_t``, with
``C^k_t = E[V^k_{t+1} | S_t]`` regressed once per k ≥ 1 and ``C^0 ≡ 0``; at
k = 1 this is the American exercise rule. Values ride in time-T units, as
in every engine of the port.

- ``engine="xla"``: :func:`_swing_engine_impl`, a reversed Python loop
  with one `amcx_torch.regress` fit per right and step (amcx's name);
- ``engine="mega"``: the swing kernel (`amcx_torch.ops.lsmc_swing`, kernel
  10) in the closed-form GBM frame, on the Philox pathgen (kernel 1) with
  ``SimConfig(backend="philox")`` or on ``torch.randn`` paths.

``payoff_kind="forward"`` pays the signed ``φ(S − K)`` per take (commodity
swing); ``n_min`` takes are owed (take-or-pay) and forced once the
remaining dates run out. :func:`price_swing_contract` prices the
volume-constrained (Jaillet-Ronn-Tompaidis) contract by its exact bang-bang
decomposition. :func:`crr_swing_price` is the f64 rights-lattice oracle
whose exercise dates sit exactly on the LSMC grid.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .engine import LSMCResult
from .types import MarketParams, ProductSpec, RegressionSpec, SimConfig

__all__ = ["price_swing_option", "price_swing_option_curves", "crr_swing_price",
           "price_swing_contract", "SwingContractResult"]


def _validate(n_rights, payoff_kind, n_min):
    if n_rights < 1:
        raise ValueError("n_rights must be >= 1")
    if payoff_kind not in ("option", "forward"):
        raise ValueError(f"unknown payoff_kind {payoff_kind!r}")
    if not 0 <= n_min <= n_rights:
        raise ValueError("need 0 <= n_min <= n_rights")


def crr_swing_price(S0, K, T, r, sigma, n_rights: int, q=0.0, n_steps: int = 100,
                    n_sub: int = 20, option_type: str = "put", payoff_kind: str = "option",
                    n_min: int = 0) -> float:
    """f64 binomial oracle for a swing option with ``n_rights`` rights, on
    the host.

    The tree has ``n_steps·n_sub`` CRR steps; a right is usable only at
    multiples of ``n_sub``, i.e. exactly on the ``n_steps+1`` LSMC dates,
    so LSMC prices converge to it with no exercise-grid bias. At an
    exercise date ``V^k = max(V^k, take + V^{k-1})``, updated in descending
    k; at maturity exactly one take. ``payoff_kind``/``n_min`` as in
    :func:`price_swing_option`; ``r``/``q`` may be ``(n_steps,)``
    piecewise-constant curves on the LSMC grid (flat sigma).
    """
    _validate(n_rights, payoff_kind, n_min)
    if n_min > n_steps + 1:
        raise ValueError("n_min exceeds the number of exercise dates")
    r_t = np.broadcast_to(np.asarray(r, np.float64), (n_steps,))
    q_t = np.broadcast_to(np.asarray(q, np.float64), (n_steps,))
    N = n_steps * n_sub
    ddt = float(T) / N
    u = np.exp(float(sigma) * np.sqrt(ddt))
    d = 1.0 / u
    p_t = (np.exp((r_t - q_t) * ddt) - d) / (u - d)
    if not np.all((0.0 < p_t) & (p_t < 1.0)):
        raise ValueError("lattice probability out of (0,1); raise n_sub")
    df_t = np.exp(-r_t * ddt)
    phi = 1.0 if option_type == "call" else -1.0

    def take(step):
        j = np.arange(step + 1, dtype=np.float64)
        signed = phi * (float(S0) * np.exp((2.0 * j - step) * float(sigma) * np.sqrt(ddt))
                        - float(K))
        return signed if payoff_kind == "forward" else np.maximum(signed, 0.0)

    def owed(k):  # k rights remaining: n_rights - k already exercised
        return max(0, n_min - (n_rights - k))

    # maturity is an exercise date: exactly one take; an outstanding
    # obligation forces it, even when negative
    ex_T = take(N)
    V = [np.zeros(N + 1)]
    for k in range(1, n_rights + 1):
        V.append(ex_T.copy() if owed(k) >= 1 else np.maximum(ex_T, 0.0))
    for step in range(N - 1, -1, -1):
        p = p_t[step // n_sub]
        df = df_t[step // n_sub]
        V = [df * (p * Vk[1:step + 2] + (1.0 - p) * Vk[:step + 1]) for Vk in V]
        if step % n_sub == 0:
            ex = take(step)
            dates_remaining = n_steps - step // n_sub + 1
            for k in range(n_rights, 0, -1):  # descending: V[k-1] pre-update
                if owed(k) >= dates_remaining:
                    V[k] = ex + V[k - 1]  # take-or-pay: forced
                else:
                    V[k] = np.maximum(V[k], ex + V[k - 1])
    return float(V[n_rights][0])


def _swing_engine_impl(paths_tm, rdt, K, phi, spec, n_rights, itm, antithetic,
                       payoff_kind="option", n_min=0):
    """Backward induction with an (n_rights+1)-deep value carry.

    ``Y[k]`` is the pathwise realised value, in time-T units, of following
    the estimated policy with k rights. Decisions use the regressed
    continuations (`amcx_torch.regress.fit_continuation_with_coeffs`,
    floored at 0 for the option kind only); all k update together from the
    t+1 carries. The forward kind drops the ITM gate and fits on all paths;
    owed takes force exercise once the remaining dates run out. Returns
    ``(price, stderr)`` 0-d tensors.
    """
    from .regress import fit_continuation_with_coeffs

    n_steps, n_paths = paths_tm.shape[0] - 1, paths_tm.shape[1]
    dtype, device = paths_tm.dtype, paths_tm.device
    rdt = torch.as_tensor(rdt, dtype=dtype, device=device)
    K = torch.as_tensor(K, dtype=dtype, device=device)

    def payoff(S):
        signed = phi * (S - K)
        return signed if payoff_kind == "forward" else torch.clamp_min(signed, 0.0)

    def owed(k):
        return max(0, n_min - (n_rights - k))

    ex_T = payoff(paths_tm[n_steps])
    Y = [torch.zeros((n_paths,), dtype=dtype, device=device)]
    for k in range(1, n_rights + 1):
        Y.append(ex_T if owed(k) >= 1 else torch.clamp_min(ex_T, 0.0))
    for t in range(n_steps - 1, -1, -1):
        S_t = paths_tm[t]
        rem = torch.tensor(float(n_steps - t), dtype=dtype, device=device)
        c_t, inv_c_t = torch.exp(-rdt * rem), torch.exp(rdt * rem)
        ex = payoff(S_t)
        weights = (ex > 0).to(dtype) if itm and payoff_kind == "option" else None
        conts = [torch.zeros((n_paths,), dtype=dtype, device=device)]  # C^0 ≡ 0
        for k in range(1, n_rights + 1):
            cont, _ = fit_continuation_with_coeffs(S_t, c_t * Y[k], spec, weights,
                                                   clamp=payoff_kind == "option")
            conts.append(cont)
        dates_remaining = n_steps - t + 1
        newY = [Y[0]]
        for k in range(1, n_rights + 1):
            hit = ex + conts[k - 1] > conts[k]
            if payoff_kind == "option":
                hit = (ex > 0) & hit
            if owed(k) > 0 and dates_remaining <= owed(k):
                hit = torch.ones_like(hit)
            newY.append(torch.where(hit, ex * inv_c_t + Y[k - 1], Y[k]))
        Y = newY
    discounted = torch.exp(-rdt * n_steps) * Y[n_rights]
    stat = discounted
    if antithetic:  # path j pairs with j + n_paths/2
        half = n_paths // 2
        stat = 0.5 * (discounted[:half] + discounted[half:])
    price = torch.mean(stat)
    stderr = torch.sqrt(torch.mean(torch.square(stat - price))) / float(np.sqrt(stat.shape[0]))
    return price, stderr


def price_swing_option(
    seed,
    market: MarketParams,
    product: ProductSpec,
    n_rights: int,
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    engine: str = "xla",
    payoff_kind: str = "option",
    n_min: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> LSMCResult:
    """Price a swing option with ``n_rights`` exercise rights (at most one
    per date) of the vanilla ``product`` payoff, simulating on ``device``.

    ``n_rights=1`` reproduces the single-exercise American estimator (same
    rule, same frame). ``engine="mega"`` runs the swing kernel in the
    closed-form frame (`amcx_torch.paths.gbm_standardization`) on
    ``sim.backend``'s paths (``"philox"`` is amcx's ``"pallas"``: kernel 1 →
    kernel 10), at most `amcx_torch.ops.lsmc_swing.SWING_MAX_RIGHTS` rights;
    ``"xla"`` the reference loop engine. ``spec.regress_on="auto"``
    localises the fit to ITM paths for the option kind and fits on all
    paths for the forward kind. Vanilla American products only. Returns
    ``LSMCResult(price, stderr, None, None, None)``.
    """
    _validate(n_rights, payoff_kind, n_min)
    if product.has_barrier:
        raise ValueError("swing pricing is vanilla-only")
    if not product.is_american:
        raise ValueError("a European swing is n_rights * european price; "
                         "use exercise='american'")
    if n_min > sim.n_steps + 1:
        raise ValueError("n_min exceeds the number of exercise dates")
    if spec.regress_on == "auto":
        spec = dataclasses.replace(spec, regress_on="itm" if payoff_kind == "option" else "all")
    if engine not in ("xla", "mega"):
        raise ValueError(f"engine must be 'xla' or 'mega', got {engine!r}")
    from .paths import gbm_standardization, simulate_gbm

    phi = 1.0 if product.option_type == "call" else -1.0
    dt = product.T / sim.n_steps
    paths = simulate_gbm(seed, market, product.T, sim, device)
    if engine == "mega":
        from .ops.lsmc_swing import lsmc_price_swing

        mean_t, inv_std_t = gbm_standardization(market, product.T, sim.n_steps,
                                                device=paths.device)
        price, stderr = lsmc_price_swing(
            paths, product.K, market.r, dt, phi, int(n_rights), basis=spec.basis,
            degree=spec.degree, rcond=spec.rcond, itm_weights=spec.regress_on == "itm",
            mean_t=mean_t, inv_std_t=inv_std_t, antithetic=sim.antithetic,
            payoff_kind=payoff_kind, n_min=int(n_min))
    else:
        # r·T/n rounded once to f32, as amcx
        rdt = float(np.float32(market.r * product.T / sim.n_steps))
        price, stderr = _swing_engine_impl(
            paths, rdt, product.K, phi, spec, int(n_rights), spec.regress_on == "itm",
            sim.antithetic, payoff_kind=payoff_kind, n_min=int(n_min))
    return LSMCResult(price, stderr, None, None, None)


def price_swing_option_curves(seed, curves, product: ProductSpec, n_rights: int,
                              spec: RegressionSpec = RegressionSpec(),
                              sim: SimConfig = SimConfig(), payoff_kind: str = "option",
                              n_min: int = 0, device: Union[str, torch.device] = "cuda"):
    """Swing pricing under r(t)/σ(t)/q(t) term structures: it needs amcx's
    `amcx.term` (``TermCurves``, curve paths and standardization), which is
    not ported yet (ROADMAP A9). The swing kernel itself already takes an
    ``(n_steps,)`` rate curve (`amcx_torch.ops.lsmc_swing.lsmc_price_swing`)."""
    raise NotImplementedError("price_swing_option_curves needs amcx/term.py, which is not "
                              "ported yet (ROADMAP A9)")


@dataclasses.dataclass(frozen=True)
class SwingContractResult:
    """Decomposed value of a volume-constrained swing contract:
    ``price = q_take_min·strip_value + (q_take_max−q_take_min)·upswing_value``.
    ``m_min``/``m_max`` are the up-swing exercise-count bounds implied by
    the global volume constraints (rounded inward when not integral)."""

    price: float
    stderr: float
    strip_value: float
    upswing_value: float
    upswing_stderr: float
    m_min: int
    m_max: int


def price_swing_contract(
    seed,
    market: MarketParams,
    K: float,
    T: float,
    q_take_min: float,
    q_take_max: float,
    Q_min: float,
    Q_max: float,
    option_type: str = "call",
    spec: RegressionSpec = RegressionSpec(),
    sim: SimConfig = SimConfig(),
    engine: str = "xla",
    device: Union[str, torch.device] = "cuda",
) -> SwingContractResult:
    """Volume-constrained swing (Jaillet-Ronn-Tompaidis): at each of the
    ``sim.n_steps+1`` grid dates the holder takes ``u ∈ [q_take_min,
    q_take_max]`` paying the signed ``φ(S_t − K)`` per unit, subject to
    ``Q_min ≤ Σu ≤ Q_max``.

    The optimal policy is bang-bang, so the contract is exactly an
    obligatory strip ``q_take_min·Σ_t φ(S0 e^{−qt} − K e^{−rt})`` (closed
    form, on the host) plus ``q_take_max − q_take_min`` units of a forward
    up-swing with ``m_max`` rights and ``m_min`` owed
    (:func:`price_swing_option` on ``device``). With ``engine="mega"``,
    ``m_max`` above the kernel's rights cap raises.
    """
    n_dates = sim.n_steps + 1
    if not 0.0 <= q_take_min <= q_take_max:
        raise ValueError("need 0 <= q_take_min <= q_take_max")
    if Q_min > Q_max:
        raise ValueError("need Q_min <= Q_max")
    if Q_min > n_dates * q_take_max + 1e-12:
        raise ValueError("Q_min unreachable even taking q_take_max always")
    if Q_max < n_dates * q_take_min - 1e-12:
        raise ValueError("Q_max below the obligatory base volume")
    phi = 1.0 if option_type == "call" else -1.0
    t = np.arange(n_dates, dtype=np.float64) * (T / sim.n_steps)
    strip = float(np.sum(phi * (float(market.S0) * np.exp(-float(market.q) * t)
                                - float(K) * np.exp(-float(market.r) * t))))
    dq = q_take_max - q_take_min
    if dq <= 1e-14:
        return SwingContractResult(q_take_min * strip, 0.0, strip, 0.0, 0.0, 0, 0)
    m_min = max(int(np.ceil((Q_min - n_dates * q_take_min) / dq - 1e-9)), 0)
    m_max = min(int(np.floor((Q_max - n_dates * q_take_min) / dq + 1e-9)), n_dates)
    if m_max < m_min:
        raise ValueError("volume constraints admit no feasible take counts on the bang-bang "
                         "grid")
    if m_max == 0:
        return SwingContractResult(q_take_min * strip, 0.0, strip, 0.0, 0.0, 0, 0)
    res = price_swing_option(
        seed, market, ProductSpec(K=K, T=T, option_type=option_type, exercise="american"),
        n_rights=m_max, spec=spec, sim=sim, engine=engine, payoff_kind="forward",
        n_min=m_min, device=device)
    up, up_se = float(res.price), float(res.stderr)
    return SwingContractResult(q_take_min * strip + dq * up, dq * up_se, strip, up, up_se,
                               m_min, m_max)

"""A strike/maturity book of vanilla options on one shared path set (port of
`amcx.book`).

Two engines. ``engine="xla"`` (amcx's name) prices each option with the
reference engine's :func:`amcx_torch.engine.backward_induction`, one after
another: per-option regressions and exercise boundaries and full cashflow/τ
planes. It is a Python loop, not a regression batched over the options:
amcx scans its strikes for the same reason (``amcx/book.py``: a batched
regression's reductions round differently, and on an ill-conditioned Gram
that moves deep in-the-money values). ``engine="mega"`` prices the whole
book in one induction, :func:`amcx_torch.ops.lsmc_megakernel.lsmc_book_megakernel`
(the kernel of ``csrc/lsmc_book.cu`` on the card), which shares the path
reads, the Gram and its factor across the options and so fits on all paths.

:func:`price_strike_grid` prices on the grid's maturity;
:func:`price_mixed_book` takes a maturity step per option (the mega engine
masks each option's induction to its own maturity; the xla engine prices
maturity buckets on sliced grids). :func:`book_ccr_exposures` nets a
weighted book's continuation surfaces into one CCR profile, and
:func:`book_greeks` applies `amcx_torch.greeks.fast_greeks` to each
option's cashflow/τ rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .engine import LSMCResult, backward_induction
from .exposures import compute_ccr_exposures
from .payoff import barrier_gate, intrinsic_value
from .types import ProductSpec, RegressionSpec

__all__ = ["BookResult", "price_strike_grid", "price_mixed_book", "book_ccr_exposures",
           "book_greeks"]


def _phi_vector(option_type, n_options):
    """``(phis, types)``: the ``(n_options,)`` f32 payoff signs (+1 call, −1
    put) and the type names, from one name or one per option."""
    types = [option_type] * n_options if isinstance(option_type, str) else list(option_type)
    if len(types) != n_options:
        raise ValueError(f"{len(types)} option types for {n_options} options")
    types = tuple(t.strip().lower() for t in types)
    if any(t not in ("put", "call") for t in types):
        raise ValueError(f"option types must be put|call, got {list(types)}")
    return torch.tensor([1.0 if t == "call" else -1.0 for t in types]), types


def _all_paths(spec: RegressionSpec) -> RegressionSpec:
    # the book's shared-Gram design fits one moment set for the whole book,
    # which needs the all-paths frame: "auto" resolves to it (per-option ITM
    # fits stay available on engine="xla" with an explicit regress_on="itm")
    return dataclasses.replace(spec, regress_on="all") if spec.regress_on == "auto" else spec


def _require_all_paths(spec: RegressionSpec) -> None:
    if spec.regress_on == "itm":
        raise ValueError("engine='mega' book shares the Gram across options, which requires "
                         "fit-on-all-paths regression (itm_weights=False)")


def _xla_engine(engine: str, mean_t) -> None:
    if engine != "xla":
        raise ValueError(f"unknown book engine {engine!r} (use 'xla' or 'mega')")
    if mean_t is not None:
        raise ValueError("mean_t/inv_std_t set the mega engine's frame; the xla engine "
                         "standardizes each fit itself")


def _strikes(strikes, paths_tm) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(strikes, dtype=paths_tm.dtype)).detach().cpu()


class BookResult(NamedTuple):
    prices: torch.Tensor  # (n_options,)
    stderrs: torch.Tensor  # (n_options,)
    cashflows: Optional[torch.Tensor]  # (n_options, n_paths); None for mega without cf/τ
    exercise_times: Optional[torch.Tensor]  # (n_options, n_paths)


def price_strike_grid(
    paths_tm: torch.Tensor,
    strikes,
    r,
    T,
    option_type="put",
    american: bool = True,
    spec: RegressionSpec = RegressionSpec(),
    engine: str = "xla",
    return_cf_tau: bool = False,
    barrier=None,
    barrier_type: str = "down-in",
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
) -> BookResult:
    """Price a strike grid of vanilla puts/calls on the shared time-major
    paths ``(n_steps+1, n_paths)``.

    ``option_type``: one name or one per option (a mixed put/call book).
    ``barrier``: one knock level shared by the whole ladder, any of the
    four ``barrier_type`` variants. ``engine="xla"``: per-option inductions
    of the reference engine, with cashflow/τ planes. ``engine="mega"``: the
    book kernel, fit on all paths only; ``return_cf_tau`` also returns its
    per-option cashflow/τ planes (the input of :func:`book_greeks`), and
    ``mean_t``/``inv_std_t`` give it a standardization frame (e.g.
    `amcx_torch.paths.gbm_standardization`; the paths' own all-paths
    statistics when omitted).
    """
    ks = _strikes(strikes, paths_tm)
    spec = _all_paths(spec)
    phis, _ = _phi_vector(option_type, ks.shape[0])
    n_steps = paths_tm.shape[0] - 1
    if engine == "mega":
        from .ops.lsmc_megakernel import lsmc_book_megakernel

        _require_all_paths(spec)
        out = lsmc_book_megakernel(
            paths_tm, ks, r, T / n_steps, phis, basis=spec.basis, degree=spec.degree,
            rcond=spec.rcond, american=american, mean_t=mean_t, inv_std_t=inv_std_t,
            return_cf_tau=return_cf_tau, barrier=barrier, barrier_type=barrier_type)
        return BookResult(*out) if return_cf_tau else BookResult(out[0], out[1], None, None)
    _xla_engine(engine, mean_t)
    knocked = barrier_gate(paths_tm, barrier, barrier_type)
    rows = []
    for K, phi in zip(ks.tolist(), phis.tolist()):
        def payoff(S, K=K, phi=phi):
            return torch.clamp_min(phi * (S - K), 0.0)

        res = backward_induction(paths_tm, knocked, r, T / n_steps, payoff, spec,
                                 american=american, return_surface=False)
        rows.append((res.price, res.stderr, res.cashflows, res.exercise_times))
    return BookResult(*(torch.stack(col) for col in zip(*rows)))


def price_mixed_book(
    paths_tm: torch.Tensor,
    strikes,
    maturity_steps,
    r,
    T,
    option_type="put",
    american: bool = True,
    spec: RegressionSpec = RegressionSpec(),
    engine: str = "xla",
    return_cf_tau: bool = False,
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
) -> BookResult:
    """Price a mixed-maturity vanilla book on one shared path grid.

    ``maturity_steps[i]`` is option i's maturity as a step index on the grid
    (1..n_steps), i.e. ``maturity_steps[i]·T/n_steps`` years.
    ``engine="mega"``: one book induction with per-option maturity masks
    (``return_cf_tau`` also returns the planes, τ starting at each option's
    own maturity step). ``engine="xla"``: the options grouped by maturity,
    each bucket priced by :func:`price_strike_grid` on the grid sliced at
    its maturity (prices and stderrs only). ``mean_t``/``inv_std_t`` as in
    :func:`price_strike_grid`.
    """
    spec = _all_paths(spec)
    n_steps = paths_tm.shape[0] - 1
    ks = _strikes(strikes, paths_tm)
    mats = [int(m) for m in maturity_steps]
    if len(mats) != ks.shape[0]:
        raise ValueError(f"{len(mats)} maturity_steps for {ks.shape[0]} strikes")
    phis, types = _phi_vector(option_type, len(mats))
    if engine == "mega":
        from .ops.lsmc_megakernel import lsmc_book_megakernel

        _require_all_paths(spec)
        out = lsmc_book_megakernel(
            paths_tm, ks, r, T / n_steps, phis, basis=spec.basis, degree=spec.degree,
            rcond=spec.rcond, american=american, mean_t=mean_t, inv_std_t=inv_std_t,
            maturity_steps=tuple(mats), return_cf_tau=return_cf_tau)
        return BookResult(*out) if return_cf_tau else BookResult(out[0], out[1], None, None)
    _xla_engine(engine, mean_t)
    dt = T / n_steps
    prices = torch.zeros(len(mats), dtype=paths_tm.dtype)
    stderrs = torch.zeros(len(mats), dtype=paths_tm.dtype)
    for m in sorted(set(mats)):
        idx = [i for i, mi in enumerate(mats) if mi == m]
        sub = price_strike_grid(paths_tm[:m + 1], ks[idx], r, m * dt,
                                option_type=[types[i] for i in idx], american=american,
                                spec=spec)
        prices[idx] = sub.prices.cpu()
        stderrs[idx] = sub.stderrs.cpu()
    return BookResult(prices.to(paths_tm.device), stderrs.to(paths_tm.device), None, None)


def book_ccr_exposures(
    paths_tm: torch.Tensor,
    strikes,
    weights,
    r,
    T,
    option_type: str = "put",
    american: bool = True,
    spec: RegressionSpec = RegressionSpec(),
    return_ene: bool = False,
):
    """Netting-set CCR profile of a vanilla book on shared paths.

    The portfolio's per-path value is ``Σ_i w_i·Ĉ_i(t, path)`` (signed
    weights: short positions offset long ones); the exposure is its positive
    part, and EPE/PFE are taken of that, which is not the weighted sum of
    per-option profiles. The continuation surfaces are added one option at a
    time, so one surface lives beside the accumulator.

    Returns ``(ccr, prices)``, or with ``return_ene`` ``(ccr, ene, prices)``
    where ``ene`` is the per-step expected negative exposure
    ``E[max(−Σ w_i Ĉ_i, 0)]`` (the DVA leg of
    `amcx_torch.exposures.bilateral_cva`).
    """
    n_steps = paths_tm.shape[0] - 1
    ks = _strikes(strikes, paths_tm)
    ws = torch.broadcast_to(torch.as_tensor(weights, dtype=paths_tm.dtype).detach().cpu(),
                            ks.shape)
    knocked = torch.ones(paths_tm.shape, dtype=torch.bool, device=paths_tm.device)
    netted = torch.zeros_like(paths_tm)
    prices = []
    for K, w in zip(ks.tolist(), ws.tolist()):
        def payoff(S, K=K):
            return intrinsic_value(S, K, option_type)

        res = backward_induction(paths_tm, knocked, r, T / n_steps, payoff, spec,
                                 american=american, return_surface=True)
        netted = netted + w * res.continuation
        prices.append(res.price)
    ccr = compute_ccr_exposures(torch.clamp_min(netted, 0.0))  # owed to us only
    prices = torch.stack(prices)
    if return_ene:
        return ccr, torch.mean(torch.clamp_min(-netted, 0.0), dim=1), prices
    return ccr, prices


def book_greeks(book: BookResult, market, strikes, T, n_steps: int, option_type="put"):
    """Per-option pathwise delta/vega/rho/dividend-rho/theta of a priced
    book: `amcx_torch.greeks.fast_greeks` on each option's ``(cashflows,
    exercise_times)`` rows (the xla book, or the mega book priced with
    ``return_cf_tau``). Returns a dict of ``(n_options,)`` tensors."""
    from .greeks import fast_greeks

    if book.cashflows is None:
        raise ValueError("book_greeks needs per-option cashflow/τ outputs: price the book "
                         "with engine='xla', or engine='mega' + return_cf_tau=True")
    ks = torch.atleast_1d(torch.as_tensor(strikes)).detach().cpu()
    _, types = _phi_vector(option_type, ks.shape[0])
    rows = []
    for i, K in enumerate(ks.tolist()):
        res = LSMCResult(book.prices[i], book.stderrs[i], book.cashflows[i],
                         book.exercise_times[i], None)
        rows.append(fast_greeks(res, market, ProductSpec(K=float(K), T=float(T),
                                                         option_type=types[i],
                                                         exercise="american"), n_steps))
    return {k: torch.stack([row[k] for row in rows]) for k in rows[0]}

"""Payoffs and barrier monitoring (pure functions on tensors).

Port of `amcx.payoff`: intrinsic values, the running knock state of a
barrier, the knock-in/knock-out exercise gate and the Bermudan allow row.
"""

from __future__ import annotations

import torch

from .types import ProductSpec

__all__ = [
    "exercise_allow_row",
    "intrinsic_value",
    "barrier_knocked",
    "barrier_gate",
    "max_call_payoff",
    "payoff_fn_for",
]


def intrinsic_value(S: torch.Tensor, K, option_type: str = "call") -> torch.Tensor:
    """``max(K-S, 0)`` for puts, ``max(S-K, 0)`` for calls."""
    if option_type.strip().lower() == "put":
        return torch.clamp_min(K - S, 0.0)
    return torch.clamp_min(S - K, 0.0)


def barrier_knocked(paths_tm: torch.Tensor, barrier, down: bool = True) -> torch.Tensor:
    """Knock state per (time, path): has the path touched the barrier
    (``S <= barrier`` for down, ``S >= barrier`` for up) at or before t?

    A running OR along time, taken as ``torch.cummax`` of the hit indicator
    viewed as uint8. ``barrier is None`` yields the all-True matrix.
    Time-major input ``(n_steps+1, n_paths, ...)``.
    """
    if barrier is None:
        return torch.ones(paths_tm.shape, dtype=torch.bool, device=paths_tm.device)
    hit = paths_tm <= barrier if down else paths_tm >= barrier
    return torch.cummax(hit.to(torch.uint8), dim=0).values.bool()


def barrier_gate(paths_tm: torch.Tensor, barrier, barrier_type: str = "down-in"):
    """Per-(time, path) exercisability gate for any knock variant: knock-IN
    products pay only once knocked, knock-OUT products only while never
    knocked."""
    if barrier is None:
        return torch.ones(paths_tm.shape, dtype=torch.bool, device=paths_tm.device)
    bt = barrier_type.strip().lower()
    knocked = barrier_knocked(paths_tm, barrier, down=bt.startswith("down"))
    return knocked if bt.endswith("in") else ~knocked


def max_call_payoff(S: torch.Tensor, K) -> torch.Tensor:
    """``max(max_i S_i - K, 0)`` over the trailing asset axis (Bermudan
    max-call)."""
    return torch.clamp_min(torch.amax(S, dim=-1) - K, 0.0)


def payoff_fn_for(product: ProductSpec):
    """Closure ``S_t -> intrinsic`` for the engine."""
    opt = product.option_type

    def payoff(S):
        return intrinsic_value(S, product.K, opt)

    return payoff


def exercise_allow_row(exercise_steps, n_steps: int, dtype=None, device=None):
    """Validate a Bermudan schedule and build the per-step allow row.

    ``exercise_steps``: step indices in 0..n_steps-1 where early exercise is
    permitted. Returns a length-``n_steps + 1`` tensor (the maturity slot
    is unused but keeps the row aligned with per-step tables); bool when
    ``dtype`` is None.
    """
    sched = set(int(i) for i in exercise_steps)
    if not all(0 <= i <= n_steps - 1 for i in sched):
        raise ValueError(
            f"exercise_steps must lie in 0..{n_steps - 1}, got {sorted(sched)}"
        )
    row = [i in sched for i in range(n_steps + 1)]
    if dtype is None:
        return torch.tensor(row, dtype=torch.bool, device=device)
    return torch.tensor([1.0 if a else 0.0 for a in row], dtype=dtype, device=device)

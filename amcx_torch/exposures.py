"""Counterparty credit risk (CCR) exposure profiles (port of `amcx.exposures`).

Per time step over a continuation-value surface: the expected positive
exposure (EPE, the mean) and the potential future exposure bands (PFE, the
5th and 95th percentiles with ``np.percentile``'s linear interpolation).
Non-finite values are masked out; a step with none left yields NaN.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import tracing

__all__ = ["CCRExposures", "compute_ccr_exposures", "distributed_percentiles",
           "bilateral_cva", "exposures_from_coeffs", "cva_from_epe"]


class CCRExposures(NamedTuple):
    """Per-step exposure profile; each field has shape ``(n_steps+1,)``."""

    pfe5: torch.Tensor
    pfe95: torch.Tensor
    epe: torch.Tensor


def _percentiles(srt: torch.Tensor, n_valid: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation percentile ``q`` of each row of ``srt`` (sorted
    ascending, with its ``n_valid`` valid entries first), as amcx computes
    it; NaN for a row without valid entries."""
    dtype, width = srt.dtype, srt.shape[-1]
    pos = (q / 100.0) * (n_valid.to(dtype) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, width - 1)
    hi = torch.clamp(lo + 1, 0, width - 1)
    frac = pos - lo.to(dtype)
    vlo = torch.gather(srt, -1, lo[..., None])[..., 0]
    vhi = torch.gather(srt, -1, hi[..., None])[..., 0]
    vhi = torch.where(torch.isfinite(vhi), vhi, vlo)  # hi may index the padding
    out = vlo + frac * (vhi - vlo)
    return torch.where(n_valid > 0, out, torch.nan)


def compute_ccr_exposures(surface_tm: torch.Tensor) -> CCRExposures:
    """EPE / PFE-5% / PFE-95% per time step of a time-major ``(n_steps+1,
    n_paths)`` continuation surface (`LSMCResult.continuation`)."""
    finite = torch.isfinite(surface_tm)
    vals = torch.where(finite, surface_tm, 0.0)
    n_valid = torch.sum(finite, dim=1)
    epe = torch.where(n_valid > 0,
                      torch.sum(vals, dim=1) / torch.clamp_min(n_valid, 1).to(vals.dtype),
                      torch.nan)
    # non-finite entries sort to the end as +inf; the percentiles
    # interpolate within the leading n_valid entries
    srt = torch.sort(torch.where(finite, surface_tm, torch.inf), dim=1).values
    return CCRExposures(pfe5=_percentiles(srt, n_valid, 5.0),
                        pfe95=_percentiles(srt, n_valid, 95.0), epe=epe)


def step_profile(cont: torch.Tensor) -> torch.Tensor:
    """``(3,)`` ``[EPE, PFE-5, PFE-95]`` of one step's ``(n_paths,)``
    continuation values, in their dtype (the engines' ``surface_stats``
    rows): non-finite values left out, EPE the f64 sum over their count
    rounded once, each NaN where no value is finite. Makes no copy from the
    host."""
    finite = torch.isfinite(cont)
    n_valid = torch.sum(finite)[None]
    total = torch.sum(torch.where(finite, cont, 0.0), dtype=torch.float64)
    epe = torch.where(n_valid > 0, total / n_valid, torch.nan).to(cont.dtype)
    srt = torch.sort(torch.where(finite, cont, torch.inf)).values[None, :]
    return torch.cat([epe, _percentiles(srt, n_valid, 5.0), _percentiles(srt, n_valid, 95.0)])


def _profile(rows, dtype, device) -> CCRExposures:
    # per-step step_profile rows, maturity column recorded as zeros (the
    # engines' surface)
    out = torch.cat([torch.stack(rows, dim=1), torch.zeros((3, 1), dtype=dtype, device=device)],
                    dim=1)
    return CCRExposures(pfe5=out[1], pfe95=out[2], epe=out[0])


def _intervals(T, n_steps: int, r, dtype, device):
    dt = torch.as_tensor(T, dtype=dtype, device=device) / n_steps
    t = torch.arange(1, n_steps + 1, dtype=dtype, device=device) * dt
    return dt, torch.exp(-torch.as_tensor(r, dtype=dtype, device=device) * t)


def _survival(hazard, dt, n_steps: int, dtype, device):
    lam = torch.broadcast_to(torch.as_tensor(hazard, dtype=dtype, device=device), (n_steps,))
    return torch.exp(-torch.cat([torch.zeros((1,), dtype=dtype, device=device),
                                 torch.cumsum(lam * dt, dim=0)]))


def _clean(x) -> torch.Tensor:
    return torch.nan_to_num(torch.as_tensor(x), nan=0.0, posinf=0.0, neginf=0.0)


def cva_from_epe(epe, T, r, hazard, recovery: float = 0.4) -> torch.Tensor:
    """Unilateral CVA ``(1−R)·Σ_i DF(t_i)·EPE(t_i)·ΔPD_i`` on the exposure
    grid: per interval the default probability from the flat or per-step
    (``(n_steps,)``) ``hazard``, the exposure at the interval end, flat
    discounting at ``r``. Non-finite EPE entries count as zero exposure."""
    epe = _clean(epe)
    n_steps, dtype, dev = epe.shape[0] - 1, epe.dtype, epe.device
    dt, df = _intervals(T, n_steps, r, dtype, dev)
    surv = _survival(hazard, dt, n_steps, dtype, dev)
    dpd = surv[:-1] - surv[1:]
    return (1.0 - recovery) * torch.sum(df * epe[1:] * dpd)


def bilateral_cva(epe, ene, T, r, hazard_cpty, hazard_own, recovery_cpty: float = 0.4,
                  recovery_own: float = 0.4):
    """Bilateral CVA, counterparty leg minus own-default (DVA) leg, each
    default probability weighted by the other party's survival to the
    interval start (first to default, no wrong-way risk). ``ene`` is the
    magnitude owed by us (`amcx_torch.book.book_ccr_exposures` with
    ``return_ene``). Returns ``(bcva, cva_leg, dva_leg)``."""
    epe, ene = _clean(epe), _clean(ene)
    n_steps, dtype, dev = epe.shape[0] - 1, epe.dtype, epe.device
    dt, df = _intervals(T, n_steps, r, dtype, dev)
    surv_c = _survival(hazard_cpty, dt, n_steps, dtype, dev)
    surv_o = _survival(hazard_own, dt, n_steps, dtype, dev)
    dpd_c = surv_c[:-1] - surv_c[1:]
    dpd_o = surv_o[:-1] - surv_o[1:]
    cva_leg = (1.0 - recovery_cpty) * torch.sum(df * epe[1:] * surv_o[:-1] * dpd_c)
    dva_leg = (1.0 - recovery_own) * torch.sum(df * ene[1:] * surv_c[:-1] * dpd_o)
    return cva_leg - dva_leg, cva_leg, dva_leg


def exposures_from_coeffs(paths_tm: torch.Tensor, coeffs: torch.Tensor, mean_t: torch.Tensor,
                          inv_std_t: torch.Tensor, basis: str = "chebyshev",
                          degree: int = 4) -> CCRExposures:
    """EPE/PFE from exported per-step regression coefficients (``(n_steps+1,
    degree+1)``, the mega engine's ``coeffs``; maturity row unused) and the
    standardization the fit used: the surface ``Ĉ_t = max(Σ_a c_{t,a}
    B_a((S_t − μ_t)·inv_std_t), 0)``, in the induction kernel's own order,
    is reduced a step at a time and never materialized. Each step's EPE is
    the f64 sum over its count, rounded once; PFE is amcx's percentile.
    `amcx_torch.ops.ccr_exposures` computes it: the kernel on f32 paths on
    a CUDA device, its plain version in the paths' dtype on any other.
    Inside the ``analytics`` span."""
    from .ops.ccr_exposures import ccr_exposures

    with tracing.span("analytics"):
        rows = ccr_exposures(paths_tm, coeffs, mean_t, inv_std_t, basis, degree)
        return CCRExposures(pfe5=rows[1], pfe95=rows[2], epe=rows[0])


def distributed_percentiles(x, qs, axis_name, n_bins: int = 2048):
    """Global percentiles of a path-sharded vector (amcx's psum'd histogram
    under ``shard_map``): not ported yet."""
    raise NotImplementedError(
        "distributed_percentiles (sharded surface_stats) is not ported yet (ROADMAP A15)")

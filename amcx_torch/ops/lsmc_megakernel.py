"""LSMC backward induction on the card: the CUDA kernels' wrapper and their
plain version.

Port of `amcx.ops.lsmc_megakernel` (``_mega_kernel``, via
``lsmc_price_megakernel``) for vanilla puts and calls. The TPU kernel runs
the whole induction in one launch because its grid is sequential; on
Hopper the per-step Gram is a grid-wide dependency, so
``amcx_torch/csrc/lsmc_mega.cu`` drives moments → solve → apply kernels per
step from a host loop on one stream (see the note at the top of that file).

:func:`_mega_reference` is a plain-torch transcription of the same
algorithm: V carried in time-T units, explicit pair moments, and the same
unrolled equilibrated-ridge Cholesky with two refinements against the
un-ridged Gram, on 0-d f32 tensors in the same operation order (never
``torch.linalg``, whose solve is what the kernel replaces). Like the kernel
it sums the moments and the final two sums in f64 and rounds them once to
f32, which makes the result independent of the summation order but for
f64 noise of ~1e-6 f32 ulp, so on the card the two agree to the bit (the
closed-form-frame ITM fit turns any f32 summation-order noise into
exercise flips; see the note in ``csrc/lsmc_mega.cu``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..basis import BASIS_IDS, basis_cols

__all__ = ["lsmc_price_megakernel", "lsmc_price_mega_reference", "MegaOutputs",
           "mega_stats"]

MAX_DEGREE = 10
_THREADS = 256  # csrc/lsmc_mega.cu kThreads
_MAX_BLOCKS = 1024


class MegaOutputs(NamedTuple):
    """``price``/``stderr`` 0-d tensors and the ``(n_steps+1, degree+1)``
    per-step solved coefficients (zeros at the maturity row)."""

    price: torch.Tensor
    stderr: torch.Tensor
    coeffs: Optional[torch.Tensor] = None


def _pairs(k):
    return [(i, j) for i in range(k) for j in range(i, k)]


def _n_moments(degree: int) -> int:
    k = degree + 1
    return k * (k + 1) // 2 + k


def _factor_equilibrated_ridge(g_raw, k, rcond):
    """Equilibrate + ridge + Cholesky-factor the Gram (amcx's static unroll,
    over 0-d tensors). Returns ``(L, d, Gnr)`` with ``Gnr`` the UN-ridged
    equilibrated Gram that the refinement uses."""
    tiny = 1e-30
    # reciprocal of the correctly rounded sqrt, as the kernel's 1.0f / sqrtf
    d = [torch.reciprocal(torch.sqrt(torch.clamp_min(g_raw(i, i), tiny))) for i in range(k)]
    Gnr = [[g_raw(i, j) * d[i] * d[j] for j in range(k)] for i in range(k)]
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = Gnr[i][j] + rcond if i == j else Gnr[i][j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            L[i][j] = torch.sqrt(torch.clamp_min(s, tiny)) if i == j else s / L[j][j]
    return L, d, Gnr


def _solve_factored(L, d, Gnr, b_raw, k, refine_steps=2):
    """Two triangular solves, preconditioned refinement against the
    un-ridged system, de-equilibrate."""
    def chol_solve(rhs):
        z = [None] * k
        for i in range(k):
            s = rhs[i]
            for m in range(i):
                s = s - L[i][m] * z[m]
            z[i] = s / L[i][i]
        c = [None] * k
        for i in reversed(range(k)):
            s = z[i]
            for m in range(i + 1, k):
                s = s - L[m][i] * c[m]
            c[i] = s / L[i][i]
        return c

    b = [b_raw[i] * d[i] for i in range(k)]
    c = chol_solve(b)
    for _ in range(refine_steps):
        resid = []
        for i in range(k):
            acc = torch.zeros((), dtype=b[i].dtype, device=b[i].device)
            for j in range(k):
                acc = acc + Gnr[i][j] * c[j]
            resid.append(b[i] - acc)
        dc = chol_solve(resid)
        c = [c[i] + dc[i] for i in range(k)]
    return [c[i] * d[i] for i in range(k)]


def _solve_equilibrated_ridge(packed, k, rcond):
    """Solve the packed ``[G_upper..., b...]`` system; returns k 0-d tensors."""
    idx = {p: n for n, p in enumerate(_pairs(k))}

    def g_raw(i, j):
        return packed[idx[(i, j)] if i <= j else idx[(j, i)]]

    off = len(idx)
    L, d, Gnr = _factor_equilibrated_ridge(g_raw, k, rcond)
    return _solve_factored(L, d, Gnr, [packed[off + i] for i in range(k)], k)


def _mega_reference(paths, stats, K, phi, rcond, basis, degree, american, itm_weights):
    """Plain-torch induction; returns ``(sums (2,), coeffs (T+1, k), V)``
    with ``V`` the final per-path carry in time-T units."""
    n_steps = paths.shape[0] - 1
    k = degree + 1
    mean_t, inv_std_t, c, inv_c = stats.view(4, n_steps + 1)
    V = torch.clamp_min(phi * (paths[n_steps] - K), 0.0)
    coeffs = torch.zeros((n_steps + 1, k), dtype=torch.float32, device=paths.device)
    for t in range(n_steps - 1, -1, -1):
        S = paths[t]
        y = c[t] * V
        xhat = (S - mean_t[t]) * inv_std_t[t]
        ex = torch.clamp_min(phi * (S - K), 0.0)
        cols = basis_cols(xhat, basis, degree)
        if itm_weights:
            w = (ex > 0.0).to(torch.float32)
            cols_w = [col * w for col in cols]
            yw = y * w
        else:
            cols_w, yw = cols, y
        packed = [_sum_once_rounded(cols_w[a] * cols[b]) for a, b in _pairs(k)]
        packed += [_sum_once_rounded(cols[a] * yw) for a in range(k)]
        coef = _solve_equilibrated_ridge(packed, k, rcond)
        coeffs[t] = torch.stack(coef)
        if american:
            fitted = cols[0] * coef[0]
            for a in range(1, k):
                fitted = fitted + cols[a] * coef[a]
            cont = torch.clamp_min(fitted, 0.0)
            V = torch.where(ex > cont, ex * inv_c[t], V)
    v = c[0] * V
    return torch.stack([_sum_once_rounded(v), _sum_once_rounded(v * v)]), coeffs, V


def _sum_once_rounded(x: torch.Tensor) -> torch.Tensor:
    """Sum of f32 values accumulated in f64 and rounded once to f32."""
    return torch.sum(x, dtype=torch.float64).to(torch.float32)


def _mega_cuda(paths, stats, K, phi, rcond, basis, degree, american, itm_weights):
    from . import _build

    n_steps = paths.shape[0] - 1
    n_paths = paths.shape[1]
    k = degree + 1
    dev = paths.device
    n_blocks = max(1, min(_MAX_BLOCKS, -(-n_paths // _THREADS)))
    V = torch.empty(n_paths, dtype=torch.float32, device=dev)
    partials = torch.empty(n_blocks * max(_n_moments(degree), 2), dtype=torch.float64,
                           device=dev)
    coeffs = torch.zeros((n_steps + 1, k), dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.function("amcx_lsmc_mega", [P, P, P, P, P, P, I, I, I, F, F, F, I, I, I, I, P])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(paths.data_ptr(), stats.data_ptr(), V.data_ptr(), partials.data_ptr(),
            coeffs.data_ptr(), sums.data_ptr(), n_steps, n_paths, n_blocks,
            float(K), float(phi), float(rcond), BASIS_IDS[basis], degree,
            int(american), int(itm_weights), stream)
    lsmc_price_megakernel.launches += 1
    _build.check(rc, "amcx_lsmc_mega")
    return sums, coeffs, V


def _data_standardization(paths, K, phi, itm_weights):
    """Per-step (mean_t, inv_std_t) from the paths themselves (all paths,
    or ITM-weighted), as amcx computes them when none are given."""
    n_paths = paths.shape[1]
    if itm_weights:
        w = (torch.clamp_min(phi * (paths - K), 0.0) > 0).to(paths.dtype)
        wsum = torch.clamp_min(torch.sum(w, dim=1), 1e-6)
        mean_t = torch.sum(w * paths, dim=1) / wsum
        var = torch.sum(w * torch.square(paths - mean_t[:, None]), dim=1) / wsum
    else:
        mean_t = torch.sum(paths, dim=1) / n_paths
        var = torch.sum(torch.square(paths - mean_t[:, None]), dim=1) / n_paths
    return mean_t, 1.0 / torch.clamp_min(torch.sqrt(var), 1e-6)


def mega_stats(mean_t, inv_std_t, r, dt, n_steps: int, device) -> torch.Tensor:
    """The kernel's per-step rows ``[mean_t, inv_std_t, c_t, 1/c_t]``, flat
    f32 of length 4(n_steps+1), with the time-T discount rows
    ``c_t = e^{−r·dt·(n_steps−t)}`` built in f32 in amcx's order."""
    f32 = torch.float32
    rem = n_steps - torch.arange(n_steps + 1, dtype=f32, device=device)
    r_rem = torch.tensor(float(r), dtype=f32, device=device) * torch.tensor(
        float(dt), dtype=f32, device=device) * rem
    return torch.cat([
        torch.as_tensor(mean_t, dtype=f32, device=device).reshape(-1),
        torch.as_tensor(inv_std_t, dtype=f32, device=device).reshape(-1),
        torch.exp(-r_rem), torch.exp(r_rem)])


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def lsmc_price_megakernel(
    paths_tm: torch.Tensor,
    K,
    r,
    dt,
    phi: float,
    basis: str = "chebyshev",
    degree: int = 4,
    rcond: float = 1e-6,
    american: bool = True,
    itm_weights: bool = False,
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
    return_coeffs: bool = False,
    barrier=None,
    exercise_steps=None,
    replay_coeffs=None,
    return_cf_tau: bool = False,
    antithetic: bool = False,
):
    """Price a vanilla put (``phi=-1``) or call (``phi=+1``) by LSMC on the
    time-major paths ``(n_steps+1, n_paths)`` f32.

    Runs where ``paths_tm`` lies: on a CUDA tensor the kernels of
    ``csrc/lsmc_mega.cu`` (or it raises), on a CPU tensor
    :func:`_mega_reference`. ``mean_t``/``inv_std_t``: per-step
    standardization (computed from the paths when omitted). Returns
    ``(price, stderr)`` 0-d tensors, or :class:`MegaOutputs` with the
    per-step coefficients when ``return_coeffs``.
    ``lsmc_price_megakernel.launches`` counts kernel launches.
    """
    dev = torch.device(paths_tm.device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_price_megakernel runs on 'cpu' or 'cuda', got {dev}")
    run = _mega_cuda if dev.type == "cuda" else _mega_reference
    return _price(run, paths_tm, K, r, dt, phi, basis, degree, rcond, american,
                  itm_weights, mean_t, inv_std_t, return_coeffs, barrier,
                  exercise_steps, replay_coeffs, return_cf_tau, antithetic)


lsmc_price_megakernel.launches = 0


def lsmc_price_mega_reference(paths_tm: torch.Tensor, *args, **kwargs):
    """:func:`lsmc_price_megakernel`'s plain version on any device (the
    card's check compares the two on the same CUDA paths)."""
    return _price(_mega_reference, paths_tm, *args, **kwargs)


def _price(run, paths_tm, K, r, dt, phi, basis="chebyshev", degree=4, rcond=1e-6,
           american=True, itm_weights=False, mean_t=None, inv_std_t=None,
           return_coeffs=False, barrier=None, exercise_steps=None,
           replay_coeffs=None, return_cf_tau=False, antithetic=False):
    if barrier is not None:
        _not_ported("the mega kernel's barrier sign-bit mode", "B2 options")
    if exercise_steps is not None:
        _not_ported("the mega kernel's exercise_steps schedule", "B2 options")
    if replay_coeffs is not None:
        _not_ported("the mega kernel's replay_coeffs mode", "B2 options / A8")
    if return_cf_tau:
        _not_ported("the mega kernel's cf/tau planes", "B2 options / A8")
    if antithetic:
        _not_ported("the mega kernel's antithetic pair folding", "B2 options")
    if isinstance(r, torch.Tensor) and r.ndim > 0:
        _not_ported("the mega kernel's per-step rate curves", "B2 options / A9")
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
    K, phi = float(K), float(phi)
    if mean_t is None or inv_std_t is None:
        mean_t, inv_std_t = _data_standardization(paths, K, phi, itm_weights)
    stats = mega_stats(mean_t, inv_std_t, r, dt, n_steps, paths.device)
    sums, coeffs, _ = run(paths, stats, K, phi, float(rcond), basis, degree,
                          bool(american), bool(itm_weights))
    price = sums[0] / n_paths
    var = torch.clamp_min(sums[1] / n_paths - price * price, 0.0)
    stderr = torch.sqrt(var / n_paths)
    if return_coeffs:
        return MegaOutputs(price, stderr, coeffs)
    return price, stderr

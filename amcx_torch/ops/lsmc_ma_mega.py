"""The multi-asset induction kernel: wrapper and plain version.

Port of `amcx.ops.lsmc_ma_mega` (``_ma_mega_kernel`` via
``lsmc_price_ma_mega``): the whole multi-state LSMC backward induction of a
multi-asset product (max-call, arithmetic and geometric baskets, the
two-plane kinds of the Heston/Asian/spread engines) in one call. On
Hopper the per-step Gram is a grid-wide dependency, so
``amcx_torch/csrc/lsmc_ma_mega.cu`` runs two launches a step from a C host
loop on one stream: the step's moments on kernel 8's tensor-core design
(``csrc/ma_moments.cuh``, on the persistent grid of
:func:`~amcx_torch.ops.maxcall_pallas.ma_moments_blocks`), after which the
last block sums the partial rows and one warp solves the m × m system
(``warp_solve_equilibrated_ridge`` of ``csrc/lsmc_common.cuh``), then the
step's exercise; the last launch takes step 0's exercise and the final
sums.

V is carried in time-T units: regression target ``y = c_t·V``, exercise
``V ← ex/c_t``, never multiplied per step. :func:`_ma_mega_reference` is
the plain-torch transcription: moments of exact products summed in f64 and
rounded once to f32, the
same unrolled solve on 0-d f32 tensors (`ops.lsmc_megakernel`), the same
per-path operation order; on the card the two agree to the bit.

Options that belong to later slices raise ``NotImplementedError`` naming
their ROADMAP item: the asset-0 sign-bit ``barrier`` (with the A11
dynamics; amcx's encoding also loses the gate at S = 0, ROADMAP queue C),
``discount_planes`` (pathwise ``direct_y``, with `amcx.hybrid`), per-step
rate curves (with A9 ``term``) and ``axis_name`` (A15).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from .lsmc_megakernel import _not_ported, _solve_equilibrated_ridge, _sum_once_rounded
from .maxcall_pallas import (MaParams, _columns, _fitted, _moments_from_cols, _payoff_for,
                             _tuple, ma_inputs, ma_moments_blocks, ma_pack_dim, ma_params)

__all__ = ["lsmc_price_ma_mega", "lsmc_price_ma_mega_reference"]

_THREADS = 256


def _ma_mega_reference(planes, stats, cfg, cf_tau, antithetic):
    """Plain-torch induction on asset-major planes ``(n_steps+1, A, n)``;
    returns ``(sums (2,), cf, tau)`` (cf/τ None unless ``cf_tau``)."""
    n_steps, A = planes.shape[0] - 1, planes.shape[1]
    K, phi, kind, w = cfg["K"], cfg["phi"], cfg["payoff_kind"], cfg["weights"]
    c, inv_c, allow = stats[2 * A], stats[2 * A + 1], stats[2 * A + 2]
    V = _payoff_for(list(torch.unbind(planes[n_steps], 0)), K, kind, phi, w)
    cf = tau = None
    if cf_tau:
        cf, tau = V.clone(), torch.full_like(V, float(n_steps))
    for t in range(n_steps - 1, -1, -1):
        P = list(torch.unbind(planes[t], 0))
        cols = _columns(P, stats, t, cfg["basis"], cfg["degree"], cfg["mode"],
                        cfg["sorted_basis"])
        ex = _payoff_for(P, K, kind, phi, w)
        wt = (ex > 0.0).to(torch.float32) if cfg["itm_weights"] else None
        packed = _moments_from_cols(cols, c[t] * V, wt)
        coef = _solve_equilibrated_ridge(packed, len(cols), cfg["rcond"])
        cont = torch.clamp_min(_fitted(cols, coef), 0.0)
        mask = (ex > cont) & (allow[t] > 0.0)
        V = torch.where(mask, ex * inv_c[t], V)
        if cf_tau:
            cf = torch.where(mask, ex, cf)
            tau = torch.where(mask, float(t), tau)
    v = c[0] * V
    if antithetic:
        half = v.shape[0] // 2
        sq = 0.5 * (v[:half] + v[half:])
    else:
        sq = v
    return torch.stack([_sum_once_rounded(v), _sum_once_rounded(sq * sq)]), cf, tau


def _ma_mega_cuda(planes, stats, cfg, cf_tau, antithetic, coeffs=None):
    """The kernels on CUDA planes; returns ``(sums (2,), cf, tau)``.
    ``coeffs``, if given, an ``((n_steps+1) m,)`` f32 CUDA tensor that
    receives each step's coefficient row t at ``[t m, (t+1) m)`` (else
    scratch)."""
    from . import _build

    n_steps, A, n_paths = planes.shape
    n_steps -= 1
    dev = planes.device
    params = cfg["params"]
    m = params.n_cols
    P = ma_pack_dim(m)
    n_sm = _build.sm_count(dev)
    n_blocks = ma_moments_blocks(n_paths, n_sm)
    n_final = max(1, min(2 * n_sm, -(-n_paths // _THREADS)))
    V = torch.empty(n_paths, dtype=torch.float32, device=dev)
    cf = tau = None
    if cf_tau:
        cf = torch.empty(n_paths, dtype=torch.float32, device=dev)
        tau = torch.empty(n_paths, dtype=torch.float32, device=dev)
    # the ticket (zeroed), then the blocks' partial rows
    partials = torch.empty(1 + max(n_blocks * P, 2 * n_final), dtype=torch.float64, device=dev)
    partials[:1].zero_()  # a fill: a scalar store would copy from the host and wait
    if coeffs is None:
        coeffs = torch.empty((n_steps + 1) * m, dtype=torch.float32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _ma_mega_fn()(planes.data_ptr(), stats.data_ptr(), V.data_ptr(),
                       None if cf is None else cf.data_ptr(),
                       None if tau is None else tau.data_ptr(), partials.data_ptr(),
                       coeffs.data_ptr(), sums.data_ptr(), n_steps, n_paths, n_blocks, n_final,
                       float(cfg["rcond"]), int(cfg["itm_weights"]), int(antithetic),
                       ctypes.byref(params), stream)
    lsmc_price_ma_mega.launches += 1
    _build.check(rc, "amcx_lsmc_ma_mega")
    return sums, cf, tau


@functools.lru_cache(maxsize=None)
def _ma_mega_fn():
    from . import _build

    Vp, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_lsmc_ma_mega", [Vp] * 8 + [I, I, I, I, F, I, I,
                                                            ctypes.POINTER(MaParams), Vp])


def lsmc_price_ma_mega(
    paths_tm: torch.Tensor,
    K,
    r,
    dt,
    phi: float = 1.0,
    payoff_kind: str = "maxcall",
    basis: str = "chebyshev",
    degree: int = 2,
    mode: str = "total",
    sorted_basis: bool = False,
    weights=None,
    rcond: float = 1e-6,
    itm_weights: bool = False,
    exercise_from_step: int = 0,
    exercise_steps=None,
    antithetic: bool = False,
    return_cf_tau: bool = False,
    discount_planes=None,
    barrier=None,
    barrier_type: str = "down-in",
    axis_name=None,
    axis_size: int = 1,
):
    """Whole multi-asset LSMC induction on time-major ``(n_steps+1, n_paths,
    n_assets)`` f32 paths (as from `amcx_torch.paths.simulate_gbm_multi`).

    Runs where ``paths_tm`` lies: on a CUDA tensor the kernels of
    ``csrc/lsmc_ma_mega.cu`` (or it raises), on a CPU tensor the plain
    version. The frame is :func:`maxcall_standardization` of the paths
    (sorted when ``sorted_basis``); ``exercise_steps`` (step indices in
    0..n_steps-1) overrides ``exercise_from_step``; maturity always pays.
    ``antithetic`` folds path i with i + n_paths/2 before the variance.
    Returns ``(price, stderr)`` or, with ``return_cf_tau``, ``(price,
    stderr, cashflows, exercise_steps)`` per path. Payoff kinds as in
    `amcx_torch.ops.maxcall_pallas._payoff_for`.
    ``lsmc_price_ma_mega.launches`` counts kernel launches.
    """
    dev = torch.device(paths_tm.device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_price_ma_mega runs on 'cpu' or 'cuda', got {dev}")
    run = _ma_mega_cuda if dev.type == "cuda" else _ma_mega_reference
    with tracing.span("induction"):
        return _price(run, paths_tm, K, r, dt, phi, payoff_kind, basis, degree, mode,
                      sorted_basis, weights, rcond, itm_weights, exercise_from_step,
                      exercise_steps, antithetic=antithetic, return_cf_tau=return_cf_tau,
                      discount_planes=discount_planes, barrier=barrier,
                      barrier_type=barrier_type, axis_name=axis_name, axis_size=axis_size)


lsmc_price_ma_mega.launches = 0


def lsmc_price_ma_mega_reference(paths_tm: torch.Tensor, *args, **kwargs):
    """:func:`lsmc_price_ma_mega`'s plain version on any device, inputs
    included (the card's check compares the two on the same CUDA paths)."""
    return _price(_ma_mega_reference, paths_tm, *args, plain=True, **kwargs)


def _price(run, paths_tm, *args, return_cf_tau=False, antithetic=False, **kwargs):
    n_paths = paths_tm.shape[1]
    with tracing.span("induction.prepare"):
        planes, stats, cfg = prepare(paths_tm, *args, antithetic=antithetic, **kwargs)
    sums, cf, tau = run(planes, stats, cfg, bool(return_cf_tau), bool(antithetic))
    price = sums[0] / n_paths
    n_eff = n_paths // 2 if antithetic else n_paths
    var = torch.clamp_min(sums[1] / n_eff - price * price, 0.0)
    stderr = torch.sqrt(var / n_eff)
    if return_cf_tau:
        return price, stderr, cf, tau
    return price, stderr


def prepare(paths_tm, K, r, dt, phi=1.0, payoff_kind="maxcall", basis="chebyshev", degree=2,
            mode="total", sorted_basis=False, weights=None, rcond=1e-6, itm_weights=False,
            exercise_from_step=0, exercise_steps=None, antithetic=False, discount_planes=None,
            barrier=None, barrier_type="down-in", axis_name=None, axis_size=1, plain=False):
    """Validate :func:`lsmc_price_ma_mega`'s arguments and build the
    induction's inputs: the asset-major planes ``(n_steps+1, A, n_paths)``,
    the :func:`ma_stats` rows (by :func:`ma_inputs`, its plain version with
    ``plain``) and the static configuration."""
    if barrier is not None:
        _not_ported("the ma-mega kernel's asset-0 sign-bit barrier", "A11 / B6 options")
    if discount_planes is not None:
        _not_ported("the ma-mega kernel's pathwise discount planes (direct_y)",
                    "A11 hybrid / B6 options")
    if isinstance(r, torch.Tensor) and r.ndim > 0:
        _not_ported("the ma-mega kernel's per-step rate curves", "A9 term / B6 options")
    if axis_name is not None:
        _not_ported("the ma-mega kernel's collective mode", "A15")
    planes, stats = ma_inputs(paths_tm, r, dt, sorted_basis=bool(sorted_basis), mode=mode,
                              exercise_from_step=exercise_from_step,
                              exercise_steps=exercise_steps, plain=plain)
    n_assets, n_paths = planes.shape[1], planes.shape[2]
    if n_paths >= 2 ** 31:
        raise ValueError(f"n_paths must be < 2^31, got {n_paths}")
    if antithetic and n_paths % 2:
        raise ValueError("antithetic pair folding needs an even n_paths")
    params = ma_params(n_assets, basis, degree, mode, bool(sorted_basis), payoff_kind, float(K),
                       float(phi), _tuple(weights))
    cfg = dict(K=float(K), phi=float(phi), payoff_kind=payoff_kind, weights=weights,
               basis=basis.strip().lower(), degree=degree, mode=mode,
               sorted_basis=bool(sorted_basis), itm_weights=bool(itm_weights),
               rcond=float(rcond), params=params)
    return planes, stats, cfg

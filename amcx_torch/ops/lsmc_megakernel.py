"""LSMC backward induction on the card: the CUDA kernels' wrappers and their
plain versions.

Port of `amcx.ops.lsmc_megakernel`: ``_mega_kernel`` (via
``lsmc_price_megakernel``) for one vanilla put or call, and
``_book_kernel`` (via :func:`lsmc_book_megakernel`) for a strike/maturity
book of them on one path set. The TPU kernels run the whole induction in
one launch because their grid is sequential; on Hopper the per-step Gram is
a grid-wide dependency. ``amcx_torch/csrc/lsmc_mega.cu`` keeps one launch a
pricing: a cooperative grid (sized by :func:`_mega_plan`) whose block 0
solves each step while the other blocks, which own the paths for the whole
pricing, sum the next step's moments; ``csrc/lsmc_book.cu`` drives moments
→ solve → apply kernels per step from a host loop on one stream (see the
notes at the top of those files).

:func:`_mega_reference` is a plain-torch transcription of the same
algorithm: V carried in time-T units, explicit pair moments, and the same
unrolled equilibrated-ridge Cholesky with two refinements against the
un-ridged Gram, on 0-d f32 tensors in the same operation order (never
``torch.linalg``, whose solve is what the kernel replaces). Like the kernel
it sums the moments and the final two sums in f64 and rounds them once to
f32, which makes the result independent of the summation order but for
f64 noise of ~1e-6 f32 ulp, so on the card the two agree to the bit (the
closed-form-frame ITM fit turns any f32 summation-order noise into
exercise flips; see the note in ``csrc/lsmc_mega.cu``). :func:`_book_reference`
does the same for the book: the shared Gram head and every option's rhs
sums, one factor, one refined back-solve per option (vectorized over the
options: the same f32 operations on each element).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from .. import tracing
from ..basis import BASIS_IDS, basis_cols
from ..payoff import barrier_gate

__all__ = ["lsmc_price_megakernel", "lsmc_price_mega_reference", "MegaOutputs",
           "mega_stats", "closed_form_frame", "closed_form_rows", "lsmc_book_megakernel",
           "lsmc_book_mega_reference", "BOOK_MAX_STRIKES"]

MAX_DEGREE = 10
_THREADS = 256  # csrc/lsmc_common.cuh kThreads
_QUAD_BYTES = 16  # one f32 plane of a quad of paths
_MEGA_PLANES = 3  # csrc/lsmc_mega.cu kPlanes: V, S even, S odd
BOOK_MAX_STRIKES = 64  # csrc/lsmc_book.cu kMaxStrikes


class MegaOutputs(NamedTuple):
    """``price``/``stderr`` 0-d tensors; the ``(n_paths,)`` undiscounted
    ``cashflows`` and ``exercise_times`` planes (SURVEY Q5/Q7, the
    contract of `amcx_torch.engine.LSMCResult`); and the ``(n_steps+1,
    degree+1)`` per-step solved coefficients (zeros at the maturity row).
    amcx's field order."""

    price: torch.Tensor
    stderr: torch.Tensor
    cashflows: Optional[torch.Tensor] = None
    exercise_times: Optional[torch.Tensor] = None
    coeffs: Optional[torch.Tensor] = None


def _pairs(k):
    return [(i, j) for i in range(k) for j in range(i, k)]


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
    """Solve the packed ``[G_upper..., b...]`` system; returns k 0-d tensors.
    The k entries of ``b`` may be ``(n_rhs,)`` tensors (the book's options):
    each coefficient is then ``(n_rhs,)``, every right-hand side solved
    against the one factor."""
    idx = {p: n for n, p in enumerate(_pairs(k))}

    def g_raw(i, j):
        return packed[idx[(i, j)] if i <= j else idx[(j, i)]]

    off = len(idx)
    L, d, Gnr = _factor_equilibrated_ridge(g_raw, k, rcond)
    return _solve_factored(L, d, Gnr, [packed[off + i] for i in range(k)], k)


def _mega_reference(paths, stats, K, phi, rcond, basis, degree, american, itm_weights,
                    cf_tau=False):
    """Plain-torch induction; returns ``(sums (2,), coeffs (T+1, k), V, cf,
    tau)`` with ``V`` the final per-path carry in time-T units and the
    cf/τ planes (None unless ``cf_tau``)."""
    n_steps = paths.shape[0] - 1
    k = degree + 1
    mean_t, inv_std_t, c, inv_c = stats.view(4, n_steps + 1)
    V = torch.clamp_min(phi * (paths[n_steps] - K), 0.0)
    cf = tau = None
    if cf_tau:
        cf = V.clone()
        tau = torch.full_like(V, float(n_steps))
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
            mask = ex > cont
            V = torch.where(mask, ex * inv_c[t], V)
            if cf_tau:
                cf = torch.where(mask, ex, cf)
                tau = torch.where(mask, float(t), tau)
    v = c[0] * V
    return torch.stack([_sum_once_rounded(v), _sum_once_rounded(v * v)]), coeffs, V, cf, tau


def _sum_once_rounded(x: torch.Tensor) -> torch.Tensor:
    """Sum of f32 values accumulated in f64 and rounded once to f32."""
    return torch.sum(x, dtype=torch.float64).to(torch.float32)


class MegaParams(ctypes.Structure):
    """``struct MegaParams`` of ``csrc/lsmc_mega.cu``, handed to the kernel
    by value."""

    _fields_ = [("n_steps", ctypes.c_int), ("n_paths", ctypes.c_int),
                ("n_blocks", ctypes.c_int), ("chip_slots", ctypes.c_int),
                ("basis", ctypes.c_int), ("american", ctypes.c_int),
                ("itm_weights", ctypes.c_int), ("strike", ctypes.c_float),
                ("phi", ctypes.c_float), ("rcond", ctypes.c_float)]


def cooperative_plan(units: int, qpu: int, slot_bytes: int, n_sms: int,
                     occupancy: Callable[[int], int], kernel: str):
    """A cooperative induction's grid (kernels 2 and 6, ``csrc/lsmc_coop.cuh``):
    ``(n_blocks, chip_slots, slots_needed)``. Block 0 solves; each thread of
    the other blocks owns ``units`` of paths, ``qpu`` quad slots a unit of
    ``slot_bytes`` for its ``_THREADS`` threads, in shared memory up to
    ``chip_slots`` and in global spill planes past them (``slots_needed >
    chip_slots``). ``occupancy`` maps a block's dynamic shared-memory bytes
    to the blocks an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
    0 when they do not fit). The widest grid that keeps every quad on chip
    wins; when none does, the widest grid keeps as many as its blocks leave
    room for."""
    widest = occupancy(0)
    if widest < 1 or widest * n_sms < 2:
        raise RuntimeError(f"the {kernel} kernel fits no two co-resident blocks")

    def grid(per_sm):
        workers = max(1, min(per_sm * n_sms - 1, -(-units // _THREADS)))
        return workers + 1, -(-units // (workers * _THREADS)) * qpu

    for per_sm in range(widest, 0, -1):
        n_blocks, needed = grid(per_sm)
        if occupancy(needed * slot_bytes) * n_sms >= n_blocks:
            return n_blocks, needed, needed
    n_blocks, needed = grid(widest)
    per_sm = -(-n_blocks // n_sms)
    chip = 0
    while chip + qpu < needed and occupancy((chip + qpu) * slot_bytes) >= per_sm:
        chip += qpu
    return n_blocks, chip, needed


def coop_partials(n_blocks: int, degree: int, device) -> torch.Tensor:
    """A cooperative induction's f64 scratch (``csrc/lsmc_coop.cuh``): the
    arrival and generation words, zeroed by a fill on the stream (a scalar
    store would copy from the host and wait for the stream), then a row of
    ``max(P, 2)`` sums for each worker block."""
    k = degree + 1
    buf = torch.empty(1 + (n_blocks - 1) * max(k * (k + 1) // 2 + k, 2), dtype=torch.float64,
                      device=device)
    buf[:1].zero_()
    return buf


def _mega_plan(n_paths: int, n_sms: int, occupancy: Callable[[int], int]):
    """Kernel 2's cooperative grid (:func:`cooperative_plan`): a worker
    thread owns quads of paths (the last one masked past ``n_paths``) and
    keeps each quad's V, S_t and S_{t+1} in a slot."""
    return cooperative_plan(-(-n_paths // 4), 1, _THREADS * _QUAD_BYTES * _MEGA_PLANES, n_sms,
                            occupancy, "mega")


@functools.lru_cache(maxsize=None)
def _mega_occupancy(degree: int, smem: int, device_index: int) -> int:
    from . import _build

    with torch.cuda.device(device_index):
        fn = _build.function("amcx_lsmc_mega_occupancy",
                             [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        blocks = ctypes.c_int(0)
        _build.check(fn(degree, smem, ctypes.byref(blocks)), "amcx_lsmc_mega_occupancy")
    return blocks.value


@functools.lru_cache(maxsize=None)
def _mega_fn():
    from . import _build

    Vp = ctypes.c_void_p
    return _build.function("amcx_lsmc_mega", [ctypes.POINTER(MegaParams)] + [Vp] * 8
                           + [ctypes.c_int, Vp])


def _mega_cuda(paths, stats, K, phi, rcond, basis, degree, american, itm_weights,
               cf_tau=False):
    from . import _build

    n_steps = paths.shape[0] - 1
    n_paths = paths.shape[1]
    k = degree + 1
    dev = paths.device
    f32 = torch.float32
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_blocks, chip_slots, needed = _mega_plan(
        n_paths, _build.sm_count(dev), lambda smem: _mega_occupancy(degree, smem, index))
    # V, S_t, S_{t+1} of the quads past the shared-memory slots
    spill = None
    if needed > chip_slots:
        spill = torch.empty(_MEGA_PLANES * 4 * (-(-n_paths // 4)), dtype=f32, device=dev)
    cf = tau = None
    if cf_tau:
        cf = torch.empty(n_paths, dtype=f32, device=dev)
        tau = torch.empty(n_paths, dtype=f32, device=dev)
    partials = coop_partials(n_blocks, degree, dev)
    coeffs = torch.zeros((n_steps + 1, k), dtype=f32, device=dev)
    sums = torch.empty(2, dtype=f32, device=dev)
    params = MegaParams(n_steps=n_steps, n_paths=n_paths, n_blocks=n_blocks,
                        chip_slots=chip_slots, basis=BASIS_IDS[basis], american=int(american),
                        itm_weights=int(itm_weights), strike=K, phi=phi, rcond=rcond)

    def ptr(x):
        return None if x is None else x.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _mega_fn()(ctypes.byref(params), paths.data_ptr(), stats.data_ptr(), ptr(spill),
                    ptr(cf), ptr(tau), partials.data_ptr(), coeffs.data_ptr(), sums.data_ptr(),
                    degree, stream)
    lsmc_price_megakernel.launches += 1
    _build.check(rc, "amcx_lsmc_mega")
    return sums, coeffs, None, cf, tau


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
    # f32(r) f32(dt) rounded once on the host (exact as a Python float): a
    # device scalar would be a copy from the host that waits for the stream
    r_dt = float(torch.tensor(float(r), dtype=f32) * torch.tensor(float(dt), dtype=f32))
    r_rem = r_dt * rem
    return torch.cat([
        torch.as_tensor(mean_t, dtype=f32, device=device).reshape(-1),
        torch.as_tensor(inv_std_t, dtype=f32, device=device).reshape(-1),
        torch.exp(-r_rem), torch.exp(r_rem)])


def closed_form_frame(S0, r, sigma, q, T, n_steps: int, dtype=torch.float32, device=None):
    """Closed-form per-step standardization statistics for GBM spot paths:
    ``(mean_t, 1/std_t)`` with ``E[S_t] = S0 e^{(r−q)t}`` and
    ``Var[S_t] = S0² e^{2(r−q)t}(e^{σ²t} − 1)``, in ``dtype`` with amcx's
    operation order (`amcx_torch.gbm_standardization`). At t=0 the variance
    is 0 and the clamped 1/std multiplies an exactly-zero deviation.
    """
    t = torch.arange(n_steps + 1, dtype=dtype, device=device) * (
        torch.tensor(T, dtype=dtype, device=device) / n_steps)
    growth = torch.exp((r - q) * t)
    mean = S0 * growth
    var = (S0 * growth) ** 2 * torch.expm1(sigma ** 2 * t)
    return mean, 1.0 / torch.clamp_min(torch.sqrt(var), 1e-6)


@functools.lru_cache(maxsize=16)
def closed_form_rows(S0: float, r: float, sigma: float, q: float, T: float, dt: float,
                     n_steps: int, device: torch.device) -> torch.Tensor:
    """Kernels 2 and 6's rows in the closed-form frame: :func:`mega_stats`
    of :func:`closed_form_frame` over ``T``, the discount rows over ``dt``.
    Built once per market, grid and device, so later calls copy nothing to
    the card. Read-only."""
    mean_t, inv_std_t = closed_form_frame(S0, r, sigma, q, T, n_steps, device=device)
    return mega_stats(mean_t, inv_std_t, r, dt, n_steps, device)


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
    barrier=None,
    barrier_type: str = "down-in",
    itm_weights: bool = False,
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    axis_name: Optional[str] = None,
    axis_size: int = 1,
    exercise_steps=None,
    return_cf_tau: bool = False,
    return_coeffs: bool = False,
    antithetic: bool = False,
    replay_coeffs=None,
):
    """Price a vanilla put (``phi=-1``) or call (``phi=+1``) by LSMC on the
    time-major paths ``(n_steps+1, n_paths)`` f32.

    amcx's parameters and return convention, minus ``interpret``: the price
    as a 0-d tensor, ``(price, stderr)`` with ``return_stats``, or
    :class:`MegaOutputs` with the per-step coefficients (``return_coeffs``)
    and the undiscounted cashflow and exercise-time planes
    (``return_cf_tau``). Runs where ``paths_tm`` lies: on a CUDA tensor the
    kernel of ``csrc/lsmc_mega.cu`` (or it raises; a grid the card cannot
    hold at once is refused, never run another way), on a CPU tensor
    :func:`_mega_reference`. ``mean_t``/``inv_std_t``: per-step
    standardization (computed from the paths when omitted). Not ported yet:
    ``barrier`` (any ``barrier_type``), ``exercise_steps``,
    ``replay_coeffs``, ``antithetic`` and rate curves (ROADMAP B2 options),
    and ``axis_name`` (A15). ``lsmc_price_megakernel.launches`` counts
    kernel launches.
    """
    run = _runner(paths_tm)
    with tracing.span("induction"):
        return _price(run, paths_tm, K, r, dt, phi, basis, degree, rcond, american, barrier,
                      barrier_type, itm_weights, mean_t, inv_std_t, return_stats, axis_name,
                      axis_size, exercise_steps, return_cf_tau, return_coeffs, antithetic,
                      replay_coeffs)


lsmc_price_megakernel.launches = 0


def lsmc_price_mega_reference(paths_tm: torch.Tensor, *args, **kwargs):
    """:func:`lsmc_price_megakernel`'s plain version on any device (the
    card's check compares the two on the same CUDA paths)."""
    return _price(_mega_reference, paths_tm, *args, **kwargs)


def _runner(paths_tm):
    dev = torch.device(paths_tm.device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_price_megakernel runs on 'cpu' or 'cuda', got {dev}")
    return _mega_cuda if dev.type == "cuda" else _mega_reference


def _price(run, paths_tm, K, r, dt, phi, basis="chebyshev", degree=4, rcond=1e-6,
           american=True, barrier=None, barrier_type="down-in", itm_weights=False,
           mean_t=None, inv_std_t=None, return_stats=False, axis_name=None, axis_size=1,
           exercise_steps=None, return_cf_tau=False, return_coeffs=False, antithetic=False,
           replay_coeffs=None):
    paths, basis = _checked(paths_tm, r, basis, degree, barrier, barrier_type, axis_name,
                            exercise_steps, replay_coeffs, antithetic)
    with tracing.span("induction.prepare"):
        if mean_t is None or inv_std_t is None:
            mean_t, inv_std_t = _data_standardization(paths, float(K), float(phi), itm_weights)
        stats = mega_stats(mean_t, inv_std_t, r, dt, paths.shape[0] - 1, paths.device)
    return _induction(run, paths, stats, K, phi, rcond, basis, degree, american, itm_weights,
                      return_stats, return_cf_tau, return_coeffs)


def _price_rows(paths_tm, stats, K, phi, basis="chebyshev", degree=4, rcond=1e-6,
                american=True, barrier=None, barrier_type="down-in", itm_weights=False,
                exercise_steps=None, return_cf_tau=False, return_coeffs=False,
                antithetic=False):
    """:func:`lsmc_price_megakernel` with ``return_stats`` on rows built
    already (:func:`closed_form_rows`; ``price_option(engine="mega")``):
    the same checks and induction, and no row of its own."""
    run = _runner(paths_tm)
    with tracing.span("induction"):
        with tracing.span("induction.prepare"):
            paths, basis = _checked(paths_tm, None, basis, degree, barrier, barrier_type, None,
                                    exercise_steps, None, antithetic)
        return _induction(run, paths, stats, K, phi, rcond, basis, degree, american,
                          itm_weights, True, return_cf_tau, return_coeffs)


def _checked(paths_tm, r, basis, degree, barrier, barrier_type, axis_name, exercise_steps,
             replay_coeffs, antithetic):
    """The contiguous paths and the normalized basis name, or the error of
    an argument the kernel does not take."""
    if axis_name is not None:
        _not_ported("the mega kernel's collective mode (axis_name)", "A15")
    if barrier is not None:
        _not_ported(f"the mega kernel's {barrier_type} barrier mode", "B2 options")
    if exercise_steps is not None:
        _not_ported("the mega kernel's exercise_steps schedule", "B2 options")
    if replay_coeffs is not None:
        _not_ported("the mega kernel's replay_coeffs mode", "B2 options / A8")
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
    if paths.shape[1] >= 2 ** 31:
        raise ValueError(f"n_paths must be < 2^31, got {paths.shape[1]}")
    return paths, basis


def _induction(run, paths, stats, K, phi, rcond, basis, degree, american, itm_weights,
               return_stats, return_cf_tau, return_coeffs):
    """Kernel 2 (or its plain version, ``run``) on checked paths and rows;
    the price and stderr in amcx's return convention."""
    n_paths = paths.shape[1]
    sums, coeffs, _, cf, tau = run(paths, stats, float(K), float(phi), float(rcond), basis,
                                   degree, bool(american), bool(itm_weights),
                                   bool(return_cf_tau))
    price = sums[0] / n_paths
    var = torch.clamp_min(sums[1] / n_paths - price * price, 0.0)
    stderr = torch.sqrt(var / n_paths)
    if return_coeffs or return_cf_tau:
        return MegaOutputs(price, stderr, cf, tau, coeffs if return_coeffs else None)
    if return_stats:
        return price, stderr
    return price


# ---------------------------------------------------------------------------
# the strike/maturity book (kernel 3)
# ---------------------------------------------------------------------------

class BookParams(ctypes.Structure):
    """``struct BookParams`` of ``csrc/lsmc_book.cu``: the options of a book
    and the induction's switches, handed to the kernels by value."""

    _fields_ = [("n_strikes", ctypes.c_int), ("basis", ctypes.c_int),
                ("american", ctypes.c_int), ("antithetic", ctypes.c_int),
                ("rcond", ctypes.c_float),
                ("strikes", ctypes.c_float * BOOK_MAX_STRIKES),
                ("phis", ctypes.c_float * BOOK_MAX_STRIKES),
                ("mats", ctypes.c_int * BOOK_MAX_STRIKES)]


@functools.lru_cache(maxsize=64)
def _book_params(strikes: tuple, phis: tuple, mats: tuple, basis: str, american: bool,
                 antithetic: bool, rcond: float) -> BookParams:
    # cached: the block is built once per book, and the kernels only read it
    p = BookParams(n_strikes=len(strikes), basis=BASIS_IDS[basis], american=int(american),
                   antithetic=int(antithetic), rcond=rcond)
    for j, (K, phi, m) in enumerate(zip(strikes, phis, mats)):
        p.strikes[j], p.phis[j], p.mats[j] = K, phi, m
    return p


def _book_reference(paths, knock, stats, cfg, cf_tau):
    """Plain-torch book induction on ``(n_steps+1, n_paths)`` paths;
    returns ``(sums, squares, cf, tau)``: the per-option ``(n_strikes,)``
    sums of c_0·V and of its (pair-folded) squares, and the ``(n_strikes,
    n_paths)`` cf/τ planes (None unless ``cf_tau``)."""
    n_steps = paths.shape[0] - 1
    dev, f32 = paths.device, torch.float32
    degree, mats = cfg["degree"], cfg["mats"]
    k = degree + 1
    mean_t, inv_std_t, c, inv_c = stats.view(4, n_steps + 1)
    K = torch.tensor(cfg["strikes"], dtype=f32, device=dev)[:, None]
    phi = torch.tensor(cfg["phis"], dtype=f32, device=dev)[:, None]

    def exercise(t):
        return torch.clamp_min(phi * (paths[t] - K), 0.0)

    def gated(t, ex):
        return ex if knock is None else torch.where(knock[t], ex, 0.0)

    full = torch.tensor([m == n_steps for m in mats], device=dev)[:, None]
    V = torch.where(full, gated(n_steps, exercise(n_steps)), 0.0)
    cf = tau = None
    if cf_tau:
        cf = V.clone()
        tau = torch.tensor(mats, dtype=f32, device=dev)[:, None].expand_as(V).clone()
    for t in range(n_steps - 1, -1, -1):
        ex = exercise(t)
        if cfg["american"]:
            cols = basis_cols((paths[t] - mean_t[t]) * inv_std_t[t], cfg["basis"], degree)
            y = c[t] * V
            packed = [_sum_once_rounded(cols[a] * cols[b]) for a, b in _pairs(k)]
            packed += [torch.sum(cols[a] * y, dim=1, dtype=torch.float64).to(f32)
                       for a in range(k)]
            coef = _solve_equilibrated_ridge(packed, k, cfg["rcond"])
            fitted = cols[0] * coef[0][:, None]
            for a in range(1, k):
                fitted = fitted + cols[a] * coef[a][:, None]
            cont = torch.clamp_min(fitted, 0.0)  # Q2; a NaN fit stays NaN
            live = torch.tensor([t < m for m in mats], device=dev)[:, None]
            mask = (ex > cont) & live
            if knock is not None:
                mask = mask & knock[t]
            V = torch.where(mask, ex * inv_c[t], V)
            if cf_tau:
                cf = torch.where(mask, ex, cf)
                tau = torch.where(mask, float(t), tau)
        if t in mats:  # shorter-dated options start at their own maturity
            at_mat = torch.tensor([t == m for m in mats], device=dev)[:, None]
            pay = gated(t, ex)
            V = torch.where(at_mat, pay * inv_c[t], V)
            if cf_tau:
                cf = torch.where(at_mat, pay, cf)
    v = c[0] * V
    sq = v
    if cfg["antithetic"]:
        half = v.shape[1] // 2
        sq = 0.5 * (v[:, :half] + v[:, half:])
    return (torch.sum(v, dim=1, dtype=torch.float64).to(f32),
            torch.sum(sq * sq, dim=1, dtype=torch.float64).to(f32), cf, tau)


def _book_cuda(paths, knock, stats, cfg, cf_tau):
    from . import _build

    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    n_s, k = len(cfg["strikes"]), cfg["degree"] + 1
    dev = paths.device
    n_blocks = book_blocks(n_paths, _build.sm_count(dev))
    V = torch.empty((n_s, n_paths), dtype=torch.float32, device=dev)
    cf = tau = None
    if cf_tau:
        cf, tau = torch.empty_like(V), torch.empty_like(V)
    P = k * (k + 1) // 2 + k * n_s
    partials = torch.empty(n_blocks * max(P, 2 * n_s), dtype=torch.float64, device=dev)
    coeffs = torch.empty(n_s * k, dtype=torch.float32, device=dev)
    sums = torch.empty((n_s, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _book_fn()(paths.data_ptr(), None if knock is None else knock.data_ptr(),
                    stats.data_ptr(), V.data_ptr(), None if cf is None else cf.data_ptr(),
                    None if tau is None else tau.data_ptr(), partials.data_ptr(),
                    coeffs.data_ptr(), sums.data_ptr(), n_steps, n_paths, n_blocks,
                    cfg["degree"], ctypes.byref(cfg["params"]), stream)
    lsmc_book_megakernel.launches += 1
    _build.check(rc, "amcx_lsmc_book")
    return sums[:, 0], sums[:, 1], cf, tau


def book_blocks(n_paths: int, n_sm: int) -> int:
    """Blocks (partial rows) of the warp-roles moments' persistent grid
    (``csrc/lsmc_roles.cuh``: kernel 3, and kernel 10 in ``lsmc_swing``):
    two per SM (a block is at most 320 threads), fewer when the paths fill
    fewer 256-path chunk pairs; the one-block solve sums this many rows per
    step."""
    return max(1, min(2 * n_sm, -(-n_paths // _THREADS)))


@functools.lru_cache(maxsize=None)
def _book_fn():
    from . import _build

    Vp, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_lsmc_book", [Vp] * 9 + [I, I, I, I, ctypes.POINTER(BookParams),
                                                         Vp])


def lsmc_book_megakernel(
    paths_tm: torch.Tensor,
    strikes,
    r,
    dt,
    phi,
    basis: str = "chebyshev",
    degree: int = 4,
    rcond: float = 1e-6,
    american: bool = True,
    mean_t: Optional[torch.Tensor] = None,
    inv_std_t: Optional[torch.Tensor] = None,
    maturity_steps=None,
    axis_name: Optional[str] = None,
    axis_size: int = 1,
    return_cf_tau: bool = False,
    antithetic: bool = False,
    barrier=None,
    barrier_type: str = "down-in",
):
    """Price a book of vanilla puts and calls on shared time-major paths
    ``(n_steps+1, n_paths)`` f32, by one LSMC induction that shares the
    path reads, the Gram and its factor across the options (fit on all
    paths; ITM-weighted Grams would differ per option).

    Runs where ``paths_tm`` lies: on a CUDA tensor the kernels of
    ``csrc/lsmc_book.cu`` (or it raises), on a CPU tensor
    :func:`_book_reference`. ``phi`` is +1 (calls) / −1 (puts) or a
    per-option vector. ``maturity_steps``: per-option maturity step indices
    in 1..n_steps (option s pays at its own step and is priced below it).
    ``barrier``: one knock level shared by the book, any ``barrier_type``.
    ``antithetic`` folds path i with i + n_paths/2 before the variance.
    ``mean_t``/``inv_std_t``: the standardization (all-paths statistics of
    the raw spots when omitted). Returns ``(prices, stderrs)``, each
    ``(n_strikes,)``, or with ``return_cf_tau`` also the ``(n_strikes,
    n_paths)`` cashflow and exercise-step planes. At most
    ``BOOK_MAX_STRIKES`` options. ``lsmc_book_megakernel.launches`` counts
    kernel launches.

    Unlike amcx: the knock state is a byte plane, not the spot's sign bit;
    any ``n_paths`` (amcx: a multiple of 4096); the discount rows are
    ``mega_stats``' (c_t from f32(r)·f32(dt), amcx's book f32(r·dt): at most
    an ulp apart).
    """
    dev = torch.device(paths_tm.device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_book_megakernel runs on 'cpu' or 'cuda', got {dev}")
    run = _book_cuda if dev.type == "cuda" else _book_reference
    return _price_book(run, paths_tm, strikes, r, dt, phi, basis, degree, rcond, american,
                       mean_t, inv_std_t, maturity_steps, axis_name, axis_size, return_cf_tau,
                       antithetic, barrier, barrier_type)


lsmc_book_megakernel.launches = 0


def lsmc_book_mega_reference(paths_tm: torch.Tensor, *args, **kwargs):
    """:func:`lsmc_book_megakernel`'s plain version on any device (the
    card's check compares the two on the same CUDA paths)."""
    return _price_book(_book_reference, paths_tm, *args, **kwargs)


def _price_book(run, paths_tm, strikes, r, dt, phi, basis="chebyshev", degree=4, rcond=1e-6,
                american=True, mean_t=None, inv_std_t=None, maturity_steps=None,
                axis_name=None, axis_size=1, return_cf_tau=False, antithetic=False,
                barrier=None, barrier_type="down-in"):
    if axis_name is not None:
        _not_ported("the book kernel's collective mode", "A15")
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
    if antithetic and n_paths % 2:
        raise ValueError(f"antithetic pair folding needs an even n_paths, got {n_paths}")
    ks = torch.atleast_1d(torch.as_tensor(strikes, dtype=torch.float32)).detach().cpu()
    n_s = ks.shape[0]
    if not 1 <= n_s <= BOOK_MAX_STRIKES:
        raise ValueError(f"the book kernel prices 1..{BOOK_MAX_STRIKES} options, got {n_s} "
                         "(the cap of csrc/lsmc_book.cu; split the book)")
    phis = torch.broadcast_to(torch.as_tensor(phi, dtype=torch.float32).detach().cpu(), (n_s,))
    if maturity_steps is None:
        mats = (n_steps,) * n_s
    else:
        mats = tuple(int(m) for m in maturity_steps)
        if len(mats) != n_s:
            raise ValueError(f"maturity_steps has {len(mats)} entries for {n_s} strikes")
        if any(m < 1 or m > n_steps for m in mats):
            raise ValueError(f"maturity_steps must lie in 1..{n_steps}")
    if mean_t is None or inv_std_t is None:
        mean_t, inv_std_t = _data_standardization(paths, 0.0, 1.0, False)
    stats = mega_stats(mean_t, inv_std_t, r, dt, n_steps, paths.device)
    knock = None if barrier is None else barrier_gate(paths, barrier, barrier_type).contiguous()
    strikes_t, phis_t = tuple(ks.tolist()), tuple(phis.tolist())
    cfg = dict(strikes=strikes_t, phis=phis_t, mats=mats, basis=basis, degree=degree,
               rcond=float(rcond), american=bool(american), antithetic=bool(antithetic),
               params=_book_params(strikes_t, phis_t, mats, basis, bool(american),
                                   bool(antithetic), float(rcond)))
    sums, squares, cf, tau = run(paths, knock, stats, cfg, bool(return_cf_tau))
    price = sums / n_paths
    n_eff = n_paths // 2 if antithetic else n_paths
    var = torch.clamp_min(squares / n_eff - price * price, 0.0)
    stderr = torch.sqrt(var / n_eff)
    if return_cf_tau:
        return price, stderr, cf, tau
    return price, stderr

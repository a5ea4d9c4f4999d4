"""Zero-path-memory LSMC: the paths are regenerated inside the induction.
The CUDA kernel's wrapper and its plain version.

Port of `amcx.ops.lsmc_fusedpath` (``_fusedpath_kernel``). No (T+1, n) path
array exists: the spot column of step t is rebuilt from a few (n,) planes
just before it is priced, by the backward Brownian-bridge recursion

    W_T = √(T·dt)·ξ_T,   W_t = (t/(t+1))·W_{t+1} + √(dt·t/(t+1))·ξ_t,
    S_t = S0·exp(drift_dt·t + σ·W_t)

(exactly W_0 = 0 at t = 0), and the mega kernel's Longstaff-Schwartz step
(moments, equilibrated ridge solve, apply) runs on that column. With a
barrier a forward walk W_s = W_{s-1} + √dt·ξ_s first records each path's
first crossing step τ_B (0 when S0 itself crosses), and the backward steps
rebuild the same path by backward differencing, W_t = W_{t+1} − √dt·ξ_{t+1};
the knock gate τ_B ≤ t comes from the forward walk, so the f32 drift of the
backward replay cannot move it.

The normals are a documented pure function of (seed, t, p):
key = (seed mod 2³², seed >> 32); counter = (t, p >> 2, 1, 0), one
Philox4x32-10 call for the four paths 4q … 4q+3 of step t (the third word
keeps this stream apart from the pathgen's (j, p, 0, 0)); u = ((x >> 8) +
1)·2⁻²⁴; Box-Muller on (u0, u1) and (u2, u3) as r·cos(a), r·sin(a) with
r = √(−2·log u) and a = u·2π rounded to f32. With ``antithetic`` path
p ≥ n/2 draws −ξ(seed, t, p − n/2), pairing p with p + n/2. The port's
rule: n_paths a multiple of 4, of 8 with ``antithetic`` (amcx's TPU rules,
n_paths % 4096 and an even chunk count, are dropped).

:func:`lsmc_price_fusedpath_reference` repeats the kernel's f32 operations
in their order on (n,) planes, sums the moments and the final two sums in
f64 and rounds them once (as ``_mega_reference``), and solves with the same
unrolled ridge Cholesky, so on the card the kernel and the plain version
agree to the bit. :func:`fusedpath_paths_reference` materialises the
(T+1, n) spots the recursion produces (for tests and the smoke run only),
so that kernel 2 can price the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
from typing import Callable, NamedTuple, Optional

import torch

from .. import tracing
from ..basis import BASIS_IDS, basis_cols
from ..payoff import exercise_allow_row
from .gbm import _seed_key, philox4x32_10
from .lsmc_megakernel import (_QUAD_BYTES, _THREADS, MAX_DEGREE, MegaOutputs, _not_ported,
                              _pairs, _solve_equilibrated_ridge, _sum_once_rounded,
                              closed_form_rows, coop_partials, cooperative_plan)

__all__ = ["lsmc_price_fusedpath", "lsmc_price_fusedpath_reference", "fusedpath_normals",
           "fusedpath_paths_reference"]

_TWO_PI = 2.0 * math.pi
_BARRIER_TYPES = ("down-in", "down-out", "up-in", "up-out")


class FusedpathParams(ctypes.Structure):
    """``struct FusedpathParams`` of ``csrc/lsmc_fusedpath.cu``, handed to
    the kernel by value."""

    _fields_ = [("n_steps", ctypes.c_int), ("n_paths", ctypes.c_int),
                ("n_blocks", ctypes.c_int), ("chip_slots", ctypes.c_int),
                ("basis", ctypes.c_int),
                ("american", ctypes.c_int), ("itm_weights", ctypes.c_int),
                ("antithetic", ctypes.c_int), ("barrier", ctypes.c_int),
                ("barrier_down", ctypes.c_int), ("barrier_in", ctypes.c_int),
                ("key_lo", ctypes.c_uint), ("key_hi", ctypes.c_uint),
                ("strike", ctypes.c_float), ("phi", ctypes.c_float),
                ("rcond", ctypes.c_float), ("sigma", ctypes.c_float),
                ("drift_dt", ctypes.c_float), ("dt", ctypes.c_float),
                ("S0", ctypes.c_float), ("level", ctypes.c_float)]


class _Config(NamedTuple):
    seed: int
    n_steps: int
    n_paths: int
    K: float
    phi: float
    rcond: float
    sigma: float
    drift_dt: float
    dt: float
    S0: float
    basis: str
    degree: int
    american: bool
    itm_weights: bool
    antithetic: bool
    barrier: Optional[float]
    barrier_down: bool
    barrier_in: bool


def _f32(v) -> float:
    """``v`` rounded to the nearest f32, as the kernel receives it."""
    return float(torch.tensor(v, dtype=torch.float32))


def fusedpath_normals(seed: int, t: int, n_paths: int, antithetic: bool = False,
                      device="cpu") -> torch.Tensor:
    """The kernel's standard normals ξ(seed, t, ·) of step ``t``, ``(n_paths,)``
    f32 (the stream of the module docstring)."""
    n_draw = n_paths // 2 if antithetic else n_paths
    q = torch.arange(n_draw // 4, dtype=torch.int64, device=device)
    step = torch.full((), int(t), dtype=torch.int64, device=device)
    one = torch.ones((), dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x = philox4x32_10((step, q, one, zero), _seed_key(seed))
    # ((x >> 8) + 1) <= 2^24 converts to f32 exactly
    u = [((xi >> 8) + 1).to(torch.float32) * 2.0 ** -24 for xi in x]
    r0 = torch.sqrt(-2.0 * torch.log(u[0]))
    r1 = torch.sqrt(-2.0 * torch.log(u[2]))
    a0 = u[1] * _TWO_PI
    a1 = u[3] * _TWO_PI
    z = torch.stack([r0 * torch.cos(a0), r0 * torch.sin(a0),
                     r1 * torch.cos(a1), r1 * torch.sin(a1)], dim=1).reshape(-1)
    return torch.cat([z, -z]) if antithetic else z


class _Walk:
    """The regenerated spot planes: the bridge state W, the spot S of the
    current step and (barrier mode) the first-crossing plane τ_B, with the
    kernel's f32 scalar arithmetic on 0-d tensors."""

    def __init__(self, cfg: _Config, device, normals: Optional[Callable]):
        f32 = torch.float32
        self.cfg = cfg
        self.dev = device
        self.draw = normals or (lambda t: fusedpath_normals(cfg.seed, t, cfg.n_paths,
                                                            cfg.antithetic, device))
        self.dt, self.sigma, self.drift_dt, self.S0 = (
            torch.tensor(v, dtype=f32, device=device)
            for v in (cfg.dt, cfg.sigma, cfg.drift_dt, cfg.S0))
        self.sqrt_dt = torch.sqrt(self.dt)
        self.tb = None
        if cfg.barrier is not None:
            self.level = torch.tensor(cfg.barrier, dtype=f32, device=device)
            self.never = float(cfg.n_steps + 1)

    def _spot(self, t: int) -> torch.Tensor:
        return self.S0 * torch.exp(self.drift_dt * float(t) + self.sigma * self.W)

    def _cross(self, S):
        return S <= self.level if self.cfg.barrier_down else S >= self.level

    def gate(self, t: int) -> torch.Tensor:
        """Open where the knock state at step ``t`` lets the option pay."""
        knocked = self.tb <= float(t)
        return knocked if self.cfg.barrier_in else ~knocked

    def maturity(self) -> torch.Tensor:
        cfg = self.cfg
        n, T = cfg.n_paths, cfg.n_steps
        if cfg.barrier is None:
            wT = torch.sqrt(self.dt * float(T))
            self.W = wT * self.draw(T)
            return self._spot(T)
        tb0 = 0.0 if bool(self._cross(self.S0)) else self.never
        self.tb = torch.full((n,), tb0, dtype=torch.float32, device=self.dev)
        self.W = torch.zeros((n,), dtype=torch.float32, device=self.dev)
        for s in range(1, T + 1):
            self.W = self.W + self.sqrt_dt * self.draw(s)
            S = self._spot(s)
            self.tb = torch.minimum(self.tb, torch.where(self._cross(S), float(s), self.never))
        return S

    def step(self, t: int) -> torch.Tensor:
        if self.cfg.barrier is None:
            tf = torch.tensor(float(t), dtype=torch.float32, device=self.dev)
            a = tf / (tf + 1.0)
            bscale = torch.sqrt(self.dt * a)  # exactly 0 at t = 0
            self.W = a * self.W + bscale * self.draw(t)
        else:
            self.W = self.W - self.sqrt_dt * self.draw(t + 1)
        return self._spot(t)


def _fusedpath_reference(cfg: _Config, stats, coeffs, allow, cf_tau,
                         normals: Optional[Callable] = None):
    """Plain-torch fusedpath induction on (n,) planes; returns ``(sums (2,),
    coeffs (T+1, k), cf, tau)``. ``coeffs`` given (replay): its rows are the
    policy and the regression is skipped."""
    n_steps, k = cfg.n_steps, cfg.degree + 1
    dev = stats.device
    mean_t, inv_std_t, c, inv_c = stats.view(4, n_steps + 1)
    walk = _Walk(cfg, dev, normals)
    K, phi = cfg.K, cfg.phi
    S = walk.maturity()
    V = torch.clamp_min(phi * (S - K), 0.0)
    if cfg.barrier is not None:
        V = torch.where(walk.gate(n_steps), V, 0.0)
    cf = tau = None
    if cf_tau:
        cf = V.clone()
        tau = torch.full_like(V, float(n_steps))
    replay = coeffs is not None
    if not replay:
        coeffs = torch.zeros((n_steps + 1, k), dtype=torch.float32, device=dev)
    for t in range(n_steps - 1, -1, -1):
        S = walk.step(t)
        xhat = (S - mean_t[t]) * inv_std_t[t]
        cols = basis_cols(xhat, cfg.basis, cfg.degree)
        ex = torch.clamp_min(phi * (S - K), 0.0)
        if replay:
            coef = [coeffs[t, a] for a in range(k)]
        else:
            y = c[t] * V
            if cfg.itm_weights:
                w = (ex > 0.0).to(torch.float32)
                if cfg.barrier is not None:
                    # ITM ∧ gate; the all-paths fit stays ungated
                    w = w * walk.gate(t).to(torch.float32)
                cols_w = [col * w for col in cols]
                yw = y * w
            else:
                cols_w, yw = cols, y
            packed = [_sum_once_rounded(cols_w[a] * cols[b]) for a, b in _pairs(k)]
            packed += [_sum_once_rounded(cols[a] * yw) for a in range(k)]
            coef = _solve_equilibrated_ridge(packed, k, cfg.rcond)
            coeffs[t] = torch.stack(coef)
        if cfg.american and allow[t]:
            fitted = cols[0] * coef[0]
            for a in range(1, k):
                fitted = fitted + cols[a] * coef[a]
            cont = torch.clamp_min(fitted, 0.0)  # Q2; a NaN fit stays NaN
            mask = ex > cont
            if cfg.barrier is not None:
                mask = mask & walk.gate(t)
            V = torch.where(mask, ex * inv_c[t], V)
            if cf_tau:
                cf = torch.where(mask, ex, cf)
                tau = torch.where(mask, float(t), tau)
    v = c[0] * V
    sq = v
    if cfg.antithetic:
        half = v.shape[0] // 2
        sq = 0.5 * (v[:half] + v[half:])
    return torch.stack([_sum_once_rounded(v), _sum_once_rounded(sq * sq)]), coeffs, cf, tau


def _state_planes(barrier: bool) -> int:
    """f32 planes of per-path state: W, V, S of two steps, and τ_B."""
    return 5 if barrier else 4


def _fusedpath_plan(n_paths: int, antithetic: bool, barrier: bool, n_sms: int,
                    occupancy: Callable[[int], int]):
    """The kernel's cooperative grid: ``(n_blocks, chip_slots,
    slots_needed)`` (:func:`~amcx_torch.ops.lsmc_megakernel.cooperative_plan`).
    Block 0 solves; each thread of the other blocks owns units of paths (a
    quad, or with ``antithetic`` the mirrored quad pair) and keeps their
    state planes in ``chip_slots`` quad slots of shared memory, the rest in
    global spill planes (``slots_needed > chip_slots``)."""
    qpu = 2 if antithetic else 1
    return cooperative_plan(n_paths // (4 * qpu), qpu,
                            _THREADS * _QUAD_BYTES * _state_planes(barrier), n_sms, occupancy,
                            "fusedpath")


@functools.lru_cache(maxsize=None)
def _occupancy(degree: int, smem: int, device_index: int) -> int:
    from . import _build

    with torch.cuda.device(device_index):
        fn = _build.function("amcx_lsmc_fusedpath_occupancy",
                             [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        blocks = ctypes.c_int(0)
        _build.check(fn(degree, smem, ctypes.byref(blocks)), "amcx_lsmc_fusedpath_occupancy")
    return blocks.value


def _fusedpath_cuda(cfg: _Config, stats, coeffs, allow, cf_tau):
    from . import _build

    n, n_steps, k = cfg.n_paths, cfg.n_steps, cfg.degree + 1
    dev = stats.device
    f32 = torch.float32
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    n_blocks, chip_slots, needed = _fusedpath_plan(
        n, cfg.antithetic, cfg.barrier is not None, _build.sm_count(dev),
        lambda smem: _occupancy(cfg.degree, smem, index))
    # the state of the quads past the shared-memory slots
    spill = None
    if needed > chip_slots:
        spill = torch.empty(_state_planes(cfg.barrier is not None) * n, dtype=f32, device=dev)
    cf = tau = None
    if cf_tau:
        cf, tau = torch.empty(n, dtype=f32, device=dev), torch.empty(n, dtype=f32, device=dev)
    partials = coop_partials(n_blocks, cfg.degree, dev)
    replay = coeffs is not None
    if not replay:
        coeffs = torch.zeros((n_steps + 1, k), dtype=f32, device=dev)
    sums = torch.empty(2, dtype=f32, device=dev)
    allow_dev = None if all(allow) else torch.tensor([int(a) for a in allow], dtype=torch.uint8,
                                                     device=dev)
    key_lo, key_hi = _seed_key(cfg.seed)
    params = FusedpathParams(
        n_steps=n_steps, n_paths=n, n_blocks=n_blocks, chip_slots=chip_slots,
        basis=BASIS_IDS[cfg.basis], american=int(cfg.american),
        itm_weights=int(cfg.itm_weights), antithetic=int(cfg.antithetic),
        barrier=int(cfg.barrier is not None), barrier_down=int(cfg.barrier_down),
        barrier_in=int(cfg.barrier_in), key_lo=key_lo, key_hi=key_hi, strike=cfg.K,
        phi=cfg.phi, rcond=cfg.rcond, sigma=cfg.sigma, drift_dt=cfg.drift_dt, dt=cfg.dt,
        S0=cfg.S0, level=0.0 if cfg.barrier is None else cfg.barrier)
    Vp, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("amcx_lsmc_fusedpath",
                         [ctypes.POINTER(FusedpathParams)] + [Vp] * 8 + [I, I, Vp])

    def ptr(x):
        return None if x is None else x.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(ctypes.byref(params), stats.data_ptr(), ptr(allow_dev), ptr(spill), ptr(cf),
            ptr(tau), partials.data_ptr(), coeffs.data_ptr(), sums.data_ptr(), cfg.degree,
            int(replay), stream)
    lsmc_price_fusedpath.launches += 1
    _build.check(rc, "amcx_lsmc_fusedpath")
    return sums, coeffs, cf, tau


def _scalar(name, x) -> float:
    if getattr(x, "ndim", 0) > 0 or isinstance(x, (list, tuple)):
        _not_ported(f"fusedpath with a per-step {name} curve", "A9, amcx/term.py")
    return float(x)


def _price_fusedpath(run, seed, S0, K, r, sigma, dt, n_steps, n_paths, phi, q=0.0,
                     basis="chebyshev", degree=4, rcond=1e-6, american=True, itm_weights=False,
                     antithetic=False, return_stats=False, exercise_steps=None, axis_name=None,
                     axis_size=1, return_cf_tau=False, return_coeffs=False, replay_coeffs=None,
                     barrier=None, barrier_type="down-in", device="cuda", **run_kw):
    if axis_name is not None:
        _not_ported("fusedpath's collective mode (axis_name)", "A15 / B10")
    r, sigma, q = _scalar("r", r), _scalar("sigma", sigma), _scalar("q", q)
    try:
        seed = operator.index(seed)
    except TypeError:
        raise TypeError(f"fusedpath draws from a counter-based stream and takes an integer "
                        f"seed, got {type(seed).__name__}") from None
    _seed_key(seed)
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"lsmc_price_fusedpath runs on 'cpu' or 'cuda', got {dev}")
    basis = basis.strip().lower()
    if basis not in BASIS_IDS:
        raise ValueError(f"Unknown basis type {basis!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree must lie in 0..{MAX_DEGREE}, got {degree}")
    n_steps, n_paths = int(n_steps), int(n_paths)
    if n_steps < 1 or not 1 <= n_paths < 2 ** 31:
        raise ValueError(f"bad shape n_steps={n_steps}, n_paths={n_paths}")
    quantum = 8 if antithetic else 4
    if n_paths % quantum:
        raise ValueError(f"fusedpath needs n_paths divisible by {quantum} (one Philox call "
                         f"per 4 paths{', mirrored halves' if antithetic else ''}), "
                         f"got {n_paths}")
    barrier_down = barrier_in = True
    if barrier is not None:
        bt = barrier_type.strip().lower()
        if bt not in _BARRIER_TYPES:
            raise ValueError(f"unknown barrier_type {barrier_type!r}")
        barrier_down, barrier_in = bt.startswith("down"), bt.endswith("in")
        barrier = float(barrier)
    k = degree + 1
    if replay_coeffs is not None:
        replay_coeffs = torch.as_tensor(replay_coeffs, dtype=torch.float32, device=dev)
        if replay_coeffs.ndim != 2 or replay_coeffs.shape[1] != k:
            raise ValueError(f"replay_coeffs must be (n_steps[+1], degree+1={k}), "
                             f"got {tuple(replay_coeffs.shape)}")
        if replay_coeffs.shape[0] not in (n_steps, n_steps + 1):
            raise ValueError(f"replay_coeffs has {replay_coeffs.shape[0]} step rows; "
                             f"expected n_steps={n_steps}")
        # zero maturity row, accepted or added
        replay_coeffs = torch.cat([replay_coeffs[:n_steps],
                                   torch.zeros((1, k), dtype=torch.float32, device=dev)])
    allow = [True] * (n_steps + 1)
    if exercise_steps is not None:
        allow = exercise_allow_row(exercise_steps, n_steps).tolist()
    with tracing.span("induction.prepare"):
        stats = closed_form_rows(float(S0), r, sigma, q, float(dt) * n_steps, float(dt), n_steps,
                                 dev)
        cfg = _Config(seed=seed, n_steps=n_steps, n_paths=n_paths, K=_f32(K), phi=_f32(phi),
                      rcond=_f32(rcond), sigma=_f32(sigma),
                      drift_dt=_f32((r - q - 0.5 * sigma ** 2) * dt), dt=_f32(dt), S0=_f32(S0),
                      basis=basis, degree=degree, american=bool(american),
                      itm_weights=bool(itm_weights), antithetic=bool(antithetic),
                      barrier=None if barrier is None else _f32(barrier),
                      barrier_down=barrier_down, barrier_in=barrier_in)
    sums, coeffs, cf, tau = run(cfg, stats, replay_coeffs, allow, bool(return_cf_tau), **run_kw)
    price = sums[0] / n_paths
    # antithetic: ΣV² was summed over the n/2 pair means (honest stderr)
    n_eff = n_paths // 2 if antithetic else n_paths
    var = torch.clamp_min(sums[1] / n_eff - price * price, 0.0)
    stderr = torch.sqrt(var / n_eff)
    if return_cf_tau or return_coeffs:
        return MegaOutputs(price, stderr, cf, tau, coeffs if return_coeffs else None)
    if not return_stats:
        return price
    return price, stderr


def lsmc_price_fusedpath(seed, S0, K, r, sigma, dt, n_steps: int, n_paths: int, phi: float,
                         q=0.0, basis: str = "chebyshev", degree: int = 4, rcond: float = 1e-6,
                         american: bool = True, itm_weights: bool = False,
                         antithetic: bool = False, return_stats: bool = False,
                         exercise_steps=None, axis_name=None, axis_size: int = 1,
                         return_cf_tau: bool = False, return_coeffs: bool = False,
                         replay_coeffs=None, barrier=None, barrier_type: str = "down-in",
                         device="cuda"):
    """American/European vanilla GBM price by LSMC with no path array: the
    paths are regenerated backward inside the induction (module docstring).

    ``seed``: an integer in [0, 2⁶⁴); the price is a pure function of
    (seed, n_paths, n_steps) and the market. Runs on ``device``: on the
    card the kernel of ``csrc/lsmc_fusedpath.cu`` (or it raises), on the
    CPU :func:`lsmc_price_fusedpath_reference`'s arithmetic. The frame and
    discount rows are `closed_form_rows`', cached per market and grid and
    shared with ``price_option(engine="mega")``, so a fit here and kernel
    2's on the same paths see the same bits.

    Returns the price, ``(price, stderr)`` with ``return_stats``, or a
    `MegaOutputs` with the undiscounted cashflow and exercise-step planes
    (``return_cf_tau``) and the ``(n_steps+1, degree+1)`` coefficients
    (``return_coeffs``; zero maturity row). ``replay_coeffs``: frozen
    ``(n_steps[+1], degree+1)`` coefficients in the same frame; the
    regression is skipped and the fixed policy is replayed on this seed's
    paths (the pricing pass of `amcx_torch.policy`). ``barrier`` and
    ``barrier_type`` (down/up × in/out) gate the maturity cashflow, the
    exercise and the ITM fit weights by the knock state (amcx's Q4);
    monitoring is discrete on the step grid including t = 0.
    ``exercise_steps``: a Bermudan schedule. ``antithetic``: path p ≥ n/2
    mirrors p − n/2, and the stderr is that of the pair means.
    Not ported: per-step r/σ/q curves (ROADMAP A9) and ``axis_name``
    (A15/B10). ``lsmc_price_fusedpath.launches`` counts kernel launches.
    """
    dev = torch.device(device)
    run = _fusedpath_cuda if dev.type == "cuda" else _fusedpath_reference
    with tracing.span("induction"):
        return _price_fusedpath(run, seed, S0, K, r, sigma, dt, n_steps, n_paths, phi, q, basis,
                                degree, rcond, american, itm_weights, antithetic, return_stats,
                                exercise_steps, axis_name, axis_size, return_cf_tau,
                                return_coeffs, replay_coeffs, barrier, barrier_type, device)


lsmc_price_fusedpath.launches = 0


def lsmc_price_fusedpath_reference(*args, normals: Optional[Callable] = None, **kwargs):
    """:func:`lsmc_price_fusedpath`'s plain version on any device (the
    card's check compares the two on the same seed). ``normals``: a
    callable t → ``(n_paths,)`` tensor that replaces the Philox stream (the
    tests feed ξ ≡ 0, the deterministic curve amcx's interpret mode gives)."""
    return _price_fusedpath(_fusedpath_reference, *args, normals=normals, **kwargs)


def fusedpath_paths_reference(seed: int, S0, r, sigma, dt, n_steps: int, n_paths: int,
                              q=0.0, antithetic: bool = False, barrier=None,
                              barrier_type: str = "down-in", device="cpu"):
    """The ``(n_steps+1, n_paths)`` f32 spots that the fusedpath recursion
    regenerates for ``seed`` (bit for bit, by the same operations), and with
    a ``barrier`` also the ``(n_paths,)`` first-crossing plane τ_B. For
    tests and the smoke run: it holds the path array the route avoids."""
    dev = torch.device(device)
    r, sigma, q = float(r), float(sigma), float(q)
    bt = barrier_type.strip().lower()
    cfg = _Config(seed=int(seed), n_steps=n_steps, n_paths=n_paths, K=0.0, phi=1.0, rcond=0.0,
                  sigma=_f32(sigma), drift_dt=_f32((r - q - 0.5 * sigma ** 2) * dt), dt=_f32(dt),
                  S0=_f32(S0), basis="power", degree=0, american=False, itm_weights=False,
                  antithetic=antithetic, barrier=None if barrier is None else _f32(barrier),
                  barrier_down=bt.startswith("down"), barrier_in=bt.endswith("in"))
    walk = _Walk(cfg, dev, None)
    paths = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=dev)
    paths[n_steps] = walk.maturity()
    for t in range(n_steps - 1, -1, -1):
        paths[t] = walk.step(t)
    return paths if barrier is None else (paths, walk.tb)

"""The multi-asset step kernels and their inputs: wrappers and their plain
versions.

Port of `amcx.ops.maxcall_pallas` (``_ma_moments_kernel`` via
:func:`ma_step_moments`, ``_ma_apply_kernel`` via :func:`ma_step_apply`).
The kernels live in ``amcx_torch/csrc/ma_step.cu`` (shared device code in
``csrc/ma_common.cuh``). :func:`ma_prepare` (``csrc/ma_prepare.cu``) builds
the inputs both multi-asset inductions run on, the asset-major planes and
the frame, in one pass over the paths. ``ma_step_moments_reference`` and
``ma_step_apply_reference`` compute the same functions in plain torch, in
the kernels' operation order, with the moments exact products of the f32
columns summed in f64 and rounded once to f32, so on the card kernel and
plain version agree to the bit.

One backward step of a multi-asset product: the asset planes of step t are
(optionally) sorted into the basket's order statistics by amcx's bubble
compare-exchange network, standardized with the per-step per-column frame,
expanded into the cross-term columns of
`amcx_torch.basis.multi_asset_cols` (amcx's column order), and either
reduced into the packed moment vector (Gram upper triangle + rhs) or
evaluated against the solved coefficients for the exercise select.

Deviations from amcx, none of which changes a value:

- Layout: the step's planes are a contiguous ``(n_assets, n_paths)`` slice
  of the time-major asset-major ``(n_steps+1, n_assets, n_paths)`` array,
  for any ``n_paths``. amcx's ``(A, rows, 512)`` blocks and its
  ``n_paths % 4096`` rule are dropped.
- The per-step scalars come from one ``(2A+3, n_steps+1)`` f32 device array
  (:func:`ma_stats`: rows mean_a, inv_std_a, c_t, 1/c_t, allow_t) and the
  step index, in place of amcx's ``(3+2A+1,)`` scalar vector, so a host
  loop never reads a value back. The two induction engines share it.
- :func:`ma_step_apply` updates ``cf``/``tau`` in place, as amcx donates
  them.

A fused loop launches the apply through :func:`ma_step_apply_launcher`: its
tensors are validated once an induction, then each step passes only ``t``
and the coefficients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..basis import BASIS_IDS, _multi_index_set, multi_asset_cols
from ..payoff import exercise_allow_row
from .lsmc_megakernel import _pairs, _sum_once_rounded

__all__ = ["ma_pack_dim", "ma_stats", "ma_inputs", "ma_prepare", "ma_prepare_reference",
           "maxcall_standardization", "ma_step_moments", "ma_step_moments_reference",
           "ma_step_apply", "ma_step_apply_reference", "ma_step_apply_launcher",
           "ma_factor_words", "PAYOFF_KINDS"]

# limits of csrc/ma_common.cuh
MAX_ASSETS = 8
MAX_COLS = 32
MAX_DEGREE = 4
_MOMENTS_WARPS = 16  # csrc/ma_moments.cuh kMomentsWarps
_PREPARE_TILE = 512  # csrc/ma_prepare.cu kTilePaths
# ma_prepare's grid: at 1M x 10 x 5 on an H100 80GB HBM3 (700 W), the kernel
# alone took 0.164-0.169 ms at two blocks an SM (medians by CUDA events,
# three rounds) against 0.199 at one and 0.177-0.192 at 3, 4, 6 and 8
_PREPARE_BLOCKS_PER_SM = 2

PAYOFF_KINDS = {"maxcall": 0, "first": 1, "second": 2, "spread": 3, "spreadk": 4,
                "basket": 5, "geobasket": 6}
_TWO_PLANE_KINDS = ("second", "spread", "spreadk")


def ma_pack_dim(m: int) -> int:
    """Length of the packed moment vector for ``m`` cross-term columns."""
    return m * (m + 1) // 2 + m


def maxcall_standardization(paths_tm: torch.Tensor, mode: str = "sorted"):
    """Per-step per-column mean and 1/std of the (descending-sorted when
    ``mode == "sorted"``) basket ``(n_steps+1, n_paths, n_assets)``: two
    ``(n_steps+1, n_assets)`` tensors, the frame the fused and mega
    engines standardize with. The order statistics come from the kernels'
    compare-exchange network, column by column (the values of a sort).

    The plain version of :func:`ma_prepare`'s frame on any device: the f64
    sums S1 and S2 of x and x², then ``mean = S1/n`` and ``1/max(sqrt(max(S2/n
    − mean², 0)), 1e-6)``, each in f64 and rounded once to the paths'
    dtype."""
    feats = torch.unbind(paths_tm, dim=-1)
    if mode == "sorted":
        feats = _sort_desc(feats)
    x = torch.stack(feats, dim=-1).to(torch.float64)
    n = x.shape[1]
    mean = torch.sum(x, dim=1) / n
    var = torch.clamp_min(torch.sum(x * x, dim=1) / n - mean * mean, 0.0)
    inv_std = 1.0 / torch.clamp_min(torch.sqrt(var), 1e-6)
    return mean.to(paths_tm.dtype), inv_std.to(paths_tm.dtype)


def _tail_rows(n_steps: int, r, dt, allow_t, device) -> torch.Tensor:
    """The last three :func:`ma_stats` rows as a ``(3, n_steps+1)`` f32
    tensor on ``device``: ``c_t = e^{−r·dt·(n_steps−t)}`` and ``1/c_t`` in
    amcx's order, f32(r)·f32(dt) rounded once on the host (exact as a Python
    float; a device scalar would be a copy from the host that waits for the
    stream) times the remaining steps, then ``allow_t``."""
    f32 = torch.float32
    rem = n_steps - torch.arange(n_steps + 1, dtype=f32, device=device)
    r_dt = float(torch.tensor(float(r), dtype=f32) * torch.tensor(float(dt), dtype=f32))
    r_rem = r_dt * rem
    return torch.stack([torch.exp(-r_rem), torch.exp(r_rem),
                        torch.as_tensor(allow_t, dtype=f32, device=device)])


def ma_stats(mean_t, inv_std_t, r, dt, allow_t) -> torch.Tensor:
    """The kernels' per-step rows as one contiguous ``(2A+3, n_steps+1)`` f32
    tensor: ``mean_a`` (A rows), ``inv_std_a`` (A rows), the time-T discount
    ``c_t = e^{−r·dt·(n_steps−t)}`` and ``1/c_t`` built in f32 in amcx's
    order, and the exercise flag ``allow_t``. ``mean_t``/``inv_std_t`` are
    ``(n_steps+1, A)``."""
    f32 = torch.float32
    tail = _tail_rows(mean_t.shape[0] - 1, r, dt, allow_t, mean_t.device)
    return torch.cat([mean_t.to(f32).T, inv_std_t.to(f32).T, tail]).contiguous()


def ma_inputs(paths_tm: torch.Tensor, r, dt, *, sorted_basis: bool, mode: str = "total",
              exercise_from_step: int = 0, exercise_steps=None, plain: bool = False):
    """The inputs both multi-asset inductions (kernels 8/9 and kernel 7) run
    on, from time-major ``(n_steps+1, n_paths, n_assets)`` f32 paths: the
    asset-major planes ``(n_steps+1, n_assets, n_paths)`` (each asset row
    coalesces) and the :func:`ma_stats` rows, with the
    :func:`maxcall_standardization` frame of the whole path set (sorted when
    ``sorted_basis``) and the exercise row (``exercise_steps``, step indices
    in 0..n_steps-1, overrides ``exercise_from_step``; a schedule is copied
    from the host). :func:`ma_prepare` builds both (one kernel on a CUDA
    tensor), or with ``plain`` :func:`ma_prepare_reference` on any device."""
    if paths_tm.ndim != 3 or paths_tm.shape[0] < 2 or paths_tm.dtype != torch.float32:
        raise ValueError(f"paths must be time-major (n_steps+1, n_paths, n_assets) float32, "
                         f"got {tuple(paths_tm.shape)} {paths_tm.dtype}")
    n_steps, dev = paths_tm.shape[0] - 1, paths_tm.device
    if exercise_steps is not None:
        allow = exercise_allow_row(exercise_steps, n_steps, torch.float32, dev)
    else:
        allow = (torch.arange(n_steps + 1, device=dev) >= exercise_from_step).to(torch.float32)
    build = ma_prepare_reference if plain else ma_prepare
    return build(paths_tm, r, dt, allow, sorted_basis=sorted_basis or mode == "sorted")


def ma_prepare_reference(paths_tm: torch.Tensor, r, dt, allow_t, *, sorted_basis: bool):
    """Plain-torch version of :func:`ma_prepare` on any device."""
    mean_t, inv_std_t = maxcall_standardization(paths_tm, "sorted" if sorted_basis else "total")
    planes = paths_tm.permute(0, 2, 1).contiguous()
    return planes, ma_stats(mean_t, inv_std_t, r, dt, allow_t)


def ma_prepare_chunks(n_paths: int, n_steps: int, n_sm: int) -> int:
    """Blocks a step of :func:`ma_prepare`'s grid: about
    ``_PREPARE_BLOCKS_PER_SM`` blocks an SM over all the steps, at most one a
    tile of 512 paths."""
    per_step = -(-_PREPARE_BLOCKS_PER_SM * n_sm // (n_steps + 1))
    return max(1, min(per_step, -(-n_paths // _PREPARE_TILE)))


def ma_prepare(paths_tm: torch.Tensor, r, dt, allow_t, *, sorted_basis: bool):
    """The asset-major planes ``(n_steps+1, A, n_paths)`` (the bits of
    ``paths_tm.permute(0, 2, 1).contiguous()``) and the ``(2A+3,
    n_steps+1)`` :func:`ma_stats` rows of time-major ``(n_steps+1, n_paths,
    A)`` f32 paths: the :func:`maxcall_standardization` frame (sorted when
    ``sorted_basis``), then ``c_t``, ``1/c_t`` of rate ``r`` and step ``dt``,
    and the exercise row ``allow_t``.

    On a CUDA tensor this launches the kernel of ``csrc/ma_prepare.cu``
    once, with no copy from the host and no synchronise (or raises); on a
    CPU tensor it runs :func:`ma_prepare_reference`.
    ``ma_prepare.launches`` counts the kernel launches.
    """
    dev = paths_tm.device
    if dev.type == "cpu":
        return ma_prepare_reference(paths_tm, r, dt, allow_t, sorted_basis=sorted_basis)
    if dev.type != "cuda":
        raise ValueError(f"ma_prepare runs on 'cpu' or 'cuda', got {dev}")
    from . import _build

    f32 = torch.float32
    T1, n_paths, n_assets = paths_tm.shape
    if paths_tm.dtype is not f32 or not 1 <= n_assets <= MAX_ASSETS:
        raise ValueError(f"paths must be (n_steps+1, n_paths, 1..{MAX_ASSETS}) float32, got "
                         f"{tuple(paths_tm.shape)} {paths_tm.dtype}")
    if not 1 <= n_paths < 2 ** 31:
        raise ValueError(f"n_paths must lie in 1..2^31-1, got {n_paths}")
    paths_tm = paths_tm.contiguous()
    tail = _tail_rows(T1 - 1, r, dt, allow_t, dev)
    n_chunks = ma_prepare_chunks(n_paths, T1 - 1, _build.sm_count(dev))
    planes = torch.empty((T1, n_assets, n_paths), dtype=f32, device=dev)
    stats = torch.empty((2 * n_assets + 3, T1), dtype=f32, device=dev)
    # the ticket (zeroed by the C entry), then a partial row of 2A sums a block
    partials = torch.empty(1 + T1 * n_chunks * 2 * n_assets, dtype=torch.float64, device=dev)
    rc = _prepare_fn()(paths_tm.data_ptr(), planes.data_ptr(), stats.data_ptr(), tail.data_ptr(),
                       partials.data_ptr(), T1 - 1, n_paths, n_assets, n_chunks,
                       int(sorted_basis), torch._C._cuda_getCurrentRawStream(dev.index))
    ma_prepare.launches += 1
    if rc:
        _build.check(rc, "amcx_ma_prepare")
    return planes, stats


ma_prepare.launches = 0


@functools.lru_cache(maxsize=None)
def _prepare_fn():
    from . import _build

    V, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_ma_prepare", [V, V, V, V, V, I, I, I, I, I, V])


def _sort_desc(vals):
    """amcx's bubble compare-exchange network: a descending sort of the
    per-asset tensors."""
    vals = list(vals)
    A = len(vals)
    for i in range(A):
        for j in range(A - 1 - i):
            hi = torch.maximum(vals[j], vals[j + 1])
            lo = torch.minimum(vals[j], vals[j + 1])
            vals[j], vals[j + 1] = hi, lo
    return vals


def _columns(planes, stats, t: int, basis: str, degree: int, mode: str, sorted_basis: bool):
    """Standardize the (sorted) planes with step t's frame and build the
    cross-term columns."""
    A = len(planes)
    feats = _sort_desc(planes) if sorted_basis else list(planes)
    xs = [(feats[a] - stats[a, t]) * stats[A + a, t] for a in range(A)]
    return multi_asset_cols(xs, basis, degree, mode)


def _weights32(weights, n_assets: int):
    """Basket weights as f32 values (amcx multiplies f32 planes by them);
    equal weights 1/A by default."""
    w = weights if weights is not None else (1.0 / n_assets,) * n_assets
    if len(w) != n_assets:
        raise ValueError(f"weights must have {n_assets} entries, got {len(w)}")
    return [float(torch.tensor(float(x), dtype=torch.float32)) for x in w]


def _payoff_for(planes, K, payoff_kind: str, phi: float = 1.0, weights=None):
    """Exercise value of the state ``planes`` (list of per-asset tensors):
    ``maxcall`` max(max_a S_a − K, 0); ``first`` φ(S_0 − K)⁺ (the (S, v)
    two-state dynamics); ``second`` φ(S_1 − K)⁺ (fixed-strike Asian on
    (S, A)); ``spread`` φ(S_0 − S_1)⁺; ``spreadk`` φ(S_0 − S_1 − K)⁺;
    ``basket`` φ(Σ w_a S_a − K)⁺; ``geobasket`` φ(exp Σ w_a ln S_a − K)⁺,
    weights 1/A by default. amcx's operation order."""
    if payoff_kind == "maxcall":
        ex = planes[0]
        for p in planes[1:]:
            ex = torch.maximum(ex, p)
        return torch.clamp_min(ex - K, 0.0)
    if payoff_kind == "first":
        return torch.clamp_min(phi * (planes[0] - K), 0.0)
    if payoff_kind == "second":
        return torch.clamp_min(phi * (planes[1] - K), 0.0)
    if payoff_kind == "spread":
        return torch.clamp_min(phi * (planes[0] - planes[1]), 0.0)
    if payoff_kind == "spreadk":
        return torch.clamp_min(phi * (planes[0] - planes[1] - K), 0.0)
    if payoff_kind in ("basket", "geobasket"):
        w = _weights32(weights, len(planes))
        f = torch.log if payoff_kind == "geobasket" else (lambda p: p)
        acc = f(planes[0]) * w[0]
        for p, wi in zip(planes[1:], w[1:]):
            acc = acc + f(p) * wi
        if payoff_kind == "geobasket":
            acc = torch.exp(acc)
        return torch.clamp_min(phi * (acc - K), 0.0)
    raise ValueError(f"unknown payoff_kind {payoff_kind!r}")


def _moments_from_cols(cols, y, w):
    """Packed ``[Σ w c_i c_j (i ≤ j)..., Σ c_i (w y)...]`` of the f32
    columns, each an f64 sum of exact products rounded once to f32: an f32 ×
    f32 product has at most 48 significant bits, so it is exact in f64, and
    ``w`` is 0 or 1, so ``c_i w`` and ``y w`` are exact in f32."""
    cols_w = cols if w is None else [c * w for c in cols]
    yw = y if w is None else y * w
    cols_w64 = [c.double() for c in cols_w]
    cols64 = cols_w64 if w is None else [c.double() for c in cols]
    yw64 = yw.double()
    m = len(cols)
    packed = [_sum_once_rounded(cols_w64[i] * cols64[j]) for i, j in _pairs(m)]
    packed += [_sum_once_rounded(cols64[i] * yw64) for i in range(m)]
    return packed


def _fitted(cols, coeffs):
    fitted = cols[0] * coeffs[0]
    for i in range(1, len(cols)):
        fitted = fitted + cols[i] * coeffs[i]
    return fitted


def ma_step_moments_reference(stats, t: int, planes, cf, tau, *, rdt: float, K: float,
                              phi: float = 1.0, basis: str = "chebyshev", degree: int = 2,
                              mode: str = "total", sorted_basis: bool = True,
                              itm_weights: bool = False, payoff_kind: str = "maxcall",
                              weights=None, direct_y: bool = False) -> torch.Tensor:
    """Plain-torch version of :func:`ma_step_moments` on any device."""
    P = list(torch.unbind(planes, 0))
    y = cf if direct_y else cf * torch.exp(-rdt * (tau - float(t)))
    cols = _columns(P, stats, t, basis, degree, mode, sorted_basis)
    w = None
    if itm_weights:
        w = (_payoff_for(P, K, payoff_kind, phi, weights) > 0.0).to(torch.float32)
    return torch.stack(_moments_from_cols(cols, y, w))


def ma_step_apply_reference(stats, t: int, coeffs, planes, cf, tau, *, K: float,
                            phi: float = 1.0, basis: str = "chebyshev", degree: int = 2,
                            mode: str = "total", sorted_basis: bool = True,
                            payoff_kind: str = "maxcall", weights=None):
    """Plain-torch version of :func:`ma_step_apply` on any device (also in
    place)."""
    P = list(torch.unbind(planes, 0))
    cols = _columns(P, stats, t, basis, degree, mode, sorted_basis)
    cont = torch.clamp_min(_fitted(cols, coeffs), 0.0)  # Q2; a NaN fit stays NaN
    ex = _payoff_for(P, K, payoff_kind, phi, weights)
    mask = (ex > cont) & (stats[-1, t] > 0.0)  # ex > cont implies ex > 0
    cf.copy_(torch.where(mask, ex, cf))
    tau.copy_(torch.where(mask, float(t), tau))
    return cf, tau


class MaParams(ctypes.Structure):
    """``struct MaParams`` of ``csrc/ma_common.cuh``: the static description
    of a multi-asset product and basis, handed to the kernels by value."""

    _fields_ = [("n_assets", ctypes.c_int), ("n_cols", ctypes.c_int),
                ("degree", ctypes.c_int), ("basis", ctypes.c_int),
                ("sorted", ctypes.c_int), ("payoff_kind", ctypes.c_int),
                ("strike", ctypes.c_float), ("phi", ctypes.c_float),
                ("weights", ctypes.c_float * MAX_ASSETS),
                ("alpha", (ctypes.c_ubyte * MAX_ASSETS) * MAX_COLS)]


@functools.lru_cache(maxsize=64)
def ma_params(n_assets: int, basis: str, degree: int, mode: str, sorted_basis: bool,
              payoff_kind: str, K: float, phi: float, weights: Optional[tuple] = None) -> MaParams:
    """Validate a product/basis against the kernels' limits and pack it,
    with amcx's multi-index table, into :class:`MaParams`. Cached: a host
    loop calls it every step, and the kernels only read the block."""
    basis = basis.strip().lower()
    if basis not in BASIS_IDS:
        raise ValueError(f"Unknown basis type {basis!r}")
    if payoff_kind not in PAYOFF_KINDS:
        raise ValueError(f"unknown payoff_kind {payoff_kind!r}")
    if not 1 <= n_assets <= MAX_ASSETS:
        raise ValueError(f"the multi-asset kernels take 1..{MAX_ASSETS} assets, got {n_assets}")
    if payoff_kind in _TWO_PLANE_KINDS and n_assets < 2:
        raise ValueError(f"payoff_kind {payoff_kind!r} needs two planes")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"the multi-asset kernels take degree 0..{MAX_DEGREE}, got {degree}")
    idx = _multi_index_set(n_assets, degree, mode)
    if len(idx) > MAX_COLS:
        raise ValueError(f"{len(idx)} basis columns exceed the kernels' {MAX_COLS}")
    p = MaParams(n_assets=n_assets, n_cols=len(idx), degree=degree, basis=BASIS_IDS[basis],
                 sorted=int(sorted_basis), payoff_kind=PAYOFF_KINDS[payoff_kind],
                 strike=float(K), phi=float(phi))
    for a, w in enumerate(_weights32(weights, n_assets)):
        p.weights[a] = w
    for c, alpha in enumerate(idx):
        for a, d in enumerate(alpha):
            p.alpha[c][a] = d
    return p


def ma_factor_words(n_assets: int, degree: int, mode: str) -> list:
    """Column c's factor slots for kernel 9, one word a column of
    amcx's multi-index table (``_multi_index_set``): the slot ``a·degree +
    d − 1`` of each asset ``a`` with ``alpha_a = d > 0``, in asset order, a
    byte each from the low byte, ``0xff`` past the last. The column is
    their univariate columns multiplied left to right (1 for none)."""
    words = []
    for alpha in _multi_index_set(n_assets, degree, mode):
        slots = [a * degree + d - 1 for a, d in enumerate(alpha) if d > 0]
        if len(slots) > MAX_DEGREE:
            raise ValueError(f"a column of {len(slots)} factors exceeds {MAX_DEGREE}")
        slots += [0xff] * (MAX_DEGREE - len(slots))
        words.append(sum(f << (8 * k) for k, f in enumerate(slots)))
    return words


class MaApply(ctypes.Structure):
    """``struct MaApply`` of ``csrc/ma_step.cu``: :class:`MaParams` and the
    columns' :func:`ma_factor_words`, handed to kernel 9 by value."""

    _fields_ = [("params", MaParams), ("factors", ctypes.c_uint * MAX_COLS)]


@functools.lru_cache(maxsize=64)
def ma_apply_params(n_assets: int, basis: str, degree: int, mode: str, sorted_basis: bool,
                    payoff_kind: str, K: float, phi: float,
                    weights: Optional[tuple] = None) -> MaApply:
    """:func:`ma_params` with the factor words (cached like it)."""
    q = MaApply(params=ma_params(n_assets, basis, degree, mode, sorted_basis, payoff_kind, K,
                                 phi, weights))
    for c, w in enumerate(ma_factor_words(n_assets, degree, mode)):
        q.factors[c] = w
    return q


def _tuple(weights):
    return None if weights is None else tuple(float(w) for w in weights)


def _check_cuda(stats, t, planes, rows, n_assets, steps=False):
    """Validate the kernels' inputs on the card in one pass: ``stats`` a
    contiguous ``(2A+3, n_steps+1)`` f32 array, ``t`` a step, ``planes``
    the step's contiguous ``(A, n_paths)`` f32 planes (with ``steps``: all
    ``(n_steps+1, A, n_paths)`` of them) and each of ``rows`` a contiguous
    ``(n_paths,)`` f32 row on the same device. Returns ``(n_steps,
    n_paths)``."""
    dev = stats.device
    f32 = torch.float32
    if stats.dtype is not f32 or stats.ndim != 2 or stats.shape[0] != 2 * n_assets + 3 \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be contiguous ({2 * n_assets + 3}, n_steps+1) float32, "
                         f"got {tuple(stats.shape)} {stats.dtype}")
    n_steps = stats.shape[1] - 1
    if not 0 <= t < n_steps:
        raise ValueError(f"step t must lie in 0..{n_steps - 1}, got {t}")
    n_paths = planes.shape[-1]
    if n_paths < 1 or n_paths >= 2 ** 31:
        raise ValueError(f"n_paths must lie in 1..2^31-1, got {n_paths}")
    want = (n_steps + 1, n_assets, n_paths) if steps else (n_assets, n_paths)
    if planes.dtype is not f32 or planes.shape != want or planes.device != dev \
            or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous {want} float32 on {dev}, "
                         f"got {tuple(planes.shape)} {planes.dtype} on {planes.device}")
    for x in rows:
        if x.dtype is not f32 or x.shape != (n_paths,) or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"rows must be contiguous ({n_paths},) float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return n_steps, n_paths


def ma_step_moments(stats, t: int, planes, cf, tau, *, rdt: float, K: float, phi: float = 1.0,
                    basis: str = "chebyshev", degree: int = 2, mode: str = "total",
                    sorted_basis: bool = True, itm_weights: bool = False,
                    payoff_kind: str = "maxcall", weights=None,
                    direct_y: bool = False) -> torch.Tensor:
    """Packed cross-term moment vector ``(ma_pack_dim(m),)`` f32 of backward
    step ``t`` from the step's ``(n_assets, n_paths)`` planes and the
    ``cf``/``tau`` carry: ``y = cf·e^{−rdt·(τ−t)}`` (``direct_y``: ``cf`` is
    already the regression target and ``tau`` is not read), ITM weights
    ``1[payoff > 0]`` when ``itm_weights``.

    ``stats``: :func:`ma_stats` rows; ``rdt`` = r·dt (an f32 value). On a
    CUDA tensor this launches the kernel of ``csrc/ma_step.cu`` (or
    raises); on a CPU tensor it runs :func:`ma_step_moments_reference`.
    ``ma_step_moments.launches`` counts the kernel launches.
    """
    kw = dict(K=K, phi=phi, basis=basis, degree=degree, mode=mode, sorted_basis=sorted_basis,
              payoff_kind=payoff_kind, weights=weights)
    if stats.device.type == "cpu":
        return ma_step_moments_reference(stats, t, planes, cf, tau, rdt=rdt,
                                         itm_weights=itm_weights, direct_y=direct_y, **kw)
    if stats.device.type != "cuda":
        raise ValueError(f"ma_step_moments runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    n_assets = planes.shape[0]
    params = ma_params(n_assets, basis, degree, mode, sorted_basis, payoff_kind, float(K),
                       float(phi), _tuple(weights))
    n_steps, n_paths = _check_cuda(stats, t, planes, (cf, tau), n_assets)
    P = ma_pack_dim(params.n_cols)
    n_blocks = ma_moments_blocks(n_paths, _build.sm_count(stats.device))
    # one allocation: the (n_blocks, P) f64 partial rows, then the (P,) f32
    # result in the tail
    scratch = torch.empty(n_blocks * P + (P + 1) // 2, dtype=torch.float64,
                          device=stats.device)
    packed = scratch[n_blocks * P:].view(torch.float32)[:P]
    rc = _moments_fn()(planes.data_ptr(), cf.data_ptr(), tau.data_ptr(), stats.data_ptr(),
                       scratch.data_ptr(), packed.data_ptr(), t, n_steps, n_paths, n_blocks, rdt,
                       int(itm_weights), int(direct_y), ctypes.byref(params),
                       torch._C._cuda_getCurrentRawStream(stats.device.index))
    ma_step_moments.launches += 1
    _build.check(rc, "amcx_ma_step_moments")
    return packed


def ma_moments_blocks(n_paths: int, n_sm: int) -> int:
    """Blocks (partial rows) of the moments' persistent grid (kernels 7 and
    8): one block of 16 warps an SM, fewer when the paths fill fewer tiles
    (a path a thread)."""
    return max(1, min(n_sm, -(-n_paths // (32 * _MOMENTS_WARPS))))


@functools.lru_cache(maxsize=None)
def _moments_fn():
    from . import _build

    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_ma_step_moments",
                           [V, V, V, V, V, V, I, I, I, I, F, I, I, ctypes.POINTER(MaParams), V])


ma_step_moments.launches = 0


def ma_step_apply(stats, t: int, coeffs, planes, cf, tau, *, K: float, phi: float = 1.0,
                  basis: str = "chebyshev", degree: int = 2, mode: str = "total",
                  sorted_basis: bool = True, payoff_kind: str = "maxcall",
                  weights: Optional[tuple] = None):
    """One fused pass at step ``t``: the cross-term fitted continuation from
    the ``(m,)`` coefficients, clamped at 0, and the exercise select.

    Updates ``cf``/``tau`` IN PLACE where ``payoff > max(fitted, 0)`` and
    the step's ``allow_t`` is set; returns ``(cf, tau)``. On a CUDA tensor
    this launches the kernel of ``csrc/ma_step.cu`` (or raises); on a CPU
    tensor it runs :func:`ma_step_apply_reference`.
    ``ma_step_apply.launches`` counts the kernel launches.
    """
    kw = dict(K=K, phi=phi, basis=basis, degree=degree, mode=mode, sorted_basis=sorted_basis,
              payoff_kind=payoff_kind, weights=weights)
    if stats.device.type == "cpu":
        return ma_step_apply_reference(stats, t, coeffs, planes, cf, tau, **kw)
    if stats.device.type != "cuda":
        raise ValueError(f"ma_step_apply runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    n_assets = planes.shape[0]
    q = ma_apply_params(n_assets, basis, degree, mode, sorted_basis, payoff_kind, float(K),
                        float(phi), _tuple(weights))
    n_steps, n_paths = _check_cuda(stats, t, planes, (cf, tau), n_assets)
    dev = stats.device
    m = q.params.n_cols
    if coeffs.dtype is not torch.float32 or coeffs.shape != (m,) or coeffs.device != dev \
            or not coeffs.is_contiguous():
        raise ValueError(f"coeffs must be contiguous ({m},) float32 on {dev}")
    rc = _apply_fn()(planes.data_ptr(), cf.data_ptr(), tau.data_ptr(), stats.data_ptr(),
                     coeffs.data_ptr(), t, n_steps, n_paths, _build.sm_count(dev),
                     ctypes.byref(q), torch._C._cuda_getCurrentRawStream(dev.index))
    ma_step_apply.launches += 1
    if rc:
        _build.check(rc, "amcx_ma_step_apply")
    return cf, tau


@functools.lru_cache(maxsize=None)
def _apply_fn():
    from . import _build

    V, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_ma_step_apply",
                           [V, V, V, V, V, I, I, I, I, ctypes.POINTER(MaApply), V])


@functools.lru_cache(maxsize=None)
def _apply_planes_fn():
    from . import _build

    V, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_ma_step_apply_planes", [V, I, V, V])


class _MaApplyPlan(ctypes.Structure):
    """``struct MaApplyPlan`` of ``csrc/ma_step.cu``: a fused loop's apply,
    validated once."""

    _fields_ = [("planes", ctypes.c_void_p), ("cf", ctypes.c_void_p), ("tau", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("n_steps", ctypes.c_int), ("n_paths", ctypes.c_int),
                ("n_sm", ctypes.c_int), ("q", MaApply)]


ma_step_apply.launches = 0


def _ma_apply_plan(stats, planes, cf, tau, *, K, phi, basis, degree, mode, sorted_basis,
                   payoff_kind, weights, n_sm) -> _MaApplyPlan:
    """Validate a fused loop's tensors once and pack :class:`_MaApplyPlan`:
    all the steps' planes, the carry, the SM count and the product with its
    factor words."""
    if planes.ndim != 3:
        raise ValueError(f"planes must be (n_steps+1, n_assets, n_paths), got "
                         f"{tuple(planes.shape)}")
    n_assets = planes.shape[1]
    q = ma_apply_params(n_assets, basis, degree, mode, sorted_basis, payoff_kind, float(K),
                        float(phi), _tuple(weights))
    n_steps, n_paths = _check_cuda(stats, 0, planes, (cf, tau), n_assets, steps=True)
    return _MaApplyPlan(planes.data_ptr(), cf.data_ptr(), tau.data_ptr(), stats.data_ptr(),
                        n_steps, n_paths, n_sm, q)


def ma_step_apply_launcher(stats, planes, cf, tau, *, K: float, phi: float = 1.0,
                           basis: str = "chebyshev", degree: int = 2, mode: str = "total",
                           sorted_basis: bool = True, payoff_kind: str = "maxcall",
                           weights: Optional[tuple] = None, reference: bool = False):
    """:func:`ma_step_apply` for a fused loop: all ``(n_steps+1, n_assets,
    n_paths)`` planes, validated once here; the returned ``launch(t,
    coeffs)`` applies step ``t`` in place, as ``ma_step_apply(stats, t,
    coeffs, planes[t], cf, tau, ...)`` would. ``coeffs`` must be a
    contiguous ``(m,)`` f32 tensor on the card (``pinv_solve``'s result);
    the loop owns it, so it is not checked again. On a CPU tensor, or with
    ``reference``, each launch runs :func:`ma_step_apply_reference`.
    """
    kw = dict(K=K, phi=phi, basis=basis, degree=degree, mode=mode, sorted_basis=sorted_basis,
              payoff_kind=payoff_kind, weights=weights)
    if reference or stats.device.type == "cpu":
        def launch_plain(t: int, coeffs):
            ma_step_apply_reference(stats, t, coeffs, planes[t], cf, tau, **kw)
        return launch_plain
    if stats.device.type != "cuda":
        raise ValueError(f"ma_step_apply runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    dev = stats.device
    plan = _ma_apply_plan(stats, planes, cf, tau, n_sm=_build.sm_count(dev), **kw)
    fn, addr = _apply_planes_fn(), ctypes.addressof(plan)
    stream_of, index = torch._C._cuda_getCurrentRawStream, dev.index

    def launch(t: int, coeffs):
        rc = fn(addr, t, coeffs.data_ptr(), stream_of(index))
        ma_step_apply.launches += 1
        if rc:
            _build.check(rc, "amcx_ma_step_apply_planes")

    # the plan and the tensors it points into live as long as the launcher
    launch.keep = (plan, planes, cf, tau, stats)
    return launch

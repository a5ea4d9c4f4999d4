"""The fused engine's step kernels: wrappers and their plain versions.

Port of `amcx.ops.lsmc_pallas` (``_moments_kernel`` via
:func:`step_moments`, ``_apply_kernel`` via :func:`step_apply`). The
kernels live in ``amcx_torch/csrc/lsmc_step.cu``; ``step_moments_reference``
and ``step_apply_reference`` compute the same functions in plain torch, in
the kernels' operation order, with the moments summed in f64 and rounded
once to f32 (so on the card kernel and plain version agree to the bit; see
the note at the top of that file).

Deviations from amcx, none of which changes a value:

- Time-major rows: each step reads row t of the ``(n_steps+1, n_paths)``
  paths and the ``(n_paths,)`` cf/τ carry, for any ``n_paths``. amcx's
  ``(rows, 512)`` layout and its ``n_paths % 4096`` rule are dropped.
- The per-step scalars come from a ``(4, n_steps+1)`` f32 device array of
  rows ``[mean_t, inv_std_t, use_w_t, allow_t]`` (:func:`step_stats`) and
  the step index ``t``, in place of amcx's ``(7,)`` scalar vector, so the
  host loop never reads a value back. ``allow_t`` is the Bermudan gate
  (1 on exercise dates) that amcx applies with a ``where`` outside the
  kernel; the result is the same.
- The knocked row is a bool tensor (amcx: an f32 0/1 plane).
- :func:`step_apply` updates ``cf``/``tau`` in place, as amcx donates them
  (``input_output_aliases``), and writes the clamped continuation into a
  caller's surface row in place of returning it.

A fused loop launches the apply through :func:`step_apply_launcher`: its
tensors are validated once an induction, then each step passes only ``t``
and the coefficients.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..basis import BASIS_IDS, basis_cols
from .lsmc_megakernel import MAX_DEGREE, _pairs, _sum_once_rounded

__all__ = ["pack_dim", "unpack_moments", "step_stats", "step_moments",
           "step_moments_reference", "step_apply", "step_apply_reference",
           "step_apply_launcher"]

_THREADS = 256  # csrc/lsmc_common.cuh kThreads
_APPLY_BLOCKS_PER_SM = 8  # the apply's grid: 2,048 threads a SM


def pack_dim(k: int) -> int:
    """Length of the packed moment vector: upper-triangular Gram + rhs."""
    return k * (k + 1) // 2 + k


@functools.lru_cache(maxsize=None)
def _gram_index(k: int, device: torch.device) -> torch.Tensor:
    # built once per (k, device): a host-to-device copy per step would wait
    # for the stream
    idx = {p: n for n, p in enumerate(_pairs(k))}
    return torch.tensor([[idx[(min(i, j), max(i, j))] for j in range(k)] for i in range(k)],
                        dtype=torch.long, device=device)


def unpack_moments(packed: torch.Tensor, k: int):
    """Packed vector → symmetric Gram ``(k, k)`` + rhs ``(k,)``."""
    n_pairs = k * (k + 1) // 2
    return packed[_gram_index(k, packed.device)], packed[n_pairs:n_pairs + k]


def step_stats(mean_t, inv_std_t, use_w_t, allow_t) -> torch.Tensor:
    """The kernels' per-step rows ``[mean_t, inv_std_t, use_w_t, allow_t]``
    as one contiguous ``(4, n_steps+1)`` f32 tensor."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=mean_t.device)
                        for v in (mean_t, inv_std_t, use_w_t, allow_t)]).contiguous()


def _weights(S, knocked, use_w, K, phi):
    w = (torch.clamp_min(phi * (S - K), 0.0) > 0.0).to(torch.float32)
    if knocked is not None:
        w = w * knocked.to(torch.float32)
    return torch.where(use_w > 0.0, w, 1.0)


def step_moments_reference(stats, t: int, S, cf, tau, knocked=None, *, rdt: float, K: float,
                           phi: float, basis: str = "chebyshev", degree: int = 4,
                           itm_weights: bool = False) -> torch.Tensor:
    """Plain-torch version of :func:`step_moments` on any device."""
    k = degree + 1
    y = cf * torch.exp(-rdt * (tau - float(t)))
    xhat = (S - stats[0, t]) * stats[1, t]
    cols = basis_cols(xhat, basis, degree)
    if itm_weights:
        w = _weights(S, knocked, stats[2, t], K, phi)
        cols_w, yw = [c * w for c in cols], y * w
    else:
        cols_w, yw = cols, y
    packed = [_sum_once_rounded(cols_w[a] * cols[b]) for a, b in _pairs(k)]
    packed += [_sum_once_rounded(cols[a] * yw) for a in range(k)]
    return torch.stack(packed)


def step_apply_reference(stats, t: int, coeffs, S, cf, tau, knocked=None, *, K: float,
                         phi: float, basis: str = "chebyshev", degree: int = 4,
                         select: bool = True, surface: Optional[torch.Tensor] = None):
    """Plain-torch version of :func:`step_apply` on any device (also in
    place)."""
    cols = basis_cols((S - stats[0, t]) * stats[1, t], basis, degree)
    fitted = cols[0] * coeffs[0]
    for a in range(1, degree + 1):
        fitted = fitted + cols[a] * coeffs[a]
    cont = torch.clamp_min(fitted, 0.0)  # Q2; a NaN fit stays NaN
    if surface is not None:
        surface.copy_(cont)
    if select:
        ex = torch.clamp_min(phi * (S - K), 0.0)
        mask = (ex > cont) & (stats[3, t] > 0.0)
        if knocked is not None:
            mask = mask & knocked
        cf.copy_(torch.where(mask, ex, cf))
        tau.copy_(torch.where(mask, float(t), tau))
    return (cf, tau) if surface is None else (cf, tau, surface)


def _basis_id(basis: str) -> int:
    bid = BASIS_IDS.get(basis)
    if bid is None:
        bid = BASIS_IDS.get(basis.strip().lower())
        if bid is None:
            raise ValueError(f"Unknown basis type {basis!r}")
    return bid


def _check_cuda(stats, t, degree, rows, knocked, planes=()):
    """Validate the kernels' inputs on the card in one pass: ``stats`` a
    contiguous ``(4, n_steps+1)`` f32 array, ``t`` a step, each of ``rows``
    a contiguous ``(n_paths,)`` f32 row and each of ``planes`` a contiguous
    ``(n_steps+1, n_paths)`` f32 plane on its device, and ``knocked`` a bool
    row (a plane when ``planes`` are given). Returns ``(n_steps, n_paths)``."""
    dev = stats.device
    f32 = torch.float32
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree must lie in 0..{MAX_DEGREE}, got {degree}")
    if stats.dtype is not f32 or stats.ndim != 2 or stats.shape[0] != 4 \
            or not stats.is_contiguous():
        raise ValueError(f"stats must be contiguous (4, n_steps+1) float32, got "
                         f"{tuple(stats.shape)} {stats.dtype}")
    n_steps = stats.shape[1] - 1
    if not 0 <= t < n_steps:
        raise ValueError(f"step t must lie in 0..{n_steps - 1}, got {t}")
    n_paths = rows[0].shape[-1]
    if n_paths < 1 or n_paths >= 2 ** 31:
        raise ValueError(f"n_paths must lie in 1..2^31-1, got {n_paths}")
    row, plane = (n_paths,), (n_steps + 1, n_paths)
    for x, want in [(x, row) for x in rows] + [(x, plane) for x in planes]:
        if x.dtype is not f32 or x.shape != want or x.device != dev or not x.is_contiguous():
            raise ValueError(f"rows must be contiguous {want} float32 on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    want = plane if planes else row
    if knocked is not None and (knocked.dtype is not torch.bool or knocked.shape != want
                                or knocked.device != dev or not knocked.is_contiguous()):
        raise ValueError(f"knocked must be a contiguous {want} bool tensor on {dev}")
    return n_steps, n_paths


def _ptr(x):
    return None if x is None else x.data_ptr()


def apply_blocks(n_paths: int, n_sm: int) -> int:
    """Blocks of the apply's persistent grid: 8 a SM (2,048 threads), fewer
    when the paths fill fewer blocks of 4 paths a thread."""
    return max(1, min(_APPLY_BLOCKS_PER_SM * n_sm, -(-n_paths // (4 * _THREADS))))


def step_blocks(n_paths: int, n_sm: int) -> int:
    """Blocks (partial rows) of the moments kernel's persistent grid: two
    per SM, fewer when the paths fill fewer blocks of 4 paths a thread."""
    return max(1, min(2 * n_sm, -(-n_paths // (4 * _THREADS))))


# (device index, stream) -> the moments kernel's f64 scratch: the ticket
# (zeroed once here, left zero by every call), then the partial rows. Kept
# per stream, so two streams never share a ticket or a row.
_SCRATCH = {}


def _moments_scratch(dev: torch.device, stream: int, n_sm: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        rows = 2 * n_sm * pack_dim(MAX_DEGREE + 1)  # step_blocks' most rows at the largest P
        buf = torch.zeros(1 + rows, dtype=torch.float64, device=dev)
        _SCRATCH[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _moments_fn():
    from . import _build

    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_step_moments",
                           [V, V, V, V, V, V, V, I, I, I, I, F, F, F, I, I, I, V])


@functools.lru_cache(maxsize=None)
def _apply_fn():
    from . import _build

    V, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_step_apply", [V, V, V, V, V, V, V, I, I, I, I, F, F, I, I, I, V])


@functools.lru_cache(maxsize=None)
def _apply_planes_fn():
    from . import _build

    V, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_step_apply_planes", [V, I, V, V])


class _ApplyPlan(ctypes.Structure):
    """``struct StepApplyPlan`` of ``csrc/lsmc_step.cu``: a fused loop's
    apply, validated once."""

    _fields_ = [("paths", ctypes.c_void_p), ("cf", ctypes.c_void_p), ("tau", ctypes.c_void_p),
                ("knocked", ctypes.c_void_p), ("stats", ctypes.c_void_p),
                ("surface", ctypes.c_void_p), ("n_steps", ctypes.c_int),
                ("n_paths", ctypes.c_int), ("n_blocks", ctypes.c_int), ("basis", ctypes.c_int),
                ("degree", ctypes.c_int), ("select", ctypes.c_int), ("strike", ctypes.c_float),
                ("phi", ctypes.c_float)]


def step_moments(stats, t: int, S, cf, tau, knocked=None, *, rdt: float, K: float, phi: float,
                 basis: str = "chebyshev", degree: int = 4,
                 itm_weights: bool = False) -> torch.Tensor:
    """Packed moment vector ``(pack_dim(degree+1),)`` f32 of backward step
    ``t``, from row t of the paths ``S``, the carry ``cf``/``tau`` and the
    knocked row (bool, or None for vanilla products).

    ``stats``: :func:`step_stats` rows; ``rdt`` = r·dt (an f32 value);
    ``phi`` +1 for calls, −1 for puts. On a CUDA tensor this launches the
    kernel of ``csrc/lsmc_step.cu`` (or raises); on a CPU tensor it runs
    :func:`step_moments_reference`. ``step_moments.launches`` counts the
    kernel launches.
    """
    if stats.device.type == "cpu":
        return step_moments_reference(stats, t, S, cf, tau, knocked, rdt=rdt, K=K, phi=phi,
                                      basis=basis, degree=degree, itm_weights=itm_weights)
    if stats.device.type != "cuda":
        raise ValueError(f"step_moments runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    bid = _basis_id(basis)
    n_steps, n_paths = _check_cuda(stats, t, degree, (S, cf, tau), knocked)
    dev = stats.device
    n_sm = _build.sm_count(dev)
    n_blocks = step_blocks(n_paths, n_sm)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)  # current_stream's handle, cheaper
    scratch = _moments_scratch(dev, stream, n_sm)
    packed = torch.empty(pack_dim(degree + 1), dtype=torch.float32, device=dev)
    rc = _moments_fn()(S.data_ptr(), cf.data_ptr(), tau.data_ptr(), _ptr(knocked),
                       stats.data_ptr(), scratch.data_ptr(), packed.data_ptr(), t, n_steps,
                       n_paths, n_blocks, rdt, float(K), float(phi), bid, degree,
                       int(itm_weights), stream)
    step_moments.launches += 1
    _build.check(rc, "amcx_step_moments")
    return packed


step_moments.launches = 0


def step_apply(stats, t: int, coeffs, S, cf, tau, knocked=None, *, K: float, phi: float,
               basis: str = "chebyshev", degree: int = 4, select: bool = True,
               surface: Optional[torch.Tensor] = None):
    """One fused pass at step ``t``: the fitted continuation from the
    ``(degree+1,)`` coefficients, clamped at 0, and the exercise select.

    Updates ``cf``/``tau`` IN PLACE where ``ex > cont``, the path is knocked
    and ``allow_t`` is set (``select=False``: no select, for a European
    surface), and writes the clamped continuation into ``surface`` (a
    ``(n_paths,)`` row, e.g. row t of a preallocated surface) when given.
    Returns ``(cf, tau)`` or ``(cf, tau, surface)``. On a CUDA tensor this
    launches the kernel of ``csrc/lsmc_step.cu`` (or raises); on a CPU
    tensor it runs :func:`step_apply_reference`. ``step_apply.launches``
    counts the kernel launches.
    """
    if stats.device.type == "cpu":
        return step_apply_reference(stats, t, coeffs, S, cf, tau, knocked, K=K, phi=phi,
                                    basis=basis, degree=degree, select=select,
                                    surface=surface)
    if stats.device.type != "cuda":
        raise ValueError(f"step_apply runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    bid = _basis_id(basis)
    rows = (S, cf, tau) if surface is None else (S, cf, tau, surface)
    n_steps, n_paths = _check_cuda(stats, t, degree, rows, knocked)
    dev = stats.device
    if coeffs.dtype is not torch.float32 or coeffs.shape != (degree + 1,) \
            or coeffs.device != dev or not coeffs.is_contiguous():
        raise ValueError(f"coeffs must be contiguous ({degree + 1},) float32 on {dev}")
    rc = _apply_fn()(S.data_ptr(), cf.data_ptr(), tau.data_ptr(), _ptr(knocked),
                     stats.data_ptr(), coeffs.data_ptr(), _ptr(surface), t, n_steps, n_paths,
                     apply_blocks(n_paths, _build.sm_count(dev)), float(K), float(phi), bid,
                     degree, int(select), torch._C._cuda_getCurrentRawStream(dev.index))
    step_apply.launches += 1
    if rc:
        _build.check(rc, "amcx_step_apply")
    return (cf, tau) if surface is None else (cf, tau, surface)


step_apply.launches = 0


def _apply_plan(stats, paths, cf, tau, knocked, surface, *, K, phi, basis, degree, select,
                n_sm) -> _ApplyPlan:
    """Validate a fused loop's tensors once and pack :class:`_ApplyPlan`:
    the planes' bases, the grid (:func:`apply_blocks` for ``n_sm`` SMs) and
    the product."""
    planes = (paths,) if surface is None else (paths, surface)
    n_steps, n_paths = _check_cuda(stats, 0, degree, (cf, tau), knocked, planes)
    return _ApplyPlan(paths.data_ptr(), cf.data_ptr(), tau.data_ptr(), _ptr(knocked),
                      stats.data_ptr(), _ptr(surface), n_steps, n_paths,
                      apply_blocks(n_paths, n_sm), _basis_id(basis), degree, int(select),
                      float(K), float(phi))


def step_apply_launcher(stats, paths, cf, tau, knocked=None, *, K: float, phi: float,
                        basis: str = "chebyshev", degree: int = 4, select: bool = True,
                        surface: Optional[torch.Tensor] = None, reference: bool = False):
    """:func:`step_apply` for a fused loop: the whole ``(n_steps+1,
    n_paths)`` paths, knocked plane and surface, validated once here; the
    returned ``launch(t, coeffs)`` applies step ``t`` in place (row t of
    each plane), as ``step_apply(stats, t, coeffs, paths[t], cf, tau,
    knocked[t], surface=surface[t], ...)`` would. ``coeffs`` must be a
    contiguous ``(degree+1,)`` f32 tensor on the card (``pinv_solve``'s
    result); the loop owns it, so it is not checked again. On a CPU tensor,
    or with ``reference``, each launch runs :func:`step_apply_reference`.
    """
    kw = dict(K=K, phi=phi, basis=basis, degree=degree, select=select)
    if reference or stats.device.type == "cpu":
        def launch_plain(t: int, coeffs):
            step_apply_reference(stats, t, coeffs, paths[t], cf, tau,
                                 None if knocked is None else knocked[t],
                                 surface=None if surface is None else surface[t], **kw)
        return launch_plain
    if stats.device.type != "cuda":
        raise ValueError(f"step_apply runs on 'cpu' or 'cuda', got {stats.device}")
    from . import _build

    dev = stats.device
    plan = _apply_plan(stats, paths, cf, tau, knocked, surface, n_sm=_build.sm_count(dev), **kw)
    fn, addr = _apply_planes_fn(), ctypes.addressof(plan)
    stream_of, index = torch._C._cuda_getCurrentRawStream, dev.index

    def launch(t: int, coeffs):
        rc = fn(addr, t, coeffs.data_ptr(), stream_of(index))
        step_apply.launches += 1
        if rc:
            _build.check(rc, "amcx_step_apply_planes")

    # the plan and the tensors it points into live as long as the launcher
    launch.keep = (plan, paths, cf, tau, knocked, surface, stats)
    return launch

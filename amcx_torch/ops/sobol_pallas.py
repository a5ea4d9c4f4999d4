"""Scrambled-Sobol GBM paths on the card: the CUDA kernel's wrapper and its
plain version.

Port of `amcx.ops.sobol_pallas` (``_sobol_gbm_kernel`` via
``sobol_gbm_paths``), under amcx's module name. The scrambled direction
numbers are scipy's engine's, derived once per (seed, n_steps, n_paths):
on the card by a second kernel (:func:`sobol_tables`, which replays the
engine's PCG64 draws by jump-ahead from the seeded state), on the CPU by
the plain version (its draws replayed and applied as one vectorised
product, :func:`_scramble`, :func:`_direction_tables`); the kernel
(``csrc/sobol_gbm.cu``) rebuilds each point as ``u_hi[j, p >> 9] ^ u_lo[j, p & 511]``, maps it to a
uniform and by Acklam's inverse CDF (:func:`norm_ppf`) to a normal, and
writes the time-major ``(n_steps+1, n_paths)`` f32 path array, either by a
running log-sum (increment order) or by the Brownian-bridge matrix (bridge
order, `amcx_torch.qmc.brownian_bridge_matrix`). In bridge order the
kernel sums only B's nonzeros, walked by a schedule the host builds once
per (n_steps, T) (:func:`_bridge_schedule`). A new seed's tables are built on
the device under the program span ``pathgen.tables``, counted by
``sobol_gbm_paths.table_builds``; a cached seed opens no span and launches
and copies nothing.

:func:`sobol_gbm_paths_reference` computes the same function in plain torch
with the kernel's operation order: a loop over steps for the running sum,
and the dense bridge product accumulated over s in ascending order (the
kernel's sparse sum skips exact zero terms only, which changes no bit). On
the card the two agree to the bit. Natural point order is a block permutation of
scipy's Gray-code order: the point sets are equal for power-of-two counts.
scipy is imported inside the functions that need it, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import heapq

import numpy as np
import torch

from .. import tracing
from ..types import BRIDGE_MAX_STEPS, SOBOL_LANES as LANES, MarketParams, SimConfig, \
    check_sobol_grid

__all__ = ["sobol_gbm_paths", "sobol_gbm_paths_reference", "paths_from_tables_reference",
           "sobol_tables", "simulate_gbm_qmc_device", "norm_ppf", "BRIDGE_MAX_STEPS"]

_LOW_BITS = 9  # the path index's bits that pick a u_lo column (LANES = 2**_LOW_BITS)
_SLOT_BITS = 8  # csrc/sobol_gbm.cu kSlotBits
_U64 = (1 << 64) - 1

# Acklam's inverse normal CDF coefficients
_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)
_P_LOW = 0.02425


def _ppf_central(p: torch.Tensor) -> torch.Tensor:
    """Acklam's central form of Φ⁻¹ (the kernel's ``norm_ppf_central``)."""
    half = p - 0.5
    r = half * half
    num = torch.full_like(p, _A[0])
    for a in _A[1:]:
        num = num * r + a
    den = torch.full_like(p, _B[0])
    for b in _B[1:]:
        den = den * r + b
    den = den * r + 1.0
    return num * half / den


def _ppf_tail(p: torch.Tensor) -> torch.Tensor:
    """Acklam's tail form of Φ⁻¹ (the kernel's ``norm_ppf_tail``)."""
    half = p - 0.5
    pt = torch.minimum(p, 1.0 - p)
    qt = torch.sqrt(-2.0 * torch.log(torch.clamp_min(pt, 1e-38)))
    num = torch.full_like(p, _C[0])
    for c in _C[1:]:
        num = num * qt + c
    den = torch.full_like(p, _D[0])
    for d in _D[1:]:
        den = den * qt + d
    den = den * qt + 1.0
    x_t = num / den  # the lower-tail form
    return torch.where(half < 0, x_t, -x_t)


def _in_tail(p: torch.Tensor) -> torch.Tensor:
    select = torch.tensor(0.5 - _P_LOW, dtype=p.dtype, device=p.device)
    return ~(torch.abs(p - 0.5) <= select)


def norm_ppf(p: torch.Tensor) -> torch.Tensor:
    """Branchless Acklam Φ⁻¹ of f32 ``p ∈ (0, 1)``, in amcx's f32 operation
    order (each Python coefficient rounded to f32)."""
    return torch.where(_in_tail(p), _ppf_tail(p), _ppf_central(p))


def _bits_to_uniform(u: torch.Tensor) -> torch.Tensor:
    """int32 Sobol integers (30 significant bits) → f32 uniforms in
    [2⁻²⁴, 1 − 2⁻²⁴]."""
    mant = torch.bitwise_and(torch.bitwise_right_shift(u, 7), 0x007FFFFF)
    return torch.bitwise_or(mant, 0x3F800000).view(torch.float32) - (1.0 - 2.0 ** -24)


@functools.lru_cache(maxsize=None)
def _joe_kuo(n_steps: int):
    """scipy's unscrambled direction numbers of ``n_steps`` dimensions,
    ``(n_steps, bits)`` uint32, and ``bits``. Read-only (cached)."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=n_steps, scramble=False)
    sv = np.asarray(eng._sv, dtype=np.uint32)
    sv.flags.writeable = False
    return sv, int(eng.bits)


def _scramble(seed: int, n_steps: int):
    """The direction numbers and digital shift of scipy's scrambled engine
    ``qmc.Sobol(d=n_steps, scramble=True, seed=seed)``: the same draws from
    ``np.random.default_rng(seed)`` in the engine's order (the shift's bits,
    then the lower-triangular matrices L of its left linear matrix scramble,
    unit diagonal), with the product over GF(2) taken at once: bit
    ``bits - 1 - p`` of a scrambled number v is the parity of row p of L,
    read most significant column first, AND v. The engine's own scramble, a
    loop over every dimension, bit and row, was most of a new seed's host
    time. ``(sv, shift, bits)``."""
    sv, bits = _joe_kuo(n_steps)
    rng = np.random.default_rng(seed)
    weights = np.uint32(1) << np.arange(bits - 1, -1, -1, dtype=np.uint32)
    shift = rng.integers(0, 2, size=(n_steps, bits), dtype=np.uint32) @ weights[::-1]
    below = rng.integers(0, 2, size=(n_steps, bits, bits), dtype=np.uint32)
    np.bitwise_and(below, np.tril(np.ones((bits, bits), dtype=np.uint32), -1), out=below)
    rows = below @ weights + weights  # (n_steps, bits): row p of L as an integer
    parity = np.bitwise_count(rows[:, None, :] & sv[:, :, None]) & 1  # (dim, j, p)
    return parity.astype(np.uint32) @ weights, shift, bits


def _scrambled_numbers(seed: int, n_steps: int, n_paths: int) -> np.ndarray:
    """``(n_steps, bits + 1)`` uint32: the scrambled direction numbers
    (:func:`_scramble`) and, in the last column, the digital shift, each
    left-aligned to 30 bits (the uniform conversion reads bits 29..7)."""
    sv, shift, bits = _scramble(int(seed), n_steps)
    if n_paths > 1 << bits:
        raise ValueError(f"n_paths exceeds the {bits}-bit Sobol period")
    return np.concatenate([sv, shift[:, None]], axis=1) << np.uint32(30 - bits)


def _factor(numbers: np.ndarray, low_bit: int, n_bits: int) -> np.ndarray:
    """``(n_steps, 2**n_bits)``: column j the XOR of ``numbers[:, low_bit +
    b]`` over the set bits b of j, built by doubling (columns 2^k + j are
    columns j ^ number k)."""
    acc = np.zeros((numbers.shape[0], 1 << n_bits), dtype=np.uint32)
    for k in range(n_bits):
        np.bitwise_xor(acc[:, :1 << k], numbers[:, low_bit + k:low_bit + k + 1],
                       out=acc[:, 1 << k:2 << k])
    return acc


def _table_factors(seed: int, n_steps: int, n_paths: int) -> np.ndarray:
    """The XOR tables' factors, side by side in one ``(n_steps, m)`` uint32
    array: u_lo's column i (bits 0-8) is the XOR of a factor over its bits
    0-4 and one over bits 5-8, u_hi's (direction numbers from bit 9 up) the
    XOR of a factor over the low half of its index bits, the shift folded
    in, and one over the high half (:func:`_xor_tables`)."""
    numbers = _scrambled_numbers(seed, n_steps, n_paths)
    hi_bits = (n_paths // LANES - 1).bit_length()
    half = (hi_bits + 1) // 2
    return np.concatenate([_factor(numbers, 0, 5), _factor(numbers, 5, _LOW_BITS - 5),
                           _factor(numbers, _LOW_BITS, half) ^ numbers[:, -1:],
                           _factor(numbers, _LOW_BITS + half, hi_bits - half)], axis=1)


def _xor_tables(factors: torch.Tensor, n_paths: int):
    """``u_hi`` ``(n_steps, n_paths/512)`` (the shift folded in) and ``u_lo``
    ``(n_steps, 512)``, int32 on the device of ``factors`` (the int32 view
    of :func:`_table_factors`): each the XOR of its two factors' columns, a
    fixed two or three device operations whatever the seed."""
    n_steps, n_cols = factors.shape[0], n_paths // LANES
    hi_bits = (n_cols - 1).bit_length()
    half = (hi_bits + 1) // 2
    cuts = np.cumsum([32, 1 << _LOW_BITS - 5, 1 << half, 1 << hi_bits - half])
    f0, f1, f2, f3 = (factors[:, a:b] for a, b in zip([0, *cuts[:-1]], cuts))
    u_lo = torch.bitwise_xor(f1[:, :, None], f0[:, None, :]).view(n_steps, LANES)
    u_hi = torch.bitwise_xor(f3[:, :, None], f2[:, None, :]).view(n_steps, -1)
    return u_hi[:, :n_cols].contiguous(), u_lo


@functools.lru_cache(maxsize=8)
def _direction_tables(seed: int, n_steps: int, n_paths: int):
    """The factored XOR tables of scipy's scrambled engine on the host:
    :func:`_xor_tables` as uint32 arrays, left-aligned to 30 bits. amcx's
    tables without the 128-column padding of ``u_hi``. Read-only (cached)."""
    tables = tuple(t.numpy().view(np.uint32)
                   for t in sobol_tables(seed, n_steps, n_paths, device="cpu"))
    for t in tables:
        t.flags.writeable = False
    return tables


def _params(S0, r, sigma, q, T, n_steps, bridge):
    """amcx's three kernel scalars as f32 values: S0, the drift per step,
    and the normal's scale (σ√dt, or σ in bridge mode, where B carries
    √dt)."""
    dt = T / n_steps
    sigma32 = np.float32(sigma)
    vol = sigma32 if bridge else sigma32 * np.sqrt(np.float32(dt))
    return (float(np.float32(S0)), float(np.float32((r - q - 0.5 * sigma ** 2) * dt)),
            float(np.float32(vol)))


def _bridge_matrix(n_steps, T):
    from ..qmc import brownian_bridge_matrix

    return np.ascontiguousarray(brownian_bridge_matrix(n_steps, T / n_steps), np.float32)


@functools.lru_cache(maxsize=8)
def _bridge_schedule(n_steps: int, T: float):
    """The bridge kernel's walk over the nonzeros of the f32 bridge matrix B:
    ``(row_ptr (n_steps+1,) int32, entries (nnz, 2) int32, n_slots)``. Row
    t's entries are its nonzero columns s in ascending order, each
    ``(s << 8 | slot | born << 31, bits of B[t, s])``: column s's normal is
    made at its first row (born) into a slot that no other column holds
    between that row and s's last row; ``n_slots`` slots are live at most.
    Read-only (cached)."""
    B = _bridge_matrix(n_steps, T)
    rows, cols = np.nonzero(B)  # row-major: columns ascending within a row
    last = np.zeros(n_steps, dtype=np.int64)
    last[cols] = rows  # the last row that uses each column
    words = np.empty(cols.size, dtype=np.int64)
    slot_of, free, n_slots = {}, [], 0
    row_ptr = np.searchsorted(rows, np.arange(n_steps + 1)).astype(np.int32)
    for t in range(n_steps):
        start, end = row_ptr[t], row_ptr[t + 1]
        for e in range(start, end):
            s = int(cols[e])
            born = s not in slot_of
            if born:  # the lowest free slot, else a new one
                slot_of[s] = heapq.heappop(free) if free else n_slots
                n_slots = max(n_slots, slot_of[s] + 1)
            words[e] = (s << _SLOT_BITS) | slot_of[s] | (born << 31)
        for s in cols[start:end]:
            if last[s] == t:
                heapq.heappush(free, slot_of[int(s)])
    if n_slots > 1 << _SLOT_BITS:
        raise ValueError(f"the bridge schedule needs {n_slots} slots")
    entries = np.stack([words.astype(np.uint32).view(np.int32),
                        B[rows, cols].view(np.int32)], axis=1)
    for a in (row_ptr, entries):
        a.flags.writeable = False
    return row_ptr, entries, n_slots


def paths_from_tables_reference(u_hi, u_lo, S0: float, drift_dt: float, vol: float,
                                n_steps: int, n_paths: int, B=None, device="cpu"):
    """Plain-torch version of the kernel on given tables (``u_hi``
    ``(n_steps, n_paths/512)`` and ``u_lo`` ``(n_steps, 512)`` as int32
    tensors or uint32 arrays) and f32 scalars: increment order, or bridge
    order on the f32 bridge matrix ``B``. Time-major ``(n_steps+1,
    n_paths)`` f32 on ``device``."""
    hi, lo = (torch.from_numpy(t.view(np.int32).copy()) if isinstance(t, np.ndarray) else t
              for t in (u_hi, u_lo))
    hi, lo = hi.to(device), lo.to(device)
    p = torch.arange(n_paths, device=device)
    z = norm_ppf(_bits_to_uniform(torch.bitwise_xor(hi[:, p >> _LOW_BITS],
                                                    lo[:, p & (LANES - 1)])))
    del hi, lo, p
    out = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=device)
    out[0] = S0
    if B is not None:
        B = torch.as_tensor(B).to(device)
        W = torch.zeros((n_steps, n_paths), dtype=torch.float32, device=device)
        for s in range(n_steps):  # ascending s, as the kernel sums
            W = W + B[:, s:s + 1] * z[s]
        trow = torch.arange(1, n_steps + 1, dtype=torch.float32, device=device)[:, None]
        out[1:] = S0 * torch.exp(drift_dt * trow + vol * W)
        return out
    cum = torch.zeros(n_paths, dtype=torch.float32, device=device)
    for j in range(n_steps):
        cum = cum + (drift_dt + vol * z[j])
        out[j + 1] = S0 * torch.exp(cum)
    return out


def sobol_gbm_paths_reference(seed, S0, r, sigma, q, T, n_steps: int, n_paths: int,
                              brownian_bridge: bool = False, device="cpu") -> torch.Tensor:
    """Plain-torch version of the kernel: time-major ``(n_steps+1,
    n_paths)`` f32 on ``device``."""
    check_sobol_grid(n_steps, n_paths, brownian_bridge, "the Sobol pathgen")
    u_hi, u_lo = _direction_tables(int(seed), n_steps, n_paths)
    S0, drift_dt, vol = _params(S0, r, sigma, q, T, n_steps, brownian_bridge)
    B = _bridge_matrix(n_steps, T) if brownian_bridge else None
    return paths_from_tables_reference(u_hi, u_lo, S0, drift_dt, vol, n_steps, n_paths, B,
                                       device)


def _cuda_device(device) -> torch.device:
    """``device`` with its index (the caches and the stream handle need it)."""
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=8)
def _device_tables(seed: int, n_steps: int, n_paths: int, device: torch.device):
    """The direction tables as int32 tensors on ``device``
    (:func:`sobol_tables`), built once per (seed, n_steps, n_paths, device)
    inside the ``pathgen.tables`` span and counted by
    ``sobol_gbm_paths.table_builds``. A call with a cached seed opens no
    span, launches nothing and copies nothing."""
    with tracing.span("pathgen.tables"):
        sobol_gbm_paths.table_builds += 1
        return sobol_tables(seed, n_steps, n_paths, device)


@functools.lru_cache(maxsize=8)
def _device_schedule(n_steps: int, T: float, device: torch.device):
    """The bridge schedule on the card, once per (n_steps, T, device)."""
    row_ptr, entries, n_slots = _bridge_schedule(n_steps, T)
    return (torch.from_numpy(row_ptr.copy()).to(device),
            torch.from_numpy(entries.copy()).to(device), n_slots)


@functools.lru_cache(maxsize=8)
def _device_directions(n_steps: int, device: torch.device):
    """scipy's unscrambled direction numbers (:func:`_joe_kuo`) on the card
    as int32, once per (n_steps, device), and ``bits``."""
    sv, bits = _joe_kuo(n_steps)
    return torch.from_numpy(sv.view(np.int32).copy()).to(device), bits


def _pcg64_state(seed: int):
    """The 128-bit state and increment of ``np.random.default_rng(seed)``'s
    bit generator before its first draw, each as (high, low) 64-bit words:
    ``(state_hi, state_lo, inc_hi, inc_lo)``."""
    st = np.random.PCG64(seed).state["state"]
    return st["state"] >> 64, st["state"] & _U64, st["inc"] >> 64, st["inc"] & _U64


@functools.lru_cache(maxsize=None)
def _sobol_fn():
    from . import _build

    Vp, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.function("amcx_sobol_gbm_paths", [Vp, Vp, Vp, Vp, Vp, I, I, F, F, F, I, Vp])


@functools.lru_cache(maxsize=None)
def _tables_fn():
    from . import _build

    Vp, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    return _build.function("amcx_sobol_tables", [Vp, U, U, U, U, I, I, I, Vp, Vp, Vp])


def sobol_tables(seed: int, n_steps: int, n_paths: int, device="cuda"):
    """The direction tables of scipy's ``qmc.Sobol(d=n_steps, scramble=True,
    seed=seed)`` for ``n_paths`` points: ``u_hi`` ``(n_steps, n_paths/512)``
    (the digital shift folded in) and ``u_lo`` ``(n_steps, 512)``, int32 on
    ``device``, left-aligned to 30 bits (:func:`_direction_tables`' bits).

    On a CUDA device one launch of ``csrc/sobol_gbm.cu``'s table kernel on
    the current stream: the host passes the seed's PCG64 state and
    increment, the card replays the scramble's draws, the scramble and both
    tables; the direction numbers are put on the card once per (n_steps,
    device). No host table, no copy, no synchronise. On the CPU the plain
    version (:func:`_table_factors`, :func:`_xor_tables`).
    ``sobol_tables.launches`` counts the kernel launches.
    """
    from . import _build

    device = torch.device(device)
    if device.type == "cpu":
        factors = torch.from_numpy(_table_factors(seed, n_steps, n_paths).view(np.int32))
        return _xor_tables(factors, n_paths)
    if device.type != "cuda":
        raise ValueError(f"sobol_tables runs on 'cpu' or 'cuda', got {device}")
    device = _cuda_device(device)
    sv, bits = _device_directions(n_steps, device)
    if n_paths > 1 << bits:
        raise ValueError(f"n_paths exceeds the {bits}-bit Sobol period")
    u_hi = torch.empty((n_steps, n_paths // LANES), dtype=torch.int32, device=device)
    u_lo = torch.empty((n_steps, LANES), dtype=torch.int32, device=device)
    stream = torch._C._cuda_getCurrentRawStream(device.index)  # current_stream's handle
    rc = _tables_fn()(sv.data_ptr(), *_pcg64_state(int(seed)), n_steps, bits, n_paths,
                      u_hi.data_ptr(), u_lo.data_ptr(), stream)
    sobol_tables.launches += 1
    _build.check(rc, "amcx_sobol_tables")
    return u_hi, u_lo


sobol_tables.launches = 0


def _launch(hi, lo, schedule, out, n_steps: int, n_paths: int, S0: float, drift_dt: float,
            vol: float) -> None:
    """One kernel launch on given device tables (int32, contiguous) into
    ``out``; ``schedule`` is ``(row_ptr, entries, n_slots)`` for the bridge
    order or None for the increment order."""
    from . import _build

    row_ptr, entries, n_slots = schedule if schedule is not None else (None, None, 0)
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)  # current_stream's handle
    rc = _sobol_fn()(hi.data_ptr(), lo.data_ptr(),
                     None if row_ptr is None else row_ptr.data_ptr(),
                     None if entries is None else entries.data_ptr(), out.data_ptr(), n_steps,
                     n_paths, S0, drift_dt, vol, n_slots, stream)
    sobol_gbm_paths.launches += 1
    _build.check(rc, "amcx_sobol_gbm_paths")


def sobol_gbm_paths(seed, S0, r, sigma, q, T, n_steps: int, n_paths: int,
                    brownian_bridge: bool = False, device="cuda") -> torch.Tensor:
    """Time-major ``(n_steps+1, n_paths)`` f32 GBM paths from scrambled-Sobol
    points on ``device``; amcx's parameters minus ``interpret``, plus
    ``device``.

    ``n_paths``: a multiple of 512 (the digital-net block), at most 2³⁰;
    powers of two keep the net balanced. ``brownian_bridge`` orders the
    Sobol dimensions by the bridge construction (at most
    :data:`BRIDGE_MAX_STEPS` steps). On a CUDA device this launches the
    kernel (``csrc/sobol_gbm.cu``) on the current stream, or raises; on the
    CPU it runs the plain version (:func:`paths_from_tables_reference`, the
    bits of :func:`sobol_gbm_paths_reference`). The tables are built once
    per (seed, n_steps, n_paths) on the device and kept there
    (:func:`_device_tables`), the bridge schedule once per (n_steps, T).
    ``sobol_gbm_paths.launches`` counts the kernel launches,
    ``sobol_gbm_paths.table_builds`` the tables built for a device.
    """
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sobol_gbm_paths runs on 'cpu' or 'cuda', got {device}")
    check_sobol_grid(n_steps, n_paths, brownian_bridge, "the Sobol pathgen")
    if device.type == "cuda":
        device = _cuda_device(device)
    hi, lo = _device_tables(int(seed), n_steps, n_paths, device)
    S0, drift_dt, vol = _params(S0, r, sigma, q, T, n_steps, brownian_bridge)
    if device.type == "cpu":
        B = _bridge_matrix(n_steps, T) if brownian_bridge else None
        return paths_from_tables_reference(hi, lo, S0, drift_dt, vol, n_steps, n_paths, B,
                                           device)
    schedule = _device_schedule(n_steps, float(T), device) if brownian_bridge else None
    out = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=device)
    _launch(hi, lo, schedule, out, n_steps, n_paths, S0, drift_dt, vol)
    return out


sobol_gbm_paths.launches = 0
sobol_gbm_paths.table_builds = 0


def simulate_gbm_qmc_device(seed: int, market: MarketParams, T, sim: SimConfig,
                            brownian_bridge: bool = False, device="cuda") -> torch.Tensor:
    """`amcx_torch.qmc.simulate_gbm_qmc`'s signature on the kernel: the
    kernel on a CUDA ``device``, its plain version on the CPU (amcx falls
    back to host scipy on a CPU backend instead). f32 paths only; scrambled
    Sobol points have no antithetic mirror, so ``sim.antithetic`` raises."""
    if sim.dtype != "float32":
        raise ValueError("the Sobol pathgen emits float32 paths")
    if sim.antithetic:
        raise ValueError("scrambled-Sobol paths have no antithetic mirror; "
                         "use SimConfig(antithetic=False)")
    return sobol_gbm_paths(seed, market.S0, market.r, market.sigma, market.q, T, sim.n_steps,
                           sim.n_paths, brownian_bridge=brownian_bridge, device=device)

"""Philox GBM pathgen: the CUDA kernel's wrapper and its plain version.

Port of `amcx.ops.gbm_pallas` (``_gbm_kernel``). The kernel lives in
``amcx_torch/csrc/gbm.cu`` (+ ``philox.cuh``); :func:`gbm_paths_reference`
computes the same function in plain torch: Philox4x32-10 in int64
arithmetic masked to 32 bits (so the uniforms agree bit for bit), the same
Box-Muller pairs and a ``torch.cumsum`` of the log increments.

The draws are a documented pure function of (seed, path, step):
key = (seed mod 2³², seed >> 32); counter = (step quad j, path p, 0, 0);
u = ((x >> 8) + 1)·2⁻²⁴ ∈ (0, 1]; Box-Muller on (u0, u1) and (u2, u3)
gives the normals of steps 4j … 4j+3; a tail quad drops its surplus.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

__all__ = ["gbm_paths", "gbm_paths_reference", "philox4x32_10", "philox_normals", "GBM_PATHS"]

GBM_PATHS = 4  # consecutive paths a thread (csrc/gbm.cu kGbmPaths)
_GBM_THREADS = 256

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI = 2.0 * math.pi


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product ``m * x`` for 32-bit
    ``m`` and ``x`` in int64, split so that no intermediate overflows."""
    x_lo = x & 0xFFFF
    x_hi = x >> 16
    t_lo = m * x_lo  # < 2^48
    t_hi = m * x_hi  # < 2^48
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _M32
    hi = ((t_hi + (t_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words.

    ``ctr``: four broadcastable int64 tensors; ``key``: two Python ints.
    Returns the four output words as int64 tensors in [0, 2³²).
    """
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _M32, key[1] & _M32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_key(seed: int):
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return seed & _M32, seed >> 32


def philox_normals(seed: int, n_steps: int, n_paths: int, device="cpu") -> torch.Tensor:
    """The pathgen's standard normals, time-major ``(n_steps, n_paths)`` f32."""
    n_quads = (n_steps + 3) // 4
    j = torch.arange(n_quads, dtype=torch.int64, device=device)[:, None]
    p = torch.arange(n_paths, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x = philox4x32_10((j, p, zero, zero), _seed_key(seed))
    # ((x >> 8) + 1) <= 2^24 converts to f32 exactly
    u = [((xi >> 8) + 1).to(torch.float32) * 2.0 ** -24 for xi in x]
    r0 = torch.sqrt(-2.0 * torch.log(u[0]))
    r1 = torch.sqrt(-2.0 * torch.log(u[2]))
    a0 = u[1] * _TWO_PI
    a1 = u[3] * _TWO_PI
    z = torch.stack([r0 * torch.cos(a0), r0 * torch.sin(a0),
                     r1 * torch.cos(a1), r1 * torch.sin(a1)], dim=1)
    return z.reshape(4 * n_quads, n_paths)[:n_steps]


def _increments(S0, r, sigma, q, T, n_steps):
    dt = float(T) / n_steps
    drift_dt = (float(r) - float(q) - 0.5 * float(sigma) ** 2) * dt
    return float(S0), drift_dt, float(sigma) * math.sqrt(dt)


def _check_scalars(**kw):
    for name, v in kw.items():
        if isinstance(v, torch.Tensor) and v.ndim > 0:
            raise NotImplementedError(
                f"per-step {name} curves are not ported yet (ROADMAP B1 options)")


def gbm_paths_reference(seed: int, S0, r, sigma, q, T, n_steps: int, n_paths: int,
                        device="cpu") -> torch.Tensor:
    """Plain-torch version of the pathgen kernel: time-major
    ``(n_steps+1, n_paths)`` f32 on ``device``."""
    _check_scalars(r=r, sigma=sigma, q=q)
    S0, drift_dt, vol_sdt = _increments(S0, r, sigma, q, T, n_steps)
    z = philox_normals(seed, n_steps, n_paths, device)
    log_inc = drift_dt + vol_sdt * z
    cum = torch.cumsum(log_inc, dim=0)
    first = torch.full((1, n_paths), S0, dtype=torch.float32, device=device)
    return torch.cat([first, S0 * torch.exp(cum)], dim=0)


class GbmPlan(NamedTuple):
    """Kernel 1's launch: ``grid`` blocks of ``threads``; thread g runs the
    ``GBM_PATHS`` consecutive paths from ``GBM_PATHS g`` (the last of the
    ``n_groups`` groups holds ``n_paths - GBM_PATHS (n_groups - 1)``; on a
    smaller grid thread t runs g = t, t + grid threads, ...) and writes
    their row 0, then ``full_quads`` quads of 4 rows, then ``tail`` rows.
    ``scalar``: rows are not 16-byte aligned (``n_paths % 4 != 0``), so each
    path is stored alone. Every field is an argument of the C entry."""

    scalar: bool
    threads: int
    grid: int
    n_groups: int
    full_quads: int
    tail: int


def _gbm_plan(n_paths: int, n_steps: int) -> GbmPlan:
    """The launch plan: a thread a group of paths, blocks enough for all."""
    n_groups = -(-n_paths // GBM_PATHS)
    return GbmPlan(n_paths % GBM_PATHS != 0, _GBM_THREADS, -(-n_groups // _GBM_THREADS),
                   n_groups, n_steps // 4, n_steps % 4)


@functools.lru_cache(maxsize=None)
def _gbm_fn():
    from . import _build

    I, F = ctypes.c_int, ctypes.c_float
    return _build.function("amcx_gbm_paths", [
        ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, I, I, I, I, I, I, I, F, F, F,
        ctypes.c_void_p])


def gbm_paths(seed: int, S0, r, sigma, q, T, n_steps: int, n_paths: int,
              device="cuda") -> torch.Tensor:
    """Time-major ``(n_steps+1, n_paths)`` f32 GBM paths on ``device``.

    On a CUDA device this launches the kernel (``csrc/gbm.cu``) on the
    current stream, or raises; on the CPU it runs
    :func:`gbm_paths_reference`. ``gbm_paths.launches`` counts the kernel
    launches.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return gbm_paths_reference(seed, S0, r, sigma, q, T, n_steps, n_paths, device)
    if device.type != "cuda":
        raise ValueError(f"gbm_paths runs on 'cpu' or 'cuda', got {device}")
    _check_scalars(r=r, sigma=sigma, q=q)
    if not (1 <= n_steps and 1 <= n_paths < 2 ** 31):
        raise ValueError(f"bad shape n_steps={n_steps}, n_paths={n_paths}")
    from . import _build

    key_lo, key_hi = _seed_key(seed)
    S0, drift_dt, vol_sdt = _increments(S0, r, sigma, q, T, n_steps)
    out = torch.empty((n_steps + 1, n_paths), dtype=torch.float32, device=device)
    plan = _gbm_plan(n_paths, n_steps)
    stream = torch._C._cuda_getCurrentRawStream(out.device.index)  # current_stream's handle
    rc = _gbm_fn()(out.data_ptr(), key_lo, key_hi, n_paths, plan.n_groups, plan.full_quads,
                   plan.tail, int(plan.scalar), plan.threads, plan.grid, S0, drift_dt, vol_sdt,
                   stream)
    gbm_paths.launches += 1
    _build.check(rc, "amcx_gbm_paths")
    return out


gbm_paths.launches = 0

"""CCR exposure profile from a pricing's coefficients on the card: the
kernel's wrapper and its plain version.

:func:`ccr_exposures` evaluates the continuation ``Ĉ_t = max(Σ_a c_{t,a}
B_a((S_t − μ_t)·inv_std_t), 0)`` of every step on the paths, in kernel 2's
own order (``csrc/lsmc_mega.cu``'s fit), and reduces each step at once to
its EPE (the f64 sum of the finite values over their count, rounded once
to f32) and its PFE-5 and PFE-95 (amcx's linear-interpolation percentile,
`amcx_torch.exposures.step_profile`); the surface is never stored. On f32
paths on a CUDA device it is one call of ``csrc/ccr_exposures.cu`` (exact
selection from a sample's windows in one pass over the paths, with an exact
fallback; see the note there), on any other device or dtype
:func:`ccr_exposures_reference`, which sorts each step. The two agree to
the bit on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..basis import BASIS_IDS, basis_cols
from ..exposures import step_profile
from .lsmc_megakernel import MAX_DEGREE

__all__ = ["ccr_exposures", "ccr_exposures_reference"]


class CcrParams(ctypes.Structure):
    """``struct CcrParams`` of ``csrc/ccr_exposures.cu``, handed to the
    kernel by value."""

    _fields_ = [("n_steps", ctypes.c_int), ("n_paths", ctypes.c_int), ("basis", ctypes.c_int)]


def _fit(S, coef, mean, inv_std, basis, degree):
    # kernel 2's plain fit (ops/lsmc_megakernel.py _mega_reference)
    cols = basis_cols((S - mean) * inv_std, basis, degree)
    fitted = cols[0] * coef[0]
    for a in range(1, degree + 1):
        fitted = fitted + cols[a] * coef[a]
    return torch.clamp_min(fitted, 0.0)


def ccr_exposures_reference(paths_tm, coeffs, mean_t, inv_std_t, basis="chebyshev",
                            degree=4) -> torch.Tensor:
    """:func:`ccr_exposures`' plain version, on any device and in the
    paths' float dtype: each step's continuation evaluated in full, then
    `amcx_torch.exposures.step_profile`."""
    paths, coeffs, mean_t, inv_std_t = _checked(paths_tm, coeffs, mean_t, inv_std_t, basis,
                                                degree)
    n_steps = paths.shape[0] - 1
    out = torch.zeros((3, n_steps + 1), dtype=paths.dtype, device=paths.device)
    for t in range(n_steps):
        out[:, t] = step_profile(_fit(paths[t], coeffs[t], mean_t[t], inv_std_t[t], basis,
                                      degree))
    return out


@functools.lru_cache(maxsize=None)
def _ccr_fn():
    from . import _build

    Vp = ctypes.c_void_p
    return _build.function("amcx_ccr_exposures", [ctypes.POINTER(CcrParams)] + [Vp] * 5
                           + [ctypes.c_longlong, Vp, ctypes.c_int, Vp])


@functools.lru_cache(maxsize=None)
def _scratch_bytes(n_steps: int, n_paths: int) -> int:
    from . import _build

    fn = _build.function("amcx_ccr_scratch_bytes",
                         [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)])
    n = ctypes.c_longlong(0)
    _build.check(fn(n_steps, n_paths, ctypes.byref(n)), "amcx_ccr_scratch_bytes")
    return n.value


def _ccr_cuda(paths, coeffs, mean_t, inv_std_t, basis, degree):
    from . import _build

    n_steps, n_paths = paths.shape[0] - 1, paths.shape[1]
    dev = paths.device
    # the kernel's counts, samples, candidates and partials (~45 MB at 100
    # steps; 256-byte aligned by the caching allocator); it zeroes the
    # counts on the stream
    scratch = torch.empty(_scratch_bytes(n_steps, n_paths), dtype=torch.uint8, device=dev)
    out = torch.empty((3, n_steps + 1), dtype=torch.float32, device=dev)
    params = CcrParams(n_steps=n_steps, n_paths=n_paths, basis=BASIS_IDS[basis])
    rc = _ccr_fn()(ctypes.byref(params), paths.data_ptr(), coeffs.data_ptr(), mean_t.data_ptr(),
                   inv_std_t.data_ptr(), scratch.data_ptr(), scratch.numel(), out.data_ptr(),
                   degree, torch.cuda.current_stream(dev).cuda_stream)
    ccr_exposures.launches += 1
    _build.check(rc, "amcx_ccr_exposures")
    return out


def _checked(paths_tm, coeffs, mean_t, inv_std_t, basis, degree):
    basis = basis.strip().lower()
    if basis not in BASIS_IDS:
        raise ValueError(f"Unknown basis type {basis!r}")
    if not 0 <= degree <= MAX_DEGREE:
        raise ValueError(f"degree must lie in 0..{MAX_DEGREE}, got {degree}")
    if paths_tm.ndim != 2 or paths_tm.shape[0] < 2 or not paths_tm.dtype.is_floating_point:
        raise ValueError(
            f"paths must be time-major (n_steps+1, n_paths) floats, got "
            f"{tuple(paths_tm.shape)} {paths_tm.dtype}")
    n_steps = paths_tm.shape[0] - 1
    dev, dtype = paths_tm.device, paths_tm.dtype
    coeffs, mean_t, inv_std_t = (torch.as_tensor(a, device=dev).to(dtype).contiguous()
                                 for a in (coeffs, mean_t, inv_std_t))
    if coeffs.shape != (n_steps + 1, degree + 1):
        raise ValueError(f"coeffs must be (n_steps+1, degree+1) = {(n_steps + 1, degree + 1)}, "
                         f"got {tuple(coeffs.shape)}")
    if mean_t.shape != (n_steps + 1,) or inv_std_t.shape != (n_steps + 1,):
        raise ValueError("mean_t and inv_std_t must be (n_steps+1,) rows")
    return paths_tm.contiguous(), coeffs, mean_t, inv_std_t


def ccr_exposures(paths_tm: torch.Tensor, coeffs, mean_t, inv_std_t, basis: str = "chebyshev",
                  degree: int = 4) -> torch.Tensor:
    """``(3, n_steps+1)`` rows ``[EPE, PFE-5, PFE-95]`` of the continuation
    that the coefficients ``(n_steps+1, degree+1)`` and the frame rows
    ``mean_t``/``inv_std_t`` give on the time-major paths ``(n_steps+1,
    n_paths)``, in the paths' dtype; the maturity column is zero. On f32
    paths on a CUDA device the kernel (``ccr_exposures.launches`` counts its
    calls), on any other :func:`ccr_exposures_reference`."""
    if paths_tm.device.type != "cuda" or paths_tm.dtype != torch.float32:
        return ccr_exposures_reference(paths_tm, coeffs, mean_t, inv_std_t, basis, degree)
    paths, coeffs, mean_t, inv_std_t = _checked(paths_tm, coeffs, mean_t, inv_std_t, basis,
                                                degree)
    if paths.shape[0] - 1 > 65535 or paths.shape[1] >= 2 ** 31:
        raise ValueError(f"the kernel takes n_steps <= 65535 and n_paths < 2^31, "
                         f"got {tuple(paths.shape)}")
    return _ccr_cuda(paths, coeffs, mean_t, inv_std_t, basis.strip().lower(), degree)


ccr_exposures.launches = 0

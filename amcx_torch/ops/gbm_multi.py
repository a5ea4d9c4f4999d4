"""Correlated multi-asset GBM paths from given normals: the CUDA kernel's
wrapper and its plain version.

The kernel lives in ``amcx_torch/csrc/gbm_multi.cu``. It replaces the torch
operations that follow ``torch.randn`` in
`amcx_torch.paths.simulate_gbm_multi`; amcx builds the same paths with XLA
operations (no Pallas kernel). :func:`gbm_multi_paths_reference` is that
chain of torch operations, on any device and differentiable in tensor
inputs; on the card the kernel gives its bits.

The kernel's scalars travel by value: :func:`host_rows` forms the per-asset
rows S0, drift and scale on the host in f32, in the chain's order, so a
launch makes no copy from the host and no synchronise. It therefore takes
only host values (Python numbers, numpy arrays, CPU tensors that need no
grad), and raises on what it does not take. A caller that needs autograd
through the paths asks for :func:`gbm_multi_paths_reference` itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

__all__ = ["MAX_ASSETS", "gbm_multi_paths", "gbm_multi_paths_reference", "host_rows"]

MAX_ASSETS = 8  # csrc/gbm_multi.cu kMaxAssets


def _chain_rows(S0, r, sigma, q, T, n_steps: int, dtype, device):
    """The chain's per-asset rows ``S0``, ``drift = (r − q − σ²/2)·dt`` and
    ``scale = σ·√dt`` with ``dt = T / n_steps``, as tensors on ``device``
    (``as_tensor`` keeps a tensor's autograd graph)."""
    S0 = torch.atleast_1d(torch.as_tensor(S0, dtype=dtype, device=device))

    def vec(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device), S0.shape)

    r, sigma, q = vec(r), vec(sigma), vec(0.0 if q is None else q)
    dt = torch.as_tensor(T, dtype=dtype, device=device) / n_steps
    drift = (r - q - 0.5 * sigma ** 2) * dt
    return S0, drift, sigma * torch.sqrt(dt)


def gbm_multi_paths_reference(Z: torch.Tensor, S0, r, sigma, q, T, corr=None) -> torch.Tensor:
    """Plain-torch version of :func:`gbm_multi_paths` on ``Z``'s device and
    dtype: ``W`` (``Z``, or ``W_b = Σ_{a≤b} Z_a L[b, a]`` with L the Cholesky
    factor of ``corr``, in elementwise products so no matrix product and no
    TF32 setting reaches the paths), the log increments ``drift + scale·W``,
    their ``torch.cumsum`` over the steps after a zero row, ``exp`` and the
    product with S0. Differentiable in tensor inputs."""
    n_steps, n_paths, n_assets = Z.shape
    dtype, device = Z.dtype, Z.device
    S0, drift, scale = _chain_rows(S0, r, sigma, q, T, n_steps, dtype, device)
    W = Z
    if corr is not None:
        L = torch.linalg.cholesky(torch.as_tensor(corr, dtype=dtype, device=device))
        cols = []
        for b in range(n_assets):
            w_b = Z[..., 0] * L[b, 0]
            for a in range(1, b + 1):
                w_b = w_b + Z[..., a] * L[b, a]
            cols.append(w_b)
        W = torch.stack(cols, dim=-1)
    log_inc = drift + scale * W
    log_rel = torch.cat([torch.zeros((1, n_paths, n_assets), dtype=dtype, device=device),
                         torch.cumsum(log_inc, dim=0)], dim=0)
    return S0 * torch.exp(log_rel)


def host_rows(S0, r, sigma, q, T, n_steps: int) -> np.ndarray:
    """The rows of :func:`gbm_multi_paths_reference` on a CUDA tensor, formed
    on the host in f32: a ``(3, n_assets)`` float32 array of S0, drift and
    scale. Each numpy f32 operation rounds as the card's does. torch divides
    a CUDA tensor by a host scalar as the product with the scalar's f32
    reciprocal (ATen's ``div_true_kernel_cuda``), so ``dt = f32(T) ·
    (1 / f32(n_steps))``; on the CPU torch divides, and there the two
    ``dt`` can differ in the last place."""
    f32 = np.float32
    S0 = np.atleast_1d(np.asarray(S0, dtype=f32))
    r, sigma, q = (np.asarray(x, dtype=f32) for x in (r, sigma, 0.0 if q is None else q))
    dt = np.asarray(T, dtype=f32) * (f32(1.0) / f32(n_steps))
    rows = np.empty((3, S0.shape[0]), dtype=f32)  # each row broadcasts per asset
    rows[0] = S0
    rows[1] = (r - q - f32(0.5) * (sigma * sigma)) * dt
    rows[2] = sigma * np.sqrt(dt)
    return rows


def _refusal(Z: torch.Tensor, S0, r, sigma, q, T, corr=None) -> Optional[str]:
    """Why :func:`gbm_multi_paths` cannot launch the kernel on these inputs
    (whatever their device), or None: ``Z`` must be contiguous
    ``(n_steps ≥ 1, 1 ≤ n_paths < 2³¹, 1..MAX_ASSETS)`` float32, and S0, r,
    sigma, q and T host values that need no grad (a device tensor's value
    would need a copy that waits for the stream); ``corr`` may lie anywhere
    but needs no grad."""
    if Z.ndim != 3 or Z.dtype != torch.float32 or not Z.is_contiguous():
        return (f"normals must be contiguous (n_steps, n_paths, n_assets) float32, got "
                f"{tuple(Z.shape)} {Z.dtype}{'' if Z.is_contiguous() else ' non-contiguous'}")
    n_steps, n_paths, n_assets = Z.shape
    if not (n_steps >= 1 and 1 <= n_paths < 2 ** 31 and 1 <= n_assets <= MAX_ASSETS):
        return (f"the kernel takes n_steps >= 1, 1 <= n_paths < 2^31 and 1..{MAX_ASSETS} "
                f"assets, got {tuple(Z.shape)}")
    for name, v in (("S0", S0), ("r", r), ("sigma", sigma), ("q", q), ("T", T)):
        if isinstance(v, torch.Tensor) and (v.device.type != "cpu" or v.requires_grad):
            return (f"{name} must be a host value that needs no grad, got a tensor on "
                    f"{v.device} with requires_grad={v.requires_grad}")
    if isinstance(corr, torch.Tensor) and corr.requires_grad:
        return "corr must need no grad"
    return None


def gbm_multi_paths(Z: torch.Tensor, S0, r, sigma, q, T, corr=None) -> torch.Tensor:
    """Time-major ``(n_steps+1, n_paths, n_assets)`` GBM paths from the
    time-major standard normals ``Z`` ``(n_steps, n_paths, n_assets)``:
    row 0 is S0, each later row ``S0 · exp(Σ (drift + scale·W))``, with
    ``W`` as in :func:`gbm_multi_paths_reference` (``corr``: the asset
    correlation matrix, identity if None).

    On a CUDA tensor this launches the kernel of ``csrc/gbm_multi.cu`` once,
    with no copy from the host and no synchronise, or raises where the
    kernel cannot take the inputs (a non-contiguous or non-float32 ``Z``,
    more than ``MAX_ASSETS`` assets, a device tensor or one that needs grad
    among S0, r, sigma, q and T); on a CPU tensor it runs
    :func:`gbm_multi_paths_reference`. ``gbm_multi_paths.launches`` counts
    the kernel launches.
    """
    if Z.device.type == "cpu":
        return gbm_multi_paths_reference(Z, S0, r, sigma, q, T, corr)
    why = _refusal(Z, S0, r, sigma, q, T, corr)
    if why is not None:
        raise ValueError(f"gbm_multi_paths: {why}")
    if Z.device.type != "cuda":
        raise ValueError(f"gbm_multi_paths runs on 'cpu' or 'cuda', got {Z.device}")
    from . import _build

    n_steps, n_paths, n_assets = Z.shape
    rows = host_rows(S0, r, sigma, q, T, n_steps)
    if rows.shape != (3, n_assets):
        raise ValueError(f"S0, r, sigma and q must give {n_assets} assets, got {rows.shape[1]}")
    chol = None
    if corr is not None:
        chol = torch.linalg.cholesky(
            torch.as_tensor(corr, dtype=torch.float32, device=Z.device)).contiguous()
        if chol.shape != (n_assets, n_assets):
            raise ValueError(f"corr must be ({n_assets}, {n_assets}), got {tuple(chol.shape)}")
    out = torch.empty((n_steps + 1, n_paths, n_assets), dtype=torch.float32, device=Z.device)
    rc = _gbm_multi_fn()(Z.data_ptr(), out.data_ptr(), None if chol is None else chol.data_ptr(),
                         rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_steps, n_paths,
                         n_assets, torch._C._cuda_getCurrentRawStream(Z.device.index))
    gbm_multi_paths.launches += 1
    if rc:
        _build.check(rc, "amcx_gbm_multi_paths")
    return out


gbm_multi_paths.launches = 0


@functools.lru_cache(maxsize=None)
def _gbm_multi_fn():
    from . import _build

    V, I = ctypes.c_void_p, ctypes.c_int
    return _build.function("amcx_gbm_multi_paths",
                           [V, V, V, ctypes.POINTER(ctypes.c_float), I, I, I, V])

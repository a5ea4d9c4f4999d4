"""The warp-parallel ridge-Cholesky solve's operation order, on the CPU.

``csrc/lsmc_common.cuh`` ``warp_solve_equilibrated_ridge`` solves the
multi-asset induction's m x m system on the 32 lanes of one warp: a
right-looking factor, a column-oriented forward substitution, a serial back
substitution and row-parallel residuals. It must give the bits of the
one-thread routine it replaces, whose plain version is
``amcx_torch.ops.lsmc_megakernel._solve_equilibrated_ridge``. A CUDA kernel
cannot run here, so this file holds a numpy-f32 transcription of the warp
schedule (each element's operations in the kernel's order) to that plain
version, bit for bit, on seeded well- and ill-conditioned packed Grams; and
amcx's own JAX solve (eager, on the CPU) to the same plain version.
"""

import numpy as np
import pytest
import torch

from amcx.ops import lsmc_megakernel as amcx_mega
from amcx_torch.ops import lsmc_megakernel as tmega

F32 = np.float32
TINY = F32(1e-30)
RCOND = 1e-6
KS = list(range(1, 12)) + [16, 21, 28, 32]


def _packed(k, seed, conditioning):
    """The packed ``[G upper triangle..., b...]`` f32 moments of a seeded
    design: Gaussian columns (well conditioned) or the powers of a uniform
    draw on [0, 1], a Hilbert-like Gram (ill conditioned: cond far past f32's
    reach from k ~ 6 on)."""
    rng = np.random.default_rng(1000 * seed + k)
    n = 512
    if conditioning == "well":
        X = rng.standard_normal((n, k))
    else:
        X = rng.uniform(0.0, 1.0, n)[:, None] ** np.arange(k)[None, :]
    y = X @ rng.standard_normal(k) + 0.1 * rng.standard_normal(n)
    G = X.T @ X
    b = X.T @ y
    pairs = [G[i, j] for i in range(k) for j in range(i, k)]
    return np.asarray(pairs + list(b), dtype=F32)


def _pair(k, a, b):
    return a * k - a * (a - 1) // 2 + (b - a)


def _sqrt(x):
    # the plain version's square root: torch's f32 sqrt on the CPU is not
    # always correctly rounded (numpy's is; they differed by an ulp on these
    # Grams), while on the card both the kernel's sqrtf and torch's are.
    # Every other operation here is one IEEE f32 operation, as in torch.
    return F32(torch.sqrt(torch.tensor(x, dtype=torch.float32)).item())


def _warp_schedule(packed, k, rcond):
    """The warp kernel's schedule in numpy f32, element by element."""
    rc = F32(rcond)
    d = [F32(1.0) / _sqrt(np.maximum(packed[_pair(k, i, i)], TINY)) for i in range(k)]
    Gnr = [[packed[_pair(k, min(i, j), max(i, j))] * d[i] * d[j] for j in range(k)]
           for i in range(k)]
    L = [[Gnr[i][j] + (rc if i == j else F32(0.0)) for j in range(k)] for i in range(k)]
    # right-looking factor: column m final, then the trailing entries
    for m in range(k):
        L[m][m] = _sqrt(np.maximum(L[m][m], TINY))
        for i in range(m + 1, k):
            L[i][m] = L[i][m] / L[m][m]
        for i in range(m + 1, k):
            for j in range(m + 1, i + 1):
                L[i][j] = L[i][j] - L[i][m] * L[j][m]

    def chol_solve(rhs):
        s = list(rhs)
        z = [F32(0.0)] * k
        for m in range(k):  # column-oriented forward substitution
            z[m] = s[m] / L[m][m]
            for i in range(m + 1, k):
                s[i] = s[i] - L[i][m] * z[m]
        c = [F32(0.0)] * k
        for r in reversed(range(k)):  # the serial back substitution of lane 0
            acc = z[r]
            for m in range(r + 1, k):
                acc = acc - L[m][r] * c[m]
            c[r] = acc / L[r][r]
        return c

    b = [packed[k * (k + 1) // 2 + i] * d[i] for i in range(k)]
    c = chol_solve(b)
    for _ in range(2):
        resid = []
        for i in range(k):  # lane i's residual row
            acc = F32(0.0)
            for j in range(k):
                acc = acc + Gnr[i][j] * c[j]
            resid.append(b[i] - acc)
        dc = chol_solve(resid)
        c = [c[i] + dc[i] for i in range(k)]
    return np.asarray([c[i] * d[i] for i in range(k)], dtype=F32)


def _plain(packed, k):
    coef = tmega._solve_equilibrated_ridge(list(torch.from_numpy(packed)), k, RCOND)
    return torch.stack(coef).numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", KS)
def test_warp_schedule_equals_plain_solve(k, seed):
    # the same f32 operations in the same order per element: identical bits
    with np.errstate(all="ignore"):
        for conditioning in ("well", "ill"):
            packed = _packed(k, seed, conditioning)
            warp = _warp_schedule(packed, k, RCOND)
            plain = _plain(packed, k)
            assert np.isfinite(plain).all()
            assert warp.tobytes() == plain.tobytes(), conditioning


@pytest.mark.parametrize("k", [1, 5, 21, 32])
def test_warp_schedule_zero_gram(k):
    # the degenerate t = 0 at S0 == K with ITM weights: an exactly-zero
    # system gives exactly-zero coefficients in both
    packed = np.zeros(k * (k + 1) // 2 + k, dtype=F32)
    warp = _warp_schedule(packed, k, RCOND)
    assert warp.tobytes() == _plain(packed, k).tobytes()
    assert not warp.any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [k for k in KS if k <= 21])
def test_plain_solve_matches_amcx(k, seed):
    # amcx's solve (jax.lax.rsqrt, XLA's f32 ops one at a time) against the
    # port's plain version (1 / sqrt): the reciprocal square roots may differ
    # by an ulp, which the factor carries into every coefficient. Well
    # conditioned: rtol 1e-4 of the largest coefficient. The ill-conditioned
    # Gram is past f32's reach there; the two stay finite.
    import jax.numpy as jnp

    for conditioning in ("well", "ill"):
        packed = _packed(k, seed, conditioning)
        ref = np.asarray([float(c) for c in amcx_mega._solve_equilibrated_ridge(
            jnp.asarray(packed), k, RCOND)], dtype=F32)
        plain = _plain(packed, k)
        assert np.isfinite(ref).all() and np.isfinite(plain).all()
        if conditioning == "well":
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-4 * scale)

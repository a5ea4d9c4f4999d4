"""A one-asset step whose moments tell the two definitions apart: exact
products of the f32 columns summed in f64 and rounded once (the port's), or
f32 products summed in f64 (the definition before it).

Columns [1, x] (power basis, degree 1) with x = s exactly (frame mean 0,
inverse std 1), payoff ``first`` with K = -2, y the regression target:

- group A: x = a = 1 + 2^-12 + 2^-23, y = a (in the money);
- group B: x = -c, c the f32 below a, y = a (in the money);
- group C: x = -3, y = 0 (out of the money).

The rhs Σ x y cancels to a (a - c) a path of A and B, 2^-23 a, while f32(a²) -
f32(c a) is 2^-23: the f32 products miss the sum by 2^-12 of itself. Shared by
the CPU tests and the card tests (which import no jax).
"""

import numpy as np
import torch

A_VAL = np.float32(1.0 + 2.0 ** -12 + 2.0 ** -23)
C_VAL = np.nextafter(A_VAL, np.float32(0.0))
STRIKE = -2.0
STEP_KW = dict(K=STRIKE, phi=1.0, basis="power", degree=1, mode="total", sorted_basis=False,
               payoff_kind="first")


def groups(n_a, n_b, n_c):
    """The step's x and y (f32 numpy) and the maturity spots whose ``first``
    payoff at K = -2 is y."""
    x = np.concatenate([np.full(n_a, A_VAL), np.full(n_b, -C_VAL),
                        np.full(n_c, np.float32(-3.0))]).astype(np.float32)
    y = np.concatenate([np.full(n_a + n_b, A_VAL), np.zeros(n_c, np.float32)])
    s_T = np.concatenate([np.full(n_a + n_b, A_VAL - np.float32(2.0)),
                          np.full(n_c, np.float32(-5.0))]).astype(np.float32)
    return x, y.astype(np.float32), s_T


def step_inputs(n_a, n_b, n_c, device, t=0, n_steps=1):
    """Kernel 8's inputs at step t: the (1, n) plane, the stats rows (frame
    mean 0, inverse std 1, c_t = 1, allow 1) and cf = y (``direct_y``)."""
    x, y, _ = groups(n_a, n_b, n_c)
    stats = np.zeros((5, n_steps + 1), np.float32)
    stats[1:, :] = 1.0
    return (torch.from_numpy(x[None]).to(device), torch.from_numpy(stats).to(device),
            torch.from_numpy(y).to(device))


def maturity_paths(n_a, n_b, n_c, device):
    """Time-major (2, n, 1) paths of a one-step induction: x at step 0, the
    spots paying y at step 1."""
    x, _, s_T = groups(n_a, n_b, n_c)
    return torch.from_numpy(np.stack([x, s_T])[:, :, None].copy()).to(device)


def f32_product_moments(cols, y, w):
    """The moments with each product rounded to f32 before its f64 sum."""
    cols_w = cols if w is None else [c * w for c in cols]
    yw = y if w is None else y * w
    m = len(cols)
    out = [torch.sum(cols_w[i] * cols[j], dtype=torch.float64) for i in range(m)
           for j in range(i, m)]
    out += [torch.sum(cols[i] * yw, dtype=torch.float64) for i in range(m)]
    return torch.stack(out).to(torch.float32)


def exact_moments_numpy(cols, y, w):
    """The moments as numpy computes them: float64 products of the f32
    columns (exact), a float64 sum, rounded once to f32."""
    c = [np.asarray(v.cpu().numpy(), np.float64) for v in cols]
    w64 = 1.0 if w is None else np.asarray(w.cpu().numpy(), np.float64)
    yw = np.asarray(y.cpu().numpy(), np.float64) * w64
    m = len(c)
    out = [np.sum(c[i] * w64 * c[j]) for i in range(m) for j in range(i, m)]
    out += [np.sum(c[i] * yw) for i in range(m)]
    return np.asarray(out).astype(np.float32)

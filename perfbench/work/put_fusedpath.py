"""Work of ``put_fusedpath``: no path array; the induction reads the 4
per-step rows and writes two sums. Per path-step: a quarter of a
Philox4x32-10 call (25 integer operations, counted as 50 f32 slots since an
SM has half as many INT32 lanes), half a Box-Muller pair (8), the bridge
multiply-add (3), the spot (4), the P pair products in f32 and their f64
sums, and the 2k - 1 operations of the fit."""

from .put_mega import pair_products


def work(cfg: dict) -> dict:
    n, T = cfg["n_paths"], cfg["n_steps"]
    k = cfg["regression"]["degree"] + 1
    P = pair_products(k)
    return {"induction": {"bytes": 4 * (T + 1) * 4 + 2 * 4,
                          "f32": T * n * (2 * 25 + 8 + 3 + 4 + P + 2 * k - 1),
                          "f64": T * n * P}}

"""Work of ``ccr_put_mega``: the pathgen and the all-paths induction as
``put_mega`` counts them; the analytics layer (the exposure kernel) reads
the paths of the n_steps dates before maturity once, the coefficient and
frame rows, and writes the three (n_steps + 1) rows, and per path-step
evaluates the fit (the standardized spot, the Chebyshev recurrence's 3
operations a column past the second, k products and k - 1 sums, the clamp)
in f32 and adds it to EPE's f64 sum."""

from .put_mega import work as put_work


def analytics_f32(k: int) -> int:
    return 2 + 3 * max(k - 2, 0) + 2 * k


def work(cfg: dict) -> dict:
    n, T = cfg["n_paths"], cfg["n_steps"]
    k = cfg["regression"]["degree"] + 1
    out = put_work(cfg)
    out["analytics"] = {"bytes": T * n * 4 + (T + 1) * (k + 2) * 4 + 3 * (T + 1) * 4,
                        "f32": T * n * analytics_f32(k), "f64": T * n}
    return out

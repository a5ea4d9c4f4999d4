"""Work of ``maxcall_mega``: the pathgen writes the (n_steps + 1, n_paths,
n_assets) f32 paths once, ~6 f32 operations a path-step-asset; the
induction reads every date's asset planes once, and per path and step forms
the P = m(m+1)/2 + m pair products of the m cross terms in f32 and sums them
in f64, and on each exercise date evaluates the fit in 2m - 1 operations."""

from math import comb


def work(cfg: dict) -> dict:
    n, T = cfg["n_paths"], cfg["n_steps"]
    A = len(cfg["market"]["S0"])
    d = cfg["regression"]["degree"]
    m = comb(A + d, d)
    P = m * (m + 1) // 2 + m
    n_ex = T - cfg["product"]["exercise_from_step"]
    path_bytes = (T + 1) * n * A * 4
    return {
        "pathgen": {"bytes": path_bytes, "f32": 6 * T * n * A},
        "induction": {"bytes": path_bytes, "f32": n * (T * P + n_ex * (2 * m - 1)),
                      "f64": T * n * P},
    }

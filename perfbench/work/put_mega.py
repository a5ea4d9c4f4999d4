"""Work of ``put_mega``: the pathgen writes the (n_steps + 1, n_paths) f32
path array once, ~6 f32 operations a path-step (Box-Muller's share, the log
increment, the exp); the induction reads the paths and the 4 per-step frame
and discount rows once, and per path-step forms the P = k(k+1)/2 + k pair
products in f32, sums them in f64, and evaluates the fit in 2k - 1 f32
operations (k = degree + 1)."""


def pair_products(k: int) -> int:
    return k * (k + 1) // 2 + k


def work(cfg: dict) -> dict:
    n, T = cfg["n_paths"], cfg["n_steps"]
    k = cfg["regression"]["degree"] + 1
    P = pair_products(k)
    path_bytes = (T + 1) * n * 4
    return {
        "pathgen": {"bytes": path_bytes, "f32": 6 * T * n},
        "induction": {"bytes": path_bytes + 4 * (T + 1) * 4, "f32": T * n * (P + 2 * k - 1),
                      "f64": T * n * P},
    }

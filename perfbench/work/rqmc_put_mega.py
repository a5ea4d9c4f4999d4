"""Work of ``rqmc_put_mega``: the pathgen (kernel 11 in bridge order) reads
the two XOR tables once, u_hi (n_steps, n_paths / 512) and u_lo (n_steps,
512) of 4 bytes, and writes the (n_steps + 1, n_paths) f32 path array once;
per path-step ~62 f32 operations (the uniform, Acklam's two rational forms
with their log and sqrt, exp, the S0 product) and per path the bridge
product's 2 operations on each nonzero of B (``bridge_nonzeros``); the
induction as ``put_mega`` counts it."""

from .put_mega import work as put_work


def bridge_nonzeros(n_steps: int) -> int:
    """Nonzeros of the bisection matrix B: the midpoint of each interval
    (of at least two steps) depends on the dimensions its two ends depend
    on and on its own, W_T on dimension 0."""
    deps = {0: frozenset(), n_steps: frozenset({0})}
    level, j = [(0, n_steps)], 1
    while level:
        below = []
        for left, right in level:
            if right - left < 2:
                continue
            m = (left + right) // 2
            deps[m] = deps[left] | deps[right] | {j}
            j += 1
            below += [(left, m), (m, right)]
        level = below
    return sum(len(deps[t]) for t in range(1, n_steps + 1))


def work(cfg: dict) -> dict:
    n, T = cfg["n_paths"], cfg["n_steps"]
    out = put_work(cfg)
    out["pathgen"] = {"bytes": (T + 1) * n * 4 + T * (n // 512 + 512) * 4,
                      "f32": 62 * T * n + 2 * bridge_nonzeros(T) * n}
    return out

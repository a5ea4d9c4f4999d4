"""Rules for holding an amcx run and an amcx_torch run of LSMC on shared
paths to each other (imported by the port's parity tests).

Early exercise makes f32 LSMC chaotic. Two implementations that sum in
different orders agree to ~1e-6 until, at some step t*, one path sits so
close to the exercise boundary that the two disagree on it. That flip
changes the regression target of every later (earlier-in-time) step, more
paths flip, and at 8192 paths the prices end up 1e-3..2e-2 apart (a 1e-7
relative nudge to the closed-form frame moves the 8192 x 16 ITM put by
~6e-3). So an American case with flips is held to:
- the per-step tolerance (coefficient or continuation rows) on every row
  the flips cannot reach (t >= t*);
- the price tolerance on the price difference that the paths with
  different exercise decisions do not explain;
- a bound on the number of such paths, which the test counts and reports.
A case without flips, and every European case, is held to all tolerances
directly.
"""

import numpy as np

import amcx_torch as at


def first_divergence(dec_j, dec_t):
    """``(t*, n)``: the largest step t* at which the two (n_steps, n_paths)
    exercise decision arrays differ and on how many paths, or (None, 0)."""
    diff = np.asarray(dec_j) != np.asarray(dec_t)
    steps = np.nonzero(diff.any(axis=1))[0]
    if not steps.size:
        return None, 0
    return int(steps.max()), int(diff[steps.max()].sum())


def first_divergence_tau(tau_j, tau_t):
    """``(t*, n)`` from two (n_paths,) exercise-step planes, for runs that
    export no per-step rows (the book): a path whose recorded exercise
    steps differ was decided differently at the later-in-time of its two
    steps or earlier, so t* is the largest such step min(τ_j, τ_t) over the
    paths that differ, and n the paths that part there; (None, 0) if the
    planes are equal."""
    tau_j, tau_t = np.asarray(tau_j), np.asarray(tau_t)
    differ = tau_j != tau_t
    if not differ.any():
        return None, 0
    parted = np.minimum(tau_j, tau_t)[differ]
    return int(parted.max()), int((parted == parted.max()).sum())


def hold_pair(what, price_j, price_t, se_j, se_t, rows_j, rows_t, first, v_j, v_t, price_tol):
    """Hold an amcx/port pair to the module docstring's rules. ``rows_*``:
    per-step coefficient or continuation rows indexed by t (None where the
    runs export none); ``first``: `first_divergence` or
    `first_divergence_tau`; ``v_*``: per-path discounted values (f64)."""
    t_star, n_first = first
    if rows_j is not None:
        scale = np.abs(rows_j).max()
        # rows: 1e-3 of the largest entry (f32 solves of the same moments
        # summed in different orders)
        rows = slice(t_star, None) if t_star is not None else slice(None)
        np.testing.assert_allclose(rows_t[rows], rows_j[rows], rtol=0, atol=1e-3 * scale)
    d_price = float(price_t) - float(price_j)
    if t_star is None:
        assert abs(d_price) <= price_tol, (what, d_price)
        np.testing.assert_allclose(float(se_t), float(se_j), rtol=1e-3)  # f32 sums
        return
    n_paths = v_j.shape[0]
    differ = np.abs(v_t - v_j) > 1e-5 * (1.0 + np.abs(v_j))
    n_diff = int(differ.sum())
    flip_part = float((v_t - v_j)[differ].sum()) / n_paths
    msg = (f"{what}: first decision flip at t={t_star} on {n_first} path(s); {n_diff} of "
           f"{n_paths} paths end with another exercise decision; price |d| "
           f"{abs(d_price):.2e}, of which {abs(flip_part):.2e} from those paths")
    print(msg)
    # where the rows agree to f32 noise only near-ties can flip: a handful
    assert n_first <= 2 + n_paths // 1000, msg
    # the cascade after it stays a minority of paths (measured 1-7% at 8k-16k
    # paths); a wrong exercise rule would move most exercised paths
    assert n_diff <= n_paths // 10, msg
    assert abs(d_price - flip_part) <= price_tol, msg


def hold_engine_pair(what, paths, jres, tres, prod, r, exercise_steps=None, price_tol=1e-4,
                     rows="coeffs"):
    """Hold two `LSMCResult`s with continuation surfaces and cf/τ on the
    numpy ``paths``: exercise decisions from each side's own surface, and
    the per-step ``rows`` ("coeffs" or "continuation") before the first
    flip."""
    n_steps = paths.shape[0] - 1
    S = at.tensor_from_numpy(paths, device="cpu")
    ex = at.intrinsic_value(S[:-1], prod.K, prod.option_type)
    gate = at.barrier_gate(S, prod.barrier, prod.barrier_type)[:-1] & (ex > 0)
    if exercise_steps is not None:
        gate &= at.exercise_allow_row(exercise_steps, n_steps)[:-1, None]

    def decide(cont):
        if not prod.is_american:
            return np.zeros(gate.shape, bool)
        return (gate & (ex > at.tensor_from_numpy(np.asarray(cont), device="cpu")[:-1])).numpy()

    first = first_divergence(decide(jres.continuation), decide(tres.continuation))
    dt = prod.T / n_steps

    def values(res):
        return (np.asarray(res.cashflows, np.float64)
                * np.exp(-r * dt * np.asarray(res.exercise_times, np.float64)))

    hold_pair(what, jres.price, tres.price, jres.stderr, tres.stderr,
              np.asarray(getattr(jres, rows)), np.asarray(getattr(tres, rows)), first,
              values(jres), values(tres), price_tol)

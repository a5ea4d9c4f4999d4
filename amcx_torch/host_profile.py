"""Host time of the fused engines' step wrappers and loops, by part.

Run from the root of a checkout on a machine with a CUDA card:

    python3 -m amcx_torch.host_profile [--calls 2000] [--label NAME]

On the flagship put (1,048,576 Philox paths x 100 steps, S0 = K = 100,
r = 1%, sigma = 20%, T = 1, Chebyshev degree 4, ITM fit; step t = 50) and
the 5-asset Bermudan max-call (1,048,576 paths, 9 dates, sorted degree-2
basis, m = 21; step t = 5), by the host clock (``time.perf_counter_ns``):

- per call, over ``--calls`` calls with no sync between them: the public
  wrappers of kernels 5 (``step_apply``, with and without a surface row)
  and 9 (``ma_step_apply``), and their parts: the input checks, the stream
  handle, the C entry called with a grid of 0 blocks (argument conversion
  and the entry's checks, no launch) and with its grid (the launch too);
- one step of each fused induction by part, the route itself run with its
  module's step functions wrapped in timers (:func:`route_split`): the
  moments call, ``unpack_moments``, ``pinv_solve`` (which waits for the
  card inside ``eigh``) and the apply (the loop's launcher where the engine
  has one, else the public wrapper on the step's rows);
- each fused induction on given paths, to a sync.

It prints one JSON line with the card's name and power limit. It runs on
any version of the port since kernel 9 landed, so two checkouts can be
compared in one call (the parts that a version lacks are left out).
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import statistics
import subprocess
import time


def _per_call_us(torch, fn, calls):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def route_split(module, parts, run, reps=3):
    """Run ``run()`` ``reps`` times with each attribute ``name`` of
    ``module`` in ``parts`` (name -> key) wrapped in a host timer; a
    launcher (a name ending in ``_launcher``) has the launches it returns
    timed. Returns the median µs a call of each key over the last ``reps -
    1`` runs (the first warms up), and the runs' count of calls."""
    calls = {}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kwargs)
            calls.setdefault(key, []).append(time.perf_counter_ns() - t0)
            return out
        return wrapper

    def timed_launcher(make, key):
        def wrapper(*args, **kwargs):
            return timed(make(*args, **kwargs), key)
        return wrapper

    saved = {name: getattr(module, name) for name in parts if hasattr(module, name)}
    try:
        for name, fn in saved.items():
            wrap = timed_launcher if name.endswith("_launcher") else timed
            setattr(module, name, wrap(fn, parts[name]))
        run()
        calls.clear()
        for _ in range(reps - 1):
            run()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return {key: statistics.median(v) / 1e3 for key, v in calls.items()}, \
        {key: len(v) // (reps - 1) for key, v in calls.items()}


def _wall_ms(torch, fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _put_parts(torch, amcx_torch, dev, calls):
    from amcx_torch.ops import _build
    from amcx_torch.ops import lsmc_pallas as lp
    from amcx_torch.ops.gbm import gbm_paths

    n_paths, n_steps, S0, r, sigma, K, T, t = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0, 50
    paths = gbm_paths(20261016, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    ones = torch.ones(n_steps + 1, device=dev)
    stats = lp.step_stats(mean_t, inv_std_t, ones, ones)
    S_t = paths[t].clone()
    cf, tau = torch.clamp_min(K - paths[-1], 0.0), torch.full((n_paths,), float(n_steps),
                                                                 device=dev)
    packed = lp.step_moments(stats, t, S_t, cf, tau, itm_weights=True,
                             rdt=float(torch.tensor(r * T / n_steps)), K=K, phi=-1.0)
    coeffs = amcx_torch.pinv_solve(*lp.unpack_moments(packed.cpu(), 5)).to(dev)
    row = torch.empty_like(cf)
    akw = dict(K=K, phi=-1.0, basis="chebyshev", degree=4)
    out = {
        "call_surface": _per_call_us(torch, lambda: lp.step_apply(
            stats, t, coeffs, S_t, cf, tau, surface=row, **akw), calls),
        "call_select": _per_call_us(torch, lambda: lp.step_apply(
            stats, t, coeffs, S_t, cf, tau, **akw), calls),
        "current_stream": _per_call_us(torch, lambda: torch.cuda.current_stream(dev).cuda_stream,
                                       calls),
        "raw_stream": _per_call_us(torch, lambda: torch._C._cuda_getCurrentRawStream(dev.index),
                                   calls),
        "row_view": _per_call_us(torch, lambda: paths[t], calls),
    }
    rows = (S_t, cf, tau, row)
    if "basis" in inspect.signature(lp._check_cuda).parameters:
        out["checks"] = _per_call_us(torch, lambda: lp._check_cuda(stats, t, "chebyshev", 4, rows,
                                                                   None), calls)
    else:
        out["checks"] = _per_call_us(torch, lambda: lp._check_cuda(stats, t, 4, rows, None), calls)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (S_t.data_ptr(), cf.data_ptr(), tau.data_ptr(), None, stats.data_ptr(),
            coeffs.data_ptr(), row.data_ptr(), t, n_steps, n_paths)
    fn, grid = lp._apply_fn(), max(1, min(1024, _build.sm_count(dev) * 8))
    out["c_entry_no_launch"] = _per_call_us(torch, lambda: fn(*args, 0, K, -1.0, 1, 4, 1, stream),
                                            calls)
    out["c_entry_launch"] = _per_call_us(torch, lambda: fn(*args, grid, K, -1.0, 1, 4, 1, stream),
                                         calls)
    return paths, out


def _maxcall_parts(torch, amcx_torch, dev, calls):
    from amcx_torch.ops import _build
    from amcx_torch.ops import maxcall_pallas as ma
    from amcx_torch.ops.lsmc_pallas import unpack_moments

    n_paths, n_dates, S0, K, r, q, sigma, T, t = 1_048_576, 9, 100.0, 100.0, 0.05, 0.1, 0.2, \
        3.0, 5
    sim = amcx_torch.SimConfig(n_paths=n_paths, n_steps=n_dates)
    paths = amcx_torch.simulate_gbm_multi(20261018, [S0] * 5, r, sigma, T, sim, q=q, device=dev)
    planes, stats = ma.ma_inputs(paths, r, T / n_dates, sorted_basis=True, exercise_from_step=1)
    rdt = float(torch.tensor(r) * torch.tensor(T / n_dates))
    cf = ma._payoff_for(list(planes[n_dates]), K, "maxcall")
    tau = torch.full((n_paths,), float(n_dates), device=dev)
    kw = dict(K=K, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    step = planes[t]
    packed = ma.ma_step_moments(stats, t, step, cf, tau, rdt=rdt, **kw)
    coeffs = amcx_torch.pinv_solve(*unpack_moments(packed.cpu(), 21)).to(dev)
    out = {"call": _per_call_us(torch, lambda: ma.ma_step_apply(stats, t, coeffs, step, cf, tau,
                                                                **kw), calls)}
    out["checks"] = _per_call_us(torch, lambda: ma._check_cuda(stats, t, step, (cf, tau), 5),
                                 calls)
    V, I = ctypes.c_void_p, ctypes.c_int
    new = hasattr(ma, "ma_apply_params")
    block = (ma.ma_apply_params if new else ma.ma_params)(5, "chebyshev", 2, "total", True,
                                                           "maxcall", K, 1.0, None)
    fn = _build.function("amcx_ma_step_apply",
                         [V, V, V, V, V, I, I, I, I, ctypes.POINTER(type(block)), V])
    grid = _build.sm_count(dev) if new else 1024
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (step.data_ptr(), cf.data_ptr(), tau.data_ptr(), stats.data_ptr(), coeffs.data_ptr(),
            t, n_dates, n_paths)
    out["c_entry_no_launch"] = _per_call_us(torch, lambda: fn(*args, 0, ctypes.byref(block),
                                                              stream), calls)
    out["c_entry_launch"] = _per_call_us(torch, lambda: fn(*args, grid, ctypes.byref(block),
                                                           stream), calls)
    return paths, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_profile: needs a CUDA card")
    import amcx_torch
    from amcx_torch import engine_pallas
    from amcx_torch.models import maxcall

    dev = torch.device("cuda", 0)
    paths, put = _put_parts(torch, amcx_torch, dev, args.calls)
    mpaths, mc = _maxcall_parts(torch, amcx_torch, dev, args.calls)
    spec = amcx_torch.RegressionSpec(basis="chebyshev", degree=4, regress_on="itm")
    mspec = amcx_torch.RegressionSpec(basis="chebyshev", degree=2)

    def put_route():
        return engine_pallas.backward_induction_fused(paths, 0.01, 0.01, 100.0, -1.0, spec)

    def mc_route():
        return maxcall.backward_induction_fused_maxcall(mpaths, 100.0, 0.05, 1.0 / 3.0, mspec)

    names = {"unpack_moments": "unpack_moments", "pinv_solve": "pinv_solve"}
    put_step, put_n = route_split(engine_pallas, dict(
        names, step_moments="moments_call", step_apply="apply_call",
        step_apply_launcher="apply_launch"), put_route)
    mc_step, mc_n = route_split(maxcall, dict(
        names, ma_step_moments="moments_call", ma_step_apply="apply_call",
        ma_step_apply_launcher="apply_launch"), mc_route)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "kernel5_host_us_per_call": put, "kernel9_host_us_per_call": mc,
        "fused_put_step_us": put_step, "fused_put_calls_per_induction": put_n,
        "fused_maxcall_step_us": mc_step, "fused_maxcall_calls_per_induction": mc_n,
        "fused_put_induction_ms": _wall_ms(torch, put_route),
        "fused_maxcall_induction_ms": _wall_ms(torch, mc_route)}))


if __name__ == "__main__":
    main()

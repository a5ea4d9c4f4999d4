"""Device time of one kernel route by phase, and a hash of its result bits.

Run from the root of a checkout on a machine with a CUDA card:

    python3 -m amcx_torch.kernel_profile
        [--route put|gbm|book|ma-step|ma-apply|ma-prepare|ma-mega|swing|step|fusedpath|qmc|ccr]
        [--reps 20]
        [--label NAME]

Routes, each on fixed inputs made from fixed seeds:

- ``put`` (the default, kernel 2): the flagship put (1,048,576 Philox
  paths x 100 steps, S0 = K = 100, r = 1%, sigma = 20%, T = 1, Chebyshev
  degree 4, ITM fit) through ``lsmc_price_megakernel``; the hash covers
  the price, stderr and coefficient bits.
- ``gbm`` (kernel 1): the flagship put's Philox paths alone (1,048,576 x
  100 steps, seed 20261016) through ``gbm_paths``; the hash covers the
  path array.
- ``book`` (kernel 3): book-16-1M (16 American puts K = 80..120, S0 = 95,
  r = 1%, sigma = 20%, T = 1, 1,048,576 Philox paths x 100 steps,
  all-paths degree 4, the closed-form frame) through
  ``lsmc_book_megakernel``; the hash covers the prices, stderrs and the
  cf/tau planes of one run with ``return_cf_tau``, the timing runs without.
- ``ma-step`` (kernel 8): one backward step (t = 5) of the 5-asset
  Bermudan max-call (1,048,576 paths, 9 dates, S0 = K = 100, r = 5%,
  q = 10%, sigma = 20%, T = 3, sorted degree-2 basis: m = 21, P = 252)
  through ``ma_step_moments``, all-paths and ITM-weighted; the hash covers
  both packed moment vectors.
- ``ma-apply`` (kernel 9): one exercise step (t = 5) of the same max-call
  through ``ma_step_apply`` on coefficients solved once on the CPU from the
  all-paths moments of the maturity carry; the hash covers cf and tau after
  one apply on fresh copies of the carry.
- ``ma-prepare``: the inputs of kernel 7 for the max-call of ``ma-mega``
  (maxcall-5-1M: 1,048,576 paths x 9 dates x 5 assets, sorted basis,
  exercise from date 1) through ``lsmc_ma_mega.prepare`` alone: the asset-
  major planes and the stats rows; the hash covers both. It also prints
  the host waits a call (synchronises and copies, by the profiler) and the
  torch-op composition by part, each alone: the frame
  (``maxcall_standardization``: the sorting network, the means and
  standard deviations), the asset-major copy (``permute(0, 2,
  1).contiguous()``) and ``ma_stats``, and the ``ma_prepare`` kernel alone.
- ``ma-mega`` (kernel 7): the whole induction of the 5-asset Bermudan
  max-call of ``ma-step`` (maxcall-5-1M: 1,048,576 paths, 9 dates, sorted
  degree-2 basis, m = 21, all-paths fit, exercise from date 1) through
  ``lsmc_ma_mega._ma_mega_cuda`` on the asset-major planes and stats rows
  that ``lsmc_ma_mega.prepare`` builds once, with the cf/tau planes; the
  hash covers the price, stderr, cf and tau bits.
- ``swing`` (kernel 10): swing-3-1M (a 3-rights put, K = 105, S0 = 100,
  r = 5%, sigma = 25%, T = 1, 1,048,576 Philox paths x 100 steps,
  Chebyshev degree 4, ITM fit, the closed-form frame) through
  ``lsmc_price_swing``; the hash covers the price and stderr bits.
- ``step`` (kernels 4 and 5): one backward step (t = 50) of the flagship
  put at 1,048,576 paths from the maturity carry: ``step_moments`` ITM and
  all-paths, then one ``step_apply`` with a surface row on coefficients
  solved once on the CPU; the hash covers both packed vectors and the
  cf, tau and surface rows of one apply on fresh copies of the carry. It
  also prints the ITM moments' device time at degrees 0, 2, 4 and 10.
- ``fusedpath`` (kernel 6): the flagship put regenerated inside the
  induction (1,048,576 paths x 100 steps, ITM fit, Chebyshev degree 4)
  through ``lsmc_price_fusedpath`` with ``return_cf_tau`` and
  ``return_coeffs``; the hash covers the price, stderr, cf/tau planes and
  coefficient bits.
- ``qmc`` (kernel 11): scrambled-Sobol paths of the flagship market at
  1,048,576 paths x 100 steps through ``sobol_gbm_paths``, increment and
  then bridge order (one run is both arrays); the hash covers the path
  bits of each order. It also prints each order on its own: ms by CUDA
  events, the wrapper's host time, and the device time by name, so the
  kernel's time stands apart from any host-to-device copy, and a new
  seed's table build (the host's ms to the call's return, the device µs
  by CUDA events).

- ``ccr`` (the exposure kernel): the CCR profile of the flagship put
  (1,048,576 Philox paths x 100 steps of ``gbm``, the all-paths fit)
  through ``ccr_exposures`` alone, on the coefficients kernel 2 exports
  once and the closed-form frame; the hash covers the EPE, PFE-5 and
  PFE-95 rows.

Every route also prints the wrappers' host time per run (enqueue, no
sync) and the CUDA-event time minus the device time; a ``step`` run is
three wrapper calls (two moments, one apply), an ``ma-apply`` run one.

Each prints one JSON line: the median ms per call by CUDA events, the
device microseconds per call of each kernel by name (``torch.profiler``)
and a SHA-256 of the result bits, so two checkouts run one after the other
on the same card can be compared phase by phase and bit for bit. It uses
only entry points that every version of the port since the route's kernel
landed has had.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import time


def _put(torch, amcx_torch, dev):
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel

    n_paths, n_steps, S0, r, sigma, K, T = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0
    paths = gbm_paths(20261016, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    kw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t)

    def run():
        return lsmc_price_megakernel(paths, K, r, T / n_steps, -1.0, return_coeffs=True, **kw)

    res = run()
    return run, (res.price, res.stderr, res.coeffs), {"price": res.price}


def _gbm(torch, amcx_torch, dev):
    from amcx_torch.ops.gbm import gbm_paths

    args = (20261016, 100.0, 0.01, 0.2, 0.0, 1.0, 100, 1_048_576)

    def run():
        return gbm_paths(*args, device=dev)

    paths = run()
    return run, (paths,), {"price": paths[-1].mean()}


def _book(torch, amcx_torch, dev):
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_book_megakernel

    n_paths, n_steps, S0, r, sigma, T = 1_048_576, 100, 95.0, 0.01, 0.2, 1.0
    paths = gbm_paths(20261017, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    ladder = torch.linspace(80.0, 120.0, 16)
    kw = dict(mean_t=mean_t, inv_std_t=inv_std_t)

    def run(**extra):
        return lsmc_book_megakernel(paths, ladder, r, T / n_steps, -1.0, **kw, **extra)

    res = run(return_cf_tau=True)
    return run, tuple(res), {"price": res[0][8]}


def _ma_step(torch, amcx_torch, dev):
    from amcx_torch.ops import maxcall_pallas as ma

    n_paths, n_dates, S0, K, r, q, sigma, T, t = 1_048_576, 9, 100.0, 100.0, 0.05, 0.1, 0.2, \
        3.0, 5
    sim = amcx_torch.SimConfig(n_paths=n_paths, n_steps=n_dates)
    paths = amcx_torch.simulate_gbm_multi(20261018, [S0] * 5, r, sigma, T, sim, q=q, device=dev)
    planes, stats = ma.ma_inputs(paths, r, T / n_dates, sorted_basis=True, exercise_from_step=1)
    del paths
    rdt = float(torch.tensor(r) * torch.tensor(T / n_dates))
    cf = ma._payoff_for(list(planes[n_dates]), K, "maxcall")
    tau = torch.full((n_paths,), float(n_dates), device=dev)
    kw = dict(rdt=rdt, K=K, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    step = planes[t]

    def run(itm=False):
        return ma.ma_step_moments(stats, t, step, cf, tau, itm_weights=itm, **kw)

    outs = (run(), run(itm=True))
    return run, outs, {"price": outs[0][0]}


def _ma_apply(torch, amcx_torch, dev):
    from amcx_torch.ops import maxcall_pallas as ma
    from amcx_torch.ops.lsmc_pallas import unpack_moments

    n_paths, n_dates, S0, K, r, q, sigma, T, t = 1_048_576, 9, 100.0, 100.0, 0.05, 0.1, 0.2, \
        3.0, 5
    sim = amcx_torch.SimConfig(n_paths=n_paths, n_steps=n_dates)
    paths = amcx_torch.simulate_gbm_multi(20261018, [S0] * 5, r, sigma, T, sim, q=q, device=dev)
    planes, stats = ma.ma_inputs(paths, r, T / n_dates, sorted_basis=True, exercise_from_step=1)
    del paths
    rdt = float(torch.tensor(r) * torch.tensor(T / n_dates))
    cf0 = ma._payoff_for(list(planes[n_dates]), K, "maxcall")
    tau0 = torch.full((n_paths,), float(n_dates), device=dev)
    kw = dict(K=K, basis="chebyshev", degree=2, mode="total", sorted_basis=True)
    step = planes[t]
    packed = ma.ma_step_moments(stats, t, step, cf0, tau0, rdt=rdt, **kw)
    # solved on the CPU, so the coefficients (and the apply's bits) do not
    # depend on the card's eigh
    coeffs = amcx_torch.pinv_solve(*unpack_moments(packed.cpu(), 21)).to(dev)
    cf, tau = cf0.clone(), tau0.clone()
    ma.ma_step_apply(stats, t, coeffs, step, cf, tau, **kw)
    cf_run, tau_run = cf0.clone(), tau0.clone()

    def run():
        # the carry converges after the first call: each timed apply
        # rewrites the same exercised paths
        ma.ma_step_apply(stats, t, coeffs, step, cf_run, tau_run, **kw)

    return run, (cf, tau), {"price": packed[0]}


def _ma_prepare(torch, amcx_torch, dev):
    from amcx_torch.ops import lsmc_ma_mega
    from amcx_torch.ops import maxcall_pallas as ma

    n_paths, n_dates, S0, K, r, q, sigma, T = 1_048_576, 9, 100.0, 100.0, 0.05, 0.1, 0.2, 3.0
    dt = T / n_dates
    sim = amcx_torch.SimConfig(n_paths=n_paths, n_steps=n_dates)
    paths = amcx_torch.simulate_gbm_multi(20261018, [S0] * 5, r, sigma, T, sim, q=q, device=dev)

    def run():
        return lsmc_ma_mega.prepare(paths, K, r, dt, payoff_kind="maxcall", degree=2,
                                    sorted_basis=True, exercise_from_step=1)[:2]

    planes, stats = run()

    def parts(split):
        allow = (torch.arange(n_dates + 1, device=dev) >= 1).to(torch.float32)
        frame = ma.maxcall_standardization(paths, "sorted")
        return {"frame": split(lambda: ma.maxcall_standardization(paths, "sorted")),
                "copy": split(lambda: paths.permute(0, 2, 1).contiguous()),
                "ma_stats": split(lambda: ma.ma_stats(*frame, r, dt, allow)),
                "ma_prepare": split(lambda: ma.ma_prepare(paths, r, dt, allow, sorted_basis=True))}

    return run, (planes, stats), {"price": stats[0, 1], "parts": parts}


def _ma_mega(torch, amcx_torch, dev):
    from amcx_torch.ops import lsmc_ma_mega

    n_paths, n_dates, S0, K, r, q, sigma, T = 1_048_576, 9, 100.0, 100.0, 0.05, 0.1, 0.2, 3.0
    sim = amcx_torch.SimConfig(n_paths=n_paths, n_steps=n_dates)
    paths = amcx_torch.simulate_gbm_multi(20261018, [S0] * 5, r, sigma, T, sim, q=q, device=dev)
    planes, stats, cfg = lsmc_ma_mega.prepare(paths, K, r, T / n_dates, payoff_kind="maxcall",
                                              degree=2, sorted_basis=True, exercise_from_step=1)
    del paths

    def run():
        return lsmc_ma_mega._ma_mega_cuda(planes, stats, cfg, True, False)

    sums, cf, tau = run()
    price = sums[0] / n_paths
    stderr = torch.sqrt(torch.clamp_min(sums[1] / n_paths - price * price, 0.0) / n_paths)
    return run, (price, stderr, cf, tau), {"price": price}


def _swing(torch, amcx_torch, dev):
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_swing import lsmc_price_swing

    n_paths, n_steps, S0, r, sigma, K, T = 1_048_576, 100, 100.0, 0.05, 0.25, 105.0, 1.0
    paths = gbm_paths(20261066, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)

    def run():
        return lsmc_price_swing(paths, K, r, T / n_steps, -1.0, 3, itm_weights=True,
                                mean_t=mean_t, inv_std_t=inv_std_t)

    outs = run()
    return run, outs, {"price": outs[0]}


def _step(torch, amcx_torch, dev):
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_pallas import step_apply, step_moments, step_stats, unpack_moments

    n_paths, n_steps, S0, r, sigma, K, T, t = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0, 50
    paths = gbm_paths(20261016, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    ones = torch.ones(n_steps + 1, device=dev)
    stats = step_stats(mean_t, inv_std_t, ones, ones)
    S_t = paths[t].clone()
    cf0 = torch.clamp_min(K - paths[-1], 0.0)
    tau0 = torch.full((n_paths,), float(n_steps), device=dev)
    del paths
    mkw = dict(rdt=float(torch.tensor(r * T / n_steps)), K=K, phi=-1.0, basis="chebyshev",
               degree=4)
    akw = dict(K=K, phi=-1.0, basis="chebyshev", degree=4)
    packed_itm = step_moments(stats, t, S_t, cf0, tau0, itm_weights=True, **mkw)
    packed_all = step_moments(stats, t, S_t, cf0, tau0, **mkw)
    # solved on the CPU, so the coefficients (and the apply's bits) do not
    # depend on the card's eigh
    coeffs = amcx_torch.pinv_solve(*unpack_moments(packed_itm.cpu(), 5)).to(dev)
    cf, tau, surface = cf0.clone(), tau0.clone(), torch.empty_like(cf0)
    step_apply(stats, t, coeffs, S_t, cf, tau, surface=surface, **akw)
    outs = (packed_itm, packed_all, cf, tau, surface)
    cf_run, tau_run, row_run = cf0.clone(), tau0.clone(), torch.empty_like(cf0)

    def run():
        # the carry converges after the first call: each timed apply
        # rewrites the same exercised paths
        step_moments(stats, t, S_t, cf0, tau0, itm_weights=True, **mkw)
        step_moments(stats, t, S_t, cf0, tau0, **mkw)
        step_apply(stats, t, coeffs, S_t, cf_run, tau_run, surface=row_run, **akw)

    def by_degree(profile_us):
        # the ITM moments alone at degrees 0, 2, 4 and 10 (P = 2, 9, 20, 77)
        return {deg: profile_us(lambda: step_moments(stats, t, S_t, cf0, tau0, itm_weights=True,
                                                      **dict(mkw, degree=deg)))
                for deg in (0, 2, 4, 10)}

    return run, outs, {"price": packed_itm[0], "by_degree": by_degree}


def _fusedpath(torch, amcx_torch, dev):
    from amcx_torch.ops.lsmc_fusedpath import lsmc_price_fusedpath

    n_paths, n_steps, S0, r, sigma, K, T = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0

    def run():
        return lsmc_price_fusedpath(20261016, S0, K, r, sigma, T / n_steps, n_steps, n_paths,
                                    -1.0, itm_weights=True, return_cf_tau=True,
                                    return_coeffs=True, device=dev)

    res = run()
    return run, tuple(res), {"price": res.price}


def _qmc(torch, amcx_torch, dev):
    from amcx_torch.ops.sobol_pallas import sobol_gbm_paths

    args = (20261016, 100.0, 0.01, 0.2, 0.0, 1.0, 100, 1_048_576)

    def run():
        return tuple(sobol_gbm_paths(*args, brownian_bridge=bridge, device=dev)
                     for bridge in (False, True))

    def tables():
        # a new seed's table build (_device_tables, uncached), medians over 5
        # seeds: the host's ms from the call to its return, and the device
        # µs between CUDA events around it, recorded behind a sleep on the
        # stream so that the host's enqueue is not counted
        from amcx_torch.ops.sobol_pallas import _device_tables

        parts = {"launch_ms": [], "device_us": []}
        for seed in range(7001, 7006):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(10_000_000)
            start.record()
            t0 = time.perf_counter()
            _device_tables.__wrapped__(seed, args[6], args[7], dev)
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            parts["launch_ms"].append((t1 - t0) * 1e3)
            parts["device_us"].append(start.elapsed_time(end) * 1e3)
        return {k: statistics.median(v) for k, v in parts.items()}

    def by_order(split):
        return {("bridge" if bridge else "increment"): split(
            lambda b=bridge: sobol_gbm_paths(*args, brownian_bridge=b, device=dev))
            for bridge in (False, True)}

    outs = run()
    return run, outs, {"price": outs[1][-1].mean(), "by_order": by_order, "tables": tables}


def _ccr(torch, amcx_torch, dev):
    from amcx_torch.ops.ccr_exposures import ccr_exposures
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel

    n_paths, n_steps, S0, r, sigma, K, T = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0
    paths = gbm_paths(20261016, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    coeffs = lsmc_price_megakernel(paths, K, r, T / n_steps, -1.0, degree=4, itm_weights=False,
                                   mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True).coeffs

    def run():
        return ccr_exposures(paths, coeffs, mean_t, inv_std_t, "chebyshev", 4)

    rows = run()
    return run, (rows,), {"price": rows[0, 0]}


ROUTES = {"put": _put, "gbm": _gbm, "book": _book, "ma-step": _ma_step, "ma-apply": _ma_apply,
          "ma-prepare": _ma_prepare, "ma-mega": _ma_mega, "swing": _swing, "step": _step,
          "fusedpath": _fusedpath, "qmc": _qmc, "ccr": _ccr}


def _device_us(torch, profile, activity, fn, reps):
    """Device microseconds per call of ``fn`` under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[activity.CPU, activity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / reps


# host calls that wait for the card: synchronises, and copies (a copy from
# or to pageable host memory returns only when the stream reaches it)
_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def _host_waits(torch, events, reps):
    """Host waits a call among the profiler's ``events`` of ``reps`` calls:
    synchronises and ``cudaMemcpy*`` calls, each by name."""
    waits = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and (
                e.name in _WAITS or e.name.startswith("cudaMemcpy")):
            waits[e.name] = waits.get(e.name, 0) + 1
    return {k: v / reps for k, v in waits.items()}


def _split(torch, profile, activity, fn, reps):
    """One call of ``fn`` on its own: ms by CUDA events (median), the host
    enqueue µs a call, device µs and launches a call by name (kernels and
    copies apart), and the host waits a call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[activity.CPU, activity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _short(e.name)
            per_name[name] = per_name.get(name, 0.0) + e.time_range.end - e.time_range.start
            count[name] = count.get(name, 0) + 1
    return {"ms_median": statistics.median(times), "host_enqueue_us": host_us,
            "device_us": {k: v / reps for k, v in per_name.items()},
            "device_launches": {k: v / reps for k, v in count.items()},
            "host_waits": _host_waits(torch, prof.events(), reps)}


def _short(name):
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:60] if "Memcpy" not in name else name[:60]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=sorted(ROUTES), default="put")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: needs a CUDA card")
    import amcx_torch

    dev = torch.device("cuda", 0)
    run, outs, extra = ROUTES[args.route](torch, amcx_torch, dev)
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for x in outs:
        digest.update(x.detach().cpu().contiguous().numpy().tobytes())
    for _ in range(3):
        run()
    times = []
    for _ in range(args.reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        run()
    host_us = (time.perf_counter() - t0) / args.reps * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
    per_name, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = _short(e.name)
            per_name[name] = per_name.get(name, 0.0) + e.time_range.end - e.time_range.start
            count[name] = count.get(name, 0) + 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    line = {
        "label": args.label, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "price": float(extra["price"]), "bits_sha256": digest.hexdigest(),
        "ms_median": statistics.median(times), "ms_min": min(times),
        "device_us_per_induction": {k: v / args.reps for k, v in
                                    sorted(per_name.items(), key=lambda kv: -kv[1])},
        "device_launches_per_induction": {k: v / args.reps for k, v in
                                          sorted(count.items(), key=lambda kv: -kv[1])}}
    if "by_degree" in extra:
        line["moments_device_us_by_degree"] = extra["by_degree"](
            lambda fn: _device_us(torch, profile, ProfilerActivity, fn, args.reps))
    if "by_order" in extra:
        line["by_order"] = extra["by_order"](
            lambda fn: _split(torch, profile, ProfilerActivity, fn, args.reps))
    if "tables" in extra:
        line["new_seed_tables"] = extra["tables"]()
    if "parts" in extra:
        line["host_waits_per_call"] = _host_waits(torch, prof.events(), args.reps)
        line["parts"] = extra["parts"](
            lambda fn: _split(torch, profile, ProfilerActivity, fn, args.reps))
    device_us = sum(per_name.values()) / args.reps
    line.update(route=args.route, device_us_per_call=device_us, host_enqueue_us_per_call=host_us,
                wall_minus_device_us=statistics.median(times) * 1e3 - device_us)
    print(json.dumps(line))


if __name__ == "__main__":
    main()

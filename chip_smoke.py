#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`amcx_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels from ``amcx_torch/csrc`` (first use, one ``nvcc`` per
source, in parallel), holds each one against its plain PyTorch version on
the card at the main paths' shape, and drives two main paths at the
flagship width of 1,048,576 paths x 100 steps:

- phases 2-4: ``amcx_torch.price_option(engine="mega")`` on the Philox
  pathgen (kernels ``gbm_paths`` and ``lsmc_mega``) against CRR-2000;
- phases 5-7: the fused per-step engine (kernels ``lsmc_step_moments`` and
  ``lsmc_step_apply``) and the induction kernel's cf/tau planes, then
  ``price_option(engine="fused")`` against CRR-2000, a down-and-in put
  against the CRR barrier tree, a European put against Black-Scholes, and
  the pathwise Greeks routes of ``amcx_torch.price_and_greeks`` against
  the closed form.

It times the pricings, each kernel and each plain version with CUDA
events. Any failed phase raises (non-zero exit). Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.

Output: one line per phase, then the card's name and power limit, then one
JSON line with the kernels' numbers, then the result line
``{"ok": true, "device": {...}}``.
"""

import json
import math
import statistics
import subprocess
import sys
import time

N_PATHS = 1_048_576
N_STEPS = 100
S0, R, SIGMA, STRIKE, T = 100.0, 0.01, 0.2, 100.0, 1.0
SEED = 20261016


def _require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _time_ms(torch, fn, reps, warm):
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warm``
    warm-ups, each run between two CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

    import amcx_torch
    from amcx_torch.engine_pallas import (backward_induction_fused,
                                          backward_induction_fused_reference)
    from amcx_torch.ops import _build
    from amcx_torch.ops.gbm import gbm_paths, gbm_paths_reference
    from amcx_torch.ops.lsmc_megakernel import (lsmc_price_mega_reference,
                                                lsmc_price_megakernel)
    from amcx_torch.ops.lsmc_pallas import (step_apply, step_apply_reference, step_moments,
                                            step_moments_reference, step_stats, unpack_moments)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- phase 1: environment + build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.libraries()
    build_s = time.perf_counter() - t0
    print(f"phase 1 env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} | {smi} | kernels built in "
          f"{build_s:.1f} s ({'compiled' if _build.build_info['built'] else 'cached'})",
          flush=True)

    market = amcx_torch.MarketParams(S0, R, SIGMA)
    dt = T / N_STEPS
    drift_dt = (R - 0.5 * SIGMA ** 2) * dt
    vol_sdt = SIGMA * math.sqrt(dt)

    # ---- phase 2: kernel 1 (Philox GBM pathgen), at the main path's shape -
    full = gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    plain = gbm_paths_reference(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev)
    torch.cuda.synchronize()
    _require(tuple(full.shape) == (N_STEPS + 1, N_PATHS), "pathgen shape")
    _require(bool(torch.isfinite(full).all()), "pathgen output finite")
    gbm_err = float(torch.max(torch.abs(full - plain)))
    gbm_rel = float(torch.max(torch.abs(full - plain) / torch.abs(plain)))
    _require(gbm_rel <= 1e-5, f"pathgen kernel vs plain rtol {gbm_rel:.3e} <= 1e-5")
    del plain
    disc_T = math.exp(-R * T) * full[-1].double()
    m_T = float(disc_T.mean())
    se_T = float(disc_T.std()) / math.sqrt(N_PATHS)
    inc = torch.log(full[1:].double() / full[:-1].double())
    n_inc = inc.numel()
    inc_mean, inc_var = float(inc.mean()), float(inc.var())
    se_mean = math.sqrt(inc_var / n_inc)
    fourth = float(((inc - inc_mean) ** 4).mean())
    se_var = math.sqrt(max(fourth - inc_var ** 2, 0.0) / n_inc)
    del disc_T, inc
    _require(abs(m_T - S0) < 4 * se_T, f"|E[e^-rT S_T] - S0| = {abs(m_T - S0):.4g} < 4*{se_T:.4g}")
    _require(abs(inc_mean - drift_dt) < 4 * se_mean,
             f"log-increment mean {inc_mean:.6g} vs {drift_dt:.6g} (4 se {4 * se_mean:.3g})")
    _require(abs(inc_var - vol_sdt ** 2) < 4 * se_var,
             f"log-increment var {inc_var:.6g} vs {vol_sdt ** 2:.6g} (4 se {4 * se_var:.3g})")
    print(f"phase 2 pathgen {N_PATHS}x{N_STEPS}: kernel vs plain max|dS| {gbm_err:.3e} "
          f"max rel {gbm_rel:.3e} | E[e^-rT S_T] {m_T:.5f} "
          f"(se {se_T:.5f}), inc mean {inc_mean:.4e} (want {drift_dt:.4e}, se {se_mean:.2e}), "
          f"inc var {inc_var:.6e} (want {vol_sdt ** 2:.6e}, se {se_var:.2e})", flush=True)

    # ---- phase 3: kernel 2 (LSMC induction) vs its plain version, on the --
    # ---- main path's (n_steps+1, n_paths) paths ------------------------------
    mean_t, inv_std_t = amcx_torch.gbm_standardization(market, T, N_STEPS, device=dev)
    mega_err = 0.0
    for itm, american in ((True, True), (False, True), (True, False)):
        kw = dict(basis="chebyshev", degree=4, american=american, itm_weights=itm,
                  mean_t=mean_t, inv_std_t=inv_std_t, return_coeffs=True)
        ker = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **kw)
        again = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **kw)
        ref = lsmc_price_mega_reference(full, STRIKE, R, dt, -1.0, **kw)
        torch.cuda.synchronize()
        d_price = abs(float(ker.price) - float(ref.price))
        d_coef = float(torch.max(torch.abs(ker.coeffs - ref.coeffs)))
        c_max = float(torch.max(torch.abs(ref.coeffs)))
        same = (torch.equal(ker.price, again.price) and torch.equal(ker.stderr, again.stderr)
                and torch.equal(ker.coeffs, again.coeffs))
        case = f"itm={itm} american={american}"
        _require(math.isfinite(float(ker.price)), f"{case}: finite price")
        _require(d_price <= 2e-4, f"{case}: kernel vs plain price |d| {d_price:.3e} <= 2e-4")
        _require(d_coef <= 1e-3 * c_max, f"{case}: coeffs |d| {d_coef:.3e} <= 1e-3*{c_max:.3e}")
        _require(same, f"{case}: two kernel runs bit-identical")
        mega_err = max(mega_err, d_price)
        print(f"phase 3 induction {N_PATHS}x{N_STEPS} {case}: kernel {float(ker.price):.6f} "
              f"plain {float(ref.price):.6f} |d| {d_price:.3e} coeffs max|d| {d_coef:.3e} "
              f"(max|c| {c_max:.3e}) stderr {float(ker.stderr):.5f} bit-identical rerun {same}",
              flush=True)

    # ---- phase 4: the main path at full width ----------------------------
    product = amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put", exercise="american")
    spec = amcx_torch.RegressionSpec(basis="chebyshev", degree=4)
    sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="philox")
    _require(amcx_torch.resolve_regression_spec(spec, product, q=0.0).regress_on == "itm",
             "auto resolves to itm")
    crr = amcx_torch.crr_price(S0, STRIKE, T, R, SIGMA, 2000, option_type="put", american=True)

    def pricing(seed=SEED):
        return amcx_torch.price_option(seed, market, product, spec, sim, engine="mega",
                                       device=dev)

    torch.cuda.synchronize()
    gbm_paths.launches = 0
    lsmc_price_megakernel.launches = 0
    res = pricing()
    torch.cuda.synchronize()
    launches = {"gbm_paths": gbm_paths.launches, "lsmc_mega": lsmc_price_megakernel.launches}
    price, stderr = float(res.price), float(res.stderr)
    _require(all(n > 0 for n in launches.values()), f"main path launched every kernel {launches}")
    _require(math.isfinite(price) and math.isfinite(stderr) and stderr > 0, "finite price/stderr")
    _require(abs(price - crr) <= 4 * stderr + 0.005,
             f"|price - CRR-2000| = {abs(price - crr):.5f} <= 4*{stderr:.5f} + 0.005")

    prices = []
    seeds = iter(range(SEED + 1, SEED + 1000))
    ms_pricing = _time_ms(torch, lambda: prices.append(pricing(next(seeds)).price), 20, 3)
    mean20 = float(torch.stack(prices[3:]).mean())
    ms_gbm = _time_ms(torch, lambda: gbm_paths(SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS,
                                               device=dev), 20, 3)
    ms_gbm_plain = _time_ms(torch, lambda: gbm_paths_reference(
        SEED, S0, R, SIGMA, 0.0, T, N_STEPS, N_PATHS, device=dev), 5, 1)
    mkw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t,
               inv_std_t=inv_std_t)
    ms_mega = _time_ms(torch, lambda: lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **mkw),
                       20, 3)
    ms_mega_plain = _time_ms(torch, lambda: lsmc_price_mega_reference(
        full, STRIKE, R, dt, -1.0, **mkw), 3, 1)
    rate = N_PATHS * N_STEPS / (ms_pricing / 1e3)
    print(f"phase 4 main path {N_PATHS}x{N_STEPS} American put: price {price:.5f} stderr "
          f"{stderr:.5f} CRR-2000 {crr:.5f} |err| {abs(price - crr):.5f} | mean of 20 timed "
          f"pricings {mean20:.5f} |err| {abs(mean20 - crr):.5f} | launches {launches} | "
          f"{ms_pricing:.3f} ms/pricing (median of 20) = {rate:.4e} path-steps/s | "
          f"pathgen kernel {ms_gbm:.3f} ms plain {ms_gbm_plain:.3f} ms | induction kernel "
          f"{ms_mega:.3f} ms plain {ms_mega_plain:.3f} ms", flush=True)

    # ---- phase 5: kernels 4+5 (fused step kernels) vs their plain versions,
    # ---- through backward_induction_fused on the phase-2 paths ---------------
    spec_itm = amcx_torch.RegressionSpec(basis="chebyshev", degree=4, regress_on="itm")
    spec_all = amcx_torch.RegressionSpec(basis="chebyshev", degree=4, regress_on="all")
    fused_err = 0.0
    for case, fspec, kw in (
            ("ITM American put", spec_itm, {}),
            ("down-in American put H=90 + surface", spec_itm,
             dict(barrier=90.0, return_surface=True)),
            ("all-paths Bermudan put, every 10th step", spec_all,
             dict(exercise_steps=tuple(range(0, N_STEPS, 10))))):
        before = (step_moments.launches, step_apply.launches)
        ker = backward_induction_fused(full, R, dt, STRIKE, -1.0, fspec, **kw)
        again = backward_induction_fused(full, R, dt, STRIKE, -1.0, fspec, **kw)
        torch.cuda.synchronize()
        n_launch = (step_moments.launches - before[0], step_apply.launches - before[1])
        ref = backward_induction_fused_reference(full, R, dt, STRIKE, -1.0, fspec, **kw)
        torch.cuda.synchronize()
        fields = ("price", "stderr", "cashflows", "exercise_times") + (
            ("continuation",) if kw.get("return_surface") else ())
        diffs = {f: float(torch.max(torch.abs(getattr(ker, f) - getattr(ref, f))))
                 for f in fields}
        same_ref = all(torch.equal(getattr(ker, f), getattr(ref, f)) for f in fields)
        same_rerun = all(torch.equal(getattr(ker, f), getattr(again, f)) for f in fields)
        n_ex = int((ker.exercise_times < N_STEPS).sum())
        print(f"phase 5 fused step kernels {N_PATHS}x{N_STEPS} {case}: kernel "
              f"{float(ker.price):.6f} plain {float(ref.price):.6f} stderr "
              f"{float(ker.stderr):.5f} | max|d| {diffs} | early-exercised paths {n_ex} | "
              f"launches (moments, apply) {n_launch} | equal to plain {same_ref} | "
              f"bit-identical rerun {same_rerun}", flush=True)
        _require(math.isfinite(float(ker.price)), f"{case}: finite price")
        _require(n_launch == (2 * N_STEPS, 2 * N_STEPS), f"{case}: launches {n_launch}")
        _require(same_ref, f"{case}: kernels equal to their plain versions {diffs}")
        _require(same_rerun, f"{case}: two kernel runs bit-identical")
        fused_err = max(fused_err, *diffs.values())
        del ker, again, ref

    # one step of each kernel at the main path's width, against its plain
    # version on the same inputs, and timed
    t_mid = N_STEPS // 2
    ones = torch.ones(N_STEPS + 1, device=dev)
    stats = step_stats(mean_t, inv_std_t, ones, ones)
    S_t = full[t_mid]
    cf0 = torch.clamp_min(STRIKE - full[-1], 0.0)
    tau0 = torch.full((N_PATHS,), float(N_STEPS), device=dev)
    mkw = dict(rdt=float(torch.tensor(R * dt)), K=STRIKE, phi=-1.0, basis="chebyshev",
               degree=4, itm_weights=True)
    akw = dict(K=STRIKE, phi=-1.0, basis="chebyshev", degree=4)
    packed = step_moments(stats, t_mid, S_t, cf0, tau0, **mkw)
    packed_plain = step_moments_reference(stats, t_mid, S_t, cf0, tau0, **mkw)
    coeffs = amcx_torch.pinv_solve(*unpack_moments(packed, 5))
    cf_k, tau_k, row_k = cf0.clone(), tau0.clone(), torch.empty_like(cf0)
    cf_p, tau_p, row_p = cf0.clone(), tau0.clone(), torch.empty_like(cf0)
    step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k, surface=row_k, **akw)
    step_apply_reference(stats, t_mid, coeffs, S_t, cf_p, tau_p, surface=row_p, **akw)
    torch.cuda.synchronize()
    moments_err = float(torch.max(torch.abs(packed - packed_plain)))
    apply_err = max(float(torch.max(torch.abs(a - b)))
                    for a, b in ((cf_k, cf_p), (tau_k, tau_p), (row_k, row_p)))
    _require(moments_err == 0.0, f"step moments kernel vs plain max|d| {moments_err:.3e} == 0")
    _require(apply_err == 0.0, f"step apply kernel vs plain max|d| {apply_err:.3e} == 0")
    ms_moments = _time_ms(torch, lambda: step_moments(stats, t_mid, S_t, cf0, tau0, **mkw), 50, 5)
    ms_moments_plain = _time_ms(torch, lambda: step_moments_reference(
        stats, t_mid, S_t, cf0, tau0, **mkw), 10, 2)
    # the carry converges after the first call: each timed call rewrites
    # the same exercised paths
    ms_apply = _time_ms(torch, lambda: step_apply(stats, t_mid, coeffs, S_t, cf_k, tau_k,
                                                  surface=row_k, **akw), 50, 5)
    ms_apply_plain = _time_ms(torch, lambda: step_apply_reference(
        stats, t_mid, coeffs, S_t, cf_p, tau_p, surface=row_p, **akw), 10, 2)
    print(f"phase 5 one step t={t_mid} at {N_PATHS} paths: moments kernel vs plain max|d| "
          f"{moments_err:.3e}, apply kernel vs plain max|d| {apply_err:.3e} | moments kernel "
          f"{ms_moments:.4f} ms plain {ms_moments_plain:.4f} ms | apply kernel {ms_apply:.4f} "
          f"ms plain {ms_apply_plain:.4f} ms", flush=True)
    del cf_k, tau_k, row_k, cf_p, tau_p, row_p

    # ---- phase 6: kernel 2's cf/tau planes vs its plain version ----------
    ckw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t,
               inv_std_t=inv_std_t, return_cf_tau=True)
    ker = lsmc_price_megakernel(full, STRIKE, R, dt, -1.0, **ckw)
    ref = lsmc_price_mega_reference(full, STRIKE, R, dt, -1.0, **ckw)
    torch.cuda.synchronize()
    cf_tau_err = max(float(torch.max(torch.abs(ker.cashflows - ref.cashflows))),
                     float(torch.max(torch.abs(ker.exercise_times - ref.exercise_times))))
    same = all(torch.equal(a, b) for a, b in zip(ker[:4], ref[:4]))
    repriced = float(torch.mean(ker.cashflows.double()
                                * torch.exp(-R * dt * ker.exercise_times.double())))
    n_ex = int((ker.exercise_times < N_STEPS).sum())
    print(f"phase 6 induction cf/tau planes {N_PATHS}x{N_STEPS}: kernel {float(ker.price):.6f} "
          f"plain {float(ref.price):.6f} | cf/tau max|d| {cf_tau_err:.3e} equal {same} | "
          f"early-exercised paths {n_ex} | planes reprice to {repriced:.6f}", flush=True)
    _require(same, f"cf/tau planes equal to the plain version (max|d| {cf_tau_err:.3e})")
    _require(abs(repriced - float(ker.price)) <= 1e-5 * float(ker.price),
             f"planes reprice {repriced:.6f} vs {float(ker.price):.6f}")
    mega_err = max(mega_err, cf_tau_err)
    del ker, ref, full

    # ---- phase 7: the fused engine's path and the Greeks at full width ----
    def fused_pricing(seed=SEED, prod=product):
        return amcx_torch.price_option(seed, market, prod, spec, sim, engine="fused",
                                       device=dev)

    torch.cuda.synchronize()
    for kernel in (gbm_paths, lsmc_price_megakernel, step_moments, step_apply):
        kernel.launches = 0
    res = fused_pricing()
    torch.cuda.synchronize()
    fused_launches = {"gbm_paths": gbm_paths.launches, "lsmc_mega": lsmc_price_megakernel.launches,
                      "lsmc_step_moments": step_moments.launches,
                      "lsmc_step_apply": step_apply.launches}
    f_price, f_se = float(res.price), float(res.stderr)
    _require(all(fused_launches[k] > 0 for k in ("gbm_paths", "lsmc_step_moments",
                                                 "lsmc_step_apply")),
             f"fused path launched its kernels {fused_launches}")
    _require(math.isfinite(f_price) and math.isfinite(f_se) and f_se > 0, "fused finite")
    _require(abs(f_price - crr) <= 4 * f_se + 0.005,
             f"fused |price - CRR-2000| = {abs(f_price - crr):.5f} <= 4*{f_se:.5f} + 0.005")
    print(f"phase 7 fused path {N_PATHS}x{N_STEPS} American put: price {f_price:.5f} stderr "
          f"{f_se:.5f} CRR-2000 {crr:.5f} |err| {abs(f_price - crr):.5f} | launches "
          f"{fused_launches}", flush=True)

    di_prod = amcx_torch.ProductSpec(K=STRIKE, T=T, barrier=90.0, option_type="put",
                                     exercise="american")
    di = fused_pricing(prod=di_prod)
    crr_di = amcx_torch.crr_down_in_price(S0, STRIKE, T, R, SIGMA, 90.0, n_steps=N_STEPS,
                                          option_type="put", american=True)
    di_err = abs(float(di.price) - crr_di)
    eu_prod = amcx_torch.ProductSpec(K=STRIKE, T=T, option_type="put", exercise="european")
    eu = fused_pricing(prod=eu_prod)
    bs = amcx_torch.bs_price(S0, STRIKE, T, R, SIGMA, option_type="put")
    eu_err = abs(float(eu.price) - bs)
    print(f"phase 7 down-in American put H=90: {float(di.price):.5f} stderr "
          f"{float(di.stderr):.5f} CRR-100 barrier tree {crr_di:.5f} |err| {di_err:.5f} | "
          f"European put {float(eu.price):.5f} stderr {float(eu.stderr):.5f} BS {bs:.5f} "
          f"|err| {eu_err:.5f}", flush=True)
    _require(di_err <= 0.2, f"down-in |price - CRR barrier tree| = {di_err:.5f} <= 0.2")
    _require(eu_err <= 4 * float(eu.stderr),
             f"European |price - BS| = {eu_err:.5f} <= 4*{float(eu.stderr):.5f}")

    torch_sim = amcx_torch.SimConfig(n_paths=N_PATHS, n_steps=N_STEPS, backend="torch")
    bsg = amcx_torch.bs_greeks(S0, STRIKE, T, R, SIGMA, option_type="put")
    greeks_ms = {}
    for route, gsim in (("fused", sim), ("fused-ad", torch_sim), ("mega", sim)):
        def greeks_run(route=route, gsim=gsim):
            return amcx_torch.price_and_greeks(SEED, market, eu_prod, spec, gsim, engine=route,
                                               device=dev)

        p, g = greeks_run()
        got = {k: float(g[k]) for k in ("delta", "vega", "rho")}
        greeks_ms[route] = _time_ms(torch, greeks_run, 3, 1)
        print(f"phase 7 Greeks engine={route} European put: price {float(p):.5f} | "
              f"{ {k: round(v, 5) for k, v in got.items()} } vs BS "
              f"{ {k: round(v, 5) for k, v in bsg.items()} } | {greeks_ms[route]:.3f} ms",
              flush=True)
        _require(abs(got["delta"] - bsg["delta"]) <= 5e-3, f"{route}: delta atol 5e-3")
        for k in ("vega", "rho"):
            _require(abs(got[k] - bsg[k]) <= 2e-2 * abs(bsg[k]), f"{route}: {k} rtol 2e-2")

    # fused-ad against fast_greeks of the same fused run (same paths, same
    # f32 r and dt tensors, so the same (cf, tau)): rtol 1e-4
    p_ad, g_ad = amcx_torch.price_and_greeks(SEED, market, product, spec, torch_sim,
                                             engine="fused-ad", device=dev)
    r_t, T_t = torch.tensor(R), torch.tensor(T)
    paths = amcx_torch.simulate_gbm(SEED, market, T_t, torch_sim, dev)
    am_spec = amcx_torch.resolve_regression_spec(spec, product, q=0.0)
    same_run = backward_induction_fused(paths, r_t, T_t / N_STEPS, STRIKE, -1.0, am_spec)
    g_fast = amcx_torch.fast_greeks(same_run, market, product, N_STEPS)
    del paths, same_run
    rel = {k: abs(float(g_ad[k]) - float(g_fast[k])) / abs(float(g_fast[k])) for k in g_fast}
    print(f"phase 7 American put fused-ad {float(p_ad):.5f} "
          f"{ {k: round(float(v), 5) for k, v in g_ad.items()} } vs fast_greeks of the same "
          f"run: max rel |d| {max(rel.values()):.3e}", flush=True)
    _require(max(rel.values()) <= 1e-4, f"fused-ad vs fast_greeks rel {rel}")

    fused_prices = []
    seeds = iter(range(SEED + 1, SEED + 1000))
    ms_fused = _time_ms(torch, lambda: fused_prices.append(fused_pricing(next(seeds)).price),
                        10, 2)
    mean10 = float(torch.stack(fused_prices[2:]).mean())
    print(f"phase 7 fused path: {ms_fused:.3f} ms/pricing (median of 10) = "
          f"{N_PATHS * N_STEPS / (ms_fused / 1e3):.4e} path-steps/s | mean of 10 timed "
          f"pricings {mean10:.5f} |err| {abs(mean10 - crr):.5f} | Greeks ms {greeks_ms}",
          flush=True)

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "gbm_paths", "route": "cuda", "source": "amcx_torch/csrc/gbm.cu",
         "replaces": "amcx/ops/gbm_pallas.py:115", "launches": launches["gbm_paths"],
         "max_abs_err": gbm_err, "ms": ms_gbm, "plain_ms": ms_gbm_plain},
        {"name": "lsmc_mega", "route": "cuda", "source": "amcx_torch/csrc/lsmc_mega.cu",
         "replaces": "amcx/ops/lsmc_megakernel.py:282", "launches": launches["lsmc_mega"],
         "max_abs_err": mega_err, "ms": ms_mega, "plain_ms": ms_mega_plain},
        {"name": "lsmc_step_moments", "route": "cuda", "source": "amcx_torch/csrc/lsmc_step.cu",
         "replaces": "amcx/ops/lsmc_pallas.py:117",
         "launches": fused_launches["lsmc_step_moments"],
         "max_abs_err": max(moments_err, fused_err), "ms": ms_moments,
         "plain_ms": ms_moments_plain},
        {"name": "lsmc_step_apply", "route": "cuda", "source": "amcx_torch/csrc/lsmc_step.cu",
         "replaces": "amcx/ops/lsmc_pallas.py:249", "launches": fused_launches["lsmc_step_apply"],
         "max_abs_err": max(apply_err, fused_err), "ms": ms_apply, "plain_ms": ms_apply_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

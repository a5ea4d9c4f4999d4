#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`amcx_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels from ``amcx_torch/csrc`` (first use), holds each one
against its plain PyTorch version on the card at the main path's shape,
prices the flagship
1,048,576-path x 100-step American put through ``amcx_torch.price_option``
(engine="mega", Philox pathgen) against the CRR-2000 oracle, and times the
pricing, each kernel and each plain version with CUDA events. Any failed
phase raises (non-zero exit). Without a CUDA device, or outside a checkout,
it exits non-zero and prints no result.

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
    from amcx_torch.ops import _build
    from amcx_torch.ops.gbm import gbm_paths, gbm_paths_reference
    from amcx_torch.ops.lsmc_megakernel import (lsmc_price_mega_reference,
                                                lsmc_price_megakernel)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- phase 1: environment + build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.library()
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

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "gbm_paths", "route": "cuda", "source": "amcx_torch/csrc/gbm.cu",
         "replaces": "amcx/ops/gbm_pallas.py:115", "launches": launches["gbm_paths"],
         "max_abs_err": gbm_err, "ms": ms_gbm, "plain_ms": ms_gbm_plain},
        {"name": "lsmc_mega", "route": "cuda", "source": "amcx_torch/csrc/lsmc_mega.cu",
         "replaces": "amcx/ops/lsmc_megakernel.py:282", "launches": launches["lsmc_mega"],
         "max_abs_err": mega_err, "ms": ms_mega, "plain_ms": ms_mega_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

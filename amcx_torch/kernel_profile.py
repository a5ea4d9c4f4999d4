"""Device time of the univariate induction kernel (kernel 2) by phase.

Run from the root of a checkout on a machine with a CUDA card:

    python3 -m amcx_torch.kernel_profile [--reps 20] [--label NAME]

It prices the flagship put (1,048,576 Philox paths x 100 steps, S0 = K =
100, r = 1%, sigma = 20%, T = 1, Chebyshev degree 4, ITM fit) with
``lsmc_price_megakernel`` on fixed paths and prints one JSON line: the
median ms per induction by CUDA events, the device microseconds per
induction of each kernel by name (``torch.profiler``), and a SHA-256 of the
price, stderr and coefficient bits, so two checkouts run one after the
other on the same card can be compared phase by phase and bit for bit. It
uses only entry points that every version of the port has had.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: needs a CUDA card")
    import amcx_torch
    from amcx_torch.ops.gbm import gbm_paths
    from amcx_torch.ops.lsmc_megakernel import lsmc_price_megakernel

    dev = torch.device("cuda", 0)
    n_paths, n_steps, S0, r, sigma, K, T = 1_048_576, 100, 100.0, 0.01, 0.2, 100.0, 1.0
    paths = gbm_paths(20261016, S0, r, sigma, 0.0, T, n_steps, n_paths, device=dev)
    mean_t, inv_std_t = amcx_torch.gbm_standardization(amcx_torch.MarketParams(S0, r, sigma), T,
                                                       n_steps, device=dev)
    kw = dict(basis="chebyshev", degree=4, itm_weights=True, mean_t=mean_t, inv_std_t=inv_std_t)

    def run():
        return lsmc_price_megakernel(paths, K, r, T / n_steps, -1.0, return_coeffs=True, **kw)

    res = run()
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for x in (res.price, res.stderr, res.coeffs):
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0][:60]
            per_name[name] = per_name.get(name, 0.0) + e.time_range.end - e.time_range.start
    print(json.dumps({
        "label": args.label, "device": torch.cuda.get_device_name(0),
        "price": float(res.price), "bits_sha256": digest.hexdigest(),
        "ms_median": statistics.median(times), "ms_min": min(times),
        "device_us_per_induction": {k: v / args.reps for k, v in
                                    sorted(per_name.items(), key=lambda kv: -kv[1])}}))


if __name__ == "__main__":
    main()

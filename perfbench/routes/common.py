"""What the route adapters share: the program's inputs from a configuration,
a synchronising host clock, and the reference run of a route."""

from __future__ import annotations

import time

import torch

from ..reference import lsmc, streams


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(dev, fn, /, *args, **kwargs):
    """``(fn(...), seconds)`` by the host clock, ended by a synchronise."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync(dev)
    return out, time.perf_counter() - t0


def to_host(price, stderr) -> dict:
    """A pricing's 0-d price and stderr on the host, in one copy."""
    price, stderr = torch.stack([torch.as_tensor(price, dtype=torch.float64),
                                 torch.as_tensor(stderr, dtype=torch.float64)]).tolist()
    return {"price": price, "stderr": stderr}


def option_inputs(cfg: dict):
    """The program's ``MarketParams``, ``ProductSpec``, ``RegressionSpec`` and
    ``SimConfig`` of a single-asset option configuration."""
    import amcx_torch

    m, p, reg = cfg["market"], cfg["product"], cfg["regression"]
    market = amcx_torch.MarketParams(S0=m["S0"], r=m["r"], sigma=m["sigma"], q=m.get("q", 0.0))
    product = amcx_torch.ProductSpec(K=p["K"], T=p["T"], option_type=p["payoff"],
                                     exercise=p["exercise"])
    spec = amcx_torch.RegressionSpec(basis=reg["basis"], degree=reg["degree"],
                                     rcond=reg["rcond"])
    sim = amcx_torch.SimConfig(n_paths=cfg["n_paths"], n_steps=cfg["n_steps"],
                               backend=cfg.get("backend", "torch"))
    return market, product, spec, sim


def reference(cfg: dict, seed: int, device, stream: str, spec: dict,
              dtype=torch.float64) -> dict:
    """The plain reference of one pricing: the stream's paths from ``seed``,
    then :func:`perfbench.reference.lsmc.induction` in ``dtype``, with its own
    fits and exercise. Values on the host."""
    p = cfg["product"]
    paths = streams.STREAMS[stream](seed, cfg["market"], p["T"], cfg["n_steps"],
                                    cfg["n_paths"], device)
    reg = dict(spec, degree=cfg["regression"]["degree"], rcond=cfg["regression"]["rcond"])
    if cfg["regression"]["basis"] != "chebyshev":
        raise ValueError("the reference evaluates the Chebyshev basis only")
    out = lsmc.induction(paths, p, cfg["market"], reg, dtype=dtype)
    del paths
    return {"price": float(out["price"]), "stderr": float(out["stderr"])}

"""``price_option(engine="mega", surface_stats=True)`` on Philox paths: kernel
1 writes the path array, kernel 2 runs the all-paths induction and exports
its coefficients, and the exposure kernel turns paths, coefficients and the
closed-form frame into EPE, PFE-5 and PFE-95 on every date.

``judge`` adds two numbers to the put's ``price_gap`` and ``stderr_gap``,
each the largest over the dates 0 .. n_steps - 1 of a gap over the
reference's EPE on that date: ``epe_gap`` of EPE, ``pfe_gap`` of either
band. A value that is not finite reads as an infinite gap."""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import check
from ..reference import ccr, streams
from . import common

STREAM = "philox_gbm"
SPEC = {"weights": "all", "solver": "ridge", "frame": "closed_form"}
BANDS = ("pfe5", "pfe95")
# the entry's time is read by the program's spans; no layer is timed alone
REST = None


def profile_gaps(prog: dict, ref: dict) -> dict:
    """``epe_gap`` and ``pfe_gap`` of a pricing's profile against the
    reference's (the maturity date, zero in both, left out)."""
    def gap(a, b, scale):
        if not (math.isfinite(a) and math.isfinite(b)) or not scale > 0:
            return math.inf
        return abs(a - b) / scale

    dates = range(len(ref["epe"]) - 1)
    return {"epe_gap": max(gap(prog["epe"][t], ref["epe"][t], ref["epe"][t]) for t in dates),
            "pfe_gap": max(gap(prog[b][t], ref[b][t], ref["epe"][t])
                           for b in BANDS for t in dates)}


class Route:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.market, self.product, spec, self.sim = common.option_inputs(cfg)
        self.spec = dataclasses.replace(spec, regress_on=cfg["regression"]["regress_on"])

    def price(self, seed: int) -> dict:
        import amcx_torch

        res = amcx_torch.price_option(seed, self.market, self.product, self.spec, self.sim,
                                      engine="mega", device=self.device, surface_stats=True)
        e = res.exposures
        f64 = torch.float64
        # price, stderr and the three rows on the host in one copy
        vals = torch.cat([torch.stack([res.price, res.stderr]).to(f64), e.epe.to(f64),
                          e.pfe5.to(f64), e.pfe95.to(f64)]).tolist()
        n = e.epe.shape[0]
        return {"price": vals[0], "stderr": vals[1], "epe": vals[2:2 + n],
                "pfe5": vals[2 + n:2 + 2 * n], "pfe95": vals[2 + 2 * n:]}

    def layers(self, seed: int) -> dict:
        return {}

    def reference(self, seed: int, dtype=torch.float64) -> dict:
        cfg, p = self.cfg, self.cfg["product"]
        paths = streams.philox_gbm(seed, cfg["market"], p["T"], cfg["n_steps"], cfg["n_paths"],
                                   self.device)
        spec = dict(SPEC, degree=cfg["regression"]["degree"], rcond=cfg["regression"]["rcond"])
        out = ccr.induction_profile(paths, p, cfg["market"], spec, dtype=dtype)
        del paths
        rows = torch.stack([out["epe"], out["pfe5"], out["pfe95"]]).tolist()
        return {"price": float(out["price"]), "stderr": float(out["stderr"]),
                "epe": rows[0], "pfe5": rows[1], "pfe95": rows[2]}

    def judge(self, seed: int, prog: dict) -> dict:
        ref = self.reference(seed)
        return {**check.price_gaps(prog, ref), **profile_gaps(prog, ref)}

    def control(self, seed: int) -> dict:
        return self.reference(seed, torch.bfloat16)

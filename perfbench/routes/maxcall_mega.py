"""``price_max_call(engine="mega")``: correlated-GBM paths of the basket by
torch operations from a ``torch.Generator``, then kernel 7's induction (two
launches a step) on the sorted basket's degree-2 cross terms, fitted on all
paths in the frame of each order statistic's mean and standard deviation,
exercisable from the first date."""

from __future__ import annotations

import torch

from .. import check
from . import common

STREAM = "randn_basket"
SPEC = {"weights": "all", "solver": "ridge", "frame": "sorted_data"}
# no public function of the program runs the induction (``prepare`` and
# kernel 7) alone: its time is the entry's less the pathgen's span
REST = "induction"


class Route:
    def __init__(self, cfg: dict, device):
        import amcx_torch

        self.cfg, self.device = cfg, torch.device(device)
        m, p = cfg["market"], cfg["product"]
        self.args = dict(S0=m["S0"], K=p["K"], T=p["T"], r=m["r"], sigma=m["sigma"], q=m["q"])
        self.spec = amcx_torch.RegressionSpec(basis=cfg["regression"]["basis"],
                                              degree=cfg["regression"]["degree"],
                                              rcond=cfg["regression"]["rcond"])
        self.sim = amcx_torch.SimConfig(n_paths=cfg["n_paths"], n_steps=cfg["n_steps"])

    def price(self, seed: int) -> dict:
        import amcx_torch

        res = amcx_torch.price_max_call(seed, **self.args, n_exercise_dates=self.sim.n_steps,
                                        n_paths=self.sim.n_paths, spec=self.spec,
                                        engine="mega", device=self.device)
        return common.to_host(res.price, res.stderr)

    def layers(self, seed: int) -> dict:
        import amcx_torch

        a = self.args
        _, t_path = common.timed(self.device, amcx_torch.simulate_gbm_multi, seed, a["S0"],
                                 a["r"], a["sigma"], a["T"], self.sim, q=a["q"],
                                 device=self.device)
        return {"pathgen": t_path}

    def reference(self, seed: int, dtype=torch.float64) -> dict:
        return common.reference(self.cfg, seed, self.device, STREAM, SPEC, dtype)

    def judge(self, seed: int, prog: dict) -> dict:
        return check.price_gaps(prog, self.reference(seed))

    def control(self, seed: int) -> dict:
        return self.reference(seed, torch.bfloat16)


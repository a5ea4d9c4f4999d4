"""``price_option(engine="mega")`` on Philox paths: kernel 1 writes the path
array, kernel 2 runs the whole induction in one cooperative launch, in the
closed-form frame with the in-the-money fit."""

from __future__ import annotations

import torch

from .. import check
from . import common

STREAM = "philox_gbm"
SPEC = {"weights": "itm", "solver": "ridge", "frame": "closed_form"}
# no public function of the program runs the induction alone: its time is the
# entry's less the pathgen's span
REST = "induction"


class Route:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.market, self.product, self.spec, self.sim = common.option_inputs(cfg)

    def price(self, seed: int) -> dict:
        import amcx_torch

        res = amcx_torch.price_option(seed, self.market, self.product, self.spec, self.sim,
                                      engine="mega", device=self.device)
        return common.to_host(res.price, res.stderr)

    def layers(self, seed: int) -> dict:
        import amcx_torch

        _, t_path = common.timed(self.device, amcx_torch.simulate_gbm, seed, self.market,
                                 self.product.T, self.sim, self.device)
        return {"pathgen": t_path}

    def reference(self, seed: int, dtype=torch.float64) -> dict:
        return common.reference(self.cfg, seed, self.device, STREAM, SPEC, dtype)

    def judge(self, seed: int, prog: dict) -> dict:
        return check.price_gaps(prog, self.reference(seed))

    def control(self, seed: int) -> dict:
        return self.reference(seed, torch.bfloat16)

"""``price_option(engine="fusedpath")``: kernel 6 regenerates each step's
spots from a counter-based Philox stream by a backward Brownian bridge and
prices them in the same cooperative launch; no path array exists."""

from __future__ import annotations

import torch

from .. import check
from . import common

STREAM = "philox_bridge"
SPEC = {"weights": "itm", "solver": "ridge", "frame": "closed_form"}
REST = None  # every layer runs in a public function of its own


class Route:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.market, self.product, self.spec, self.sim = common.option_inputs(cfg)

    def price(self, seed: int) -> dict:
        import amcx_torch

        res = amcx_torch.price_option(seed, self.market, self.product, self.spec, self.sim,
                                      engine="fusedpath", device=self.device)
        return common.to_host(res.price, res.stderr)

    def layers(self, seed: int) -> dict:
        import amcx_torch

        m, p, n = self.market, self.product, self.sim.n_steps
        _, t_ind = common.timed(
            self.device, amcx_torch.lsmc_price_fusedpath, seed, m.S0, p.K, m.r, m.sigma,
            p.T / n, n, self.sim.n_paths, -1.0 if p.option_type == "put" else 1.0, q=m.q,
            basis=self.spec.basis, degree=self.spec.degree, rcond=self.spec.rcond,
            american=True, itm_weights=True, return_stats=True, device=self.device)
        return {"induction": t_ind}

    def reference(self, seed: int, dtype=torch.float64) -> dict:
        return common.reference(self.cfg, seed, self.device, STREAM, SPEC, dtype)

    def judge(self, seed: int, prog: dict) -> dict:
        return check.price_gaps(prog, self.reference(seed))

    def control(self, seed: int) -> dict:
        return self.reference(seed, torch.bfloat16)

"""``price_option(engine="mega")`` on randomized-QMC paths
(``SimConfig(backend="sobol-bridge")``): a new seed's direction tables are
built on the host and put on the card (the program span
``pathgen.tables``), kernel 11 writes the path array in Brownian-bridge
order, and kernel 2 runs the induction in one cooperative launch, in the
closed-form frame with the in-the-money fit. Every pricing's seed is new, so
every pricing draws a new scramble.

``judge`` holds a pricing to the reference by a chain of numbers, because
the prices of two scrambles, or of half a scrambled net and the whole,
differ by a fraction of a standard error, as float32 exercise flips move
one:

- ``price_gap`` and ``stderr_gap``: the put's, against the plain reference;
- ``path_gap``: the largest |S - S_ref| / S_ref over every date and path
  between the program's paths for the seed (``simulate_gbm``, the function
  ``price_option`` calls) and the reference's, which holds the pathgen to a
  new scramble for each seed;
- ``replay_gap``: kernel 2 run again on those paths, with the cash-flow and
  exercise-date planes, against the timed pricing's price and stderr, in
  reference stderrs. Kernel 2 gives the same bits on the same paths, so an
  honest pricing reads 0; a timed pricing on other paths, or with other
  tables, does not;
- ``planes_price_gap`` and ``planes_stderr_gap``: the price and stderr that
  the replay's planes give over every path, discounted in float64, against
  the timed pricing's, in reference stderrs: sums that leave paths out
  differ, whatever mean they take over the rest.

The control brings its own paths and no kernel run, so it reads ``inf`` on
the three replay numbers. A value that is not finite reads as an infinite
gap.

The configuration's backend is set up in ``Route.__init__``: a program
without the Sobol backends refuses it there, before any pricing."""

from __future__ import annotations

import math

import torch

from .. import check
from ..reference import lsmc, sobol
from . import common

SPEC = {"weights": "itm", "solver": "ridge", "frame": "closed_form"}
REPLAY = ("replay_gap", "planes_price_gap", "planes_stderr_gap")
# the entry's time is read by the program's spans; no layer is timed alone
REST = None


def path_gap(paths: torch.Tensor, ref: torch.Tensor) -> float:
    """max |paths - ref| / ref over every entry; inf where the shapes differ
    or a value is not finite."""
    if tuple(paths.shape) != tuple(ref.shape):
        return math.inf
    gap = float(torch.max(torch.abs(paths.to(ref.dtype) - ref) / ref))
    return gap if math.isfinite(gap) else math.inf


def planes_stats(cf: torch.Tensor, tau: torch.Tensor, rdt: float, n_paths: int):
    """``(price, stderr)`` of the undiscounted cash flows ``cf`` paid at the
    steps ``tau``, discounted by ``exp(-rdt * tau)`` in float64; ``(inf,
    inf)`` unless both planes hold ``n_paths`` entries."""
    if tuple(cf.shape) != (n_paths,) or tuple(tau.shape) != (n_paths,):
        return math.inf, math.inf
    v = cf.to(torch.float64) * torch.exp(-rdt * tau.to(torch.float64))
    price = torch.mean(v)
    stderr = torch.sqrt(torch.mean(torch.square(v - price)) / n_paths)
    return float(price), float(stderr)


def replay_gaps(prog: dict, replay: dict, planes: tuple, ref_stderr: float) -> dict:
    """The three replay numbers of a timed pricing ``prog``, its ``replay``
    and the replay's ``planes_stats``."""
    gap = check._gap
    return {"replay_gap": max(gap(prog["price"], replay["price"], ref_stderr),
                              gap(prog["stderr"], replay["stderr"], ref_stderr)),
            "planes_price_gap": gap(prog["price"], planes[0], ref_stderr),
            "planes_stderr_gap": gap(prog["stderr"], planes[1], ref_stderr)}


class Route:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.market, self.product, self.spec, self.sim = common.option_inputs(cfg)

    def price(self, seed: int) -> dict:
        import amcx_torch
        from amcx_torch.ops import sobol_pallas

        # Forget the cached tables, so that a seed priced twice builds them
        # again as every new seed does: the span phase of perfbench/spans.py
        # prices its lead-in seed a second time, and a cached seed runs two
        # device operations fewer than the profiled pricings.
        sobol_pallas._device_tables.cache_clear()
        res = amcx_torch.price_option(seed, self.market, self.product, self.spec, self.sim,
                                      engine="mega", device=self.device)
        return common.to_host(res.price, res.stderr)

    def layers(self, seed: int) -> dict:
        return {}

    def reference(self, seed: int, dtype=torch.float64) -> dict:
        """The plain reference's price, stderr and float64 paths."""
        cfg, p = self.cfg, self.cfg["product"]
        if cfg["regression"]["basis"] != "chebyshev":
            raise ValueError("the reference evaluates the Chebyshev basis only")
        paths = sobol.sobol_bridge(seed, cfg["market"], p["T"], cfg["n_steps"], cfg["n_paths"],
                                   self.device, dtype)
        spec = dict(SPEC, degree=cfg["regression"]["degree"], rcond=cfg["regression"]["rcond"])
        out = lsmc.induction(paths, p, cfg["market"], spec, dtype=dtype)
        return {"price": float(out["price"]), "stderr": float(out["stderr"]), "paths": paths}

    def replay(self, paths: torch.Tensor) -> tuple:
        """Kernel 2 on ``paths`` with ``price_option(engine="mega")``'s rows
        and options, the planes returned: ``({"price", "stderr"}, (planes
        price, planes stderr))``."""
        from amcx_torch import resolve_regression_spec
        from amcx_torch.ops.lsmc_megakernel import closed_form_frame, lsmc_price_megakernel

        m, p, n_steps = self.market, self.product, self.sim.n_steps
        spec = resolve_regression_spec(self.spec, p, q=m.q)
        dt = p.T / n_steps
        mean_t, inv_std_t = closed_form_frame(float(m.S0), float(m.r), float(m.sigma),
                                              float(m.q), float(p.T), n_steps,
                                              device=paths.device)
        out = lsmc_price_megakernel(paths, p.K, float(m.r), dt,
                                    1.0 if p.option_type == "call" else -1.0,
                                    basis=spec.basis, degree=spec.degree, rcond=spec.rcond,
                                    american=p.is_american, itm_weights=spec.regress_on == "itm",
                                    mean_t=mean_t, inv_std_t=inv_std_t, return_cf_tau=True)
        planes = planes_stats(out.cashflows, out.exercise_times, float(m.r) * dt,
                              self.sim.n_paths)
        return common.to_host(out.price, out.stderr), planes

    def judge(self, seed: int, prog: dict) -> dict:
        ref = self.reference(seed)
        gaps = check.price_gaps(prog, ref)
        if "paths" in prog:  # the control: its own paths, and no kernel run to replay
            return {**gaps, "path_gap": path_gap(prog["paths"], ref["paths"]),
                    **dict.fromkeys(REPLAY, math.inf)}
        import amcx_torch

        paths = amcx_torch.simulate_gbm(seed, self.market, self.product.T, self.sim,
                                        self.device)
        replay, planes = self.replay(paths)
        return {**gaps, "path_gap": path_gap(paths, ref["paths"]),
                **replay_gaps(prog, replay, planes, ref["stderr"])}

    def control(self, seed: int) -> dict:
        return self.reference(seed, torch.bfloat16)

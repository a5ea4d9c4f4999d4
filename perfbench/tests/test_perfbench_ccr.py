"""The CCR cell's files at a small size on the CPU: the work count, the
reference's profile, the profile gaps, the three analytics readers, and
``correct`` for the program and not for the control."""

import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench import check, roofline, run  # noqa: E402
from perfbench.reference import ccr, lsmc, streams  # noqa: E402
from perfbench.routes import ccr_put_mega  # noqa: E402
from perfbench.work import ccr_put_mega as ccr_work  # noqa: E402

sys.path.remove(str(ROOT))

CELL = "put-1M-ccr.mega"
SMALL = {"n_paths": 16384, "n_steps": 16}
SEED = 2 ** 31 + 2718
MARKET = {"S0": 100.0, "r": 0.01, "sigma": 0.2, "q": 0.0}
PUT = {"payoff": "put", "K": 100.0, "T": 1.0, "exercise_from_step": 0}
ALL = {"weights": "all", "solver": "ridge", "frame": "closed_form", "degree": 4, "rcond": 1e-6}


def _metric(name):
    return run.Cell(run.load_manifest(ROOT), CELL).reader(name)


def test_work_by_hand():
    # degree 1 (k = 2): the fit is x (2), no recurrence, 2 products and a sum, the clamp
    cfg = {"n_paths": 8, "n_steps": 4, "regression": {"degree": 1}}
    w = ccr_work.work(cfg)
    assert w["analytics"] == {"bytes": 4 * 8 * 4 + 5 * 4 * 4 + 3 * 5 * 4, "f32": 4 * 8 * 6,
                              "f64": 4 * 8}
    assert ccr_work.analytics_f32(5) == 21  # Chebyshev degree 4
    assert {"pathgen", "induction"} <= set(w)


def test_the_flagship_analytics_bound_is_its_path_read():
    w = ccr_work.work({"n_paths": 1_048_576, "n_steps": 100, "regression": {"degree": 4}})
    assert roofline.bound_s(w["analytics"]) == pytest.approx(100 * 1_048_576 * 4 / 3.35e12,
                                                             rel=1e-5)


def test_reference_profile():
    paths = streams.philox_gbm(SEED, MARKET, 1.0, 12, 4096, "cpu")
    out = ccr.induction_profile(paths, PUT, MARKET, ALL)
    price = lsmc.induction(paths, PUT, MARKET, ALL)
    assert float(out["price"]) == float(price["price"])
    assert float(out["stderr"]) == float(price["stderr"])
    assert out["epe"].shape == (13,) and float(out["epe"][12]) == 0.0
    assert bool((out["pfe5"][1:12] <= out["epe"][1:12]).all())
    assert bool((out["epe"][1:12] <= out["pfe95"][1:12]).all())
    # t = 0: every path is S0, so one continuation value (its mean to rounding)
    assert float(out["pfe5"][0]) == float(out["pfe95"][0])
    assert float(out["epe"][0]) == pytest.approx(float(out["pfe95"][0]), rel=1e-12)
    srt = torch.sort(torch.tensor([3.0, 1.0, 4.0, 1.0, 5.0], dtype=torch.float64)).values
    for q in (5.0, 37.5, 95.0):
        assert float(ccr._percentile(srt, q)) == pytest.approx(np.percentile(srt.numpy(), q))


def test_profile_gaps():
    ref = {"epe": [2.0, 4.0, 0.0], "pfe5": [1.0, 2.0, 0.0], "pfe95": [3.0, 8.0, 0.0]}
    prog = {"epe": [2.2, 4.0, 9.0], "pfe5": [1.0, 1.0, 9.0], "pfe95": [3.0, 8.0, 9.0]}
    gaps = ccr_put_mega.profile_gaps(prog, ref)
    assert gaps["epe_gap"] == pytest.approx(0.1) and gaps["pfe_gap"] == pytest.approx(0.25)
    prog["pfe95"][0] = math.nan
    assert ccr_put_mega.profile_gaps(prog, ref)["pfe_gap"] == math.inf


def test_readers_read_nothing_without_the_span():
    ctx = {"trace": {}, "work": {}, "program": {"trace": {"names": ["entry"], "waits": {},
                                                          "entry_waits": [0, 0],
                                                          "device_s": {}},
                                                "self_s": [{"entry": 0.001}]}}
    for name in ("analytics.host_waits", "analytics.self_ms", "analytics.device_roofline_pct"):
        assert _metric(name)(ctx) is None


def test_readers_read_the_span():
    work = ccr_work.work({"n_paths": 1_048_576, "n_steps": 100, "regression": {"degree": 4}})
    bound = roofline.bound_s(work["analytics"])
    ctx = {"trace": {}, "work": work,
           "program": {"trace": {"names": ["analytics", "entry"],
                                 "waits": {"analytics": 2, "entry": 8},
                                 "entry_waits": [5, 5, 5, 5],
                                 "device_s": {"analytics": [4 * bound] * 3,
                                              "induction": [1.0] * 3}},
                       "self_s": [{"analytics": 5e-5}, {"analytics": 7e-5},
                                  {"analytics": 6e-5}]}}
    assert _metric("analytics.host_waits")(ctx) == 0.5
    assert _metric("analytics.self_ms")(ctx) == pytest.approx(0.06)
    assert _metric("analytics.device_roofline_pct")(ctx) == pytest.approx(25.0)


def test_program_is_correct_and_the_control_is_not():
    cell = run.Cell(run.load_manifest(ROOT), CELL, SMALL)
    result, _ = run.run_cell(cell, SEED, 0.2, False, "cpu", time.monotonic())
    assert result["failed"] == 0 and result["correct"], result["check"]
    route = cell.route.Route(cell.config, torch.device("cpu"))
    readings = [route.judge(s, route.control(s)) for s in (SEED, SEED + 1)]
    correct, numbers = check.judge(readings, cell.limits)
    assert not correct, numbers

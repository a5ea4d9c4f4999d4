"""The randomized-QMC cell's files at a small size on the CPU: ``correct``
true for the program and false for the control and for each planted fault
(a step that leaves its state unchanged; half the paths left out with the
mean taken over the rest, with the cash-flow planes cut to the rest or left
whole; the price altered by 1%; the scramble not renewed; a timed pricing on
another seed's paths); the replay numbers; the reference's stream and
bisection; the two new readers; the work count by hand."""

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
from perfbench.reference import sobol  # noqa: E402
from perfbench.routes import rqmc_put_mega  # noqa: E402
from perfbench.work import rqmc_put_mega as rqmc_work  # noqa: E402

sys.path.remove(str(ROOT))

CELL = "put-1M-rqmc.mega"
SMALL = {"n_paths": 131072, "n_steps": 16}
SEED = 2 ** 31 + 4321
MARKET = {"S0": 100.0, "r": 0.01, "sigma": 0.2, "q": 0.0}


def _cell():
    return run.Cell(run.load_manifest(ROOT), CELL, SMALL)


def _run():
    result, _ = run.run_cell(_cell(), SEED, 0.2, False, "cpu", time.monotonic())
    return result


@pytest.fixture
def fresh_tables():
    """No table of an earlier test's seed survives into this one, or out of it."""
    from amcx_torch.ops import sobol_pallas

    sobol_pallas._device_tables.cache_clear()
    yield
    sobol_pallas._device_tables.cache_clear()


def test_program_is_correct_and_the_control_is_not(fresh_tables):
    result = _run()
    assert result["failed"] == 0 and result["correct"], result["check"]
    cell = _cell()
    route = cell.route.Route(cell.config, torch.device("cpu"))
    readings = [route.judge(s, route.control(s)) for s in (SEED, SEED + 1)]
    correct, numbers = check.judge(readings, cell.limits)
    assert not correct, numbers


@pytest.mark.parametrize("fault", ["unchanged", "half", "half-sums", "altered"])
def test_induction_fault_is_not_correct(fault, monkeypatch, fresh_tables):
    # "half": the kernel is handed the first half of the paths and its sums
    # are doubled, the mean over the rest (test_perfbench_correct.py's
    # fault); "half-sums": every path is priced and written to the planes,
    # and the sums are doubled over the first half. The price of half a
    # scrambled net is itself a randomized-QMC estimate, 0.003-0.48
    # reference stderrs from the reference over 40 seeds at this size, so
    # price_gap alone does not see either: the planes' sums over every path do
    from amcx_torch.ops import lsmc_megakernel as mod

    orig = mod._mega_reference

    def broken(paths, stats, K, phi, rcond, basis, degree, american, itm_weights, cf_tau=False):
        if fault == "unchanged":
            american = False
        if fault == "half":
            paths = paths[:, :paths.shape[1] // 2].contiguous()
        sums, coeffs, V, cf, tau = orig(paths, stats, K, phi, rcond, basis, degree, american,
                                        itm_weights, cf_tau)
        if fault == "half":
            sums = 2 * sums
        if fault == "half-sums":
            v = (stats.view(4, -1)[2, 0] * V)[:V.shape[0] // 2]
            sums = 2 * torch.stack([torch.sum(v, dtype=torch.float64),
                                    torch.sum(v * v, dtype=torch.float64)]).float()
        if fault == "altered":
            sums = sums * torch.tensor([1.01, 1.0])
        return sums, coeffs, V, cf, tau
    monkeypatch.setattr(mod, "_mega_reference", broken)
    result = _run()
    assert not result["correct"], result["check"]
    if fault.startswith("half"):  # seen by the sums over every path
        assert result["check"]["planes_price_gap"]["value"] > 0.01, result["check"]


def test_a_scramble_that_is_not_renewed_is_not_correct(monkeypatch, fresh_tables):
    from amcx_torch.ops import sobol_pallas as mod

    scramble = mod._scramble
    monkeypatch.setattr(mod, "_scramble",  # one scramble, whatever the seed
                        lambda seed, n_steps: scramble(7, n_steps))
    result = _run()
    assert not result["correct"], result["check"]
    assert result["check"]["path_gap"]["value"] > 0.01


def test_a_pricing_on_another_seeds_paths_is_not_correct(monkeypatch, fresh_tables):
    # the entry draws the paths of a seed it was not given (it imports
    # simulate_gbm from amcx_torch.paths at each call), while the judge's
    # amcx_torch.simulate_gbm stays right: only the replay of kernel 2 on the
    # seed's own paths tells the two pricings apart
    import amcx_torch
    from amcx_torch import paths

    simulate = amcx_torch.simulate_gbm
    monkeypatch.setattr(paths, "simulate_gbm",
                        lambda seed, *args: simulate(seed + 2 ** 20, *args))
    result = _run()
    assert not result["correct"], result["check"]
    assert result["check"]["replay_gap"]["value"] > 0.01
    assert result["check"]["path_gap"]["value"] < 1e-3


def test_an_honest_replay_reads_zero(fresh_tables):
    cell = _cell()
    route = cell.route.Route(cell.config, torch.device("cpu"))
    prog = route.price(SEED)
    got = route.judge(SEED, prog)
    assert got["replay_gap"] == 0.0
    assert got["planes_price_gap"] < 1e-4 and got["planes_stderr_gap"] < 1e-6, got
    ctrl = route.judge(SEED, route.control(SEED))
    assert all(ctrl[k] == math.inf for k in rqmc_put_mega.REPLAY)


def test_planes_stats():
    cf = torch.tensor([4.0, 0.0, 2.0, 6.0])
    tau = torch.tensor([1.0, 4.0, 0.0, 2.0])
    v = cf.double() * torch.exp(-0.01 * tau.double())
    price, stderr = rqmc_put_mega.planes_stats(cf, tau, 0.01, 4)
    assert price == pytest.approx(float(v.mean()), rel=1e-15)
    assert stderr == pytest.approx(float(v.std(unbiased=False) / 2.0), rel=1e-13)
    assert rqmc_put_mega.planes_stats(cf[:2], tau[:2], 0.01, 4) == (math.inf, math.inf)


def test_path_gap():
    ref = torch.tensor([[100.0, 100.0], [90.0, 110.0]], dtype=torch.float64)
    assert rqmc_put_mega.path_gap(ref.float(), ref) == 0.0
    moved = ref * torch.tensor([1.0, 1.002], dtype=torch.float64)
    assert rqmc_put_mega.path_gap(moved, ref) == pytest.approx(0.002)
    assert rqmc_put_mega.path_gap(ref[:, :1], ref) == math.inf
    assert rqmc_put_mega.path_gap(ref * math.nan, ref) == math.inf


def test_the_reference_stream_is_scipys_net_in_natural_order():
    from scipy.stats import qmc

    n, n_steps = 1024, 8
    paths = sobol.sobol_bridge(SEED, MARKET, 1.0, n_steps, n, "cpu")
    assert paths.shape == (n_steps + 1, n) and bool((paths[0] == 100.0).all())
    # W_T = sqrt(T) z_0: the first dimension's normals, path p at natural index p
    x = qmc.Sobol(d=n_steps, scramble=True, seed=SEED).random(n)[:, 0]
    k = np.arange(n)
    z = np.empty(n)
    z[k ^ (k >> 1)] = torch.special.ndtri(
        (torch.floor(torch.from_numpy(x) * 2.0 ** 23) + 0.5) / 2.0 ** 23).numpy()
    drift = 0.01 - 0.5 * 0.2 ** 2
    want = 100.0 * np.exp(drift + 0.2 * z)
    np.testing.assert_allclose(paths[-1].numpy(), want, rtol=1e-13)
    with pytest.raises(ValueError, match="power-of-two"):
        sobol.sobol_bridge(SEED, MARKET, 1.0, n_steps, 1536, "cpu")


@pytest.mark.parametrize("n_steps", [1, 2, 3, 7, 24, 100])
def test_bisection_covariance_is_brownian(n_steps):
    B = sobol.bisection_matrix(n_steps, 2.0)
    t = torch.arange(1, n_steps + 1, dtype=torch.float64) * (2.0 / n_steps)
    torch.testing.assert_close(B @ B.T, torch.minimum(t[:, None], t[None, :]), rtol=0,
                               atol=1e-13)
    assert float(B[-1, 0]) == pytest.approx(2.0 ** 0.5)  # dimension 0 drives W_T
    if n_steps > 1:  # then dimension 1 the midpoint, with no dimension past it
        m = n_steps // 2
        assert float(B[m - 1, 1]) > 0 and not bool(B[m - 1, 2:].any())


def _metric(name):
    return run.Cell(run.load_manifest(ROOT), CELL).reader(name)


def test_readers_read_nothing_without_the_span():
    ctx = {"trace": {}, "work": {},
           "program": {"trace": {"names": ["entry", "pathgen"], "window_s": 0.05,
                                 "idle_s": {"pathgen": 0.01}},
                       "span_ms": {"entry": 2.0, "pathgen": 1.0}}}
    for name in ("pathgen.tables_self_ms", "pathgen.idle_pct"):
        assert _metric(name)(ctx) is None
        assert _metric(name)({}) is None


def test_readers_read_the_span():
    ctx = {"trace": {}, "work": {},
           "program": {"trace": {"names": ["entry", "pathgen", "pathgen.tables"],
                                 "window_s": 0.05,
                                 "idle_s": {"pathgen": 0.01, "pathgen.tables": 0.02,
                                            "entry": 0.005}},
                       "span_ms": {"entry": 9.0, "pathgen": 8.0, "pathgen.tables": 6.5}}}
    assert _metric("pathgen.tables_self_ms")(ctx) == 6.5
    assert _metric("pathgen.idle_pct")(ctx) == pytest.approx(60.0)


def test_work_by_hand():
    # 4 steps: B's rows are W_1 (dims 0, 1, 2), W_2 (0, 1), W_3 (0, 1, 3), W_4 (0)
    assert rqmc_work.bridge_nonzeros(4) == 9
    assert rqmc_work.bridge_nonzeros(100) == 673  # nnz of the bridge at 100 steps
    w = rqmc_work.work({"n_paths": 1024, "n_steps": 4, "regression": {"degree": 1}})
    assert w["pathgen"] == {"bytes": 5 * 1024 * 4 + 4 * (2 + 512) * 4,
                            "f32": 62 * 4 * 1024 + 2 * 9 * 1024}
    assert w["induction"] == {"bytes": 5 * 1024 * 4 + 4 * 5 * 4, "f32": 4 * 1024 * (5 + 3),
                              "f64": 4 * 1024 * 5}


def test_the_flagship_pathgen_bound_is_its_bytes():
    w = rqmc_work.work({"n_paths": 1_048_576, "n_steps": 100, "regression": {"degree": 4}})
    want = (101 * 1_048_576 + 100 * (2048 + 512)) * 4 / 3.35e12
    assert roofline.bound_s(w["pathgen"]) == pytest.approx(want)

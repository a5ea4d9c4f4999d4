"""The plain reference on its own: its streams against the program's plain
versions of the same published functions, its solvers and its prices
against the binomial tree."""

import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from perfbench.reference import lsmc, streams  # noqa: E402

sys.path.remove(str(ROOT))

MARKET = {"S0": 100.0, "r": 0.01, "sigma": 0.2, "q": 0.0}
PUT = {"payoff": "put", "K": 100.0, "T": 1.0, "exercise_from_step": 0}
ITM = {"weights": "itm", "solver": "ridge", "frame": "closed_form", "degree": 4, "rcond": 1e-6}
SEED = 2 ** 31 + 977


def test_philox_known_answer():
    # Random123's Philox4x32-10 known-answer vector: counter 0, key 0
    z = torch.zeros((), dtype=torch.int64)
    out = [int(v) for v in streams.philox(z, z, z, z, 0)]
    assert out == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_gbm_stream_is_the_pathgens():
    from amcx_torch.ops.gbm import gbm_paths_reference

    ref = streams.philox_gbm(SEED, MARKET, 1.0, 10, 64, "cpu")
    prog = gbm_paths_reference(SEED, 100.0, 0.01, 0.2, 0.0, 1.0, 10, 64)
    torch.testing.assert_close(ref, prog.double(), rtol=2e-6, atol=0)


def test_philox_bridge_stream_is_the_fusedpaths():
    from amcx_torch.ops.lsmc_fusedpath import fusedpath_paths_reference

    ref = streams.philox_bridge(SEED, MARKET, 1.0, 12, 64, "cpu")
    prog = fusedpath_paths_reference(SEED, 100.0, 0.01, 0.2, 1.0 / 12, 12, 64)
    torch.testing.assert_close(ref, prog.double(), rtol=2e-6, atol=0)


def test_randn_basket_stream_is_the_programs():
    import amcx_torch

    m = {"S0": [100.0] * 3, "r": 0.05, "sigma": 0.2, "q": 0.1}
    ref = streams.randn_basket(SEED, m, 3.0, 9, 32, "cpu")
    prog = amcx_torch.simulate_gbm_multi(SEED, [100.0] * 3, 0.05, 0.2, 3.0,
                                         amcx_torch.SimConfig(n_paths=32, n_steps=9), q=0.1,
                                         device="cpu")
    torch.testing.assert_close(ref, prog.double(), rtol=2e-6, atol=0)


def test_solvers_agree_on_a_well_conditioned_system():
    g = torch.Generator().manual_seed(3)
    A = torch.randn(500, 4, generator=g, dtype=torch.float64)
    y = torch.randn(500, generator=g, dtype=torch.float64)
    exact = torch.linalg.lstsq(A, y).solution
    for solver in ("ridge", "pinv"):
        c = lsmc.solve(A.T @ A, A.T @ y, solver, 1e-6)
        torch.testing.assert_close(c, exact, rtol=1e-8, atol=1e-10)


def test_total_degree_columns():
    assert len(lsmc.total_degree_indices(5, 2)) == 21
    x = torch.tensor([0.5])
    assert lsmc.chebyshev(x, 4)[4].item() == pytest.approx(8 * 0.5 ** 4 - 8 * 0.5 ** 2 + 1)


def test_put_price_near_the_tree():
    import amcx_torch

    paths = streams.philox_gbm(SEED, MARKET, 1.0, 50, 65536, "cpu")
    out = lsmc.induction(paths, PUT, MARKET, ITM)
    tree = amcx_torch.crr_price(100.0, 100.0, 1.0, 0.01, 0.2, 2000, option_type="put",
                                american=True)
    assert abs(float(out["price"]) - float(tree)) < 4 * float(out["stderr"]) + 0.02


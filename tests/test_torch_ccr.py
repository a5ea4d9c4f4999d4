"""The CCR exposure profile of ``price_option(engine="mega", surface_stats=True)``
on the CPU (the exposure kernel's plain version), with no JAX.

- The program against the benchmark's plain reference
  (``perfbench/reference/ccr.py``: float64 paths regenerated from the
  seed, its own all-paths fits and exercise) at 16,384 paths x 24 steps:
  EPE and the two PFE bands within 1e-4 of the reference's EPE on every
  date (float32 paths and fits against float64 ones; the same relative
  gaps read 1e-7 and 2e-6 at this size), the price within 0.05 of its
  standard error.
- The price and stderr with the profile are the bits of the same call
  without it; ``regress_on="auto"`` resolves to the all-paths fit.
- The selection's plain rule (`amcx_torch.exposures.step_profile`)
  against numpy's linear percentile and mean on rows of ties, an all-equal
  row, -0.0, and positions that are whole ranks; and a numpy transcription of the
  kernel's selection (the order key and the 13-, 10- and 9-bit digits'
  counts, ``csrc/ccr_exposures.cu``) against it, bit for bit.
- ``fused`` and ``fusedpath`` refuse ``surface_stats``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amcx_torch as at
from amcx_torch import exposures as texp
from amcx_torch.ops import ccr_exposures as tccr

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from perfbench.reference import ccr, streams  # noqa: E402

sys.path.remove(str(ROOT))

SEED = 2 ** 31 + 1619
MARKET = {"S0": 100.0, "r": 0.01, "sigma": 0.2, "q": 0.0}
PUT = {"payoff": "put", "K": 100.0, "T": 1.0, "exercise_from_step": 0}
N_PATHS, N_STEPS = 16_384, 24


def _args(n_paths=N_PATHS, n_steps=N_STEPS, regress_on="all"):
    return (SEED, at.MarketParams(100.0, 0.01, 0.2),
            at.ProductSpec(K=100.0, T=1.0, option_type="put", exercise="american"),
            at.RegressionSpec(degree=4, regress_on=regress_on),
            at.SimConfig(n_paths=n_paths, n_steps=n_steps, backend="philox"))


@pytest.fixture(scope="module")
def profiled():
    return at.price_option(*_args(), engine="mega", device="cpu", surface_stats=True)


def test_profile_matches_the_plain_reference(profiled):
    paths = streams.philox_gbm(SEED, MARKET, 1.0, N_STEPS, N_PATHS, "cpu")
    spec = {"weights": "all", "solver": "ridge", "frame": "closed_form", "degree": 4,
            "rcond": 1e-6}
    ref = ccr.induction_profile(paths, PUT, MARKET, spec)
    e = profiled.exposures
    scale = ref["epe"][:N_STEPS]
    for name in ("epe", "pfe5", "pfe95"):
        got = getattr(e, name).double()
        assert got.shape == (N_STEPS + 1,) and got[N_STEPS] == 0.0 == ref[name][N_STEPS]
        gap = torch.max(torch.abs(got[:N_STEPS] - ref[name][:N_STEPS]) / scale)
        assert gap < 1e-4, (name, float(gap))
    assert abs(float(profiled.price) - float(ref["price"])) < 0.05 * float(ref["stderr"])
    assert bool((e.pfe5 <= e.epe).all()) and bool((e.epe <= e.pfe95).all())


def test_profile_keeps_the_price_bits(profiled):
    plain = at.price_option(*_args(), engine="mega", device="cpu")
    auto = at.price_option(*_args(regress_on="auto"), engine="mega", device="cpu",
                           surface_stats=True)
    for res in (plain, auto):
        assert torch.equal(res.price, profiled.price) and torch.equal(res.stderr, profiled.stderr)
    assert torch.equal(auto.exposures.epe, profiled.exposures.epe)
    assert plain.exposures is None and profiled.coeffs is None


def test_exposures_from_coeffs_is_the_plain_version(profiled):
    args = _args()
    with_coeffs = at.price_option(*args, engine="mega", device="cpu", surface_stats=True,
                                  return_coeffs=True)
    paths = at.simulate_gbm(SEED, args[1], 1.0, args[4], "cpu")
    mean_t, inv_std_t = at.gbm_standardization(args[1], 1.0, N_STEPS, device="cpu")
    rows = tccr.ccr_exposures_reference(paths, with_coeffs.coeffs, mean_t, inv_std_t)
    e = at.exposures_from_coeffs(paths, with_coeffs.coeffs, mean_t, inv_std_t)
    assert torch.equal(torch.stack([e.epe, e.pfe5, e.pfe95]), rows)
    assert torch.equal(e.epe, profiled.exposures.epe)
    # the f64 paths take the plain version in their own dtype
    e64 = at.exposures_from_coeffs(paths.double(), with_coeffs.coeffs, mean_t, inv_std_t)
    assert e64.epe.dtype == torch.float64
    torch.testing.assert_close(e64.epe, e.epe.double(), rtol=1e-5, atol=0)


ROWS = {
    "ties": np.array([3.0, 1.0, 3.0, 3.0, 0.0, 0.0, 2.0, 3.0, 1.0, 3.0, 0.0] * 9, np.float32),
    "all_equal": np.full(1000, 7.25, np.float32),
    "negative_zero": np.array([0.0, -0.0] * 30 + [1.5, 2.5], np.float32),
    "whole_ranks": np.linspace(0.0, 4.0, 21, dtype=np.float32),  # 5% of 20 and 95% of 20
    "one": np.array([4.5], np.float32),
    "two": np.array([4.5, 1.0], np.float32),
    "spread": np.random.default_rng(5).lognormal(1.0, 0.7, 4099).astype(np.float32),
}


def _select(values: np.ndarray, ranks) -> np.ndarray:
    """The kernel's selection, transcribed: each target narrowed to a bin of
    the 13-, then 10-, then 9-bit digit of the order key by counting the
    values under its prefix; the key back to its value."""
    bits = values.view(np.uint32).copy()
    bits[values == 0.0] = 0
    keys = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint32)
    out = []
    for r in ranks:
        prefix, rank = 0, int(r)
        for width, shift in ((13, 19), (10, 9), (9, 0)):
            under = keys if shift == 19 else keys[(keys >> (shift + width)) == prefix]
            hist = np.bincount((under >> shift) & ((1 << width) - 1), minlength=1 << width)
            upto = np.cumsum(hist)
            b = int(np.searchsorted(upto, rank, side="right"))
            prefix, rank = (prefix << width) | b, rank - int(upto[b] - hist[b])
        key = np.uint32(prefix)
        out.append(np.uint32(key & 0x7FFFFFFF) if key & 0x80000000 else np.uint32(~key))
    return np.array(out, np.uint32).view(np.float32)


def _kernel_rule(values: np.ndarray) -> np.ndarray:
    n = values.shape[0]
    out = [np.float64(values.astype(np.float64).sum() / n).astype(np.float32)]
    for q in (np.float32(0.05), np.float32(0.95)):
        pos = q * (np.float32(n) - np.float32(1.0))
        lo = int(np.floor(pos))
        vlo, vhi = _select(values, [lo, min(lo + 1, n - 1)])
        out.append(vlo + (pos - np.float32(lo)) * (vhi - vlo))
    return np.array(out, np.float32)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_selection_rule(name):
    values = ROWS[name]
    got = texp.step_profile(torch.from_numpy(values)).numpy()
    want = [values.astype(np.float64).mean(), np.percentile(values.astype(np.float64), 5.0),
            np.percentile(values.astype(np.float64), 95.0)]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    assert np.array_equal(_kernel_rule(values).view(np.uint32), got.view(np.uint32))
    assert not np.signbit(got).any()  # -0.0 comes out +0.0


def test_non_finite_values_are_left_out():
    values = torch.tensor([1.0, float("nan"), 3.0, float("inf"), 2.0])
    torch.testing.assert_close(texp.step_profile(values),
                               texp.step_profile(torch.tensor([1.0, 3.0, 2.0])), rtol=0, atol=0)
    assert bool(torch.isnan(texp.step_profile(torch.tensor([float("nan")] * 3))).all())


@pytest.mark.parametrize("engine", ["fused", "fusedpath"])
def test_other_routes_refuse_surface_stats(engine):
    with pytest.raises(ValueError, match="'mega' or 'xla'"):
        at.price_option(*_args(1024, 4), engine=engine, device="cpu", surface_stats=True)

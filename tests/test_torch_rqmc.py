"""Randomized-QMC pricing through ``SimConfig(backend="sobol" | "sobol-bridge")``
on the CPU (kernel 11's and kernel 2's plain versions).

- The backends' paths are the bits of ``sobol_gbm_paths_reference`` (and
  of ``simulate_gbm_qmc_device``) on the same seed, in both orders; the
  scramble the tables are built from is scipy's engine's, bit for bit.
- Against amcx's host route ``simulate_gbm_qmc`` (scipy's f64 inverse CDF
  of the full 30-bit points, in scipy's Gray-code order: its k-th path is
  the port's path k ^ (k >> 1)) and against the benchmark's plain reference
  (``perfbench/reference/sobol.py``: float64 ``ndtri`` of the 23-bit cell
  midpoints, its own bisection matrix): every path within
  sigma * sum_s |B[t, s]| * dz + 1e-6 relative on date t, where B is the
  order's construction matrix and dz bounds the port's normals' error.
  The kernel's float32 Acklam inverse CDF is off float64's by at most
  3.68e-4 over all 2^23 uniforms it can meet (at u ~ 0.0251, where the
  central rational's terms of ~40 cancel to ~2); against amcx dz also takes
  the largest move of a normal between the 23-bit cell midpoint and the
  full point, computed from the points themselves. Measured 5e-5 to 7e-5.
- ``price_option(engine="mega")`` and ``"xla"`` at 16,384 paths x 24 steps
  within 0.3 reference standard errors of the reference price: the cell's
  own limit (``perfbench/limits/put-1M-rqmc.mega.json``). 0.05 does not
  hold: the float32 normals above move near-tie exercise decisions of the
  in-the-money fit, and the flips cascade; on this seed mega reads 0.282
  and xla 0.166 (0.004-0.28 over twelve seeds), about the spread of the
  price between two scrambles (0.21 standard errors at this size). The
  stderr within 2% of the reference's (the same flips; the cell's runs
  read up to 0.73% at this size).
- ``SimConfig`` refuses antithetic pairs, float64, an n_paths that is no
  multiple of 512 or above 2^30, and a bridge of more than 1,024 steps;
  ``engine="fusedpath"`` refuses the backends; a Generator seed is refused.
- A new seed builds its tables once, inside the ``pathgen.tables`` span; a
  cached seed builds none and opens no span.
- The card's table kernel replays the scramble's draws from numpy's PCG64
  state by jump-ahead: a plain model of its indexing equals
  ``rng.integers``' draws and ``_scramble``'s numbers.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import qmc as jq
from amcx_torch import tracing
from amcx_torch.ops import sobol_pallas as tsp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from perfbench.reference import lsmc, sobol  # noqa: E402

sys.path.remove(str(ROOT))

SEED = 2 ** 31 + 2005
S0, R, SIGMA, T = 100.0, 0.01, 0.2, 1.0
MARKET = {"S0": S0, "r": R, "sigma": SIGMA, "q": 0.0}
PUT = {"payoff": "put", "K": 100.0, "T": T, "exercise_from_step": 0}
ITM = {"weights": "itm", "solver": "ridge", "frame": "closed_form", "degree": 4, "rcond": 1e-6}
ACKLAM_F32_DZ = 3.68e-4  # the largest |norm_ppf(u) - ndtri(u)| over every f32 uniform
BACKENDS = ["sobol", "sobol-bridge"]


def _sim(backend="sobol-bridge", n_paths=16_384, n_steps=24, **kw):
    return at.SimConfig(n_paths=n_paths, n_steps=n_steps, backend=backend, **kw)


def _market():
    return at.MarketParams(S0, R, SIGMA)


def _construction(backend, n_steps):
    """W = B z of the order: the bridge's bisection, or the running sum."""
    if backend == "sobol-bridge":
        return sobol.bisection_matrix(n_steps, T)
    return torch.tril(torch.full((n_steps, n_steps), (T / n_steps) ** 0.5, dtype=torch.float64))


def _within(paths, want, backend, dz):
    """Every date's relative gap against sigma * sum_s |B[t, s]| * dz + 1e-6."""
    n_steps = paths.shape[0] - 1
    rowsum = torch.cat([torch.zeros(1, dtype=torch.float64),
                        _construction(backend, n_steps).abs().sum(dim=1)])
    gap = torch.max(torch.abs(paths.double() - want) / want, dim=1).values
    tol = SIGMA * rowsum * dz + 1e-6
    assert bool((gap <= tol).all()), (gap, tol)
    return float(gap.max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_paths_are_the_kernels_plain_version(backend):
    bridge = backend == "sobol-bridge"
    got = at.simulate_gbm(SEED, _market(), T, _sim(backend, 4096, 16), "cpu")
    want = tsp.sobol_gbm_paths_reference(SEED, S0, R, SIGMA, 0.0, T, 16, 4096,
                                         brownian_bridge=bridge)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    device_route = tsp.simulate_gbm_qmc_device(SEED, _market(), T, _sim("torch", 4096, 16),
                                               brownian_bridge=bridge, device="cpu")
    assert torch.equal(got, device_route)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_paths_match_amcx_host_route(backend):
    from scipy.stats import qmc

    n, n_steps = 4096, 16
    got = at.simulate_gbm(SEED, _market(), T, _sim(backend, n, n_steps), "cpu")
    want = np.asarray(jq.simulate_gbm_qmc(
        SEED, amcx.MarketParams(S0, R, SIGMA), T, amcx.SimConfig(n_paths=n, n_steps=n_steps),
        brownian_bridge=backend == "sobol-bridge"))
    k = np.arange(n)
    got = got[:, torch.from_numpy(k ^ (k >> 1))]
    # amcx's normals are of the full points (clipped at 1e-12), the port's of
    # their 23-bit cell midpoints
    x = torch.from_numpy(qmc.Sobol(d=n_steps, scramble=True, seed=SEED).random(n))
    mid = (torch.floor(x * 2.0 ** 23) + 0.5) / 2.0 ** 23
    quant = float(torch.max(torch.abs(torch.special.ndtri(mid)
                                      - torch.special.ndtri(x.clamp(1e-12, 1 - 1e-12)))))
    _within(got, torch.tensor(want, dtype=torch.float64), backend, ACKLAM_F32_DZ + quant)


@pytest.mark.parametrize("n_steps", [1, 24, 100, 1000])
def test_scramble_is_scipys_engine(n_steps):
    # the direction numbers and shift of qmc.Sobol(scramble=True, seed=s),
    # from its replayed draws, for a small, a 32-bit and a 42-bit seed
    from scipy.stats import qmc

    for seed in (7, SEED, 2 ** 41 + 99):
        eng = qmc.Sobol(d=n_steps, scramble=True, seed=seed)
        sv, shift, bits = tsp._scramble(seed, n_steps)
        assert bits == eng.bits
        assert np.array_equal(sv, eng._sv) and np.array_equal(shift, eng._shift)


# A plain model of the card's table kernel (csrc/sobol_gbm.cu,
# sobol_tables_kernel) in Python integers: draw i of the scramble is bit 31
# of 32-bit word i of numpy's PCG64 (Lemire's method never rejects at a
# range of 2), the low half (i even) or the high half (i odd) of output
# i // 2 + 1, reached by jump-ahead from the seeded state; each row of a
# dimension's draws (the shift, then the rows of L) by one jump and steps.
PCG_MULT = 0x2360ED051FC65DA4_4385DF649FCCF645
MASK128, MASK64 = (1 << 128) - 1, (1 << 64) - 1


def _pcg_advance(state, inc, k):
    """The state k LCG steps on (Brown's jump-ahead, as ``pcg_advance``)."""
    acc_mult, acc_plus, cur_mult, cur_plus = 1, 0, PCG_MULT, inc
    while k:
        if k & 1:
            acc_mult, acc_plus = acc_mult * cur_mult & MASK128, \
                (acc_plus * cur_mult + cur_plus) & MASK128
        cur_plus, cur_mult = (cur_mult + 1) * cur_plus & MASK128, cur_mult * cur_mult & MASK128
        k >>= 1
    return (acc_mult * state + acc_plus) & MASK128


def _pcg_output(state):
    x, rot = ((state >> 64) ^ state) & MASK64, state >> 122
    return ((x >> rot) | (x << (64 - rot))) & MASK64


def _model_draw(state, inc, i):
    return _pcg_output(_pcg_advance(state, inc, i // 2 + 1)) >> (63 if i & 1 else 31) & 1


def _model_row(state, inc, d, r, n_steps, bits):
    """Row r of dimension d's draws as ``draw_row`` packs it: r = 0 the
    shift, r = 1 + p row p of L with its unit diagonal."""
    first = d * bits if r == 0 else n_steps * bits + (d * bits + r - 1) * bits
    s = _pcg_advance(state, inc, first // 2 + 1)
    row = 0
    for b in range(bits):
        if b and (first + b) % 2 == 0:
            s = (s * PCG_MULT + inc) & MASK128
        bit = _pcg_output(s) >> (63 if (first + b) & 1 else 31) & 1
        row |= bit << b if r == 0 else (bit << (bits - 1 - b) if b < r - 1 else 0)
    return row if r == 0 else row | 1 << (bits - r)


def _model_scramble(seed, n_steps, dims, sv, bits):
    """The scrambled direction numbers and shift of ``dims`` from the model."""
    st = np.random.PCG64(seed).state["state"]
    out_sv, out_shift = [], []
    for d in dims:
        rows = [_model_row(st["state"], st["inc"], d, r, n_steps, bits) for r in range(bits + 1)]
        out_sv.append([sum((bin(rows[1 + p] & int(v)).count("1") & 1) << (bits - 1 - p)
                           for p in range(bits)) for v in sv[d]])
        out_shift.append(rows[0])
    return np.array(out_sv, dtype=np.uint32), np.array(out_shift, dtype=np.uint32)


@pytest.mark.parametrize("n_steps", [1, 24, 100, 1000])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 4321, 2 ** 41 + 99])
def test_table_kernels_draw_model_is_scipys_scramble(seed, n_steps):
    # the model's draws equal rng.integers' at the first and last draw of
    # the shift block, the first of the matrices', each dimension's first
    # of both and the last; its (sv, shift) equal _scramble's in full up to
    # 100 steps, at the first, a middle and the last dimension at 1,000
    sv, bits = tsp._joe_kuo(n_steps)
    rng = np.random.default_rng(seed)
    draws = np.concatenate([rng.integers(0, 2, size=(n_steps, bits), dtype=np.uint32).ravel(),
                            rng.integers(0, 2, size=(n_steps, bits, bits),
                                         dtype=np.uint32).ravel()])
    n_shift = n_steps * bits
    picks = {0, n_shift - 1, n_shift, draws.size - 1}
    picks |= {d * bits for d in range(n_steps)} | {n_shift + d * bits * bits
                                                   for d in range(n_steps)}
    st = np.random.PCG64(seed).state["state"]
    assert [_model_draw(st["state"], st["inc"], i) for i in sorted(picks)] == \
        [int(draws[i]) for i in sorted(picks)]
    dims = range(n_steps) if n_steps <= 100 else [0, n_steps // 2, n_steps - 1]
    want_sv, want_shift, _ = tsp._scramble(seed, n_steps)
    got_sv, got_shift = _model_scramble(seed, n_steps, dims, sv, bits)
    assert np.array_equal(got_sv, want_sv[list(dims)])
    assert np.array_equal(got_shift, want_shift[list(dims)])


def test_backend_paths_match_the_plain_reference():
    got = at.simulate_gbm(SEED, _market(), T, _sim(), "cpu")
    want = sobol.sobol_bridge(SEED, MARKET, T, 24, 16_384, "cpu")
    assert _within(got, want, "sobol-bridge", ACKLAM_F32_DZ) > 0.0


@pytest.fixture(scope="module")
def reference_price():
    paths = sobol.sobol_bridge(SEED, MARKET, T, 24, 16_384, "cpu")
    return lsmc.induction(paths, PUT, MARKET, ITM)


@pytest.mark.parametrize("engine", ["mega", "xla"])
def test_price_matches_the_plain_reference(engine, reference_price):
    res = at.price_option(SEED, _market(), at.ProductSpec(K=100.0, T=T, option_type="put",
                                                          exercise="american"),
                          at.RegressionSpec(degree=4), _sim(), engine=engine, device="cpu")
    se = float(reference_price["stderr"])
    assert abs(float(res.price) - float(reference_price["price"])) <= 0.3 * se
    assert abs(float(res.stderr) - se) <= 0.02 * se


@pytest.mark.parametrize("kw", [dict(antithetic=True), dict(dtype="float64"),
                                dict(n_paths=16_384 + 256), dict(n_paths=2 ** 30 + 512),
                                dict(n_steps=1025)], ids=lambda kw: next(iter(kw)))
def test_simconfig_refuses_what_the_kernel_cannot_draw(kw):
    with pytest.raises(ValueError, match="backend 'sobol-bridge'"):
        _sim(**kw)


def test_increment_order_and_other_backends_take_long_grids():
    assert _sim("sobol", n_steps=1025).n_steps == 1025
    assert _sim("philox", n_paths=1000, n_steps=1025).backend == "philox"


def test_fusedpath_and_generator_seeds_refuse_the_backend():
    product = at.ProductSpec(K=100.0, T=T, option_type="put", exercise="american")
    with pytest.raises(ValueError, match="fusedpath.*'sobol-bridge'"):
        at.price_option(SEED, _market(), product, at.RegressionSpec(), _sim(), engine="fusedpath",
                        device="cpu")
    with pytest.raises(TypeError, match="integer seed"):
        at.simulate_gbm(torch.Generator(), _market(), T, _sim(), "cpu")


def test_a_cached_seed_builds_no_tables_and_opens_no_span():
    seed, sim = SEED + 17, _sim(n_paths=1024, n_steps=8)
    tracing.drain()
    builds = tsp.sobol_gbm_paths.table_builds
    with tracing.recording():
        first = at.simulate_gbm(seed, _market(), T, sim, "cpu")
        names_first = [s.name for s in tracing.drain()]
        assert tsp.sobol_gbm_paths.table_builds == builds + 1
        again = at.simulate_gbm(seed, _market(), T, sim, "cpu")
        names_again = [s.name for s in tracing.drain()]
    assert tsp.sobol_gbm_paths.table_builds == builds + 1
    assert names_first == ["pathgen.tables", "pathgen"] and names_again == ["pathgen"]
    assert torch.equal(first, again)

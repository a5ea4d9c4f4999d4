"""Quasi-Monte Carlo paths (`amcx_torch.qmc`, `amcx_torch.ops.sobol_pallas`)
against the JAX package and scipy, on the same seeds.

- the Sobol kernel's plain version (``sobol_gbm_paths_reference``) against
  amcx's ``sobol_gbm_paths``, which the CPU backend runs in Pallas interpret
  mode (two calls at 1,024 paths x 8 steps, increment and bridge order);
- its pieces: the direction tables bit for bit, the point set against
  scipy's scrambled engine, the inverse normal CDF on a grid;
- the host routes (``brownian_bridge_matrix``, ``sobol_normals``,
  ``simulate_gbm_qmc``, ``simulate_gbm_multi_qmc``) against amcx's.

Tolerances, with their reasons:

- plain version vs amcx's kernel: rtol 1e-4. amcx's kernel body is
  compiled by XLA, which contracts the inverse CDF's central polynomial
  into fused multiply-adds; near the select boundary (|u − ½| ≈ 0.476,
  |z| ≈ 1.4..2) that polynomial cancels (terms of ~40, a value of ~0.01),
  so the contraction moves z by up to 2.6e-4 and the paths by up to 3e-5
  relative (measured at this seed and size). The port rounds every
  operation on its own (torch's separate ops; the kernel is built with
  -fmad=false), as amcx's norm_ppf does when called op by op;
- ``norm_ppf`` against amcx's, op by op: atol 2e-6 (XLA's and torch's
  logs differ by an ulp in the tail form, |z| up to 5.3; measured 7e-7);
- the host routes: rtol 1e-5 (XLA's and torch's exp and cumsum order;
  the bridge product in f64 against XLA's f32 dot; measured 2e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import qmc as jq
from amcx.ops import sobol_pallas as jsp
from amcx_torch import qmc as tq
from amcx_torch.ops import lsmc_megakernel as tmega
from amcx_torch.ops import sobol_pallas as tsp

S0, R, SIGMA, Q = 100.0, 0.05, 0.2, 0.01


@pytest.mark.parametrize("bridge", [False, True])
def test_sobol_plain_matches_amcx_kernel(bridge):
    want = np.asarray(jsp.sobol_gbm_paths(7, S0, R, SIGMA, Q, 1.0, 8, 1024, interpret=True,
                                          brownian_bridge=bridge))
    got = tsp.sobol_gbm_paths_reference(7, S0, R, SIGMA, Q, 1.0, 8, 1024,
                                        brownian_bridge=bridge)
    assert got.shape == (9, 1024) and got.dtype == torch.float32
    assert bool((got[0] == S0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # on the CPU the wrapper runs the plain version
    assert torch.equal(tsp.sobol_gbm_paths(7, S0, R, SIGMA, Q, 1.0, 8, 1024,
                                           brownian_bridge=bridge, device="cpu"), got)


def test_direction_tables_match_amcx():
    # amcx pads u_hi to 128 columns (the TPU's lane tiling); the port does not
    for seed, n_steps, n_paths in ((7, 8, 1024), (3, 100, 4096)):
        j_hi, j_lo = (np.asarray(a).view(np.uint32)
                      for a in jsp._direction_tables(seed, n_steps, n_paths))
        t_hi, t_lo = tsp._direction_tables(seed, n_steps, n_paths)
        assert t_hi.shape == (n_steps, n_paths // 512) and t_lo.shape == (n_steps, 512)
        assert np.array_equal(j_hi[:, :n_paths // 512], t_hi)
        assert np.array_equal(j_lo, t_lo)


def _mask_pass_tables(seed, n_steps, n_paths):
    # the tables as the port first built them: one boolean-mask XOR pass
    # over the columns per index bit
    from scipy.stats import qmc

    eng = qmc.Sobol(d=n_steps, scramble=True, seed=seed)
    sv = np.asarray(eng._sv, dtype=np.uint32)
    bits = int(eng.bits)

    def xor_table(indices):
        acc = np.zeros((n_steps, indices.size), dtype=np.uint32)
        for j in range(bits):
            mask = ((indices >> j) & 1).astype(bool)
            acc[:, mask] ^= sv[:, j:j + 1]
        return acc

    u_lo = xor_table(np.arange(512, dtype=np.uint64))
    u_hi = xor_table(np.arange(n_paths // 512, dtype=np.uint64) << 9)
    u_hi ^= np.asarray(eng._shift, dtype=np.uint32)[:, None]
    return u_hi << (30 - bits), u_lo << (30 - bits)


# powers of two and not (3 and 5 columns of u_hi), one step to a thousand
@pytest.mark.parametrize("seed,n_steps,n_paths", [(7, 8, 1024), (3, 100, 1 << 20),
                                                  (11, 1, 512), (5, 33, 1536),
                                                  (2026, 1000, 2560)])
def test_direction_tables_by_doubling_equal_mask_passes(seed, n_steps, n_paths):
    want_hi, want_lo = _mask_pass_tables(seed, n_steps, n_paths)
    got_hi, got_lo = tsp._direction_tables.__wrapped__(seed, n_steps, n_paths)
    assert np.array_equal(got_hi, want_hi) and np.array_equal(got_lo, want_lo)


def _norm_ppf_split(p):
    # norm_ppf as the increment kernel evaluates it: the central form
    # everywhere, the tail form only on the compacted points that select it.
    # The compacted list is padded to a multiple of 64 points, so that
    # torch's CPU log takes its vectorised loop on every point, as it does
    # on the full tensor
    out = tsp._ppf_central(p)
    tail = tsp._in_tail(p)
    pts = p[tail]
    pad = -pts.numel() % 64
    pts = torch.cat([pts, torch.full((pad,), 0.5, dtype=p.dtype)])
    out[tail] = tsp._ppf_tail(pts)[:pts.numel() - pad]
    return out


def test_norm_ppf_split_equals_branchless_on_every_uniform():
    # the increment kernel evaluates the central form everywhere and the
    # tail form only on the compacted points that select it: on each of the
    # 2^23 uniforms that _bits_to_uniform can produce (every mantissa) the
    # split gives norm_ppf's bits
    p = tsp._bits_to_uniform(torch.arange(1 << 23, dtype=torch.int32) << 7)
    assert float(p.min()) == 2.0 ** -24 and float(p.max()) == 1 - 2.0 ** -24
    split = _norm_ppf_split(p)
    assert torch.equal(split.view(torch.int32), tsp.norm_ppf(p).view(torch.int32))
    assert int(tsp._in_tail(p).sum()) == 406_848  # 4.85% of the points


def test_point_set_matches_scipy():
    # natural-order point i of the tables is scipy's Gray-code point k with
    # i = k ^ (k >> 1): exactly the same 30-bit integers, and the f32
    # uniforms keep their leading 23 bits (|u - scipy| <= 2^-24)
    from scipy.stats import qmc

    n_steps, n = 100, 4096
    u_hi, u_lo = tsp._direction_tables(11, n_steps, 1 << 20)
    k = np.arange(n)
    i = k ^ (k >> 1)
    pts = u_hi[:, i >> 9] ^ u_lo[:, i & 511]
    ref = qmc.Sobol(d=n_steps, scramble=True, seed=11).random(n).T
    assert np.array_equal(pts * 2.0 ** -30, ref)
    u = tsp._bits_to_uniform(torch.from_numpy(pts.view(np.int32))).numpy()
    assert np.abs(u.astype(np.float64) - ref).max() <= 2.0 ** -24


def test_norm_ppf_matches_amcx():
    p = np.concatenate([np.linspace(2.0 ** -24, 1 - 2.0 ** -24, 100_001),
                        2.0 ** -np.arange(6, 25),
                        1 - 2.0 ** -np.arange(6, 24)]).astype(np.float32)
    want = np.asarray(jsp.norm_ppf(jnp.asarray(p)))
    got = tsp.norm_ppf(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # and against the exact quantile: Acklam's form is good to 1.15e-9
    # relative, but in f32 its central polynomial cancels near the select
    # boundary (measured 3.0e-4 there), far below a QMC path's error
    from scipy.stats import norm

    exact = norm.ppf(p.astype(np.float64))
    assert np.abs(got - exact).max() < 5e-4


def test_brownian_bridge_matrix_matches_amcx():
    for n_steps, dt in ((1, 1.0), (8, 0.125), (100, 0.01)):
        assert np.array_equal(tq.brownian_bridge_matrix(n_steps, dt),
                              jq.brownian_bridge_matrix(n_steps, dt))
    B = tq.brownian_bridge_matrix(16, 0.25)
    t = np.arange(1, 17) * 0.25
    np.testing.assert_allclose(B @ B.T, np.minimum.outer(t, t), atol=1e-12)


def test_sobol_normals_match_amcx():
    assert np.array_equal(tq.sobol_normals(5, 8, 1024), jq.sobol_normals(5, 8, 1024))


@pytest.mark.parametrize("bridge", [False, True])
def test_simulate_gbm_qmc_matches_amcx(bridge):
    jm, tm = amcx.MarketParams(S0, R, SIGMA, Q), at.MarketParams(S0, R, SIGMA, Q)
    want = np.asarray(jq.simulate_gbm_qmc(3, jm, 1.0, amcx.SimConfig(n_paths=1024, n_steps=8),
                                          brownian_bridge=bridge))
    got = at.simulate_gbm_qmc(3, tm, 1.0, at.SimConfig(n_paths=1024, n_steps=8),
                              brownian_bridge=bridge, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("bridge", [False, True])
def test_simulate_gbm_multi_qmc_matches_amcx(bridge):
    corr = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]])
    args = ([100.0, 90.0, 110.0], R, [0.2, 0.3, 0.25], 1.0)
    want = np.asarray(jq.simulate_gbm_multi_qmc(4, *args, amcx.SimConfig(n_paths=1024,
                                                                         n_steps=8),
                                                q=Q, corr=corr, brownian_bridge=bridge))
    got = at.simulate_gbm_multi_qmc(4, *args, at.SimConfig(n_paths=1024, n_steps=8), q=Q,
                                    corr=corr, brownian_bridge=bridge, device="cpu")
    assert got.shape == (9, 1024, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_qmc_device_route_prices_the_put():
    # the CPU route of simulate_gbm_qmc_device (the kernel's plain version)
    # into the induction's plain version: the flagship put at 16,384 x 50
    # in the closed-form frame against CRR-2000 (QMC keeps it well inside
    # the 0.05 gate at this size), and the bridge-order European put
    # against Black-Scholes (0.02: a single scramble at 16k points)
    market = at.MarketParams(100.0, 0.01, 0.2)
    sim = at.SimConfig(n_paths=16_384, n_steps=50)
    mean_t, inv_std_t = at.gbm_standardization(market, 1.0, 50, device="cpu")
    crr = at.crr_price(100.0, 100.0, 1.0, 0.01, 0.2, 2000, option_type="put", american=True)
    for bridge in (False, True):
        paths = at.simulate_gbm_qmc_device(2, market, 1.0, sim, brownian_bridge=bridge,
                                           device="cpu")
        assert torch.equal(paths, tsp.sobol_gbm_paths_reference(
            2, 100.0, 0.01, 0.2, 0.0, 1.0, 50, 16_384, brownian_bridge=bridge))
        price = tmega.lsmc_price_megakernel(paths, 100.0, 0.01, 0.02, -1.0, itm_weights=True,
                                           mean_t=mean_t, inv_std_t=inv_std_t)
        assert abs(float(price) - crr) < 0.05, (bridge, float(price), crr)
    euro = float(np.exp(-0.01) * torch.clamp_min(100.0 - paths[-1].double(), 0.0).mean())
    assert abs(euro - at.bs_price(100.0, 100.0, 1.0, 0.01, 0.2, option_type="put")) < 0.02


def test_qmc_validation_errors():
    with pytest.raises(ValueError, match="multiple of 512"):
        tsp.sobol_gbm_paths(0, S0, R, SIGMA, Q, 1.0, 8, 1000, device="cpu")
    with pytest.raises(ValueError, match=f"at most {tsp.BRIDGE_MAX_STEPS} steps"):
        tsp.sobol_gbm_paths(0, S0, R, SIGMA, Q, 1.0, tsp.BRIDGE_MAX_STEPS + 1, 512,
                            brownian_bridge=True, device="cpu")
    market = at.MarketParams(S0, R, SIGMA)
    with pytest.raises(ValueError, match="antithetic"):
        at.simulate_gbm_qmc_device(0, market, 1.0, at.SimConfig(n_paths=512, n_steps=4,
                                                                antithetic=True),
                                   device="cpu")
    with pytest.raises(ValueError, match="antithetic"):
        at.simulate_gbm_qmc(0, market, 1.0, at.SimConfig(n_paths=512, n_steps=4,
                                                         antithetic=True), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        at.simulate_gbm_qmc_device(0, market, 1.0, at.SimConfig(n_paths=512, n_steps=4,
                                                                dtype="float64"),
                                   device="cpu")


# the bridge kernel's schedule (csrc/sobol_gbm.cu walks it): the nonzeros of
# the f32 bridge matrix, each column's normal made once and kept in a slot
BRIDGE_STEPS = (1, 2, 3, 7, 20, 100, 225, tsp.BRIDGE_MAX_STEPS)


def _decode(entries):
    """(column, slot, born, value) of each schedule entry."""
    word = entries[:, 0].astype(np.int64) & 0xFFFFFFFF
    return (word & 0x7FFFFFFF) >> 8, word & 0xFF, word >> 31, entries[:, 1].view(np.float32)


@pytest.mark.parametrize("n_steps", BRIDGE_STEPS)
def test_bridge_schedule_holds_the_nonzeros(n_steps):
    B = tq.brownian_bridge_matrix(n_steps, 1.0 / n_steps).astype(np.float32)
    row_ptr, entries, n_slots = tsp._bridge_schedule(n_steps, 1.0)
    cols, slots, born, vals = _decode(entries)
    assert row_ptr[0] == 0 and row_ptr[-1] == len(entries) == np.count_nonzero(B)
    sparse = np.zeros_like(B)
    holder, seen = {}, set()
    last = {int(c): t for t in range(n_steps) for c in cols[row_ptr[t]:row_ptr[t + 1]]}
    for t in range(n_steps):
        lo, hi = row_ptr[t], row_ptr[t + 1]
        assert np.all(np.diff(cols[lo:hi]) > 0)  # ascending, as the dense sum adds
        sparse[t, cols[lo:hi]] = vals[lo:hi]
        for c, k, b in zip(cols[lo:hi].tolist(), slots[lo:hi].tolist(), born[lo:hi].tolist()):
            assert b == (c not in seen)  # made at its first row
            if b:  # into a slot whose holder is dead
                assert k not in holder or last[holder[k]] < t
                holder[k] = c
                seen.add(c)
            assert holder[k] == c
    # exactly the f32 matrix's nonzeros, to the bit
    assert np.array_equal(sparse.view(np.int32), B.view(np.int32))
    # the live normals: as many as the densest row needs
    assert n_slots == max(np.diff(row_ptr)) == len(set(slots.tolist()))


def _bridge_walk(seed, n_steps, n_paths):
    """The bridge kernel's arithmetic in torch: each row's f32 sum over its
    schedule entries, in order, each normal made where it is born."""
    u_hi, u_lo = tsp._direction_tables(seed, n_steps, n_paths)
    S0_, drift_dt, vol = tsp._params(S0, R, SIGMA, Q, 1.0, n_steps, True)
    p = torch.arange(n_paths)
    hi = torch.from_numpy(u_hi.view(np.int32).copy())[:, p >> 9]
    lo = torch.from_numpy(u_lo.view(np.int32).copy())[:, p & 511]
    row_ptr, entries, n_slots = tsp._bridge_schedule(n_steps, 1.0)
    cols, slots, born, vals = _decode(entries)
    held = [None] * n_slots
    out = torch.empty((n_steps + 1, n_paths))
    out[0] = S0_
    for t in range(n_steps):
        w = torch.zeros(n_paths)
        for e in range(row_ptr[t], row_ptr[t + 1]):
            if born[e]:
                c = cols[e]
                held[slots[e]] = tsp.norm_ppf(tsp._bits_to_uniform(hi[c] ^ lo[c]))
            w = w + torch.tensor(vals[e]) * held[slots[e]]
        out[t + 1] = S0_ * torch.exp(drift_dt * torch.tensor(float(t + 1)) + vol * w)
    return out


@pytest.mark.parametrize("n_steps", (1, 7, 20, 100, tsp.BRIDGE_MAX_STEPS))
def test_bridge_schedule_sum_equals_the_dense_plain_version(n_steps):
    # skipping B's exact zeros changes no bit: a skipped term is ±0 (the
    # normals are finite), w + ±0 = w but for a zero's sign, and exp of the
    # drift plus vol·w cannot tell +0 from -0
    want = tsp.sobol_gbm_paths_reference(5, S0, R, SIGMA, Q, 1.0, n_steps, 1024,
                                         brownian_bridge=True)
    assert torch.equal(_bridge_walk(5, n_steps, 1024), want)

"""The port's path layer (`amcx_torch.paths`, `amcx_torch.ops.gbm`) against
the JAX package and against its own documented Philox stream.

The random numbers differ from amcx's by design (Philox / torch.randn vs
threefry / the TPU PRNG), so pathgen parity is statistical; the closed-form
standardization is compared value by value.
"""

import math

import jax
import numpy as np
import pytest
import torch

import amcx
import amcx_torch as at
from amcx import paths as jpaths
from amcx_torch.ops import gbm

M = at.MarketParams(100.0, 0.01, 0.2)


@pytest.mark.parametrize("T,n_steps,q", [(1.0, 16, 0.0), (0.5, 100, 0.03), (2.0, 7, 0.0)])
def test_gbm_standardization_matches_amcx(T, n_steps, q):
    # same f32 formula and order; rtol 1e-6 leaves room for the one-ulp
    # exp/expm1 differences between XLA's and torch's CPU math
    jm, js = jpaths.gbm_standardization(amcx.MarketParams(100.0, 0.01, 0.2, q), T, n_steps)
    tm, ts = at.gbm_standardization(at.MarketParams(100.0, 0.01, 0.2, q), T, n_steps)
    assert tm.dtype == ts.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    assert float(ts[0]) == 1e6  # t=0: zero variance, clamped std


KAT = [  # Random123 known-answer vectors for Philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = gbm.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(x) for x in got) == want


def test_philox_stream_is_a_function_of_seed_path_step():
    # path p's normals do not depend on how many paths are drawn, and a
    # shorter grid is a prefix of a longer one (tail quads drop surplus)
    z = gbm.philox_normals(123, 9, 300)
    np.testing.assert_array_equal(gbm.philox_normals(123, 9, 100).numpy(), z[:, :100].numpy())
    np.testing.assert_array_equal(gbm.philox_normals(123, 5, 300).numpy(), z[:5].numpy())
    assert not torch.equal(gbm.philox_normals(124, 9, 300), z)
    # seed = lo + 2^32 hi splits into the two key words
    assert not torch.equal(gbm.philox_normals(123 + 2 ** 32, 9, 300), z)
    with pytest.raises(ValueError, match="seed"):
        gbm.philox_normals(-1, 4, 4)


def test_plain_pathgen_statistics():
    # 8192 x 16 from the documented stream; every gate is 4 standard errors
    n, T = 8192, 16
    S = gbm.gbm_paths(7, 100.0, 0.01, 0.2, 0.0, 1.0, T, n).double()
    assert S.shape == (T + 1, n) and bool(torch.all(S[0] == 100.0))
    disc = math.exp(-0.01) * S[-1]
    assert abs(float(disc.mean()) - 100.0) < 4 * float(disc.std()) / math.sqrt(n)
    inc = torch.log(S[1:] / S[:-1])
    dt = 1.0 / T
    mean, var = float(inc.mean()), float(inc.var())
    se_mean = math.sqrt(var / inc.numel())
    se_var = var * math.sqrt(2.0 / inc.numel())
    assert abs(mean - (0.01 - 0.02) * dt) < 4 * se_mean
    assert abs(var - 0.04 * dt) < 4 * se_var
    # increments of different steps are uncorrelated
    corr = float(torch.corrcoef(torch.stack([inc[3], inc[4]]))[0, 1])
    assert abs(corr) < 4 / math.sqrt(n)


def test_pathgen_matches_amcx_in_law():
    # amcx's threefry paths and the port's Philox paths, same market and
    # grid: the means of S_T agree within 4 combined standard errors
    n, T = 8192, 16
    js = np.asarray(jpaths.simulate_gbm(jax.random.key(3), amcx.MarketParams(100.0, 0.01, 0.2),
                                        1.0, amcx.SimConfig(n_paths=n, n_steps=T)))[-1]
    ts = at.simulate_gbm(3, M, 1.0, at.SimConfig(n_paths=n, n_steps=T, backend="philox"))[-1]
    ts = ts.double().numpy()
    se = math.sqrt(js.var() / n + ts.var() / n)
    assert abs(js.mean() - ts.mean()) < 4 * se


def test_simulate_gbm_torch_backend():
    sim = at.SimConfig(n_paths=4096, n_steps=8)
    a = at.simulate_gbm(5, M, 1.0, sim)
    gen = torch.Generator().manual_seed(5)
    b = at.simulate_gbm(gen, M, 1.0, sim)
    assert a.shape == (9, 4096) and a.dtype == torch.float32
    assert torch.equal(a, b)  # an int seed is a Generator seeded with it
    anti = at.simulate_gbm(5, M, 1.0, at.SimConfig(n_paths=4096, n_steps=8, antithetic=True))
    # antithetic: the mirror path's log-increments are the negated normals
    la = torch.log(anti[1:] / anti[:-1]).double()
    drift = (0.01 - 0.02) / 8
    np.testing.assert_allclose((la[:, :2048] - drift).numpy(), -(la[:, 2048:] - drift).numpy(),
                               atol=2e-6)
    assert at.to_path_major(a).shape == (4096, 9)


def test_simulate_gbm_philox_backend_rules():
    sim = at.SimConfig(n_paths=64, n_steps=4, backend="philox")
    S = at.simulate_gbm(9, M, 1.0, sim)
    assert torch.equal(S, gbm.gbm_paths_reference(9, 100.0, 0.01, 0.2, 0.0, 1.0, 4, 64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        at.simulate_gbm(9, M, 1.0, at.SimConfig(n_paths=64, n_steps=4, backend="philox",
                                                antithetic=True))
    with pytest.raises(TypeError):
        at.simulate_gbm(torch.Generator(), M, 1.0, sim)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gbm.gbm_paths(9, 100.0, torch.full((4,), 0.01), 0.2, 0.0, 1.0, 4, 64)


def test_cpu_pathgen_never_launches_the_kernel():
    before = gbm.gbm_paths.launches
    gbm.gbm_paths(1, 100.0, 0.01, 0.2, 0.0, 1.0, 4, 64, device="cpu")
    assert gbm.gbm_paths.launches == before

"""The port's special functions and multi-uniform samplers against
``genjax_tpu/dists/special.py`` and closed forms.

The deterministic functions take the same numpy grids through both packages
(``log I_v`` to 2e-6 relative to ``max(1, |value|)``, the others to 1e-5
absolute, equal infinities); the samplers are held in law at fixed seeds
(5 standard errors), and under ``torch.func.vmap``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import scipy.stats as ss
import torch
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu.dists.special as R
import genjax_tpu_torch.dists.special as P

N = 20000


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("v", [0.0, 0.5, 1.0, 2.5, 10.0, 12.0, 40.0])
def test_log_bessel_iv_matches_reference(v):
    x = np.asarray([0.0, 1e-3, 0.5, 3.0, 50.0, 399.0, 401.0, 2000.0], np.float32)
    ref = np.asarray(R.log_bessel_iv(np.float32(v), jnp.asarray(x)))
    got = P.log_bessel_iv(_t(v), _t(x)).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    assert np.max(np.abs(got[fin] - ref[fin]) / np.maximum(1.0, np.abs(ref[fin]))) < 2e-6
    # and against scipy in float64 where the series rules
    small = (x > 0) & (x < 50)
    exact = np.log(sps.ive(v, x[small].astype(np.float64))) + x[small]
    np.testing.assert_allclose(got[small], exact, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "name,grid",
    [
        ("log_bessel_i0", [-30.0, -3.0, 0.0, 0.5, 5.0, 80.0]),
        ("lambertw", [-1 / math.e + 1e-4, -0.2, 0.0, 0.1, 1.0, math.e, 10.0, 1e4]),
        ("erfcinv", [1e-6, 0.1, 0.5, 1.0, 1.9]),
    ],
)
def test_elementwise_functions_match_reference(name, grid):
    x = np.asarray(grid, np.float32)
    ref = np.asarray(getattr(R, name)(jnp.asarray(x)))
    got = getattr(P, name)(_t(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_lambertw_inverts():
    z = np.linspace(-0.3, 50.0, 41).astype(np.float32)
    w = P.lambertw(_t(z)).double().numpy()
    np.testing.assert_allclose(w * np.exp(w), z, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [8, 128])
def test_gauss_legendre_matches_reference(n):
    nodes, weights = P.gauss_legendre(n)
    rn, rw = R.gauss_legendre(n)
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(rw))
    # exact for polynomials of degree < 2n on [0, 1]
    assert float(torch.sum(weights * nodes**5)) == pytest.approx(1 / 6, rel=1e-6)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_masked_rejection_keeps_first_accept_under_vmap():
    gen = _gen(7)

    def propose(g):
        u = torch.rand((), generator=g)
        return u, u < 0.3

    out = torch.func.vmap(lambda _: P._masked_rejection(gen, propose), randomness="different")(torch.zeros(N))
    # each lane's first accepted proposal: uniform on [0, 0.3)
    acc = out.numpy()
    assert np.all(acc < 0.3)
    assert abs(acc.mean() - 0.15) < 5 * 0.3 / math.sqrt(12 * N)


@pytest.mark.parametrize("loc,kappa", [(0.5, 2.0), (-2.0, 0.3), (1.0, 40.0)])
def test_von_mises_sampler_in_law(loc, kappa):
    x = P.von_mises_sample(_gen(2), _t(loc), _t(kappa), (N,)).double().numpy()
    assert np.all(np.abs(x) <= math.pi)
    # E[cos(x - loc)] = I_1(k) / I_0(k); var of cos from the second moment
    c = np.cos(x - loc)
    a1 = sps.ive(1, kappa) / sps.ive(0, kappa)
    assert abs(c.mean() - a1) < 5 * c.std() / math.sqrt(N)
    # the draws wrap onto [-pi, pi]; scipy's support is loc +- pi
    d = np.remainder(x - loc + math.pi, 2 * math.pi) - math.pi
    assert ss.kstest(d, ss.vonmises(kappa).cdf).pvalue > 1e-3


def test_zipf_sampler_in_law():
    a = 2.5
    x = P.zipf_sample(_gen(3), _t(a), (N,)).numpy()
    assert x.dtype == np.int32 and x.min() >= 1
    k = np.arange(1, 200)
    pmf = k**-a / sps.zeta(a)
    # the share of 1, 2 and 3, within 5 SE each
    for v in (1, 2, 3):
        p = pmf[v - 1]
        assert abs(np.mean(x == v) - p) < 5 * math.sqrt(p * (1 - p) / N)


@pytest.mark.parametrize("kappa", [0.5, 5.0, 50.0])
def test_von_mises_fisher_sampler_in_law(kappa):
    mu = torch.tensor([0.0, 0.6, 0.8])
    x = P.von_mises_fisher_sample(_gen(4), mu.expand(N, 3), _t(kappa).expand(N)).double()
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0, atol=1e-5)
    # E[mu . x] = A_3(k) = coth(k) - 1/k in three dimensions
    t = (x @ mu.double()).numpy()
    a3 = 1 / math.tanh(kappa) - 1 / kappa
    assert abs(t.mean() - a3) < 5 * t.std() / math.sqrt(N)


@pytest.mark.parametrize("kappa", [0.5, 5.0])
def test_power_spherical_sampler_in_law(kappa):
    mu = torch.tensor([0.0, 0.0, 1.0])
    x = P.power_spherical_sample(_gen(5), mu.expand(N, 3), _t(kappa).expand(N)).double()
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0, atol=1e-5)
    # (mu . x + 1) / 2 ~ Beta((d-1)/2 + k, (d-1)/2)
    t = (x[:, 2].numpy() + 1) / 2
    assert ss.kstest(t, ss.beta(1.0 + kappa, 1.0).cdf).pvalue > 1e-3


@pytest.mark.parametrize("name", ["power_spherical_logpdf", "von_mises_fisher_logpdf"])
def test_directional_logpdfs_match_reference(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4))
    x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    mu = np.asarray([0.5, 0.5, 0.5, 0.5], np.float32)
    for kappa in (0.0, 1e-7, 2.0, 30.0):
        ref = np.asarray(getattr(R, name)(jnp.asarray(x), jnp.asarray(mu), np.float32(kappa)))
        got = getattr(P, name)(_t(x), _t(mu), _t(kappa)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

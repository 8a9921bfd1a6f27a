"""Stochastic-gradient MCMC in the port (``genjax_tpu_torch/kernels/sgld.py``)
against ``genjax_tpu.kernels.sgld`` and the exact stationary laws of
``tests/kernels/test_sgld.py``.

The gradient estimators are deterministic given their rows: the same numpy
positions and the same row indices go through both packages, held to rtol
1e-5. The sweeps draw from a ``torch.Generator`` where the reference folds a
key in, so they are held in law against the closed forms (ULA's stationary
variance, SGHMC's discrete Lyapunov solution, the conjugate posterior), with
the reference test's tolerances stated beside each.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch
from scipy.linalg import solve_discrete_lyapunov

from genjax_tpu.kernels import sgld as ref
from genjax_tpu_torch.kernels.sgld import (
    full_grad_cols,
    minibatch_grad_cols,
    sghmc_sweep_cols,
    sgld_sweep_cols,
)
from torch_threads import _one_thread  # noqa: F401

N_CHAINS = 4096
RNG = np.random.RandomState(3)
X = RNG.randn(64, 3).astype(np.float32)
Y = RNG.randn(64).astype(np.float32)


def _lp_t(q):
    return -0.5 * torch.sum(q**2, dim=0)


def _ll_t(q, shard):
    x, y = shard
    return -0.5 * torch.sum((y[:, None] - x @ q[:3]) ** 2, dim=0)


def _lp_j(q):
    return -0.5 * jnp.sum(q**2, axis=0)


def _ll_j(q, shard):
    x, y = shard
    return -0.5 * jnp.sum((y[:, None] - x @ q[:3]) ** 2, axis=0)


def test_full_grad_matches_reference():
    q = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)

    def ld_t(qq):
        return _lp_t(qq) + _ll_t(qq, (torch.from_numpy(X), torch.from_numpy(Y)))

    def ld_j(qq):
        return _lp_j(qq) + _ll_j(qq, (jnp.asarray(X), jnp.asarray(Y)))

    port = full_grad_cols(ld_t)(torch.from_numpy(q), torch.Generator())
    want = ref.full_grad_cols(ld_j)(jnp.asarray(q), jr.key(0))
    np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_minibatch_grad_on_the_same_rows_matches_reference():
    """The reference's rows for its key, fed to the port's ``on_rows``; the
    scale ``n_total / batch_size`` included."""
    q = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)
    for n_total in (None, 1000):
        r_grad = ref.minibatch_grad_cols(_lp_j, _ll_j, (jnp.asarray(X), jnp.asarray(Y)), 8, n_total=n_total)
        p_grad = minibatch_grad_cols(_lp_t, _ll_t, (torch.from_numpy(X), torch.from_numpy(Y)), 8, n_total=n_total)
        for k in range(3):
            key = jr.key(k)
            idx = np.array(jr.randint(key, (8,), 0, 64))
            want = r_grad(jnp.asarray(q), key)
            port = p_grad.on_rows(torch.from_numpy(q), torch.from_numpy(idx))
            np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gaussian_stationary_variance_exact():
    """Mirrors TestULAStationary::test_gaussian_stationary_variance_exact:
    ULA on N(1.7, 1) at eps 0.4 is AR(1) with stationary variance
    s2 / (1 - eps / (4 s2)); mean within 0.04, variance within 6%."""
    mu, s2, eps = 1.7, 1.0, 0.4
    q0 = torch.zeros(1, N_CHAINS)
    q, draws = sgld_sweep_cols(full_grad_cols(lambda q: -0.5 * torch.sum((q - mu) ** 2, dim=0) / s2), q0, 0,
                               n_steps=400, eps=eps)
    d = q[0].numpy()
    np.testing.assert_allclose(d.mean(), mu, atol=0.04)
    np.testing.assert_allclose(d.var(), s2 / (1.0 - eps / (4.0 * s2)), rtol=0.06)
    assert draws is None and q.device == q0.device


def test_psgld_anisotropic_means():
    """Mirrors test_psgld_anisotropic_means: means within 0.8 and 0.1."""
    mus = torch.tensor([[2.0], [-3.0]])
    s2 = torch.tensor([[100.0], [0.01]])
    q, _ = sgld_sweep_cols(full_grad_cols(lambda q: -0.5 * torch.sum((q - mus) ** 2 / s2, dim=0)),
                           torch.zeros(2, N_CHAINS), 1, n_steps=6000, eps=0.01, precondition=True)
    means = q.mean(dim=1).numpy()
    np.testing.assert_allclose(means[0], 2.0, atol=0.8)
    np.testing.assert_allclose(means[1], -3.0, atol=0.1)


def test_gaussian_lyapunov_exact():
    """Mirrors TestSGHMCStationary::test_gaussian_lyapunov_exact: the
    q-marginal of the discrete Lyapunov solution; mean within 0.05,
    variance within 8%."""
    s2, eps, C = 1.0, 0.05, 1.0
    q, p = sghmc_sweep_cols(full_grad_cols(lambda q: -0.5 * torch.sum(q**2, dim=0) / s2),
                            torch.zeros(1, N_CHAINS), 0, n_steps=3000, eps=eps, friction=C)
    M = np.array([[1.0 - eps**2 / s2, eps * (1.0 - eps * C)], [-eps / s2, 1.0 - eps * C]])
    Q = 2.0 * C * eps * np.array([[eps**2, eps], [eps, 1.0]])
    sigma = solve_discrete_lyapunov(M, Q)
    d = q[0].numpy()
    np.testing.assert_allclose(d.mean(), 0.0, atol=0.05)
    np.testing.assert_allclose(d.var(), sigma[0, 0], rtol=0.08)
    assert tuple(p.shape) == (1, N_CHAINS)


def test_unbiased_vs_full_gradient():
    """Mirrors TestMinibatchGradient::test_unbiased_vs_full_gradient: the
    mean of 8,000 minibatch gradients against the full one (rtol 0.1, atol
    0.6)."""
    data = (torch.from_numpy(X), torch.from_numpy(Y))
    grad = minibatch_grad_cols(_lp_t, _ll_t, data, batch_size=8)
    q = torch.from_numpy(np.random.RandomState(4).randn(4, 2).astype(np.float32))
    full = full_grad_cols(lambda qq: _lp_t(qq) + _ll_t(qq, data))(q, None)
    gen = torch.Generator().manual_seed(0)
    est = torch.stack([grad(q, gen) for _ in range(8000)]).mean(dim=0)
    np.testing.assert_allclose(est.numpy(), full.numpy(), rtol=0.1, atol=0.6)


def test_minibatch_sgld_conjugate_posterior():
    """Mirrors test_minibatch_sgld_conjugate_posterior: batch 16 of 64
    observations; mean within 0.02 of the conjugate posterior's, variance
    between 0.8 and 3 times its (minibatch noise inflates it)."""
    obs = np.asarray(np.random.RandomState(5).randn(64) * 0.5 + 2.0, np.float32)
    s = 0.5
    v_post = 1.0 / (1.0 + len(obs) / s**2)
    m_post = v_post * obs.sum() / s**2

    def ll(q, shard):
        (ys,) = shard
        return -0.5 * torch.sum((ys[:, None] - q[0]) ** 2, dim=0) / s**2

    grad = minibatch_grad_cols(_lp_t, ll, (torch.from_numpy(obs),), batch_size=16)
    q, draws = sgld_sweep_cols(grad, torch.full((1, N_CHAINS), float(m_post)), 2, n_steps=2000, eps=2e-4,
                               collect=True)
    d = q[0].numpy()
    np.testing.assert_allclose(d.mean(), m_post, atol=0.02)
    assert v_post * 0.8 < d.var() < v_post * 3.0
    assert tuple(draws.shape) == (2000, 1, N_CHAINS)


def test_sghmc_streams_differ_from_sgld_under_one_seed():
    """An int seed gives SGHMC its own stream, the root ``key(seed ^
    0x5A17)``, as the reference derives its key: the momentum starts as the
    normal draw of ``fold_in(root, n_steps)``."""
    from genjax_tpu_torch.core import keys

    grad = full_grad_cols(lambda q: -0.5 * torch.sum(q**2, dim=0))
    _q, p0 = sghmc_sweep_cols(grad, torch.zeros(1, 8), 7, n_steps=0, eps=0.1)
    assert torch.equal(p0, keys.normal(keys.fold_in(keys.key(7 ^ 0x5A17, device="cpu"), 0), (1, 8)))

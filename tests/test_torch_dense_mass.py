"""Dense mass-matrix HMC in the port (``genjax_tpu_torch/kernels/dense_mass.py``)
against ``genjax_tpu.kernels.dense_mass`` and the closed forms of
``tests/kernels/test_dense_mass.py``.

The covariance estimator and the whitening maps are deterministic: the same
numpy inputs go through both packages, held to rtol 1e-5. The sweeps draw
from a ``torch.Generator`` where the reference splits a key, so they are held
in law against the reference test's closed forms, with its tolerances stated
beside each check.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.kernels import dense_mass as ref
from genjax_tpu_torch.kernels import column_hmc, nuts_sweep_cols
from genjax_tpu_torch.kernels.dense_mass import (
    cross_chain_cov,
    hmc_sweep_dense_cols,
    warmup_column_dense,
    whiten_logdensity,
)
from torch_threads import _one_thread  # noqa: F401

N_CHAINS = 2048
RTOL = 1e-5


def _correlated_target(rho=0.9, scales=(1.0, 0.3, 0.1)):
    """N(mu*, Sigma*) with constant correlation rho and the given scales."""
    d = len(scales)
    corr = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    s = np.diag(scales)
    sigma = (s @ corr @ s).astype(np.float64)
    mu = np.linspace(-1.0, 1.0, d).astype(np.float32)
    prec = torch.from_numpy(np.linalg.inv(sigma).astype(np.float32))
    mu_t = torch.from_numpy(mu)

    def ld(q):
        r = q - mu_t[:, None]
        return -0.5 * torch.sum(r * (prec @ r), dim=0)

    return ld, mu, sigma.astype(np.float32)


@pytest.mark.parametrize("shape, shrinkage, jitter", [
    ((3, 8192), 0.0, 1e-6), ((3, 8192), 0.5, 0.0), ((5, 300), 0.1, 1e-6), ((8, 4), 0.3, 1e-6),
])
def test_cross_chain_cov_matches_reference(shape, shrinkage, jitter):
    """Full rank, and N < D where only the shrinkage makes it invertible."""
    q = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    port = cross_chain_cov(torch.from_numpy(q), shrinkage=shrinkage, jitter=jitter).numpy()
    want = np.asarray(ref.cross_chain_cov(jnp.asarray(q), shrinkage=shrinkage, jitter=jitter))
    np.testing.assert_allclose(port, want, rtol=RTOL, atol=1e-7)


def test_whitening_matches_reference():
    """The round trip, the white log-density, and the two maps, against the
    reference on the same factor, mean and points."""
    _ld, mu, sigma = _correlated_target()
    chol = np.linalg.cholesky(sigma).astype(np.float32)
    q = np.random.default_rng(1).normal(size=(3, 16)).astype(np.float32)
    prec = np.linalg.inv(sigma).astype(np.float32)

    def ld_t(x):
        return -0.5 * torch.sum(x * (torch.from_numpy(prec) @ x), dim=0)

    def ld_j(x):
        return -0.5 * jnp.sum(x * (jnp.asarray(prec) @ x), axis=0)

    white, whiten, unwhiten = whiten_logdensity(ld_t, torch.from_numpy(chol), mean=torch.from_numpy(mu))
    r_white, r_whiten, r_unwhiten = ref.whiten_logdensity(ld_j, jnp.asarray(chol), mean=jnp.asarray(mu))
    qt = torch.from_numpy(q)
    np.testing.assert_allclose(unwhiten(whiten(qt)).numpy(), q, atol=1e-5)
    np.testing.assert_allclose(whiten(qt).numpy(), np.asarray(r_whiten(jnp.asarray(q))), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(unwhiten(qt).numpy(), np.asarray(r_unwhiten(jnp.asarray(q))), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(white(qt).numpy(), np.asarray(r_white(jnp.asarray(q))), rtol=RTOL)
    # a scalar mean broadcasts over the rows
    _w, whiten0, _u = whiten_logdensity(ld_t, torch.from_numpy(chol))
    _rw, r_whiten0, _ru = ref.whiten_logdensity(ld_j, jnp.asarray(chol))
    np.testing.assert_allclose(whiten0(qt).numpy(), np.asarray(r_whiten0(jnp.asarray(q))), rtol=RTOL, atol=1e-6)


def test_recovers_known_covariance():
    """Mirrors TestCrossChainCov::test_recovers_known_covariance (atol 0.05)."""
    _, _, sigma = _correlated_target()
    q = np.linalg.cholesky(sigma) @ np.random.RandomState(0).randn(3, 8192)
    est = cross_chain_cov(torch.from_numpy(q.astype(np.float32)), shrinkage=0.0).numpy()
    np.testing.assert_allclose(est, sigma, atol=0.05)


def test_shrinkage_preserves_diagonal():
    """Mirrors test_shrinkage_preserves_diagonal (rtol 1e-5)."""
    _, _, sigma = _correlated_target()
    q = torch.from_numpy((np.linalg.cholesky(sigma) @ np.random.RandomState(1).randn(3, 8192)).astype(np.float32))
    full = cross_chain_cov(q, shrinkage=0.0, jitter=0.0).numpy()
    shrunk = cross_chain_cov(q, shrinkage=0.5, jitter=0.0).numpy()
    np.testing.assert_allclose(np.diag(shrunk), np.diag(full), rtol=1e-5)
    off = ~np.eye(3, dtype=bool)
    np.testing.assert_allclose(shrunk[off], 0.5 * full[off], rtol=1e-5)


def test_singular_cloud_stays_choleskyable():
    """Mirrors test_singular_cloud_stays_choleskyable: D = 8 > N = 4."""
    q = torch.from_numpy(np.random.RandomState(2).randn(8, 4).astype(np.float32))
    chol = torch.linalg.cholesky(cross_chain_cov(q, shrinkage=0.3))
    assert bool(torch.isfinite(chol).all())


def test_posterior_moments_with_true_metric():
    """Mirrors TestDenseMassExactness::test_posterior_moments_with_true_metric:
    accept over 0.6, means within 0.05, covariance within 0.06."""
    ld, mu, sigma = _correlated_target()
    chol = torch.from_numpy(np.linalg.cholesky(sigma))
    q0 = torch.zeros(3, N_CHAINS)
    q, acc = hmc_sweep_dense_cols(ld, q0, 0, n_steps=300, eps=0.8, L=4, cov_chol=chol)
    draws = q.numpy()
    assert float(acc) > 0.6, float(acc)
    np.testing.assert_allclose(draws.mean(axis=1), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(draws), sigma, atol=0.06)
    assert q.device == q0.device


def test_warmup_recovers_metric_and_samples():
    """Mirrors test_warmup_recovers_metric_and_samples: the adapted metric
    within rtol 0.35 + atol 0.05 of Sigma*; afterwards accept over 0.5,
    means within 0.05, covariance within 0.05."""
    ld, mu, sigma = _correlated_target(rho=0.85, scales=(1.0, 0.2))
    q0 = torch.from_numpy(np.random.RandomState(3).randn(2, N_CHAINS).astype(np.float32))
    q, eps, cov_chol = warmup_column_dense(ld, q0, 7, n_phases=8, steps_per_phase=30, eps0=0.1, L=4,
                                           shrinkage=0.05)
    np.testing.assert_allclose((cov_chol @ cov_chol.T).numpy(), sigma, rtol=0.35, atol=0.05)
    q, acc = hmc_sweep_dense_cols(ld, q, 11, n_steps=200, eps=float(eps), L=4, cov_chol=cov_chol)
    draws = q.numpy()
    assert float(acc) > 0.5
    np.testing.assert_allclose(draws.mean(axis=1), mu[:2], atol=0.05)
    np.testing.assert_allclose(np.cov(draws), sigma, atol=0.05)


def test_dense_beats_diagonal_on_correlated_target():
    """Mirrors test_dense_beats_diagonal_on_correlated_target: at rho = 0.99
    and the same eps, the dense metric accepts over 0.6 and the identity
    under 0.25."""
    ld, _, sigma = _correlated_target(rho=0.99, scales=(1.0, 1.0))
    chol = np.linalg.cholesky(sigma)
    q0 = torch.from_numpy((chol @ np.random.RandomState(4).randn(2, 512)).astype(np.float32))
    _, acc_dense = hmc_sweep_dense_cols(ld, q0, 1, n_steps=50, eps=0.9, L=4, cov_chol=torch.from_numpy(chol))
    _, acc_diag = hmc_sweep_dense_cols(ld, q0, 1, n_steps=50, eps=0.9, L=4, cov_chol=torch.eye(2))
    assert float(acc_dense) > 0.6, float(acc_dense)
    assert float(acc_diag) < 0.25, float(acc_diag)


def test_collect_and_nan_rejection():
    """``collect`` returns every transition's positions; a NaN log
    acceptance is a rejection (the reference's ``-inf``)."""
    def ld(q):
        return torch.where(q[0] > 0.0, torch.nan, -0.5 * torch.sum(q**2, dim=0))

    q0 = torch.full((2, 64), -1.0)
    q, acc, draws = hmc_sweep_dense_cols(ld, q0, 2, n_steps=7, eps=0.5, L=3, cov_chol=torch.eye(2),
                                         collect=True)
    assert tuple(draws.shape) == (7, 2, 64) and torch.equal(draws[-1], q)
    assert bool((draws[:, 0] <= 0.0).all()) and 0.0 <= float(acc) <= 1.0


def _collinear():
    rng = np.random.RandomState(0)
    n_obs, s2 = 32, 0.25
    x1 = rng.randn(n_obs)
    X = np.stack([x1, x1 + 0.15 * rng.randn(n_obs)], axis=1).astype(np.float32)
    y = (X @ np.asarray([1.0, -0.5], np.float32) + np.sqrt(s2) * rng.randn(n_obs)).astype(np.float32)
    cov_post = np.linalg.inv(np.eye(2) + X.T @ X / s2)
    mean_post = cov_post @ (X.T @ y) / s2
    Xt = torch.from_numpy(X)

    @g.gen
    def model():
        w = g.mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        _ = g.mv_normal_diag(Xt @ w, torch.full((n_obs,), float(np.sqrt(s2)))) @ "y"

    return model, torch.from_numpy(y), mean_post, cov_post


def test_gen_model_correlated_posterior_exact():
    """Mirrors TestColumnBridgeDense::test_gen_model_correlated_posterior_exact:
    column_hmc(mass='dense', warmup=True) on a near-collinear regression
    (|rho| > 0.9): accept over 0.5, means within 0.05, covariance within
    0.03."""
    model, y, mean_post, cov_post = _collinear()
    rho = cov_post[0, 1] / np.sqrt(cov_post[0, 0] * cov_post[1, 1])
    assert abs(rho) > 0.9
    q, accept, _packer = column_hmc(model, g.C["y"].set(y), (), ["w"], n_chains=1024, n_steps=300, eps=0.3,
                                    L=4, warmup=True, mass="dense", device="cpu")
    assert float(accept) > 0.5, float(accept)
    draws = q[:2].numpy()
    np.testing.assert_allclose(draws.mean(axis=1), mean_post, atol=0.05)
    np.testing.assert_allclose(np.cov(draws), cov_post, atol=0.03)


def test_dense_column_hmc_rejects_what_it_cannot_use(monkeypatch):
    model, y, _m, _c = _collinear()
    kw = dict(n_chains=8, n_steps=1, eps=0.3, device="cpu")
    with pytest.raises(ValueError, match="warmup=True"):
        column_hmc(model, g.C["y"].set(y), (), ["w"], mass="dense", **kw)
    with pytest.raises(ValueError, match="inv_mass"):
        column_hmc(model, g.C["y"].set(y), (), ["w"], mass="dense", warmup=True, inv_mass=[1.0, 1.0], **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column_hmc(model, g.C["y"].set(y), (), ["w"], n_chains=8, n_steps=1, eps=0.3, warmup=True,
                   mass="dense")


def test_nuts_gains_dense_metric_via_whitening():
    """Mirrors TestWhitening::test_nuts_gains_dense_metric_via_whitening:
    on rho = 0.99 the whitened chain's means within 0.1 and covariance within
    0.12, under 8 leapfrogs a transition, and the raw chain needing over
    twice as many."""
    ld, mu, sigma = _correlated_target(rho=0.99, scales=(1.0, 1.0))
    chol = np.linalg.cholesky(sigma)
    white_ld, whiten, unwhiten = whiten_logdensity(ld, torch.from_numpy(chol), mean=torch.from_numpy(mu))
    q0 = torch.from_numpy((chol @ np.random.RandomState(7).randn(2, 1024) + mu[:, None]).astype(np.float32))
    u, _acc, leaps_w = nuts_sweep_cols(white_ld, whiten(q0), 1, n_steps=40, eps=0.9, max_depth=6)
    draws = unwhiten(u).numpy()
    np.testing.assert_allclose(draws.mean(axis=1), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(draws), sigma, atol=0.12)
    assert float(leaps_w) < 8.0, float(leaps_w)
    _q2, _acc2, leaps_raw = nuts_sweep_cols(ld, q0, 1, n_steps=10, eps=0.05, max_depth=6)
    assert float(leaps_raw) > 2.0 * float(leaps_w), (float(leaps_raw), float(leaps_w))


def test_roundtrip():
    """Mirrors TestWhitening::test_roundtrip (atol 1e-5)."""
    ld, mu, sigma = _correlated_target()
    _, whiten, unwhiten = whiten_logdensity(ld, torch.from_numpy(np.linalg.cholesky(sigma)),
                                            mean=torch.from_numpy(mu))
    q = torch.from_numpy(np.random.RandomState(0).randn(3, 16).astype(np.float32))
    np.testing.assert_allclose(unwhiten(whiten(q)).numpy(), q.numpy(), atol=1e-5)

"""The port's MAP and Laplace estimation against
``genjax_tpu/inference/learning.py`` and closed forms, and its Poisson GLM
against ``genjax_tpu/models/regression.py``.

The cases of ``tests/inference/test_learning.py`` and
``tests/models/test_glm.py``, with their tolerances; beside them, on the
same data, the port's mode and Laplace covariance against the reference's
(both climb to the same strictly concave optimum from their own prior
draws: 1e-3 absolute on the mode, 1e-3 relative on the covariance), and
``poisson_regression``'s ``assess`` against the reference's on the same
choices (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.learning import laplace_approximation as ref_laplace
from genjax_tpu_torch.inference import fit_map, laplace_approximation
from genjax_tpu_torch.models import linear_regression, poisson_regression

CPU = {"device": "cpu"}


class TestFitMAP:
    def test_conjugate_map_is_posterior_mode(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 1.0) @ "y"

        res = fit_map(0, model, g.C["y"].set(2.0), (), g.S["mu"], n_steps=200, learning_rate=0.1, **CPU)
        # posterior N(1, 1/2): mode 1
        assert float(res["mu"]) == pytest.approx(1.0, abs=0.01)
        expected_lj = -np.log(2 * np.pi) - 0.5 * (1.0 + 1.0)
        assert float(res.log_joint) == pytest.approx(expected_lj, abs=1e-3)

    def test_vector_regression_map(self):
        N, D = 20, 3
        rng = np.random.default_rng(0)
        X = rng.normal(size=(N, D)).astype(np.float32)
        y = (X @ np.asarray([1.0, -1.0, 0.5], np.float32) + 0.25 * rng.normal(size=N)).astype(np.float32)
        model, exact_posterior = linear_regression(X)
        post_mean, _ = exact_posterior(y)
        res = fit_map(0, model, g.C["y"].set(torch.as_tensor(y)), (), g.S["w"], n_steps=400, learning_rate=0.05, **CPU)
        # Gaussian posterior: mode == mean
        assert torch.allclose(res["w"], post_mean, atol=0.01)

    def test_laplace_exact_on_gaussian_posterior(self):
        """Laplace is exact for Gaussian posteriors: mean, covariance and
        evidence all match the conjugate closed forms."""
        N, D = 20, 3
        rng = np.random.default_rng(1)
        X = rng.normal(size=(N, D)).astype(np.float32)
        y = (X @ np.asarray([1.0, -1.0, 0.5]) + 0.25 * rng.normal(size=N)).astype(np.float32)
        model, exact_posterior = linear_regression(X)
        post_mean, post_cov = exact_posterior(y)
        lap = laplace_approximation(
            0, model, g.C["y"].set(torch.as_tensor(y)), (), g.S["w"], n_steps=400, learning_rate=0.05, **CPU
        )
        assert torch.allclose(lap.mean, post_mean, atol=0.01)
        assert torch.allclose(lap.cov, post_cov, atol=1e-3)
        S = 0.25**2 * np.eye(N) + X.astype(np.float64) @ X.T
        _, logdet = np.linalg.slogdet(2 * np.pi * S)
        exact_lml = -0.5 * (logdet + y @ np.linalg.solve(S, y))
        assert float(lap.log_marginal) == pytest.approx(float(exact_lml), abs=0.01)
        # unpack maps a raveled vector back to the selection's choices
        assert torch.equal(lap.unpack(lap.mean)["w"], lap.mean)

    def test_restarts_escape_bad_inits(self):
        # bimodal: mu^2 observed; restarts find one of the modes +-2
        @g.gen
        def model():
            mu = g.normal(0.0, 3.0) @ "mu"
            _ = g.normal(mu * mu, 0.2) @ "y"

        res = fit_map(
            0, model, g.C["y"].set(4.0), (), g.S["mu"], n_steps=300, learning_rate=0.05, n_restarts=16, **CPU
        )
        assert abs(abs(float(res["mu"])) - 2.0) < 0.05
        assert float(res.trajectory[-1]) >= float(res.trajectory[0])


def test_laplace_non_positive_definite_surfaces_nan():
    """At a point where -H is not positive definite the Gaussian
    approximation does not exist: log_marginal and cov come back NaN."""

    @g.gen
    def saddle():
        z = g.uniform(-1e-3, 1e-3) @ "z"  # flat prior, zero curvature
        _ = g.normal(z * z, 0.1) @ "y"  # y = 4: log-likelihood curvature at 0 is +800

    lap = laplace_approximation(0, saddle, g.C["y"].set(4.0), (), g.S["z"], n_steps=0, n_restarts=2, **CPU)
    assert bool(torch.isnan(lap.log_marginal))
    assert bool(torch.all(torch.isnan(lap.cov)))


def test_entry_points_default_to_the_card():
    @g.gen
    def model():
        _ = g.normal(0.0, 1.0) @ "mu"

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fit_map(0, model, g.C, (), g.S["mu"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            laplace_approximation(0, model, g.C, (), g.S["mu"])


# ---------------------------------------------------------------------
# the Poisson GLM
# ---------------------------------------------------------------------

_rng = np.random.RandomState(0)
N, D = 40, 3
X = _rng.randn(N, D).astype(np.float32) * 0.5
W_TRUE = np.asarray([0.8, -0.5, 0.3], np.float32)
Y = _rng.poisson(np.exp(X @ W_TRUE)).astype(np.float32)


def _obs():
    return g.C["obs", torch.arange(N), "y"].set(torch.as_tensor(Y))


def _ref_obs():
    return gj.C["obs", jnp.arange(N), "y"].set(jnp.asarray(Y))


def _newton_mode():
    """The float64 optimum of ``-log p(w, y) = |w|^2 / 2 + sum(exp(Xw) -
    y Xw)``, and its inverse Hessian."""
    Xd, Yd = X.astype(np.float64), Y.astype(np.float64)
    w = np.zeros(D)
    for _ in range(50):
        rate = np.exp(Xd @ w)
        grad = w + Xd.T @ (rate - Yd)
        H = np.eye(D) + Xd.T @ (rate[:, None] * Xd)
        w = w - np.linalg.solve(H, grad)
    rate = np.exp(Xd @ w)
    return w, np.linalg.inv(np.eye(D) + Xd.T @ (rate[:, None] * Xd))


class TestPoissonGLM:
    def test_model_scores_and_simulates(self):
        """generate's weight under full observation equals assess (the
        GFI identity), and assess equals the reference's on the same
        choices."""
        model = poisson_regression(X)
        tr, _ = model.generate(torch.Generator().manual_seed(1), _obs(), ())
        score, _ = model.assess(tr.get_choices(), ())
        assert bool(torch.isfinite(score))
        assert float(score) == pytest.approx(float(tr.get_score()), abs=1e-3)
        w = tr.get_choices()["w"].numpy()
        ref_model = gj.models.poisson_regression(X)
        ref_score, _ = ref_model.assess(_ref_obs() | gj.C["w"].set(jnp.asarray(w)), ())
        assert float(score) == pytest.approx(float(ref_score), rel=1e-6)

    def test_laplace_mode_and_covariance(self):
        model = poisson_regression(X)
        lap = laplace_approximation(0, model, _obs(), (), g.S["w"], n_steps=800, learning_rate=0.05, **CPU)
        w_map = lap.mean.double().numpy()
        mode, cov = _newton_mode()
        np.testing.assert_allclose(w_map, mode, atol=1e-3)
        np.testing.assert_allclose(lap.cov.double().numpy(), cov, rtol=1e-3, atol=1e-6)
        # the reference's own Laplace fit on the same data
        ref = ref_laplace(jax.random.key(0), gj.models.poisson_regression(X), _ref_obs(), (), gj.S["w"], n_steps=800)
        np.testing.assert_allclose(w_map, np.asarray(ref.mean), atol=1e-3)
        np.testing.assert_allclose(lap.cov.numpy(), np.asarray(ref.cov), rtol=1e-3, atol=1e-6)
        assert float(lap.log_marginal) == pytest.approx(float(ref.log_marginal), abs=1e-3)

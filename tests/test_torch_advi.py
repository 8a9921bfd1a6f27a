"""The port's ADVI against ``genjax_tpu/inference/advi.py`` and exact
Gaussian algebra.

The cases of ``tests/inference/test_advi.py`` with their tolerances: full
rank on a Gaussian target has the target as its optimum (mean, covariance
and ``log Z`` in closed form), mean field on a correlated Gaussian reaches
the inverse-precision diagonal, ``column_advi`` the conjugate posterior;
beside them the guide's ``log q`` against the reference's on the same
parameters and columns (rtol 1e-6).
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal
from torch_threads import _one_thread  # noqa: F401

import genjax_tpu_torch as g
from genjax_tpu_torch.inference.advi import ADVIResult, advi, column_advi

CPU = {"device": "cpu"}
# the module: ``genjax_tpu.inference.advi`` is the fit function
RA = importlib.import_module("genjax_tpu.inference.advi")


def _gaussian_target(m, cov):
    m = torch.as_tensor(np.asarray(m, np.float32))
    prec = torch.linalg.inv(torch.as_tensor(np.asarray(cov, np.float32)))

    def logp(z):  # (D, K) -> (K,), unnormalized
        d = z - m[:, None]
        return -0.5 * torch.sum(d * (prec @ d), dim=0)

    return logp


class TestFullRank:
    def setup_method(self):
        rng = np.random.default_rng(3)
        a = rng.normal(size=(3, 3))
        self.cov = np.asarray(a @ a.T + 3.0 * np.eye(3), np.float32)
        self.m = np.asarray([1.0, -2.0, 0.5], np.float32)
        self.log_z = 0.5 * 3 * np.log(2 * np.pi) + 0.5 * np.linalg.slogdet(self.cov)[1]

    def test_recovers_mean_covariance_and_log_normalizer(self):
        res = advi(
            7, _gaussian_target(self.m, self.cov), 3, rank="full", n_steps=2000, n_samples=32,
            learning_rate=0.05, n_elbo_samples=2048, **CPU,
        )
        np.testing.assert_allclose(res.mu.numpy(), self.m, atol=0.05)
        np.testing.assert_allclose(res.cov.numpy(), self.cov, atol=0.15, rtol=0.05)
        # target unnormalized N(m, cov): log Z = D/2 log 2 pi + 1/2 log|cov|
        assert float(res.elbo) == pytest.approx(float(self.log_z), abs=0.05)

    def test_stl_beats_entropy_noise_floor(self):
        common = dict(rank="full", n_steps=2000, learning_rate=0.05, **CPU)
        stl = advi(7, _gaussian_target(self.m, self.cov), 3, estimator="stl", **common)
        ent = advi(7, _gaussian_target(self.m, self.cov), 3, estimator="entropy", **common)
        assert float(torch.std(stl.elbo_trace[-200:])) < float(torch.std(ent.elbo_trace[-200:]))
        assert float(ent.elbo) == pytest.approx(float(self.log_z), abs=0.2)

    def test_logq_matches_scipy_and_reference(self):
        res = advi(7, _gaussian_target(self.m, self.cov), 3, rank="full", n_steps=50, **CPU)
        z = torch.randn((3, 5), generator=torch.Generator().manual_seed(1))
        expected = multivariate_normal.logpdf(z.numpy().T, res.mu.double().numpy(), res.cov.double().numpy())
        np.testing.assert_allclose(res.logq(z).numpy(), expected, rtol=1e-4, atol=1e-4)
        ref = RA.ADVIResult(
            mu=jnp.asarray(res.mu.numpy()), scale_tril=jnp.asarray(res.scale_tril.numpy()), elbo_trace=None, elbo=None
        )
        np.testing.assert_allclose(res.logq(z).numpy(), np.asarray(ref.logq(jnp.asarray(z.numpy()))), rtol=1e-6)
        draws = res.sample(torch.Generator().manual_seed(2), 40000)
        np.testing.assert_allclose(draws.mean(1).numpy(), res.mu.numpy(), atol=0.05)
        np.testing.assert_allclose(torch.cov(draws).numpy(), res.cov.numpy(), atol=0.1)


class TestMeanField:
    def test_independent_gaussian_exact(self):
        cov = np.diag([0.25, 4.0]).astype(np.float32)
        m = np.asarray([2.0, -1.0], np.float32)
        res = advi(7, _gaussian_target(m, cov), 2, rank="diag", n_steps=2000, learning_rate=0.05, **CPU)
        np.testing.assert_allclose(res.mu.numpy(), m, atol=0.03)
        np.testing.assert_allclose(res.sd.numpy(), [0.5, 2.0], rtol=0.05)

    def test_correlated_gaussian_gives_inverse_precision_diag(self):
        # q cannot match p, so STL gradients do not vanish at the optimum:
        # a cosine-decayed step size passes below the noise floor
        cov = np.asarray([[1.0, 0.8], [0.8, 1.0]], np.float32)
        m = np.asarray([0.3, -0.7], np.float32)

        def cosine(step, n=3000, lr=0.05):
            return lr * 0.5 * (1.0 + math.cos(math.pi * min(step, n) / n))

        res = advi(7, _gaussian_target(m, cov), 2, rank="diag", n_steps=3000, learning_rate=cosine, **CPU)
        expected_sd = 1.0 / np.sqrt(np.diag(np.linalg.inv(cov)))
        np.testing.assert_allclose(res.mu.numpy(), m, atol=0.03)
        np.testing.assert_allclose(res.sd.numpy(), expected_sd, rtol=0.06)

    def test_validation(self):
        with pytest.raises(ValueError, match="rank"):
            advi(7, _gaussian_target([0.0], [[1.0]]), 1, rank="banded", **CPU)
        with pytest.raises(ValueError, match="estimator"):
            advi(7, _gaussian_target([0.0], [[1.0]]), 1, estimator="score", **CPU)


class TestColumnADVI:
    def _model(self):
        @g.gen
        def model():
            mu = g.normal(0.0, 1.0) @ "mu"
            _ = g.normal(mu, 0.5) @ "y"

        return model

    def test_conjugate_normal_normal(self):
        post = column_advi(
            7, self._model(), g.C["y"].set(1.0), (), ["mu"], rank="full", n_steps=2000, learning_rate=0.05, **CPU
        )
        # posterior: var = 1 / (1 + 1 / 0.25) = 0.2, mean = 0.8
        assert float(post.mean_choices()["mu"]) == pytest.approx(0.8, abs=0.03)
        assert float(post.result.sd[0]) == pytest.approx(np.sqrt(0.2), rel=0.08)
        chms = post.sample_choices(torch.Generator().manual_seed(3), 4000)
        draws = chms["mu"]
        assert tuple(draws.shape) == (4000,)
        assert float(draws.mean()) == pytest.approx(0.8, abs=0.05)
        # a padding dimension (the packer pads 1 -> 8) fits N(0, 1)
        assert float(post.result.mu[1]) == pytest.approx(0.0, abs=0.06)
        assert float(post.result.sd[1]) == pytest.approx(1.0, rel=0.08)

    def test_constrained_address_rejected(self):
        with pytest.raises(ValueError, match="constrained"):
            column_advi(7, self._model(), g.C["y"].set(1.0), (), ["y"], **CPU)

    def test_defaults_to_the_card(self):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                column_advi(7, self._model(), g.C["y"].set(1.0), (), ["mu"])
            with pytest.raises(RuntimeError, match="device='cpu'"):
                advi(7, _gaussian_target([0.0], [[1.0]]), 1)


def test_result_is_a_pytree():
    res = ADVIResult(torch.zeros(2), torch.eye(2), torch.zeros(3), torch.tensor(0.0))
    assert torch.equal(res.cov, torch.eye(2))
    assert torch.equal(res.sd, torch.ones(2))

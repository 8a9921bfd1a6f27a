"""The PPCA and BNN model families (``models/ppca.py``, ``models/bnn.py``)
against ``genjax_tpu`` on the same numpy-seeded inputs.

Deterministic to 1e-5 (relative; absolute 1e-5, 1e-4 for sums over 400
points): PPCA's log-likelihood (and against scipy's MVN), the ML fit
(``W W^T``, ``mu``, ``sigma2``: ``W``'s columns are signed freely), the
latent posterior, 60 EM iterations and their likelihood trace, EM's fixed
point against the spectral ML solution, the ``@gen`` model's score; the
BNN's scores, forward pass, ``bnn_exact_linear_posterior`` and
``bnn_predict`` over the same draws (carried across with
``interop.choice_map_from_numpy``). In law: ``column_advi``'s fit of the
linear network against the exact posterior (the reference test's 0.05 on
the mean and 0.02 on the covariance).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from scipy.stats import multivariate_normal

import genjax_tpu as gj
import genjax_tpu.models.bnn as rbnn
import genjax_tpu.models.ppca as rppca
import genjax_tpu_torch as g
from genjax_tpu_torch import interop
from genjax_tpu_torch.models.bnn import bayesian_nn, bnn_exact_linear_posterior, bnn_predict
from genjax_tpu_torch.models.ppca import ppca_em, ppca_log_likelihood, ppca_ml, ppca_model, ppca_posterior
from torch_threads import _one_thread  # noqa: F401

D, Q, N = 5, 2, 400
_rng = np.random.RandomState(0)
W_TRUE = _rng.randn(D, Q).astype(np.float32)
MU_TRUE = _rng.randn(D).astype(np.float32)
SIGMA = 0.4
X = (_rng.randn(N, Q) @ W_TRUE.T + MU_TRUE + SIGMA * _rng.randn(N, D)).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_ppca_log_likelihood_matches_reference_and_scipy():
    W, mu, s = interop.ppca_params_from_numpy(W_TRUE, MU_TRUE, SIGMA)
    got = ppca_log_likelihood(X, W, mu, s**2)
    _close(got, rppca.ppca_log_likelihood(X, jnp.asarray(W_TRUE), MU_TRUE, SIGMA**2), atol=1e-4)
    cov = W_TRUE.astype(np.float64) @ W_TRUE.T + SIGMA**2 * np.eye(D)
    _close(got, multivariate_normal.logpdf(X, MU_TRUE, cov).sum(), 1e-4)


def test_ppca_ml_and_posterior_match_reference():
    W, mu, s2 = ppca_ml(X, Q)
    r_W, r_mu, r_s2 = rppca.ppca_ml(X, Q)
    _close(W @ W.T, np.asarray(r_W @ r_W.T), atol=1e-4)
    _close(mu, r_mu)
    _close(s2, r_s2)
    m, c = ppca_posterior(torch.from_numpy(X[0]), torch.from_numpy(W_TRUE), MU_TRUE, SIGMA**2)
    r_m, r_c = rppca.ppca_posterior(jnp.asarray(X[0]), jnp.asarray(W_TRUE), MU_TRUE, SIGMA**2)
    _close(m, r_m)
    _close(c, r_c)


def test_ppca_em_matches_reference_and_reaches_the_ml_fixed_point():
    (W, mu, s2), lls = ppca_em(X, Q, n_iters=60)
    (r_W, _, r_s2), r_lls = jax.jit(lambda: rppca.ppca_em(X, Q, n_iters=60))()
    _close(lls, r_lls, atol=1e-4)
    _close(W, r_W, 1e-4, 1e-4)
    _close(s2, r_s2, 1e-4)
    assert bool((torch.diff(lls) > -1e-2).all())
    W_ml, mu_ml, s2_ml = ppca_ml(X, Q)
    (W_em, _, s2_em), _ = ppca_em(X, Q, n_iters=200)
    _close(ppca_log_likelihood(X, W_em, mu, s2_em), ppca_log_likelihood(X, W_ml, mu_ml, s2_ml), 1e-5)


def test_ppca_model_score_matches_reference():
    model = ppca_model(W_TRUE, MU_TRUE, SIGMA)
    tr = model.simulate(torch.Generator().manual_seed(0), ())
    z, x = tr.get_choices()["z"].numpy(), tr.get_choices()["x"].numpy()
    r_model = rppca.ppca_model(W_TRUE, jnp.asarray(MU_TRUE), SIGMA)
    r_score, _ = r_model.assess(gj.C["z"].set(jnp.asarray(z)) | gj.C["x"].set(jnp.asarray(x)), ())
    _close(tr.get_score(), r_score)
    score, _ = model.assess(interop.choice_map_from_numpy({("z",): z, ("x",): x}), ())
    _close(score, r_score)


XB = np.random.default_rng(2).normal(size=(6, 2)).astype(np.float32)


@pytest.mark.parametrize("hidden,d_out,activation", [((), 1, "linear"), ((4, 3), 2, "relu"), ((5,), 1, "tanh"),
                                                     ((3,), 2, "gelu")])
def test_bnn_scores_forward_and_predict_match_reference(hidden, d_out, activation):
    model, addresses, forward = bayesian_nn(XB, hidden=hidden, d_out=d_out, activation=activation)
    r_model, r_addresses, r_forward = rbnn.bayesian_nn(XB, hidden=hidden, d_out=d_out, activation=activation)
    assert addresses == r_addresses
    draws = jax.jit(jax.vmap(lambda k: r_model.simulate(k, ()).get_choices()))(jr.split(jr.key(0), 5))
    entries = {(a,): np.asarray(draws.get_submap(a).get_value()) for a in addresses + ["y"]}
    chms = interop.choice_map_from_numpy(entries)
    scores = torch.func.vmap(lambda c: model.assess(c, ())[0])(chms)
    _close(scores, jax.jit(jax.vmap(lambda c: r_model.assess(c, ())[0]))(draws), 1e-5, 1e-4)
    mean, sd = bnn_predict(chms, XB, forward)
    r_mean, r_sd = jax.jit(lambda d: rbnn.bnn_predict(d, XB, r_forward))(draws)
    _close(mean, r_mean)
    _close(sd, r_sd)
    assert tuple(mean.shape) == (6, d_out)


def test_bnn_validation_and_addresses():
    with pytest.raises(ValueError, match="activation"):
        bayesian_nn(np.zeros((4, 2), np.float32), activation="swishh")
    model, addresses, forward = bayesian_nn(XB, hidden=(4, 3), d_out=2, activation="relu")
    assert addresses == ["W0", "b0", "W1", "b1", "W2", "b2"]
    tr = model.simulate(torch.Generator().manual_seed(3), ())
    resid = tr.get_choices()["y"] - forward(tr.get_choices(), XB).reshape(-1)
    assert float(resid.abs().max()) < 5 * 0.25


_r = np.random.default_rng(0)
XL = _r.normal(size=(30, 3)).astype(np.float32)
YL = (XL @ np.asarray([1.0, -0.5, 0.25], np.float32) + 0.3 + 0.25 * _r.normal(size=30)).astype(np.float32)


def test_bnn_exact_linear_posterior_matches_reference():
    mean, cov = bnn_exact_linear_posterior(XL, YL)
    r_mean, r_cov = rbnn.bnn_exact_linear_posterior(XL, YL)
    _close(mean, r_mean)
    _close(cov, r_cov)


def test_column_advi_fits_the_linear_network_in_law():
    model, addresses, _ = bayesian_nn(XL, hidden=())
    post = g.inference.column_advi(3, model, g.C["y"].set(torch.from_numpy(YL)), (), addresses, rank="full",
                                   n_steps=1500, learning_rate=0.03, device="cpu")
    mean, cov = bnn_exact_linear_posterior(XL, YL)
    _close(post.result.mu[:4], mean, 0, 0.05)
    _close(post.result.cov[:4, :4], cov, 0, 0.02)

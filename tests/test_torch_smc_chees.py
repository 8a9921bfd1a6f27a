"""ChEES-adaptive tempered SMC (``inference/smc_chees.py``) against
``genjax_tpu`` and the exact Gaussian answers of
``tests/inference/test_smc_chees.py``.

Deterministic to 1e-5 against the reference: the conditional-ESS bisection
that places the rungs (``smc_chees.py:121-140``) on the same weights and
likelihoods, read off the reference's ladder with the particles held still
(no rejuvenation, no resampling), where the likelihoods alone set every
rung. In law, at the reference test's tolerances: on a d = 4 Gaussian the
ladder reaches beta = 1, the log marginal is within 0.05 of the closed form
and the weighted posterior moments within 0.08, the acceptance on the
active rungs in (0.3, 1); on the conjugate model the column bridge's log
marginal is within 0.05 of exact and 0.08 of the fixed-ladder
``tempered_smc``, its posterior moments within 0.08; a sharper likelihood
takes more rungs.
"""

import math

import jax
import jax.numpy as jnp
import jax.scipy.stats as jss
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.inference.smc_chees import chees_tempered_smc as ref_chees_tempered_smc
from genjax_tpu_torch.inference import chees_tempered_smc, column_tempered_chees, geometric_ladder, tempered_smc
from genjax_tpu_torch.inference.tempered import _choose_delta
from torch_threads import _one_thread  # noqa: F401

C = -0.5 * math.log(2 * math.pi)


def _gaussian_problem(d, y, sigma):
    """Prior N(0, I_d); per-dimension likelihood N(y; q_i, sigma)."""

    def log_prior_cols(q):
        return torch.sum(-0.5 * q**2 + C, dim=0)

    def log_lik_cols(q):
        return torch.sum(-0.5 * ((y - q) / sigma) ** 2 - math.log(sigma) + C, dim=0)

    s2 = 1.0 + sigma**2
    logz = d * (-0.5 * y * y / s2 - 0.5 * math.log(s2) + C)
    return log_prior_cols, log_lik_cols, logz, y / s2, sigma**2 / s2


@pytest.mark.parametrize("cess_target", [0.5, 0.9])
def test_cess_bisection_matches_reference(cess_target):
    n = 256
    lik = (np.random.default_rng(0).normal(size=n) * 3.0 - 2.0).astype(np.float32)
    fixed = lambda lk: (lambda q: lk + 0.0 * q[0])  # noqa: E731  the likelihoods, whatever q
    prior = lambda xp: (lambda q: xp.sum(0.0 * q, axis=0))  # noqa: E731
    ref = ref_chees_tempered_smc(
        jax.random.key(0), prior(jnp), fixed(jnp.asarray(lik)), jnp.zeros((2, n)), cess_target=cess_target,
        max_rungs=6, n_rejuvenation=0, ess_threshold=0.0,
    )
    want = np.asarray(ref.beta_history)
    lik_t = torch.from_numpy(lik)
    log_w, beta, got = torch.zeros(n), torch.zeros(()), []
    for _ in range(6):
        delta = _choose_delta(log_w, lik_t, beta, cess_target, 30)
        beta = torch.clamp(beta + delta, max=1.0)
        log_w = log_w + delta * lik_t
        got.append(float(beta))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    port = chees_tempered_smc(0, prior(torch), fixed(lik_t), torch.zeros(2, n), cess_target=cess_target,
                              max_rungs=6, n_rejuvenation=0, ess_threshold=0.0)
    np.testing.assert_allclose(port.beta_history.numpy(), want, rtol=1e-5, atol=1e-6)
    assert int(port.n_rungs) == int(ref.n_rungs)


def test_evidence_and_moments_match_exact():
    lp, ll, logz, post_mean, post_var = _gaussian_problem(4, 1.5, 0.5)
    q0 = torch.randn(4, 4096, generator=torch.Generator().manual_seed(1))
    res = chees_tempered_smc(0, lp, ll, q0, n_rejuvenation=3)
    assert float(res.final_beta) == pytest.approx(1.0, abs=1e-6)
    assert 1 <= int(res.n_rungs) <= 64
    assert float(res.log_marginal) == pytest.approx(logz, abs=0.05)
    w = torch.softmax(res.log_weights, 0)
    mean = torch.sum(w * res.particles, dim=1)
    var = torch.sum(w * (res.particles - mean[:, None]) ** 2, dim=1)
    assert torch.allclose(mean, torch.full((4,), post_mean), atol=0.08), mean
    assert torch.allclose(var, torch.full((4,), post_var), atol=0.08), var
    k = int(res.n_rungs)
    assert 0.3 < float(res.accept_history[:k].mean()) < 1.0
    # the idle rows of the padded histories, as the reference's
    assert tuple(res.beta_history.shape) == (64,)
    assert torch.all(res.beta_history[k:] == res.final_beta)
    for h in (res.ess_history, res.accept_history, res.eps_history, res.trajectory_history, res.leapfrog_history):
        assert torch.all(h[k:] == 0.0) and torch.all(h[:k] > 0.0)


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


OBS = g.C["y"].set(1.5)
EXACT = float(jss.norm.logpdf(1.5, 0.0, math.sqrt(1.25)))


def test_agrees_with_fixed_ladder_tempered_smc():
    fixed = tempered_smc(0, conjugate, OBS, (), n_particles=4096, betas=geometric_ladder(10),
                         rejuvenation=g.S["mu"], n_rejuvenation=2, device="cpu")
    res, _packer = column_tempered_chees(conjugate, OBS, (), ["mu"], 7, 4096, device="cpu")
    assert float(res.log_marginal) == pytest.approx(EXACT, abs=0.05)
    assert float(res.log_marginal) == pytest.approx(float(fixed.log_marginal), abs=0.08)


def test_column_bridge_posterior_moments():
    res, packer = column_tempered_chees(conjugate, OBS, (), ["mu"], 3, 4096, device="cpu")
    assert packer.dim == 1 and tuple(res.particles.shape) == (8, 4096)
    w = torch.softmax(res.log_weights, 0)
    mu = res.particles[0]
    mean = float(torch.sum(w * mu))
    assert mean == pytest.approx(1.2, abs=0.08)
    assert float(torch.sum(w * (mu - mean) ** 2)) == pytest.approx(0.2, abs=0.08)


def test_cess_target_validated():
    lp, ll, *_ = _gaussian_problem(2, 1.0, 1.0)
    with pytest.raises(ValueError, match="cess_target"):
        chees_tempered_smc(0, lp, ll, torch.zeros(2, 16), cess_target=1.5)


def test_harder_target_uses_more_rungs():
    q0 = torch.randn(2, 1024, generator=torch.Generator().manual_seed(2))
    lp_easy, ll_easy, *_ = _gaussian_problem(2, 0.5, 2.0)
    lp_hard, ll_hard, *_ = _gaussian_problem(2, 3.0, 0.1)
    easy = chees_tempered_smc(0, lp_easy, ll_easy, q0)
    hard = chees_tempered_smc(0, lp_hard, ll_hard, q0)
    assert int(hard.n_rungs) > int(easy.n_rungs)
    assert float(easy.final_beta) == pytest.approx(1.0, abs=1e-6)
    assert float(hard.final_beta) == pytest.approx(1.0, abs=1e-6)


def test_devices():
    lp, ll, *_ = _gaussian_problem(2, 1.0, 1.0)
    res = chees_tempered_smc(0, lp, ll, torch.zeros(2, 64, dtype=torch.float64), max_rungs=2)
    assert res.particles.device.type == "cpu" and res.particles.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            column_tempered_chees(conjugate, OBS, (), ["mu"], 0, 16)

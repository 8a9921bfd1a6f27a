"""Nested sampling (``inference/nested.py``) against ``genjax_tpu`` and the
closed-form evidences of ``tests/inference/test_nested.py``.

Deterministic to 1e-5 against the reference: the evidence quadrature and
the information, fed the reference's own dead and live likelihoods. The
runs are one batch: a step of the constrained walk calls the densities once
whatever ``n_runs`` is. In law, at the reference test's tolerances: the
Gaussian evidence within 0.15 over 16 runs and the between-run spread
within 5 times the classic error estimate; dead likelihoods non-decreasing
and the final live points above the last dead one; positive information
and a walk acceptance in (0.05, 0.9); the bimodal evidence within 0.15 with
both modes alive; through the column bridge, the conjugate model's
evidence within 0.2, the posterior mean within 0.1 and variance within
0.06, and a two-latent model within 0.25 of ``tempered_smc``. The bimodal
and column cases run at fewer live points and walk steps than the
reference's (which marks the column cases slow), the tolerances unchanged.
"""

import math

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.inference.nested import nested_sampling as ref_nested_sampling
from genjax_tpu_torch.inference import column_nested_sampling, geometric_ladder, nested_sampling, tempered_smc
from genjax_tpu_torch.inference.nested import NestedSamplingResult, _evidence
from torch_threads import _one_thread  # noqa: F401


def _log_normal(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2 - math.log(sigma) - 0.5 * math.log(2 * math.pi)


def _gaussian_problem(d=2, sigma=0.5, calls=None):
    y = torch.tensor(np.linspace(0.4, 1.0, d), dtype=torch.float32)

    def log_lik(q):
        if calls is not None:
            calls.append(q.shape[1])
        return torch.sum(_log_normal(q, y[:, None], sigma), dim=0)

    exact = float(sum(_log_normal(float(v), 0.0, math.sqrt(1.0 + sigma**2)) for v in y))
    return (lambda gen, n: torch.randn((d, n), generator=gen)), (lambda q: torch.sum(_log_normal(q, 0.0, 1.0), 0)), \
        log_lik, exact


def test_evidence_quadrature_matches_reference():
    d, sigma, n_live = 2, 0.5, 32
    y = jnp.asarray(np.linspace(0.4, 1.0, d), jnp.float32)
    res = jax.jit(lambda k: ref_nested_sampling(
        lambda kk, n: jr.normal(kk, (d, n)),
        lambda q: jnp.sum(-0.5 * q**2, axis=0),
        lambda q: jnp.sum(-0.5 * ((q - y[:, None]) / sigma) ** 2, axis=0),
        k, n_live=n_live, n_iter=120, n_mcmc=5, n_runs=3,
    ))(jr.key(0))
    log_z, h, dead_log_w = _evidence(torch.tensor(np.asarray(res.dead_log_lik)),
                                     torch.tensor(np.asarray(res.live_log_lik)), n_live)
    for got, want in ((log_z, res.log_z), (h, res.h), (dead_log_w, res.dead_log_weight)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_runs_are_one_batch():
    counts = {}
    for n_runs in (4, 16):
        calls = []
        sample_prior, log_prior, log_lik, _ = _gaussian_problem(calls=calls)
        nested_sampling(sample_prior, log_prior, log_lik, 0, n_live=16, n_iter=20, n_mcmc=3, n_runs=n_runs,
                        device="cpu")
        counts[n_runs] = calls
    assert len(counts[4]) == len(counts[16]) == 1 + 20 * 3
    assert counts[16][1:] == [16] * 60 and counts[16][0] == 16 * 16


def test_gaussian_evidence():
    sample_prior, log_prior, log_lik, exact = _gaussian_problem()
    res = nested_sampling(sample_prior, log_prior, log_lik, 0, n_live=200, n_iter=1600, n_mcmc=20, n_runs=16,
                          device="cpu")
    assert isinstance(res, NestedSamplingResult)
    assert abs(float(res.log_z_mean) - exact) < 0.15, (float(res.log_z_mean), exact, float(res.log_z_std))
    assert float(res.log_z_std) < 5 * max(float(res.error_estimate()), 0.02)
    assert tuple(res.dead.shape) == (16, 1600, 2) and tuple(res.live.shape) == (16, 2, 200)


def test_dead_likelihoods_nondecreasing():
    sample_prior, log_prior, log_lik, _ = _gaussian_problem()
    res = nested_sampling(sample_prior, log_prior, log_lik, 1, n_live=64, n_iter=300, n_mcmc=10, n_runs=4,
                          device="cpu")
    assert bool(torch.all(torch.diff(res.dead_log_lik, dim=1) >= -1e-5))
    assert bool(torch.all(res.live_log_lik >= res.dead_log_lik[:, -1:] - 1e-5))


def test_information_and_acceptance_sane():
    sample_prior, log_prior, log_lik, _ = _gaussian_problem()
    res = nested_sampling(sample_prior, log_prior, log_lik, 2, n_live=128, n_iter=900, n_mcmc=15, n_runs=8,
                          device="cpu")
    assert bool(torch.all(torch.isfinite(res.h))) and bool(torch.all(res.h > 0.0))
    assert 0.05 < float(res.accept_rate.mean()) < 0.9


def test_bimodal_evidence():
    prior_sigma, s, a = 3.0, 0.3, 2.0

    def log_lik(q):
        return torch.logaddexp(_log_normal(q[0], -a, s), _log_normal(q[0], a, s)) - math.log(2.0)

    marg = math.sqrt(prior_sigma**2 + s**2)
    exact = float(np.logaddexp(_log_normal(-a, 0.0, marg), _log_normal(a, 0.0, marg)) - math.log(2.0))
    res = nested_sampling(lambda gen, n: prior_sigma * torch.randn((1, n), generator=gen),
                          lambda q: _log_normal(q[0], 0.0, prior_sigma), log_lik, 3,
                          n_live=100, n_iter=900, n_mcmc=20, n_runs=16, device="cpu")
    assert abs(float(res.log_z_mean) - exact) < 0.15
    live = res.live.reshape(-1)
    assert float((live < 0).float().mean()) > 0.15 and float((live > 0).float().mean()) > 0.15


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


def test_column_bridge_conjugate_evidence():
    res, packer = column_nested_sampling(conjugate, g.C["y"].set(1.2), (), ["mu"], 4, n_live=48, n_iter=300,
                                         n_mcmc=5, n_runs=8, device="cpu")
    exact = _log_normal(1.2, 0.0, math.sqrt(1.25))
    assert abs(float(res.log_z_mean) - exact) < 0.2, (float(res.log_z_mean), exact)
    assert packer.dim == 1
    assert abs(float(res.posterior_mean()[0]) - 1.2 / 1.25) < 0.1
    draws = res.resample_posterior(torch.Generator().manual_seed(9), 2000)
    assert abs(float(torch.var(draws[:, 0], correction=0)) - 0.25 / 1.25) < 0.06


def test_column_bridge_agrees_with_tempered_smc():
    @g.gen
    def model():
        loc = g.normal(0.0, 1.0) @ "loc"
        scale = g.log_normal(0.0, 0.3) @ "scale"
        _ = g.normal(loc, scale) @ "y"

    obs = g.C["y"].set(0.8)
    res, _ = column_nested_sampling(model, obs, (), ["loc", "scale"], 5, n_live=48, n_iter=300, n_mcmc=5,
                                    n_runs=8, device="cpu")
    sm = tempered_smc(6, model, obs, (), n_particles=4096, betas=geometric_ladder(30), device="cpu")
    assert abs(float(res.log_z_mean) - float(sm.log_marginal)) < 0.25


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    sample_prior, log_prior, log_lik, _ = _gaussian_problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nested_sampling(sample_prior, log_prior, log_lik, 0, n_live=8, n_iter=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column_nested_sampling(conjugate, g.C["y"].set(1.2), (), ["mu"], 0, n_live=8, n_iter=2)

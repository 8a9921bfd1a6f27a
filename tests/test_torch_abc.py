"""ABC rejection and adaptive ABC-SMC (``inference/abc.py``) against
``genjax_tpu`` and the closed forms its tests use.

Deterministic to 1e-5 against the reference: ``column_weighted_moments``.
Resampling under the indicator weights that kill the particles outside the
tolerance keeps only live particles. In law, at the reference test's
tolerances (``tests/inference/test_abc.py``): the rejection posterior's
mean and variance within 0.02 of the quadrature of the closed-form ABC
posterior and its acceptance within 0.01 of the marginal hit probability
(at the test's 400,000 simulations); ABC-SMC's mean within 0.06 of the
quadrature at its final tolerance and its variance within 20%, and within
0.1 / 20% of the conjugate posterior; a non-increasing tolerance ladder;
moves that accept (> 0.05) without collapsing the population.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import genjax_tpu_torch as g
from genjax_tpu.inference.abc import column_weighted_moments as ref_moments
from genjax_tpu_torch.inference import abc_rejection, abc_smc, column_weighted_moments
from genjax_tpu_torch.parallel import resample_particles
from torch_threads import _one_thread  # noqa: F401

T0, S, Y_OBS = 1.0, 0.7, 1.3


@g.gen
def gauss_model():
    theta = g.normal(0.0, T0) @ "theta"
    return g.normal(theta, S) @ "y"


def distance(tr):
    return torch.abs(tr.get_choices()["y"] - Y_OBS)


def exact_abc_moments(eps, grid_n=200_001, lim=6.0):
    """Quadrature of p_eps(theta | y) ∝ N(theta; 0, t0²) [Φ((y+eps-theta)/s)
    - Φ((y-eps-theta)/s)]."""
    th = np.linspace(-lim, lim, grid_n)
    w = norm.pdf(th, 0.0, T0) * (norm.cdf((Y_OBS + eps - th) / S) - norm.cdf((Y_OBS - eps - th) / S))
    w = w / np.trapezoid(w, th)
    mean = np.trapezoid(th * w, th)
    return float(mean), float(np.trapezoid((th - mean) ** 2 * w, th))


def conjugate_posterior():
    var = 1.0 / (1.0 / T0**2 + 1.0 / S**2)
    return var * Y_OBS / S**2, var


def test_column_weighted_moments_match_reference():
    params = np.random.default_rng(0).normal(size=(8, 500)).astype(np.float32)
    mean, var = column_weighted_moments(torch.from_numpy(params), 3)
    rmean, rvar = ref_moments(jnp.asarray(params), 3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(rvar), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["systematic", "stratified", "multinomial", "residual"])
def test_indicator_weights_resample_to_the_live_particle(method):
    log_w = torch.full((64,), float("-inf"))
    log_w[37] = 0.0
    q = torch.arange(64.0)[:, None] * torch.ones(1, 3)
    out_q, out_d = resample_particles(torch.Generator().manual_seed(1), (q, torch.arange(64.0)), log_w, 64, method)
    assert torch.equal(out_d, torch.full((64,), 37.0)) and torch.equal(out_q, torch.full((64, 3), 37.0))


def test_rejection_matches_quadrature():
    eps = 0.5
    res = abc_rejection(0, gauss_model, (), distance, n_samples=400_000, tolerance=eps, device="cpu")
    w = res.choices.flag.to(torch.float64)
    th = res.choices.value["theta"].to(torch.float64)
    mean = float((w * th).sum() / w.sum())
    var = float((w * (th - mean) ** 2).sum() / w.sum())
    exact_mean, exact_var = exact_abc_moments(eps)
    assert mean == pytest.approx(exact_mean, abs=0.02)
    assert var == pytest.approx(exact_var, abs=0.02)
    s_marg = np.sqrt(T0**2 + S**2)
    p_hit = norm.cdf((Y_OBS + eps) / s_marg) - norm.cdf((Y_OBS - eps) / s_marg)
    assert float(res.accept_rate) == pytest.approx(p_hit, abs=0.01)


def test_rejection_fixed_shapes_and_mask_idiom():
    res = abc_rejection(0, gauss_model, (), distance, n_samples=1024, tolerance=0.3, device="cpu")
    assert tuple(res.distances.shape) == (1024,) and tuple(res.choices.flag.shape) == (1024,)
    assert tuple(res.choices.value["theta"].shape) == (1024,)
    assert torch.equal(res.choices.flag, res.distances <= 0.3)


def test_smc_converges_to_conjugate_posterior():
    res, packer = abc_smc(0, gauss_model, (), distance, ["theta"], n_particles=4096, n_generations=10,
                          quantile=0.5, mh_moves=2, device="cpu")
    mean, var = column_weighted_moments(res.params, packer.dim)
    eps = float(res.tolerance)
    assert eps < 0.3, eps
    exact_mean, exact_var = exact_abc_moments(eps)
    assert float(mean[0]) == pytest.approx(exact_mean, abs=0.06)
    assert float(var[0]) == pytest.approx(exact_var, rel=0.2)
    cmean, cvar = conjugate_posterior()
    assert float(mean[0]) == pytest.approx(cmean, abs=0.1)
    assert float(var[0]) == pytest.approx(cvar, rel=0.2)


def test_smc_tolerance_ladder_monotone():
    res, _ = abc_smc(1, gauss_model, (), distance, ["theta"], n_particles=512, n_generations=6, device="cpu")
    ladder = res.tolerance_history
    assert bool(torch.all(ladder[1:] <= ladder[:-1] + 1e-7))
    assert bool(torch.all(res.distances <= res.tolerance))
    assert tuple(res.move_accept_history.shape) == (6,)


def test_smc_moves_accept_and_particles_move():
    res, _ = abc_smc(2, gauss_model, (), distance, ["theta"], n_particles=1024, n_generations=5, mh_moves=3,
                     device="cpu")
    assert float(res.move_accept_history.mean()) > 0.05
    assert float(torch.var(res.params[0])) > 1e-4


def test_smc_packer_reuse_and_determinism():
    r1, packer = abc_smc(3, gauss_model, (), distance, ["theta"], n_particles=256, n_generations=3, device="cpu")
    r2, _ = abc_smc(3, gauss_model, (), distance, ["theta"], n_particles=256, n_generations=3, packer=packer,
                    device="cpu")
    assert torch.equal(r1.params, r2.params) and float(r1.tolerance) == float(r2.tolerance)


def test_smc_multidim_parameters():
    @g.gen
    def loc_scale():
        mu = g.normal(0.0, 1.0) @ "mu"
        log_s = g.normal(0.0, 0.3) @ "log_s"
        return g.normal(mu, torch.exp(log_s)) @ "y"

    res, packer = abc_smc(5, loc_scale, (), lambda tr: torch.abs(tr.get_choices()["y"] - 0.8), ["mu", "log_s"],
                          n_particles=2048, n_generations=8, device="cpu")
    assert packer.dim == 2 and packer.padded_dim == 8
    mean, var = column_weighted_moments(res.params, 2)
    assert 0.1 < float(mean[0]) < 0.9
    assert bool(torch.all(torch.isfinite(var)))
    # the padding rows carry no parameter and never move
    assert torch.equal(res.params[2:], torch.zeros_like(res.params[2:]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        abc_rejection(0, gauss_model, (), distance, n_samples=8, tolerance=0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        abc_smc(0, gauss_model, (), distance, ["theta"], n_particles=8, n_generations=1)

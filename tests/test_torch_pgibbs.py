"""Particle Gibbs and PMMH (``inference/pgibbs.py``) against
``genjax_tpu`` and the Kalman closed forms its tests use.

Deterministic parts to 1e-5: a conditional sweep with one particle (slot
``K-1`` is the retained path at every step, so its weights are given) has
the reference's log marginal and the closed form ``sum_t log p(y_t |
z_t^ret)``, and returns the retained path. Random parts in law, at the
reference test's tolerances (``tests/inference/test_pgibbs.py``): the
unconditional sweep's logmeanexp of log marginals within 0.15 of the
Kalman log marginal; the particle Gibbs chain's smoothed means within 0.25
of the RTS smoother's and its variances within a ratio of 0.5-1.7, with and
without ancestor sampling; exact-marginal PMMH against the quadrature
posterior (mean within 0.3 SD, SD within 35%).
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.pgibbs import csmc_sweep as ref_csmc_sweep
from genjax_tpu.models import linear_gaussian_ssm as ref_linear_gaussian_ssm
from genjax_tpu_torch.inference.pgibbs import csmc_sweep, particle_gibbs, pmmh
from genjax_tpu_torch.models import linear_gaussian_ssm
from torch_threads import _one_thread  # noqa: F401


def kalman_smoother(ys, q, r):
    """RTS smoother of z_t ~ N(z_{t-1}, q), y_t ~ N(z_t, r), z_0 ~ N(0, q):
    (smoothed means, smoothed variances, log marginal)."""
    T = len(ys)
    fm, fv, pm, pv = np.zeros(T), np.zeros(T), np.zeros(T), np.zeros(T)
    mean, var, log_z = 0.0, q, 0.0
    for t, y in enumerate(ys):
        pm[t], pv[t] = mean, var
        s = var + r
        log_z += -0.5 * (np.log(2 * np.pi * s) + (y - mean) ** 2 / s)
        gain = var / s
        mean, var = mean + gain * (y - mean), var * (1 - gain)
        fm[t], fv[t] = mean, var
        var = var + q
    sm, sv = fm.copy(), fv.copy()
    for t in range(T - 2, -1, -1):
        c = fv[t] / pv[t + 1]
        sm[t] = fm[t] + c * (sm[t + 1] - pm[t + 1])
        sv[t] = fv[t] + c * c * (sv[t + 1] - pv[t + 1])
    return sm, sv, log_z


T = 8
_rng = np.random.default_rng(0)
YS = (np.cumsum(_rng.normal(size=T)) + 0.5 * _rng.normal(size=T)).astype(np.float32)
SM, SV, LOG_Z = kalman_smoother(YS, 1.0, 0.25)
KERNEL, _ = linear_gaussian_ssm(trans_scale=1.0, obs_scale=0.5)
OBS = g.C[:, "y"].set(torch.from_numpy(YS))


def test_one_particle_conditional_sweep_is_deterministic_and_matches_reference():
    ret_np = (YS + 0.3).astype(np.float32)
    out = csmc_sweep(torch.Generator().manual_seed(0), KERNEL, 0.0, torch.zeros(T), OBS,
                     g.C["z"].set(torch.from_numpy(ret_np)), latent_selection=g.S["z"], n_particles=1)
    r_kernel, _ = ref_linear_gaussian_ssm(trans_scale=1.0, obs_scale=0.5)
    r_out = ref_csmc_sweep(jr.key(0), r_kernel, 0.0, jnp.zeros(T), gj.C[:, "y"].set(jnp.asarray(YS)),
                           gj.C["z"].set(jnp.asarray(ret_np)), latent_selection=gj.S["z"], n_particles=1)
    np.testing.assert_allclose(out.log_marginal.numpy(), np.asarray(r_out.log_marginal), rtol=1e-5, atol=1e-5)
    closed = np.sum(-0.5 * np.log(2 * np.pi * 0.25) - (YS.astype(np.float64) - ret_np) ** 2 / (2 * 0.25))
    np.testing.assert_allclose(out.log_marginal.numpy(), closed, rtol=1e-5, atol=1e-5)
    assert torch.equal(out.retained["z"], torch.from_numpy(ret_np))
    np.testing.assert_allclose(out.final_carry.numpy(), ret_np[-1], rtol=1e-6)


def test_unconditional_sweep_log_marginal_in_law():
    gen = torch.Generator().manual_seed(1)
    lms = torch.stack([csmc_sweep(gen, KERNEL, 0.0, torch.zeros(T), OBS, None, latent_selection=g.S["z"],
                                  n_particles=256).log_marginal for _ in range(16)])
    est = float(torch.logsumexp(lms, dim=0) - np.log(16))
    assert abs(est - LOG_Z) < 0.15, (est, LOG_Z)


def test_sweep_structure_feeds_back_and_pins_the_retained_slot():
    gen = torch.Generator().manual_seed(3)
    first = csmc_sweep(gen, KERNEL, 0.0, torch.zeros(T), OBS, None, latent_selection=g.S["z"], n_particles=8)
    second = csmc_sweep(gen, KERNEL, 0.0, torch.zeros(T), OBS, first.retained, latent_selection=g.S["z"],
                        n_particles=8)
    assert tuple(second.retained["z"].shape) == (T,)
    ret = g.C["z"].set(torch.from_numpy(YS))
    out = csmc_sweep(gen, KERNEL, 0.0, torch.zeros(T), OBS, ret, latent_selection=g.S["z"], n_particles=2,
                     ancestor_sampling=False)
    assert torch.utils._pytree.tree_structure(out.retained) == torch.utils._pytree.tree_structure(ret)
    with pytest.raises(ValueError, match="n_steps"):
        csmc_sweep(gen, KERNEL, 0.0, None, OBS, None, latent_selection=g.S["z"], n_particles=2)


@pytest.mark.parametrize("ancestor_sampling", [True, False])
def test_particle_gibbs_smoothing_posterior_in_law(ancestor_sampling):
    out = particle_gibbs(5, KERNEL, 0.0, torch.zeros(T), OBS, latent_selection=g.S["z"], n_particles=32,
                         n_sweeps=260, ancestor_sampling=ancestor_sampling, device="cpu")
    zs = out.trajectories["z"]
    assert tuple(zs.shape) == (260, T) and tuple(out.log_marginals.shape) == (260,)
    draws = zs[60:].double().numpy()
    np.testing.assert_allclose(draws.mean(0), SM, atol=0.25)
    ratio = draws.var(0) / SV
    assert np.all(ratio > 0.5) and np.all(ratio < 1.7), ratio


def _drift_logz(ys, m):
    q, r = 1.0, 0.25
    mean, var, lz = m, q, 0.0
    for y in ys:
        s = var + r
        lz += -0.5 * (np.log(2 * np.pi * s) + (y - mean) ** 2 / s)
        gain = var / s
        mean, var = mean + gain * (y - mean) + m, var * (1 - gain) + q
    return lz


def test_exact_marginal_pmmh_in_law_against_quadrature():
    rng = np.random.default_rng(7)
    ys = (np.cumsum(0.6 + rng.normal(size=10)) + 0.5 * rng.normal(size=10)).astype(np.float32)
    grid = np.linspace(-2.0, 3.0, 2001)
    logp = np.array([_drift_logz(ys, m) - 0.5 * m**2 for m in grid])
    w = np.exp(logp - logp.max())
    w /= w.sum()
    post_mean = float((grid * w).sum())
    post_std = float(np.sqrt(((grid - post_mean) ** 2 * w).sum()))
    yt = torch.from_numpy(ys)

    def exact_lz(_gen, m):
        mean, var, lz = m, torch.tensor(1.0), torch.tensor(0.0)
        for y in yt:
            s = var + 0.25
            lz = lz - 0.5 * (torch.log(2 * torch.pi * s) + (y - mean) ** 2 / s)
            gain = var / s
            mean, var = mean + gain * (y - mean) + m, var * (1 - gain) + 1.0
        return lz

    out = pmmh(8, 0.0, lambda m: -0.5 * m**2, exact_lz, n_steps=3000, step_scales=0.5, device="cpu")
    chain = out.params[500:].double().numpy()
    assert 0.15 < float(out.accept_rate) < 1.0
    assert abs(chain.mean() - post_mean) < 3 * post_std / 10
    assert abs(chain.std() - post_std) < 0.35 * post_std
    assert tuple(out.log_priors.shape) == (3000,) and torch.isfinite(out.log_zs).all()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        particle_gibbs(0, KERNEL, 0.0, torch.zeros(T), OBS, latent_selection=g.S["z"], n_particles=4, n_sweeps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmmh(0, 0.0, lambda m: -0.5 * m**2, lambda _g, m: m * 0.0, n_steps=2, step_scales=0.5)

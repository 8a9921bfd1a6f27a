"""The port's warmup adaptation against ``genjax_tpu.kernels.adaptation``.

The estimators equal the reference's to 1e-6 on numpy-seeded inputs, and
``windowed_warmup`` driven by the same deterministic toy sweep (written once
in jnp and once in torch) returns the reference's positions, step size,
inverse mass and accept history to 1e-6. The HMC warmup ``warmup_column``
agrees with the reference's in law.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genjax_tpu.kernels import adaptation as jax_adaptation
from genjax_tpu_torch.kernels import adaptation, hmc

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps, acc", [(0.1, 0.8), (0.5, 0.3), (0.02, 0.99), (1.7, 0.0)])
def test_multiplicative_nudge_matches_reference(eps, acc):
    for rate, target in [(1.5, 0.8), (0.7, 0.65)]:
        ref = jax_adaptation.multiplicative_nudge(eps, acc, target_accept=target, rate=rate)
        got = adaptation.multiplicative_nudge(eps, acc, target_accept=target, rate=rate)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("chain_axis", [1, 0])
def test_cross_chain_inv_mass_matches_reference(chain_axis):
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(16, 256)) * np.geomspace(0.1, 10.0, 16)[:, None]).astype(np.float32)
    q[12:] = 3.0  # constant rows: floored variance
    if chain_axis == 0:
        q = q.T.copy()
    ref = jax_adaptation.cross_chain_inv_mass(jnp.asarray(q), chain_axis=chain_axis)
    got = adaptation.cross_chain_inv_mass(torch.from_numpy(q), chain_axis=chain_axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    assert float(got.min()) == pytest.approx(1e-6)


def test_dual_averaging_matches_reference():
    accs = np.random.default_rng(1).uniform(0.2, 1.0, size=30).astype(np.float32)
    jstate = jax_adaptation.StepSizeAdaptState.init(0.3)
    tstate = adaptation.StepSizeAdaptState.init(0.3)
    for a in accs:
        jstate = jax_adaptation.dual_averaging_update(jstate, float(a), target_accept=0.75)
        tstate = adaptation.dual_averaging_update(tstate, float(a), target_accept=0.75)
        for field in ("log_eps", "log_eps_bar", "h_bar", "mu"):
            np.testing.assert_allclose(
                getattr(tstate, field).numpy(), np.asarray(getattr(jstate, field)), **TOL
            )
        assert int(tstate.step) == int(jstate.step)


def _toy_sweep_jax(q, idx, eps, inv_mass):
    q = 0.8 * q + 0.1 * eps * inv_mass[:, None] * jnp.sin(q + idx)
    return q, 0.5 + 0.4 * jnp.tanh(jnp.mean(q) + eps)


def _toy_sweep_torch(q, idx, eps, inv_mass):
    q = 0.8 * q + 0.1 * eps * inv_mass[:, None] * torch.sin(q + idx)
    return q, 0.5 + 0.4 * torch.tanh(torch.mean(q) + eps)


@pytest.mark.parametrize("n_windows, eps0", [(6, 0.1), (10, 0.7)])
def test_windowed_warmup_matches_reference(n_windows, eps0):
    q0 = np.random.default_rng(2).normal(size=(8, 64)).astype(np.float32)
    jq, jeps, jim, jaccs = jax_adaptation.windowed_warmup(
        _toy_sweep_jax, jnp.asarray(q0), n_windows=n_windows, eps0=eps0
    )
    tq, teps, tim, taccs = adaptation.windowed_warmup(
        _toy_sweep_torch, torch.from_numpy(q0), n_windows=n_windows, eps0=eps0
    )
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(float(teps), float(jeps), **TOL)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), **TOL)
    np.testing.assert_allclose(taccs.numpy(), np.asarray(jaccs), **TOL)


def test_hmc_warmup_agrees_in_law_with_reference():
    """``warmup_column`` on an anisotropic Gaussian from the same positions:
    the adapted step sizes within 20% of each other, and each adapted
    inverse mass within 25% of the true variances."""
    from genjax_tpu.kernels.hmc import warmup_column as jax_warmup_column

    d, n = 8, 512
    var = np.geomspace(0.25, 4.0, d).astype(np.float32)
    q0 = np.random.default_rng(3).normal(size=(d, n)).astype(np.float32)
    jq, jeps, jim = jax_warmup_column(
        lambda q: -0.5 * jnp.sum(q * q / jnp.asarray(var)[:, None], axis=0), jnp.asarray(q0), 2
    )
    tq, teps, tim = hmc.warmup_column(
        lambda q: -0.5 * torch.sum(q * q / torch.from_numpy(var)[:, None], dim=0),
        torch.from_numpy(q0), 2,
    )
    assert hmc.pallas_hmc.last_backend == "torch"
    assert abs(teps - jeps) / jeps < 0.2, (teps, jeps)
    np.testing.assert_allclose(tim.numpy(), var, rtol=0.25)
    np.testing.assert_allclose(np.asarray(jim), var, rtol=0.25)
    assert tuple(tq.shape) == (d, n) and bool(torch.isfinite(tq).all())


def test_column_hmc_warmup_reaches_the_conjugate_posterior():
    """mu ~ N(0, 1), y ~ N(mu, 1), y = 2: the posterior is N(1, 1/2)."""
    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels import column_hmc

    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        _ = g.normal(mu, 1.0) @ "y"

    n = 512
    q, accept, _ = column_hmc(
        model, g.C["y"].set(2.0), (), ["mu"], n_chains=n, n_steps=50, eps=0.05, L=5, seed=2,
        warmup=True, device="cpu",
    )
    assert abs(float(q[0].mean()) - 1.0) < 4 * (0.5 / n) ** 0.5
    assert abs(float(q[0].var()) - 0.5) < 0.1
    assert 0.5 < float(accept) <= 1.0

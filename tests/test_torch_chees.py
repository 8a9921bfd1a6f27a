"""ChEES-HMC in the port (``genjax_tpu_torch/kernels/chees.py``) against
``genjax_tpu.kernels.chees`` and the closed forms of
``tests/kernels/test_chees.py``.

The port draws from a ``torch.Generator`` where the reference splits a key,
so chains are held in law: both packages run from the same numpy start
columns and each must meet the reference test's closed form, with the
reference test's tolerance stated beside each check. The Halton jitter,
which is deterministic, is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as rg
import genjax_tpu_torch as g
from genjax_tpu.kernels import chees_hmc as ref_chees_hmc
from genjax_tpu.kernels.adaptation import _halton2 as ref_halton2
from genjax_tpu_torch.core.device import chain_generator
from genjax_tpu_torch.kernels import chees_hmc, column_chees
from genjax_tpu_torch.kernels.adaptation import StepSizeAdaptState, _halton2
from torch_threads import _one_thread  # noqa: F401

KW = dict(rng_impl="threefry2x32")


def _q0(seed, shape, scale):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def test_halton2_matches_reference_bit_for_bit():
    ref = np.asarray(jax.vmap(ref_halton2)(jnp.arange(4096)))
    port = np.asarray([_halton2(i).item() for i in range(4096)], np.float32)
    assert port.dtype == ref.dtype
    assert np.array_equal(port.view(np.uint32), ref.view(np.uint32))


def test_anisotropic_gaussian_recovery():
    """Mirrors TestChEESKernel::test_anisotropic_gaussian_recovery: sds
    within 10% of the scales, the inverse mass within 25% of their squares,
    accept in (0.5, 0.9), for both packages from the same start."""
    scales = np.asarray([1.0, 10.0], np.float32)
    q0 = _q0(0, (2, 2048), 0.1)
    st = torch.from_numpy(scales)
    q, info = chees_hmc(lambda q: -0.5 * torch.sum((q / st[:, None]) ** 2, dim=0),
                        torch.from_numpy(q0), 1, n_warmup=400, n_steps=200, eps0=0.05)
    rq, rinfo = jax.jit(lambda q0: ref_chees_hmc(
        lambda q: -0.5 * jnp.sum((q / scales[:, None]) ** 2, axis=0), q0, 1,
        n_warmup=400, n_steps=200, eps0=0.05, **KW))(jnp.asarray(q0))
    for qq, im, acc in ((q.numpy(), info.inv_mass.numpy(), float(info.accept_rate)),
                        (np.asarray(rq), np.asarray(rinfo.inv_mass), float(rinfo.accept_rate))):
        np.testing.assert_allclose(qq.std(axis=1), scales, rtol=0.1)
        np.testing.assert_allclose(im, scales**2, rtol=0.25)
        assert 0.5 < acc < 0.9


def test_correlated_gaussian_grows_trajectory():
    """Mirrors test_correlated_gaussian_grows_trajectory: a 0.95-correlated
    Gaussian; covariance within 0.12 and the trajectory grown past 0.5 from
    t0 = 0.1."""
    cov = np.asarray([[1.0, 0.95], [0.95, 1.0]], np.float32)
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))
    q, info = chees_hmc(lambda q: -0.5 * torch.sum(q * (prec @ q), dim=0),
                        torch.from_numpy(_q0(1, (2, 2048), 0.1)), 2,
                        n_warmup=500, n_steps=300, eps0=0.05, t0=0.1)
    np.testing.assert_allclose(np.cov(q.numpy()), cov, atol=0.12)
    assert float(info.trajectory_length) > 0.5


def test_seed_takes_a_generator():
    """Mirrors test_seed_accepts_prng_key: sds within 0.15 of 1; the same
    stream gives the same chains, another stream other chains; positions
    stay on their device."""
    def ld(q):
        return -0.5 * torch.sum(q**2, dim=0)

    q0 = torch.from_numpy(_q0(4, (2, 512), 0.1))

    def run(seed):
        return chees_hmc(ld, q0, torch.Generator().manual_seed(seed), n_warmup=100, n_steps=50, eps0=0.1)

    (q, info), (q2, _), (q3, _) = run(11), run(11), run(12)
    np.testing.assert_allclose(q.std(dim=1).numpy(), 1.0, atol=0.15)
    assert torch.equal(q, q2) and not torch.equal(q, q3)
    assert q.device == q0.device and info.draws is None and info.eps.device == q0.device


def test_nan_trajectories_count_as_rejections():
    """Mirrors test_nan_trajectories_count_as_rejections: eps0 = 50
    diverges at once; eps stays finite, positions finite, accept > 0.3."""
    def ld(q):
        return -0.5 * torch.sum(q**2, dim=0) - 0.05 * torch.sum(q**4, dim=0)

    q, info = chees_hmc(ld, torch.from_numpy(_q0(2, (2, 256), 1.0)), 3,
                        n_warmup=200, n_steps=50, eps0=50.0)
    assert np.isfinite(float(info.eps))
    assert bool(torch.isfinite(q).all())
    assert float(info.accept_rate) > 0.3
    assert 0.0 <= float(info.divergence_rate) < 1.0


def test_a_nan_density_is_a_divergence_and_a_rejection():
    """The reference's branches on a NaN: alpha 0, the chain stays, the
    sweep counts a divergence, and the trajectory gradient stays finite."""
    def ld(q):
        lp = -0.5 * torch.sum(q**2, dim=0)
        return torch.where(q[0] > 0.5, torch.nan, lp)

    q0 = torch.from_numpy(_q0(5, (2, 256), 1.0))
    q, info = chees_hmc(ld, q0, 0, n_warmup=0, n_steps=10, eps0=0.3, t0=1.0)
    inside = q0[0] <= 0.5
    assert bool((q[0, inside] <= 0.5).all())  # no chain accepted a NaN density
    assert torch.equal(q[:, ~inside], q0[:, ~inside])  # a chain at a NaN never moves
    assert float(info.divergence_rate) > 0.0
    assert np.isfinite(float(info.trajectory_length))


def test_zero_warmup_keeps_the_callers_settings():
    q0 = torch.from_numpy(_q0(6, (3, 64), 1.0))
    _q, info = chees_hmc(lambda q: -0.5 * torch.sum(q**2, dim=0), q0, 0, n_warmup=0, n_steps=5,
                         eps0=0.123, t0=0.7, inv_mass=[1.0, 2.0, 3.0], collect=True)
    assert float(info.eps) == pytest.approx(0.123)
    assert float(info.trajectory_length) == pytest.approx(0.7)
    assert info.inv_mass.tolist() == [1.0, 2.0, 3.0]
    assert tuple(info.draws.shape) == (5, 3, 64)


def test_step_size_state_lives_on_the_chains_device():
    st = StepSizeAdaptState.init(torch.full((3,), 0.1), device="cpu")
    for leaf in (st.log_eps, st.log_eps_bar, st.h_bar, st.step, st.mu):
        assert leaf.device == torch.device("cpu")
    assert tuple(st.log_eps.shape) == (3,) and tuple(st.step.shape) == ()


def test_a_generator_elsewhere_raises():
    with pytest.raises(ValueError, match="chains' device"):
        chain_generator(torch.Generator(), torch.device("cuda"), "chees_hmc")


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


@rg.gen
def ref_conjugate():
    mu = rg.normal(0.0, 1.0) @ "mu"
    _ = rg.normal(mu, 0.5) @ "y"


def test_column_chees_conjugate_posterior_with_draws():
    """Mirrors TestColumnChEES::test_conjugate_posterior_with_draws: the
    posterior N(1.2, 1/5) within 0.05 in mean and sd, for both packages."""
    kw = dict(n_chains=1024, n_warmup=200, n_steps=100, eps=0.1, collect=True)
    q, info, packer = column_chees(conjugate, g.C["y"].set(1.5), (), ["mu"], device="cpu", **kw)
    _rq, rinfo, _rp = rg.kernels.column_chees(ref_conjugate, rg.C["y"].set(1.5), (), ["mu"], **kw, **KW)
    for mus in (info.draws[-50:, 0, :].numpy().ravel(), np.asarray(rinfo.draws[-50:, 0, :]).ravel()):
        assert np.mean(mus) == pytest.approx(1.2, abs=0.05)
        assert np.std(mus) == pytest.approx(1.0 / np.sqrt(5.0), abs=0.05)
    assert "mu" in packer.unpack(q[:, 0])


def test_column_chees_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column_chees(conjugate, g.C["y"].set(1.5), (), ["mu"], n_chains=8, n_warmup=1, n_steps=1)

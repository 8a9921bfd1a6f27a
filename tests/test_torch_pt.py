"""Parallel-tempering HMC in the port (``genjax_tpu_torch/kernels/pt.py``)
against ``genjax_tpu.kernels.pt`` and the closed forms of
``tests/kernels/test_pt.py``.

The ladder is deterministic and held to 1e-7. Chains draw from a
``torch.Generator`` where the reference splits a key, so they are held in
law against the reference test's closed forms, with its tolerances stated
beside each check. The reference marks its two bimodal cases slow; here they
run at the reference's sizes in the fast lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.kernels import geometric_ladder as ref_geometric_ladder
from genjax_tpu.kernels import pt_hmc as ref_pt_hmc
from genjax_tpu_torch.kernels import column_pt, geometric_ladder, pt_hmc
from torch_threads import _one_thread  # noqa: F401

KW = dict(rng_impl="threefry2x32")


def bimodal_ld(sep=3.0, scale=0.5):
    """0.5 N(-sep, scale^2) + 0.5 N(+sep, scale^2) per dimension."""

    def ld(q):
        a = -0.5 * ((q - sep) / scale) ** 2
        b = -0.5 * ((q + sep) / scale) ** 2
        return torch.sum(torch.logaddexp(a, b), dim=0)

    return ld


@pytest.mark.parametrize("beta_min", [0.05, 0.1])
@pytest.mark.parametrize("n_rungs", range(1, 9))
def test_geometric_ladder_matches_reference(n_rungs, beta_min):
    port = geometric_ladder(n_rungs, beta_min=beta_min).numpy()
    ref = np.asarray(ref_geometric_ladder(n_rungs, beta_min=beta_min))
    assert port.dtype == ref.dtype and port.shape == (n_rungs,)
    np.testing.assert_allclose(port, ref, rtol=1e-7, atol=0)


def test_geometric_ladder():
    """Mirrors TestPTKernel::test_geometric_ladder."""
    betas = geometric_ladder(5, beta_min=0.1)
    assert float(betas[0]) == pytest.approx(1.0)
    assert float(betas[-1]) == pytest.approx(0.1)
    ratios = (betas[1:] / betas[:-1]).numpy()
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)
    assert tuple(geometric_ladder(1).shape) == (1,)


def test_bimodal_mode_weights():
    """Mirrors TestPTKernel::test_bimodal_mode_weights: every chain starts in
    the negative mode. One rung (plain HMC) stays trapped (under 5% cross);
    the ladder weights the modes 50/50 within 0.08, with each mode's mean
    within 0.1 of 4 and sd within 0.1 of 0.5, every pair swapping over 10%."""
    ld = bimodal_ld(sep=4.0)
    q0 = torch.from_numpy((-4.0 + 0.1 * np.random.default_rng(0).normal(size=(1, 512))).astype(np.float32))
    q_hmc, _ = pt_hmc(ld, q0, 1, betas=[1.0], n_warmup=150, n_steps=150, eps0=0.1, L=8)
    assert float((q_hmc > 0).float().mean()) < 0.05
    _q, info = pt_hmc(ld, q0, 1, betas=geometric_ladder(6, beta_min=0.02), n_warmup=300,
                      n_steps=500, eps0=0.1, L=8, collect=True)
    draws = info.draws[250:].numpy()
    assert float(np.mean(draws > 0)) == pytest.approx(0.5, abs=0.08)
    pos = draws[draws > 0]
    assert np.mean(pos) == pytest.approx(4.0, abs=0.1)
    assert np.std(pos) == pytest.approx(0.5, abs=0.1)
    assert bool((info.swap_rate > 0.1).all())


def test_unimodal_exactness_and_per_rung_adaptation():
    """Mirrors test_unimodal_exactness_and_per_rung_adaptation: cold sds
    within 15%; the cold rung's mass within 35% of the variances, the hot
    rung wider; every rung's accept over 0.6. The reference, from the same
    start, meets the same limits."""
    scales = np.asarray([1.0, 5.0], np.float32)
    q0 = (0.1 * np.random.default_rng(2).normal(size=(2, 1024))).astype(np.float32)
    st = torch.from_numpy(scales)
    kw = dict(n_warmup=400, n_steps=200, eps0=0.05, L=8)
    q, info = pt_hmc(lambda q: -0.5 * torch.sum((q / st[:, None]) ** 2, dim=0), torch.from_numpy(q0), 3,
                     betas=geometric_ladder(4), **kw)
    rq, rinfo = jax.jit(lambda q0: ref_pt_hmc(
        lambda q: -0.5 * jnp.sum((q / scales[:, None]) ** 2, axis=0), q0, 3,
        betas=ref_geometric_ladder(4), **kw, **KW))(jnp.asarray(q0))
    for qq, im, acc in ((q.numpy(), info.inv_mass.numpy(), info.accept_rate.numpy()),
                        (np.asarray(rq), np.asarray(rinfo.inv_mass), np.asarray(rinfo.accept_rate))):
        np.testing.assert_allclose(qq.std(axis=1), scales, rtol=0.15)
        np.testing.assert_allclose(im[0], scales**2, rtol=0.35)
        assert im[-1, 1] > im[0, 1]
        assert np.all(acc > 0.6)
    assert tuple(info.eps.shape) == (4,) and tuple(info.swap_rate.shape) == (3,)


def test_per_rung_initial_positions():
    """Mirrors test_per_rung_initial_positions."""
    q0 = torch.stack([torch.full((1, 64), -3.0), torch.full((1, 64), 3.0)])
    q, _info = pt_hmc(bimodal_ld(), q0, 4, betas=[1.0, 0.05], n_warmup=50, n_steps=50, eps0=0.1, L=4)
    assert tuple(q.shape) == (1, 64) and q.device == q0.device
    assert bool(torch.isfinite(q).all())


def test_ladder_validation():
    """Mirrors test_ladder_validation."""
    ld = bimodal_ld()
    with pytest.raises(ValueError, match="1-D"):
        pt_hmc(ld, torch.zeros(1, 8), 0, betas=torch.ones(2, 2))
    with pytest.raises(ValueError, match="rung"):
        geometric_ladder(0)
    with pytest.raises(ValueError, match=r"\(D, N\) or \(R, D, N\)"):
        pt_hmc(ld, torch.zeros(2, 1, 8), 0, betas=[1.0])


def test_swap_rate_counts_attempts():
    """At equal temperatures every attempted swap is accepted: the rate per
    attempt is 1 exactly, twice the raw mean over sweeps (each pair is
    active every other sweep), as the reference reports it."""
    q0 = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32))
    _q, info = pt_hmc(lambda q: -0.5 * torch.sum(q**2, dim=0), q0, 0, betas=[1.0, 1.0, 1.0],
                      n_warmup=0, n_steps=6, eps0=0.2, L=2)
    assert info.swap_rate.tolist() == [1.0, 1.0]


def test_non_finite_proposals_are_rejections():
    """A non-finite proposal is a rejection: a density that is NaN past 1
    never lets a chain cross."""
    def ld(q):
        return torch.where(q[0] > 1.0, torch.nan, -0.5 * torch.sum(q**2, dim=0))

    q0 = torch.full((1, 128), -0.5)
    _q, info = pt_hmc(ld, q0, 5, betas=geometric_ladder(3), n_warmup=20, n_steps=20, eps0=0.5, L=4,
                      collect=True)
    assert bool((info.draws <= 1.0).all())
    assert bool(torch.isfinite(info.eps).all())


@g.gen
def bimodal():
    mu = g.normal(0.0, 10.0) @ "mu"
    _ = g.normal(mu * mu, 1.0) @ "y"


def test_bimodal_gen_model():
    """Mirrors TestColumnPT::test_bimodal_gen_model: mu ~ N(0, 10), y ~
    N(mu^2, 1), y = 4 puts equal mass near -2 and +2; the modes weighted
    50/50 within 0.1."""
    _q, info, _packer = column_pt(
        bimodal, g.C["y"].set(4.0), (), ["mu"], n_chains=256, n_rungs=5, n_warmup=200, n_steps=400,
        eps=0.05, L=8, seed=5, collect=True, device="cpu",
    )
    draws = info.draws[200:, 0, :].numpy()
    assert float(np.mean(draws > 0)) == pytest.approx(0.5, abs=0.1)


def test_column_pt_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        column_pt(bimodal, g.C["y"].set(4.0), (), ["mu"], n_chains=8, n_warmup=1, n_steps=1)

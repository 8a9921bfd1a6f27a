"""The column algorithms of the port's ``sample_posterior`` (``"chees"``,
``"pt"``, ``"dense_hmc"``, ``"dense_nuts"``) and ``sample_logdensity``,
against ``genjax_tpu.inference.sample`` and the closed forms of
``tests/inference/test_sample_posterior.py`` and
``tests/inference/test_sample_logdensity.py``.

With ``n_warmup=0`` the drivers are deterministic in their settings: both
packages return ``eps0`` and the identity metric, and results of the same
shapes and addresses on the same inputs. Draws come from a
``torch.Generator``, so they are held in law against the reference tests'
closed forms, with their tolerances stated beside each check. Left out: the
reference's ``mesh=`` cases (``test_sharded_chain_axis``,
``test_data_sharded_posterior_on_mesh``; sharding is ROADMAP item 15) and
``test_indexed_selection_raises``, which needs the ``scan`` combinator
(item 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as rg
import genjax_tpu_torch as g
from genjax_tpu.inference.sample import sample_posterior as ref_sample_posterior
from genjax_tpu_torch.inference import sample
from genjax_tpu_torch.inference.sample import sample_logdensity, sample_posterior
from genjax_tpu_torch.kernels import dense_mass
from torch_threads import _one_thread  # noqa: F401

COLUMN = ["chees", "pt", "dense_hmc", "dense_nuts"]


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


OBS = g.C["y"].set(2.0)


@g.gen
def two_sites():
    w = g.mv_normal_diag(torch.zeros(3), torch.ones(3)) @ "w"
    s = g.normal(0.0, 1.0) @ "s"
    _ = g.normal(w.sum() + s, 1.0) @ "y"


@rg.gen
def ref_two_sites():
    w = rg.mv_normal_diag(jnp.zeros(3), jnp.ones(3)) @ "w"
    s = rg.normal(0.0, 1.0) @ "s"
    _ = rg.normal(w.sum() + s, 1.0) @ "y"


@pytest.mark.parametrize("algorithm", COLUMN)
def test_zero_warmup_keeps_caller_settings_and_the_references_shapes(algorithm):
    """Mirrors test_zero_warmup_keeps_caller_settings and
    test_zero_warmup_identity_metric: ``eps`` is ``eps0`` and the metric the
    identity; positions, R-hat and ESS have the reference's shapes and
    addresses on the same model and selection."""
    kw = dict(n_chains=16, n_warmup=0, n_samples=6, thin=2, algorithm=algorithm, eps0=0.345, L=3,
              max_depth=3, n_rungs=2)
    res = sample_posterior(0, two_sites, g.C["y"].set(1.0), (), g.S["w"] | g.S["s"], device="cpu", **kw)
    want = ref_sample_posterior(jax.random.key(0), ref_two_sites, rg.C["y"].set(1.0), (), rg.S["w"] | rg.S["s"],
                                **kw)
    assert float(res.eps) == pytest.approx(0.345)
    np.testing.assert_array_equal(res.inv_mass.numpy(), np.ones(4, np.float32))
    np.testing.assert_array_equal(np.asarray(want.inv_mass), np.ones(4, np.float32))
    for addr in ("w", "s"):
        assert tuple(res[addr].shape) == tuple(want[addr].shape)
        assert tuple(res.rhat_of(addr).shape) == tuple(want.rhat_of(addr).shape)
        assert tuple(res.ess_of(addr).shape) == tuple(want.ess_of(addr).shape)
    for field in ("accept_rate", "divergence_rate", "eps"):
        assert tuple(torch.as_tensor(getattr(res, field)).shape) == tuple(np.shape(getattr(want, field)))


def _run(algorithm, **kw):
    return sample_posterior(314159, conjugate, OBS, (), g.S["mu"], algorithm=algorithm, device="cpu", **kw)


def test_chees_conjugate_posterior():
    """Mirrors TestChEESAlgorithm::test_conjugate_posterior: mean within
    0.05 of 1, sd within 0.05 of 1/sqrt(2), R-hat under 1.1, ESS over 500,
    divergences under 1%."""
    res = _run("chees", n_chains=512, n_warmup=200, n_samples=60, thin=2, eps0=0.1)
    draws = res["mu"][:, 20:]
    assert tuple(draws.shape) == (512, 40)
    assert float(draws.mean()) == pytest.approx(1.0, abs=0.05)
    assert float(draws.std()) == pytest.approx(1.0 / np.sqrt(2.0), abs=0.05)
    assert float(res.rhat_of("mu")) < 1.1
    assert float(res.ess_of("mu")) > 500
    assert float(res.divergence_rate) < 0.01


def test_chees_target_accept_forwarded():
    """Mirrors test_target_accept_forwarded: accept over 0.85 at 0.95."""
    res = _run("chees", n_chains=256, n_warmup=250, n_samples=20, eps0=0.1, target_accept=0.95)
    assert float(res.accept_rate) > 0.85


@pytest.mark.parametrize("algorithm", COLUMN)
def test_unaddressed_model_raises(algorithm):
    """Mirrors test_unaddressed_model_raises."""
    with pytest.raises(ValueError, match="ADDRESSED"):
        sample_posterior(0, g.normal, g.ChoiceMap.empty(), (0.0, 1.0), g.Selection.all(), n_chains=8,
                         n_samples=4, algorithm=algorithm, device="cpu")


@g.gen
def bimodal():
    mu = g.normal(0.0, 10.0) @ "mu"
    _ = g.normal(mu * mu, 1.0) @ "y"


def test_pt_bimodal_mode_weights():
    """Mirrors TestPTAlgorithm::test_bimodal_mode_weights: the modes at +-2
    weighted 50/50 within 0.1, |mu| within 0.1 of 2, accept in (0.2, 1],
    divergence rate 0."""
    res = sample_posterior(314159, bimodal, g.C["y"].set(4.0), (), g.S["mu"], n_chains=256, n_warmup=200,
                           n_samples=200, algorithm="pt", eps0=0.05, L=8, n_rungs=5, device="cpu")
    draws = res["mu"]
    assert tuple(draws.shape) == (256, 200)
    assert float((draws[:, 100:] > 0).float().mean()) == pytest.approx(0.5, abs=0.1)
    assert float(draws[:, 100:].abs().mean()) == pytest.approx(2.0, abs=0.1)
    assert 0.2 < float(res.accept_rate) <= 1.0
    assert float(res.divergence_rate) == 0.0


def test_pt_conjugate_exactness():
    """Mirrors test_conjugate_exactness: mean and sd within 0.1, R-hat
    within 0.15 of 1."""
    res = _run("pt", n_chains=256, n_warmup=150, n_samples=100, eps0=0.1, L=8, n_rungs=3)
    draws = res["mu"][:, -50:]
    assert float(draws.mean()) == pytest.approx(1.0, abs=0.1)
    assert float(draws.std()) == pytest.approx(1.0 / np.sqrt(2.0), abs=0.1)
    assert float(res.rhat_of("mu")) == pytest.approx(1.0, abs=0.15)


def _collinear():
    rng = np.random.RandomState(0)
    n_obs, s2 = 32, 0.25
    x1 = rng.randn(n_obs)
    X = np.stack([x1, x1 + 0.15 * rng.randn(n_obs)], axis=1).astype(np.float32)
    y = (X @ np.asarray([1.0, -0.5]) + np.sqrt(s2) * rng.randn(n_obs)).astype(np.float32)
    cov_post = np.linalg.inv(np.eye(2) + X.T @ X / s2)
    mean_post = cov_post @ (X.T @ y) / s2
    Xt = torch.from_numpy(X)

    @g.gen
    def model():
        w = g.mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        _ = g.mv_normal_diag(Xt @ w, torch.full((n_obs,), float(np.sqrt(s2)))) @ "y"

    return model, torch.from_numpy(y), mean_post, cov_post


@pytest.mark.parametrize("algorithm, kw", [
    ("dense_hmc", dict(L=4)),
    ("dense_nuts", dict(max_depth=6)),
])
def test_dense_correlated_posterior_exact(algorithm, kw):
    """Mirrors TestDenseHMCAlgorithm/TestDenseNUTSAlgorithm::
    test_correlated_posterior_exact: means within 0.05, covariance within
    0.03, accept in (0.5, 1], R-hat under 1.1; dense_hmc's metric diagonal
    within 50% of the marginal variances, dense_nuts's divergences under
    1%."""
    model, y, mean_post, cov_post = _collinear()
    res = sample_posterior(314159, model, g.C["y"].set(y), (), g.S["w"], n_chains=512, n_warmup=200,
                           n_samples=100, thin=2, algorithm=algorithm, eps0=0.2, device="cpu", **kw)
    flat = res["w"].reshape(-1, 2).T.numpy()
    np.testing.assert_allclose(flat.mean(axis=1), mean_post, atol=0.05)
    np.testing.assert_allclose(np.cov(flat), cov_post, atol=0.03)
    assert 0.5 < float(res.accept_rate) <= 1.0
    assert float(res.rhat_of("w").max()) < 1.1
    if algorithm == "dense_hmc":
        np.testing.assert_allclose(res.inv_mass.numpy(), np.diag(cov_post), rtol=0.5)
    else:
        assert float(res.divergence_rate) < 0.01


@pytest.mark.parametrize("n_warmup", [1, 5, 6, 7, 13])
def test_dense_warmup_budget_is_exactly_n_warmup(n_warmup, monkeypatch):
    """Up to 6 phases and a remainder sweep: the dense-HMC transitions of
    the warmup total exactly ``n_warmup``."""
    counted = []
    sweep = dense_mass.hmc_sweep_dense_cols

    def counting(*a, **kw):
        counted.append(kw["n_steps"])
        return sweep(*a, **kw)

    monkeypatch.setattr(dense_mass, "hmc_sweep_dense_cols", counting)
    monkeypatch.setattr(sample, "hmc_sweep_dense_cols", counting)
    _run("dense_hmc", n_chains=8, n_warmup=n_warmup, n_samples=4, thin=2, eps0=0.3, L=2)
    assert sum(counted[:-1]) == n_warmup and counted[-1] == 8


def test_sample_logdensity_conjugate_posterior():
    """Mirrors TestSampleLogdensity::test_conjugate_posterior_plain: mean
    within 0.02 of 1.25, variance within 20% of 0.04, R-hat under 1.05, ESS
    over 200, draws (256, 100, 8); the run stays where ``q0`` lives."""
    mu_post, v_post = 1.25, 0.04

    def ld(q):
        return -0.5 * (q[0] - mu_post) ** 2 / v_post - 0.5 * torch.sum(q[1:] ** 2, dim=0)

    q0 = torch.zeros(8, 256)
    res = sample_logdensity(0, ld, q0, n_warmup=200, n_samples=100)
    draws = res.draws[:, :, 0].numpy().ravel()
    np.testing.assert_allclose(draws.mean(), mu_post, atol=0.02)
    np.testing.assert_allclose(draws.var(), v_post, rtol=0.2)
    assert float(res.rhat[0]) < 1.05
    assert float(res.ess[0]) > 200
    assert tuple(res.draws.shape) == (256, 100, 8)
    assert res.draws.device == q0.device and res.eps.device == q0.device


def test_column_algorithms_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for algorithm in COLUMN:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sample_posterior(0, conjugate, OBS, (), g.S["mu"], n_chains=8, n_samples=2, algorithm=algorithm)

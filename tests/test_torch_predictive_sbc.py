"""Posterior predictive checks and simulation-based calibration
(``inference/predictive.py``, ``inference/sbc.py``) against ``genjax_tpu``
and the closed forms its tests use.

Deterministic to 1e-5: ``sbc_uniformity``'s counts (exactly) and p-values
on the same given ranks as the reference's, and the ranks ``sbc_ranks``
makes from given draws (a sampler whose draws are a deterministic function
of the simulated data, checked against a count in numpy). In law:
``posterior_predictive`` of the conjugate model (``mu ~ N(1, 1/2)`` draws
give ``y_rep ~ N(1, 3/2)``: mean within 4 SE, variance within 4 SE), the
constrained sites replayed exactly; an exact posterior sampler passes
uniformity (p > 1e-3), a biased and an over-dispersed one fail it (p <
1e-3), and a slice-sampling pipeline passes it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu_torch as g
from genjax_tpu.inference.sbc import sbc_uniformity as ref_sbc_uniformity
from genjax_tpu_torch.inference import PosteriorSamples, posterior_predictive
from genjax_tpu_torch.inference.sbc import sbc_ranks, sbc_uniformity
from torch_threads import _one_thread  # noqa: F401


@g.gen
def conjugate():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


def _in_law(x, mean, var):
    x = x.double()
    n = x.shape[0]
    assert abs(float(x.mean()) - mean) < 4 * np.sqrt(var / n), (float(x.mean()), mean)
    assert abs(float(x.var()) - var) < 4 * var * np.sqrt(2 / n), (float(x.var()), var)


def test_predictive_from_a_dict_in_law_and_replayed():
    gen = torch.Generator().manual_seed(0)
    mus = 1.0 + np.sqrt(0.5) * torch.randn(20000, generator=gen)
    out = posterior_predictive(gen, conjugate, (), {"mu": mus})
    assert tuple(out["y"].shape) == (20000,)
    _in_law(out["y"], 1.0, 1.5)
    assert torch.equal(out["mu"], mus)


def test_predictive_from_posterior_samples_flattens_chains_and_samples():
    draws = torch.arange(12.0).reshape(3, 4)
    samples = PosteriorSamples(g.C["mu"].set(draws), None, None, None, None, None, None)
    out = posterior_predictive(torch.Generator().manual_seed(1), conjugate, (), samples)
    assert torch.equal(out["mu"], draws.reshape(-1)) and tuple(out["y"].shape) == (12,)


def test_predictive_subsampling_and_errors():
    out = posterior_predictive(torch.Generator(), conjugate, (), {"mu": torch.arange(100.0)}, n_draws=10)
    assert tuple(out["y"].shape) == (10,)
    # the floor of linspace(0, 99, 10)
    assert out["mu"].tolist() == [0.0, 11.0, 22.0, 33.0, 44.0, 55.0, 66.0, 77.0, 88.0, 99.0]
    with pytest.raises(ValueError, match="at least one site"):
        posterior_predictive(torch.Generator(), conjugate, (), {})
    with pytest.raises(ValueError, match="disagree"):
        posterior_predictive(torch.Generator(), conjugate, (), {"mu": torch.zeros(5), "y": torch.zeros(6)})


@pytest.mark.parametrize("n_draws,n_bins,seed", [(99, 20, 0), (39, 10, 1), (9, 5, 2)])
def test_uniformity_matches_reference_on_given_ranks(n_draws, n_bins, seed):
    ranks = np.random.default_rng(seed).integers(0, n_draws + 1, size=(300, 3))
    pvals, counts = sbc_uniformity(torch.from_numpy(ranks), n_draws, n_bins=n_bins)
    r_pvals, r_counts = ref_sbc_uniformity(jnp.asarray(ranks), n_draws, n_bins=n_bins)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    np.testing.assert_allclose(pvals.numpy(), np.asarray(r_pvals), rtol=1e-5, atol=1e-5)


N_SIMS, N_DRAWS = 400, 99


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    g.normal(mu, 0.5) @ "y"


def posterior_params(constraint):
    y = constraint.get_submap("y").get_value()
    v = 1.0 / (1.0 + 1.0 / 0.25)
    return v * y / 0.25, np.sqrt(v)


def _sampler(shift=0.0, widen=1.0):
    def sampler(gen, constraint):
        m, sd = posterior_params(constraint)
        return (m + shift + widen * sd * torch.randn(N_DRAWS, generator=gen))[:, None]

    return sampler


def test_ranks_from_given_draws():
    grid = torch.linspace(-3.0, 3.0, N_DRAWS)

    def fixed(_gen, constraint):
        # draws that are a function of the data alone
        return (grid + constraint.get_submap("y").get_value())[:, None]

    state = torch.Generator().manual_seed(4).get_state()
    res = sbc_ranks(torch.Generator().set_state(state), model, (), g.S["mu"], fixed, n_sims=64, device="cpu")
    # the same simulations, replayed from the same stream: each rank counts
    # the draws below the prior draw
    gen = torch.Generator().set_state(state)
    mu_y = torch.func.vmap(lambda _: (lambda c: torch.stack([c["mu"], c["y"]]))(model.simulate(gen, ()).get_choices()),
                           randomness="different")(torch.zeros(64))
    want = ((grid[None, :] + mu_y[:, 1:2]) < mu_y[:, 0:1]).sum(dim=1)
    assert res.n_draws == N_DRAWS and torch.equal(res.ranks[:, 0], want)
    assert len(torch.unique(want)) > 10


def test_exact_sampler_is_uniform_and_bad_ones_are_caught():
    res = sbc_ranks(0, model, (), g.S["mu"], _sampler(), n_sims=N_SIMS, device="cpu")
    assert tuple(res.ranks.shape) == (N_SIMS, 1)
    pvals, counts = sbc_uniformity(res, n_bins=20)
    assert float(pvals[0]) > 1e-3, (pvals, counts)
    for bad in (_sampler(shift=0.3), _sampler(widen=2.0)):
        pvals, _ = sbc_uniformity(sbc_ranks(1, model, (), g.S["mu"], bad, n_sims=N_SIMS, device="cpu").ranks,
                                  N_DRAWS, n_bins=20)
        assert float(pvals[0]) < 1e-3


def test_slice_pipeline_passes():
    n_draws = 39

    def mcmc_sampler(gen, constraint):
        tr, _ = model.generate(gen, constraint, ())
        req = g.SliceSample(g.S["mu"], width=2.0, max_steps=8)
        draws = []
        for i in range(n_draws + 5):
            tr, _ = g.mh(gen, tr, req)
            if i >= 5:
                draws.append(tr.get_choices()["mu"])
        return torch.stack(draws)[:, None]

    res = sbc_ranks(3, model, (), g.S["mu"], mcmc_sampler, n_sims=200, device="cpu")
    pvals, counts = sbc_uniformity(res, n_bins=10)
    assert float(pvals[0]) > 1e-3, (pvals, counts)


def test_sbc_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sbc_ranks(0, model, (), g.S["mu"], _sampler(), n_sims=4)

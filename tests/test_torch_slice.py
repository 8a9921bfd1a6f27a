"""The port's flagship slice end to end against ``genjax_tpu``.

``column_hmc`` on the hierarchical regression at 512 chains is held in law
against the reference's ``column_hmc(backend="xla")``: the cross-chain mean
of each ``w_j`` within 4 combined Monte Carlo standard errors. The two start
from different prior draws (the port's generator stream is not the
reference's), so the comparison is of laws, not of draws.
``linear_regression``'s conjugate posterior matches the reference's and is
recovered by the port's sampler. The entry points run on the card by
default, and without one the default raises instead of running on the CPU.
"""

import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.kernels import column_hmc as jax_column_hmc
from genjax_tpu.models import hierarchical_regression as jax_hier
from genjax_tpu.models import linear_regression as jax_linear
from genjax_tpu_torch.kernels import column_hmc, column_nuts
from genjax_tpu_torch.kernels.hmc import pallas_hmc
from genjax_tpu_torch.kernels.nuts_pallas import pallas_nuts
from genjax_tpu_torch.models import hierarchical_regression, linear_regression

N_CHAINS = 512


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


def test_flagship_column_hmc_matches_jax_in_law():
    X, y = flagship_data()
    kw = dict(n_chains=N_CHAINS, n_steps=50, eps=0.02, L=5, seed=0)
    jq, jacc, _ = jax_column_hmc(jax_hier(X), gj.C["y"].set(y), (), ["tau", "w"], backend="xla", **kw)
    tq, tacc, packer = column_hmc(
        hierarchical_regression(X), g.C["y"].set(y), (), ["tau", "w"], device="cpu", **kw
    )
    assert pallas_hmc.last_backend == "torch"
    assert tuple(tq.shape) == (16, N_CHAINS) and bool(torch.isfinite(tq).all())
    jw, tw = np.asarray(jq)[1:9], tq[1:9].numpy()
    se = np.sqrt(jw.var(axis=1) / N_CHAINS + tw.var(axis=1) / N_CHAINS)
    z = np.abs(jw.mean(axis=1) - tw.mean(axis=1)) / se
    assert (z < 4).all(), z
    assert abs(float(tacc) - float(jacc)) < 0.05


def test_linear_regression_exact_posterior_matches_jax():
    X = np.random.default_rng(2).normal(size=(12, 3)).astype(np.float32)
    y = np.random.default_rng(3).normal(size=(12,)).astype(np.float32)
    _, j_post = jax_linear(X, obs_scale=0.5)
    _, t_post = linear_regression(X, obs_scale=0.5)
    (jm, jc), (tm, tc) = j_post(y), t_post(y)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)


def test_linear_regression_posterior_mean_recovered():
    X = np.random.default_rng(2).normal(size=(12, 3)).astype(np.float32)
    y = np.random.default_rng(3).normal(size=(12,)).astype(np.float32)
    model, exact_posterior = linear_regression(X, obs_scale=0.5)
    mean, cov = exact_posterior(y)
    q, acc, packer = column_hmc(
        model, g.C["y"].set(y), (), ["w"], n_chains=1024, n_steps=150, eps=0.1, L=5, seed=4,
        device="cpu",
    )
    assert float(acc) > 0.6
    w = q[:3]
    se = torch.sqrt(torch.diagonal(cov) / 1024)
    assert bool(((w.mean(dim=1) - mean).abs() < 5 * se + 0.01).all()), (w.mean(dim=1), mean)
    torch.testing.assert_close(w.var(dim=1), torch.diagonal(cov), rtol=0.2, atol=1e-3)


@pytest.mark.parametrize("entry", ["column_hmc", "column_nuts", "run_chains"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a card the default ``device`` raises and runs nothing on the
    CPU; ``device="cpu"`` runs the plain twin there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = flagship_data()
    if entry == "run_chains":
        model, made = hierarchical_regression(X), []

        def make_trace(gen):
            made.append(gen.device.type)
            return model.generate(gen, g.C["y"].set(torch.as_tensor(y)), ())[0]

        request = g.HMC(g.S["w"] | g.S["tau"], 0.02, L=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            g.run_chains(0, make_trace, request, n_steps=2, n_chains=64)
        assert made == []
        res = g.run_chains(0, make_trace, request, n_steps=2, n_chains=64, device="cpu")
        assert made == ["cpu"] and res.trace["w"].device.type == "cpu"
        assert tuple(res.trace["w"].shape) == (64, 8)
        return
    fn = column_hmc if entry == "column_hmc" else column_nuts
    kw = dict(n_chains=64, n_steps=2, eps=0.02)
    pallas_hmc.last_backend = pallas_nuts.last_backend = None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(hierarchical_regression(X), g.C["y"].set(y), (), ["tau", "w"], **kw)
    assert pallas_hmc.last_backend is None and pallas_nuts.last_backend is None
    out = fn(hierarchical_regression(X), g.C["y"].set(y), (), ["tau", "w"], device="cpu", **kw)
    assert out[0].device.type == "cpu" and tuple(out[0].shape) == (16, 64)

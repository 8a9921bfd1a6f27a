"""The ``EllipticalSlice`` and ``SliceSample`` requests
(``inference/requests/elliptical.py``, ``slice_.py``) in law against the
closed forms and quadratures the reference tests use
(``tests/inference/test_elliptical_request.py``, ``test_slice_request.py``),
run by ``run_chains`` under ``torch.func.vmap`` over chains.

Means within 4 SE of the closed form (the SE over chains), variances within
4 SE of theirs (``var * sqrt(2 / n)``) and the correlated-prior covariance
within 0.06; the weight is exactly 0 and the backward request the request.
The fixed, masked budget: with ``max_iters``/``max_steps`` too small to find
a point, every lane stays put and reports ``exhausted``.
"""

import numpy as np
import pytest
import torch
from scipy.stats import laplace, norm

import genjax_tpu_torch as g
from genjax_tpu_torch.dists import mv_normal, mv_normal_diag
from genjax_tpu_torch.inference.requests import EllipticalSlice, SliceSample
from torch_threads import _one_thread  # noqa: F401

N_CHAINS = 2048


def _run(model, constraint, req, n_steps, seed=0, n_chains=N_CHAINS):
    res = g.run_chains(seed, lambda gen: model.generate(gen, constraint, ())[0], req, n_steps, n_chains,
                       device="cpu")
    assert float(res.accept_rate.min()) == 1.0
    return res.trace.get_choices()


def _moments_in_law(draws, mean, var):
    draws = torch.as_tensor(draws).double()
    mean, var = np.array(mean), np.array(var)
    n = draws.shape[0]
    assert torch.all((draws.mean(0) - torch.as_tensor(mean)).abs() < 4 * torch.sqrt(torch.as_tensor(var) / n)), (
        draws.mean(0), mean)
    assert torch.all((draws.var(0) - torch.as_tensor(var)).abs() < 4 * torch.as_tensor(var) * np.sqrt(2 / n)), (
        draws.var(0), var)


@g.gen
def nn_ess():
    mu = g.normal(2.0, 1.5) @ "mu"
    g.normal(mu, 0.5) @ "y"


def test_ess_normal_normal_posterior():
    v = 1.0 / (1.0 / 1.5**2 + 1.0 / 0.5**2)
    m = v * (2.0 / 1.5**2 + 3.1 / 0.5**2)
    ch = _run(nn_ess, g.C["y"].set(3.1), EllipticalSlice(g.S["mu"], mean=2.0, chol=1.5), 25)
    _moments_in_law(ch["mu"], m, v)


def test_ess_weight_zero_backward_same_and_moves():
    tr, _ = nn_ess.generate(torch.Generator().manual_seed(1), g.C["y"].set(1.0), ())
    new, w, _, bwd = tr.edit(torch.Generator().manual_seed(2), EllipticalSlice(g.S["mu"], mean=2.0, chol=1.5))
    assert float(w) == 0.0 and isinstance(bwd, EllipticalSlice) and not bool(bwd.exhausted)
    assert float(new.get_choices()["mu"]) != float(tr.get_choices()["mu"])


def test_ess_linear_regression_posterior():
    rng = np.random.RandomState(0)
    X = rng.randn(10, 3).astype(np.float32)
    s = 0.5
    y = (X @ np.asarray([1.0, -1.0, 0.5]) + s * rng.randn(10)).astype(np.float32)
    cov = np.linalg.inv(np.eye(3) + X.T @ X / s**2)
    Xt = torch.from_numpy(X)

    @g.gen
    def model():
        w = mv_normal_diag(torch.zeros(3), torch.ones(3)) @ "w"
        mv_normal_diag(Xt @ w, s * torch.ones(10)) @ "y"

    ch = _run(model, g.C["y"].set(torch.from_numpy(y)), EllipticalSlice(g.S["w"]), 25, seed=3)
    _moments_in_law(ch["w"], cov @ (X.T @ y) / s**2, np.diag(cov))


def test_ess_full_cholesky_prior():
    sigma = np.asarray([[1.0, 0.7], [0.7, 1.0]], np.float32)
    s, obs, a = 0.4, 1.2, np.asarray([1.0, 1.0])
    cov = np.linalg.inv(np.linalg.inv(sigma) + np.outer(a, a) / s**2)

    @g.gen
    def model():
        w = mv_normal(torch.zeros(2), torch.from_numpy(sigma)) @ "w"
        g.normal(w[0] + w[1], s) @ "y"

    req = EllipticalSlice(g.S["w"], chol=torch.from_numpy(np.linalg.cholesky(sigma)))
    ws = _run(model, g.C["y"].set(obs), req, 25, seed=4)["w"]
    _moments_in_law(ws, cov @ a * obs / s**2, np.diag(cov))
    np.testing.assert_allclose(np.cov(ws.double().numpy().T), cov, atol=0.06)


@g.gen
def nn_slice():
    mu = g.normal(1.0, 2.0) @ "mu"
    g.normal(mu, 0.5) @ "y"


def test_slice_normal_normal_moments():
    v = 1.0 / (1.0 / 4.0 + 1.0 / 0.25)
    m = v * (1.0 / 4.0 + 2.4 / 0.25)
    _moments_in_law(_run(nn_slice, g.C["y"].set(2.4), SliceSample(g.S["mu"]), 15)["mu"], m, v)


def test_slice_weight_zero_and_vector_selection_rejected():
    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        w = mv_normal_diag(torch.zeros(2), torch.ones(2)) @ "w"
        g.normal(mu + w[0], 1.0) @ "y"

    tr, _ = model.generate(torch.Generator().manual_seed(1), g.C["y"].set(0.5), ())
    new, w, _, bwd = tr.edit(torch.Generator().manual_seed(2), SliceSample(g.S["mu"]))
    assert float(w) == 0.0 and isinstance(bwd, SliceSample) and not bool(bwd.exhausted)
    assert float(new.get_choices()["mu"]) != float(tr.get_choices()["mu"])
    with pytest.raises(ValueError, match="exactly one scalar"):
        tr.edit(torch.Generator(), SliceSample(g.S["w"]))


def test_slice_laplace_prior_against_quadrature():
    y_obs, s = 1.2, 0.5

    @g.gen
    def model():
        x = g.laplace(0.0, 1.0) @ "x"
        g.normal(x, s) @ "y"

    grid = np.linspace(-6, 8, 4001)
    lw = laplace.logpdf(grid) + norm.logpdf(y_obs, grid, s)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    m = float(w @ grid)
    _moments_in_law(_run(model, g.C["y"].set(y_obs), SliceSample(g.S["x"], width=1.0), 15, seed=4)["x"], m,
                    float(w @ (grid - m) ** 2))


def test_slice_bimodal_mixes_across_modes():
    @g.gen
    def model():
        x = g.normal(0.0, 3.0) @ "x"
        g.normal(torch.abs(x), 0.3) @ "y"

    xs = _run(model, g.C["y"].set(2.0), SliceSample(g.S["x"], width=4.0), 15, seed=5)["x"].double()
    frac = float((xs > 0).double().mean())
    assert abs(frac - 0.5) < 4 * np.sqrt(0.25 / N_CHAINS), frac
    assert abs(float(xs.abs().mean()) - 1.95) < 0.15


@pytest.mark.parametrize("req", [EllipticalSlice(g.S["mu"], mean=2.0, chol=1.5, max_iters=0),
                                 SliceSample(g.S["mu"], width=1.0, max_steps=1)])
def test_out_of_budget_lanes_stay_put_and_are_counted_under_vmap(req):
    gen = torch.Generator().manual_seed(6)
    trs = torch.func.vmap(lambda _: nn_ess.generate(gen, g.C["y"].set(3.1), ())[0], randomness="different")(
        torch.zeros(256))

    def one(tr):
        new, w, _rd, bwd = tr.edit(gen, req)
        return new, w, bwd.exhausted

    new, w, exhausted = torch.func.vmap(one, randomness="different")(trs)
    assert tuple(exhausted.shape) == (256,) and torch.equal(w, torch.zeros(256))
    stayed = new.get_choices()["mu"] == trs.get_choices()["mu"]
    assert torch.equal(stayed, exhausted)
    # no shrink step (ESS), or one shrink step in a bracket not stepped out
    # (slice): some lanes find a point, some run out
    assert 0 < int(exhausted.sum()) < 256

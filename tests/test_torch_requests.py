"""The port's gradient view and ``HMC`` edit request against ``genjax_tpu``.

The same choices and the same ``(z0, r0)``, from numpy seeds, go through the
reference's ``selected_logdensity`` / ``jax.value_and_grad`` and the port's:
values, gradients and the leapfrog trajectory agree to 1e-4. The request's
chains are held in law against the conjugate closed forms the reference's
tests use (``tests/inference/test_requests.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.requests.grad_view import selected_logdensity as j_selected_logdensity
from genjax_tpu.inference.requests.grad_view import selection_gradient as j_selection_gradient
from genjax_tpu.core.diff import Diff as JDiff
from genjax_tpu.models import hierarchical_regression as jax_hier
from genjax_tpu_torch.core.diff import Diff
from genjax_tpu_torch.inference.requests.grad_view import (
    selected_logdensity, selection_gradient, split_ravel,
)
from genjax_tpu_torch.inference.requests.hmc import hmc_trajectory
from genjax_tpu_torch.models import hierarchical_regression

TOL = 1e-4  # values, gradients, positions and alpha against the reference


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def _flagship_traces(seed):
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    rng = np.random.default_rng(seed)
    flat = {"tau": np.float32(rng.uniform(0.5, 1.5)), "w": rng.normal(size=8).astype(np.float32),
            "y": rng.normal(size=16).astype(np.float32)}
    jtr, _ = jax_hier(X).generate(
        jax.random.key(0), gj.ChoiceMap.d({k: jnp.asarray(v) for k, v in flat.items()}), ())
    ttr, _ = hierarchical_regression(X).generate(
        gen_at(0), g.ChoiceMap.d({k: torch.as_tensor(v) for k, v in flat.items()}), ())
    return jtr, ttr


def _views(seed, sel=lambda m: m.S["w"] | m.S["tau"]):
    jtr, ttr = _flagship_traces(seed)
    jz0, j_ld, _ = j_selected_logdensity(jtr.get_gen_fn(), jtr.get_choices(), sel(gj), ())
    tz0, t_ld, t_to = selected_logdensity(ttr.get_gen_fn(), ttr.get_choices(), sel(g), ())
    return (jtr, jz0, j_ld), (ttr, tz0, t_ld, t_to)


@pytest.mark.parametrize("seed", range(3))
def test_selected_logdensity_value_and_gradient_match_jax(seed):
    (_, jz0, j_ld), (ttr, tz0, t_ld, _) = _views(30 + seed)
    np.testing.assert_array_equal(tz0.numpy(), np.asarray(jz0))  # same ravel order: tau, w
    z = (np.asarray(jz0) + 0.1 * np.random.default_rng(seed).normal(size=9)).astype(np.float32)
    j_lp, j_g = jax.value_and_grad(j_ld)(jnp.asarray(z))
    t_g, t_lp = torch.func.grad_and_value(t_ld)(torch.as_tensor(z))
    np.testing.assert_allclose(float(t_lp), float(j_lp), rtol=TOL)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(j_g), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(t_ld(tz0)), float(ttr.get_score()), rtol=1e-6)


def test_selected_logdensity_of_one_address():
    (_, jz0, j_ld), (_, tz0, t_ld, t_to) = _views(33, lambda m: m.S["w"])
    assert tuple(tz0.shape) == (8,) == tuple(jz0.shape)
    np.testing.assert_allclose(float(t_ld(tz0 + 0.5)), float(j_ld(jz0 + 0.5)), rtol=TOL)
    assert t_to(tz0 + 0.5).static_addresses() == ("w",)


def test_split_ravel_round_trip_leaves_discrete_leaves_alone():
    chm = (g.C["b"].set(torch.tensor(True)) | g.C["mu"].set(torch.tensor(0.5))
           | g.C["w"].set(torch.arange(6.0).reshape(2, 3)) | g.C["k"].set(torch.tensor(3)))
    z0, rebuild = split_ravel(chm)
    assert z0.tolist() == [0.5, 0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    out = rebuild(z0 * 2.0)
    assert out["b"] is chm["b"] and out["k"] is chm["k"]
    assert float(out["mu"]) == 1.0 and out["w"].shape == (2, 3) and float(out["w"][1, 2]) == 10.0
    zeros = rebuild(z0, nongrad_fill=lambda leaf: torch.zeros((), dtype=torch.float32))
    assert zeros["b"].dtype == torch.float32 and float(zeros["mu"]) == 0.5
    empty, rebuild_empty = split_ravel(g.C["b"].set(torch.tensor(True)))
    assert empty.numel() == 0 and rebuild_empty(empty)["b"].dtype == torch.bool


def test_selection_gradient_matches_jax():
    jtr, ttr = _flagship_traces(34)
    j_vals, j_grads = j_selection_gradient(gj.S["w"], jtr, JDiff.tree_diff_no_change(()))
    t_vals, t_grads = selection_gradient(g.S["w"], ttr, Diff.tree_diff_no_change(()))
    np.testing.assert_allclose(t_grads["w"].numpy(), np.asarray(j_grads["w"]), rtol=TOL, atol=TOL)
    assert torch.equal(t_vals["w"], ttr["w"])
    assert ("tau" in t_grads) == ("tau" in j_grads) == False  # noqa: E712


@pytest.mark.parametrize("inv_mass", [None, "diag"], ids=["unit-mass", "diag-mass"])
def test_hmc_trajectory_matches_a_jax_leapfrog(inv_mass):
    """The port's integrator on ``(z0, r0)`` against the same leapfrog
    written here with the reference's ``selected_logdensity``."""
    (_, jz0, j_ld), (_, tz0, t_ld, _) = _views(35)
    rng = np.random.default_rng(36)
    r0 = rng.normal(size=9).astype(np.float32)
    im = np.ones(9, np.float32) if inv_mass is None else rng.uniform(0.5, 2.0, size=9).astype(np.float32)
    eps, L = 0.02, 5

    vg = jax.value_and_grad(j_ld)
    z, r, jim = jz0, jnp.asarray(r0), jnp.asarray(im)
    lp0, grad = vg(z)
    for _ in range(L):
        r = r + (eps / 2) * grad
        z = z + eps * jim * r
        lp, grad = vg(z)
        r = r + (eps / 2) * grad
    j_alpha = lp - lp0 + 0.5 * jnp.sum(jim * r0 * r0) - 0.5 * jnp.sum(jim * r * r)

    def value_and_grad(zz):
        gg, v = torch.func.grad_and_value(t_ld)(zz)
        return v, gg

    tim = torch.as_tensor(im)
    z1, r1, t_lp0, t_lp1 = hmc_trajectory(value_and_grad, tz0, torch.as_tensor(r0), eps, L, tim)
    t_alpha = t_lp1 - t_lp0 + 0.5 * torch.sum(tim * torch.as_tensor(r0) ** 2) - 0.5 * torch.sum(tim * r1 * r1)
    np.testing.assert_allclose(z1.numpy(), np.asarray(z), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(t_alpha), float(j_alpha), rtol=TOL, atol=TOL)


# ----------------------------------------------------------------------
# the request
# ----------------------------------------------------------------------


@g.gen
def normal_normal():
    mu = g.normal(0.0, 1.0) @ "mu"
    y = g.normal(mu, 1.0) @ "y"
    return y


def exact_posterior(y_obs):
    # mu | y ~ N(y/2, 1/sqrt(2))
    return y_obs / 2.0, 1.0 / np.sqrt(2.0)


def test_alpha_is_mh_ratio_structurally():
    tr, _ = normal_normal.generate(gen_at(42), g.C["y"].set(1.0), ())
    new_tr, alpha, rd, bwd = tr.edit(gen_at(43), g.HMC(g.S["mu"], 0.1, L=5))
    assert bool(torch.isfinite(alpha))
    assert isinstance(bwd, g.HMC) and bwd.L == 5
    assert float(new_tr["y"]) == pytest.approx(1.0)  # y stays constrained
    assert float(new_tr["mu"]) != float(tr["mu"])
    np.testing.assert_allclose(
        float(new_tr.get_score()), float(normal_normal.assess(new_tr.get_choices(), ())[0]), rtol=1e-6
    )
    # energy is nearly conserved at a small step
    assert abs(float(alpha)) < 0.05


def test_hmc_on_the_flagship_with_inverse_mass():
    _, tr = _flagship_traces(37)
    req = g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5, inv_mass=torch.full((9,), 0.5))
    new_tr, alpha, _, bwd = tr.edit(gen_at(1), req)
    assert bool(torch.isfinite(alpha)) and torch.equal(new_tr["y"], tr["y"])
    assert not torch.equal(new_tr["w"], tr["w"]) and float(new_tr["tau"]) > 0
    assert torch.equal(bwd.inv_mass, req.inv_mass)
    with pytest.raises(NotImplementedError, match="unchanged arguments"):
        req.edit(gen_at(1), tr, (Diff.unknown_change(1.0),))


def test_safe_hmc():
    tr, _ = normal_normal.generate(gen_at(42), g.C["y"].set(1.0), ())
    with pytest.raises(AssertionError, match="return value changed"):
        tr.edit(gen_at(2), g.SafeHMC(g.S["y"], 0.1, L=2))  # y is the return value

    @g.gen
    def no_retval():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 1.0) @ "y"

    tr, _ = no_retval.generate(gen_at(42), g.C["y"].set(1.0), ())
    new_tr, alpha, _, _ = tr.edit(gen_at(2), g.SafeHMC(g.S["mu"], 0.1, L=2))
    assert bool(torch.isfinite(alpha)) and float(new_tr["mu"]) != float(tr["mu"])


def test_discrete_selected_leaf_stays_fixed():
    @g.gen
    def mixed():
        g.flip(0.5) @ "b"
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 1.0) @ "y"

    tr, _ = mixed.generate(gen_at(3), g.C["y"].set(1.0), ())
    new_tr, alpha, _, _ = tr.edit(gen_at(4), g.HMC(g.S["b"] | g.S["mu"], 0.3, L=3))
    assert bool(torch.isfinite(alpha))
    assert bool(new_tr["b"] == tr["b"]) and new_tr["b"].dtype == torch.bool
    assert float(new_tr["mu"]) != float(tr["mu"])


def test_mh_accept_selects_leaf_by_leaf():
    tr, _ = normal_normal.generate(gen_at(5), g.C["y"].set(1.0), ())
    new_tr, _, _, _ = tr.update(gen_at(6), g.C["mu"].set(3.0))
    kept, accept = g.mh_accept(gen_at(7), tr, new_tr, torch.tensor(-torch.inf))
    assert not bool(accept) and torch.equal(kept["mu"], tr["mu"])
    torch.testing.assert_close(kept.get_score(), tr.get_score())
    moved, accept = g.mh_accept(gen_at(7), tr, new_tr, torch.tensor(torch.inf))
    assert bool(accept) and float(moved["mu"]) == 3.0
    nan_kept, accept = g.mh_accept(gen_at(7), tr, new_tr, torch.tensor(torch.nan))
    assert not bool(accept) and torch.equal(nan_kept["mu"], tr["mu"])


def test_posterior_moments_single_chain():
    """150 transitions of one chain, the first 30 dropped: with trajectories
    of length 3 the draws are nearly independent, so the mean's standard
    error is about 0.065 and the sd's 0.046; limits 0.2 and 0.15."""
    mean, std = exact_posterior(1.0)
    gen = gen_at(42)
    tr, _ = normal_normal.generate(gen, g.C["y"].set(1.0), ())
    mus, accepts = [], []
    for _ in range(150):
        new_tr, alpha, _, _ = tr.edit(gen, g.HMC(g.S["mu"], 0.3, L=10))
        tr, accept = g.mh_accept(gen, tr, new_tr, alpha)
        mus.append(tr["mu"])
        accepts.append(accept)
    mus = torch.stack(mus)[30:]
    assert float(torch.stack(accepts).float().mean()) > 0.5
    assert float(mus.mean()) == pytest.approx(mean, abs=0.2)
    assert float(mus.std()) == pytest.approx(std, abs=0.15)


def test_many_chains_vmapped():
    """512 chains as one vmapped batch, 50 transitions each: ``HMC.edit``
    under ``torch.func.vmap``. Limits 0.1, about 3 standard errors."""
    mean, std = exact_posterior(2.0)
    gen = gen_at(42)

    def chain(_):
        tr, _w = normal_normal.generate(gen, g.C["y"].set(2.0), ())
        for _ in range(50):
            new_tr, alpha, _, _ = tr.edit(gen, g.HMC(g.S["mu"], 0.3, L=10))
            tr, _acc = g.mh_accept(gen, tr, new_tr, alpha)
        return tr["mu"]

    mus = torch.func.vmap(chain, randomness="different")(torch.zeros(512))
    assert float(mus.mean()) == pytest.approx(mean, abs=0.1)
    assert float(mus.std()) == pytest.approx(std, abs=0.1)

"""Involutive MCMC (``inference/involutive.py``) against the closed forms
the reference tests use (``tests/inference/test_involutive.py``).

Deterministic to 1e-5: the Jacobians' log-determinants (0 for the random
walk and the split/merge jump, ``u`` for the scale move), the involutions'
round-trip errors (0 to 1e-5) and the acceptance ratio against the
hand-computed posterior ratio at the proposed point (float64). In law, every
chain vmapped over chains with ``torch.func.vmap``: the conjugate posterior
and the lognormal prior (final states' mean within 4 SE, variance within 4
SE of the closed form's), and the reversible-jump chain's ``P(k = 1)``
against the enumerated posterior (within 4 binomial SE).
"""

import numpy as np
import pytest
import torch
from scipy.stats import norm

import genjax_tpu_torch as g
from genjax_tpu_torch.inference.gibbs import gibbs_sweep
from genjax_tpu_torch.inference.involutive import involutive_mh, involutive_move
from torch_threads import _one_thread  # noqa: F401

X_OBS = 1.2
POST_MEAN, POST_VAR = X_OBS / 2.0, 0.5


@g.gen
def conj_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    return g.normal(mu, 1.0) @ "x"


@g.gen
def rw_aux():
    return g.normal(0.0, 0.6) @ "eps"


def rw_involution(t, u):
    return g.C["mu"].set(t["mu"] + u["eps"]) | g.C["x"].set(t["x"]), g.C["eps"].set(-u["eps"])


@g.gen
def scale_aux():
    return g.normal(0.0, 0.4) @ "u"


def scale_involution(t, u):
    return g.C["sigma"].set(t["sigma"] * torch.exp(u["u"])), g.C["u"].set(-u["u"])


@g.gen
def lognormal_model():
    return g.log_normal(0.0, 1.0) @ "sigma"


def _conj_trace(seed=0):
    return conj_model.generate(torch.Generator().manual_seed(seed), g.C["x"].set(X_OBS), ())[0]


def _fork(gen):
    return torch.Generator().set_state(gen.get_state())


def test_random_walk_logdet_alpha_and_round_trip():
    tr = _conj_trace()
    mu = float(tr.get_choices()["mu"])
    gen = torch.Generator().manual_seed(7)
    eps = float(rw_aux.simulate(_fork(gen), ()).get_choices()["eps"])
    _, info = involutive_mh(gen, tr, rw_aux, rw_involution, check=True)
    np.testing.assert_allclose(float(info.logdet), 0.0, atol=1e-5)
    np.testing.assert_allclose(float(info.involution_error), 0.0, atol=1e-6)

    def lp(m):
        return norm.logpdf(m, 0.0, 1.0) + norm.logpdf(X_OBS, m, 1.0)

    np.testing.assert_allclose(float(info.alpha), lp(mu + eps) - lp(mu), rtol=1e-5, atol=1e-5)


def test_scale_move_logdet_is_u():
    gen = torch.Generator().manual_seed(3)
    tr = lognormal_model.simulate(torch.Generator().manual_seed(0), ())
    u = float(scale_aux.simulate(_fork(gen), ()).get_choices()["u"])
    _, info = involutive_mh(gen, tr, scale_aux, scale_involution, check=True)
    np.testing.assert_allclose(float(info.logdet), u, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(info.involution_error), 0.0, atol=1e-6)


def test_checks_flag_bad_involutions():
    tr = _conj_trace()

    def broken(t, u):
        return g.C["mu"].set(t["mu"] + 1.0) | g.C["x"].set(t["x"]), g.C["eps"].set(-u["eps"])

    _, info = involutive_mh(torch.Generator().manual_seed(1), tr, rw_aux, broken, check=True)
    assert float(info.involution_error) > 0.5

    def drops_u(t, u):
        return g.C["mu"].set(t["mu"]) | g.C["x"].set(t["x"]), g.ChoiceMap.empty()

    with pytest.raises(ValueError, match="dimension-balanced"):
        involutive_mh(torch.Generator().manual_seed(1), tr, rw_aux, drops_u)
    _, info = involutive_mh(torch.Generator().manual_seed(1), tr, rw_aux, rw_involution, jacobian="zero")
    assert float(info.logdet) == 0.0
    with pytest.raises(ValueError, match="jacobian"):
        involutive_mh(torch.Generator(), tr, rw_aux, rw_involution, jacobian="numeric")


def _in_law(x, mean, var):
    x = x.double()
    n = x.shape[0]
    assert abs(float(x.mean()) - mean) < 4 * np.sqrt(var / n), (float(x.mean()), mean)
    assert abs(float(x.var()) - var) < 4 * var * np.sqrt(2 / n), (float(x.var()), var)


def test_vmapped_chains_hit_the_conjugate_posterior():
    gen = torch.Generator().manual_seed(1)
    move = involutive_move(rw_aux, rw_involution)

    def chain(_):
        tr, _ = conj_model.generate(gen, g.C["x"].set(X_OBS), ())
        return gibbs_sweep(gen, tr, [move], n_sweeps=40).trace.get_choices()["mu"]

    _in_law(torch.func.vmap(chain, randomness="different")(torch.zeros(2048)), POST_MEAN, POST_VAR)


def test_vmapped_scale_chains_keep_the_lognormal_prior():
    gen = torch.Generator().manual_seed(2)

    def chain(_):
        tr = lognormal_model.simulate(gen, ())
        out = gibbs_sweep(gen, tr, [involutive_move(scale_aux, scale_involution)], n_sweeps=20)
        return torch.log(out.trace.get_choices()["sigma"])

    _in_law(torch.func.vmap(chain, randomness="different")(torch.zeros(2048)), 0.0, 1.0)


YS = torch.tensor([-0.8, -0.5, 0.4, 0.7])


@g.gen
def sat_model():
    k = g.flip(0.5) @ "k"
    theta = g.normal(0.0, 2.0) @ "theta"
    a = g.normal(0.0, 2.0) @ "a"
    b = g.normal(0.0, 2.0) @ "b"
    mus = torch.where(k, torch.stack([a, a, b, b]), theta.expand(4))
    _ = g.normal.vmap(in_axes=(0, None))(mus, 0.8) @ "ys"
    return k


@g.gen
def jump_aux():
    return g.normal(0.0, 1.2) @ "du"


def jump_involution(t, u):
    """(theta, du) <-> (a, b) by split and merge: net log|det| 0."""
    theta, a, b, du = t["theta"], t["a"], t["b"], u["du"]
    t_new = (g.C["k"].set(torch.logical_not(t["k"])) | g.C["theta"].set((a + b) / 2.0)
             | g.C["a"].set(theta - du) | g.C["b"].set(theta + du) | g.C["ys", :].set(t["ys", :]))
    return t_new, g.C["du"].set((b - a) / 2.0)


@g.gen
def refresh_aux():
    u1 = g.normal(0.0, 2.0) @ "u1"
    u2 = g.normal(0.0, 2.0) @ "u2"
    return u1 + u2


def refresh_involution(t, u):
    """The dormant block swapped with fresh pseudo-prior draws: alpha 0."""
    k, theta, a, b, u1, u2 = t["k"], t["theta"], t["a"], t["b"], u["u1"], u["u2"]
    t_new = (g.C["k"].set(k) | g.C["theta"].set(torch.where(k, u1, theta)) | g.C["a"].set(torch.where(k, a, u1))
             | g.C["b"].set(torch.where(k, b, u2)) | g.C["ys", :].set(t["ys", :]))
    return t_new, g.C["u1"].set(torch.where(k, theta, a)) | g.C["u2"].set(torch.where(k, u2, b))


def sat_rw_involution(t, u):
    k, eps = t["k"], u["eps"]
    zero = torch.zeros_like(eps)
    t_new = (g.C["k"].set(k) | g.C["theta"].set(t["theta"] + torch.where(k, zero, eps))
             | g.C["a"].set(t["a"] + torch.where(k, eps, zero)) | g.C["b"].set(t["b"] - torch.where(k, eps, zero))
             | g.C["ys", :].set(t["ys", :]))
    return t_new, g.C["eps"].set(-eps)


def _sat_trace(gen):
    return sat_model.generate(gen, g.C["k"].set(False) | g.C["ys", :].set(YS), ())[0]


def test_jump_and_refresh_involutions_exact():
    tr = _sat_trace(torch.Generator().manual_seed(0))
    _, info = involutive_mh(torch.Generator().manual_seed(1), tr, jump_aux, jump_involution, check=True)
    assert np.isfinite(float(info.alpha))
    np.testing.assert_allclose(float(info.logdet), 0.0, atol=1e-5)
    np.testing.assert_allclose(float(info.involution_error), 0.0, atol=1e-5)
    _, info = involutive_mh(torch.Generator().manual_seed(5), tr, refresh_aux, refresh_involution, check=True)
    np.testing.assert_allclose(float(info.alpha), 0.0, atol=1e-4)
    np.testing.assert_allclose(float(info.involution_error), 0.0, atol=1e-5)


def test_reversible_jump_chain_matches_the_enumerated_posterior():
    def branch_logml(design):
        cov = 4.0 * design @ design.T + 0.64 * np.eye(4)
        y = YS.double().numpy()
        return -0.5 * (np.linalg.slogdet(2 * np.pi * cov)[1] + y @ np.linalg.solve(cov, y))

    lm0 = branch_logml(np.ones((4, 1)))
    lm1 = branch_logml(np.array([[1.0, 0], [1, 0], [0, 1], [0, 1]]))
    p_k1 = 1.0 / (1.0 + np.exp(lm0 - lm1))
    moves = [involutive_move(jump_aux, jump_involution), involutive_move(rw_aux, sat_rw_involution),
             involutive_move(refresh_aux, refresh_involution)]
    gen = torch.Generator().manual_seed(2)
    n = 1024

    def chain(_):
        return gibbs_sweep(gen, _sat_trace(gen), moves, n_sweeps=30).trace.get_choices()["k"]

    ks = torch.func.vmap(chain, randomness="different")(torch.zeros(n)).double()
    assert abs(float(ks.mean()) - p_k1) < 4 * np.sqrt(p_k1 * (1 - p_k1) / n), (float(ks.mean()), p_k1)


@pytest.mark.cuda
def test_python_number_constraints_record_on_the_card():
    """A constraint's Python number is made a tensor on the generator's
    device: ``C["k"].set(False)`` on a draw whose arguments are numbers too
    (``flip(0.5)``) recorded a CPU score and value in a trace made on the
    card, and the next edit there raised."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tr = sat_model.generate(gen, g.C["k"].set(False) | g.C["ys", :].set(YS.cuda()), ())[0]
    assert all(v.is_cuda for v in torch.utils._pytree.tree_leaves(tr) if isinstance(v, torch.Tensor))
    new, info = involutive_mh(gen, tr, jump_aux, jump_involution, check=True)
    assert new.get_choices()["k"].is_cuda and float(info.involution_error) < 1e-5

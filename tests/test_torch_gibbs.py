"""Exact enumeration and enumerative Gibbs (``inference/enumerate_.py``,
``inference/gibbs.py``) against ``genjax_tpu`` and the closed forms its
tests use.

Deterministic parts to 1e-5: the enumeration table, its evidence,
posterior and marginals against the reference's ``enumerate_posterior``;
the exact Gibbs conditionals (``GibbsInfo.log_probs``) against the
reference's and against numpy float64. Random parts in law: sampled
conditionals (each frequency within 4 SE + 1e-3 of the exact one), and the
Gibbs-within-MH sweep on the reference test's ``mixed_model`` (``x =
1.4``), vmapped over chains: ``P(z = 1)`` and ``E[mu]`` within 4 SE of the
closed form, the SE over chain means. Also the static handler's repair: an
``IndexRequest`` into a vmap inside a ``@gen`` body.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from scipy.special import logsumexp
from scipy.stats import norm

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.enumerate_ import enumerate_posterior as ref_enumerate_posterior
from genjax_tpu.inference.gibbs import enumerative_gibbs as ref_enumerative_gibbs
from genjax_tpu_torch.inference.enumerate_ import enumerate_posterior
from genjax_tpu_torch.inference.gibbs import (
    enum_move,
    enum_vmap_move,
    enumerative_gibbs,
    enumerative_gibbs_vmap,
    gibbs_sweep,
    mh_move,
)
from genjax_tpu_torch.inference.requests import HMC
from torch_threads import _one_thread  # noqa: F401

PI = np.asarray([0.2, 0.5, 0.3])
MUS_NP = np.asarray([-2.0, 0.0, 3.0])
LOG_PI, MUS = torch.log(torch.tensor(PI, dtype=torch.float32)), torch.tensor(MUS_NP, dtype=torch.float32)
R_LOG_PI, R_MUS = jnp.log(jnp.asarray(PI, jnp.float32)), jnp.asarray(MUS_NP, jnp.float32)


def exact_conditional(x):
    lw = np.log(PI) + norm.logpdf(x, MUS_NP, 1.0)
    return lw - logsumexp(lw)


@g.gen
def one_site():
    z = g.categorical(LOG_PI) @ "z"
    return g.normal(MUS[z], 1.0) @ "x"


@gj.gen
def r_one_site():
    z = gj.categorical(R_LOG_PI) @ "z"
    return gj.normal(R_MUS[z], 1.0) @ "x"


P0, TR, MU2 = np.asarray([0.6, 0.4]), np.asarray([[0.8, 0.2], [0.3, 0.7]]), np.asarray([-1.0, 1.5])


@g.gen
def two_step_hmm():
    z0 = g.categorical(torch.log(torch.tensor(P0, dtype=torch.float32))) @ "z0"
    z1 = g.categorical(torch.log(torch.tensor(TR, dtype=torch.float32))[z0]) @ "z1"
    mu = torch.tensor(MU2, dtype=torch.float32)
    _ = g.normal(mu[z0], 1.0) @ "y0"
    _ = g.normal(mu[z1], 1.0) @ "y1"


@gj.gen
def r_two_step_hmm():
    z0 = gj.categorical(jnp.log(jnp.asarray(P0, jnp.float32))) @ "z0"
    z1 = gj.categorical(jnp.log(jnp.asarray(TR, jnp.float32))[z0]) @ "z1"
    mu = jnp.asarray(MU2, jnp.float32)
    _ = gj.normal(mu[z0], 1.0) @ "y0"
    _ = gj.normal(mu[z1], 1.0) @ "y1"


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("x", [0.7, -1.1, 2.5])
def test_single_site_enumeration_matches_reference_and_closed_form(x):
    res = enumerate_posterior(one_site, (), g.C["x"].set(x), {"z": torch.arange(3)}, device="cpu")
    ref = ref_enumerate_posterior(r_one_site, (), gj.C["x"].set(x), {"z": jnp.arange(3)})
    for name in ("log_joint", "log_evidence", "log_posterior"):
        _close(getattr(res, name), getattr(ref, name))
    _close(res.log_posterior, exact_conditional(x))
    _close(res.marginal(0), res.log_posterior)


@pytest.mark.parametrize("ys", [(0.3, 1.0), (-2.0, 0.4)])
def test_joint_table_matches_reference_and_forward_algorithm(ys):
    obs = g.C["y0"].set(ys[0]) | g.C["y1"].set(ys[1])
    r_obs = gj.C["y0"].set(ys[0]) | gj.C["y1"].set(ys[1])
    sites = {"z0": torch.arange(2), "z1": torch.arange(2)}
    res = enumerate_posterior(two_step_hmm, (), obs, sites, device="cpu")
    ref = ref_enumerate_posterior(r_two_step_hmm, (), r_obs, {"z0": jnp.arange(2), "z1": jnp.arange(2)})
    for name in ("log_joint", "log_evidence", "log_posterior"):
        _close(getattr(res, name), getattr(ref, name))
    for axis in (0, 1):
        _close(res.marginal(axis), ref.marginal(axis))
    e0, e1 = norm.pdf(ys[0], MU2, 1.0), norm.pdf(ys[1], MU2, 1.0)
    joint = (P0 * e0)[:, None] * TR * e1[None, :]
    _close(torch.exp(res.log_joint), joint, 1e-4)


def test_enumeration_guards_and_device_default():
    obs = g.C["y0"].set(0.0) | g.C["y1"].set(0.0)
    with pytest.raises(ValueError, match="joint states"):
        enumerate_posterior(two_step_hmm, (), obs, {"z0": torch.arange(4096), "z1": torch.arange(4096)},
                            device="cpu")
    with pytest.raises(Exception) as err:
        enumerate_posterior(two_step_hmm, (), obs, {"z0": torch.arange(2)}, device="cpu")
    assert "z1" in str(err.value) or "Missing" in type(err.value).__name__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            enumerate_posterior(two_step_hmm, (), obs, {"z0": torch.arange(2), "z1": torch.arange(2)})


def _scalar_trace(x, seed=0):
    return one_site.generate(torch.Generator().manual_seed(seed), g.C["x"].set(x), ())[0]


@pytest.mark.parametrize("x", [0.7, -1.1])
def test_gibbs_conditional_matches_reference_and_enumeration(x):
    tr = _scalar_trace(x)
    new, info = enumerative_gibbs(torch.Generator().manual_seed(1), tr, "z", torch.arange(3))
    r_tr, _ = r_one_site.generate(jr.PRNGKey(0), gj.C["x"].set(x), ())
    _, r_info = ref_enumerative_gibbs(jr.PRNGKey(1), r_tr, "z", jnp.arange(3))
    _close(info.log_probs, r_info.log_probs)
    _close(info.log_probs, exact_conditional(x))
    res = enumerate_posterior(one_site, (), g.C["x"].set(x), {"z": torch.arange(3)}, device="cpu")
    _close(info.log_probs, res.log_posterior)
    score, _ = one_site.assess(new.get_choices(), ())
    _close(new.get_score(), score)


def test_gibbs_draws_in_law_vmapped_over_chains():
    tr = _scalar_trace(0.7)
    gen = torch.Generator().manual_seed(2)
    n = 4000
    zs = torch.func.vmap(lambda _: enumerative_gibbs(gen, tr, "z", torch.arange(3))[0].get_choices()["z"],
                         randomness="different")(torch.zeros(n))
    freq = np.bincount(zs.numpy(), minlength=3) / n
    exact = np.exp(exact_conditional(0.7))
    assert np.all(np.abs(freq - exact) <= 4 * np.sqrt(exact * (1 - exact) / n) + 1e-3), (freq, exact)


@g.gen
def site(x):
    z = g.categorical(LOG_PI) @ "z"
    return g.normal(MUS[z], 1.0) @ "y"


@g.gen
def vmapped_model(xs):
    return site.vmap(in_axes=(0,))(xs) @ "assign"


XS = torch.tensor([-1.8, 0.2, 2.5, 0.0])
EXACT_LANES = np.stack([exact_conditional(x) for x in XS.numpy()])


def _vmapped_trace(seed=0):
    return vmapped_model.generate(torch.Generator().manual_seed(seed),
                                  g.C["assign", torch.arange(4), "y"].set(XS), (XS,))[0]


def test_block_gibbs_conditionals_draws_and_lane_batches():
    tr = _vmapped_trace()
    new, info = enumerative_gibbs_vmap(torch.Generator().manual_seed(2), tr, ("assign", None, "z"), torch.arange(3))
    _close(info.log_probs, EXACT_LANES)
    got = new.get_choices()["assign", torch.arange(4), "z"]
    got = got.value if isinstance(got, g.Mask) else got
    assert torch.equal(got, info.index)
    score, _ = vmapped_model.assess(new.get_choices(), (XS,))
    _close(new.get_score(), score)
    for lb in (1, 3, 7):
        _, info_lb = enumerative_gibbs_vmap(torch.Generator().manual_seed(2), tr, ("assign", None, "z"),
                                            torch.arange(3), lane_batch=lb)
        assert torch.equal(info_lb.log_probs, info.log_probs) and torch.equal(info_lb.index, info.index)
    vm = site.vmap(in_axes=(0,))
    tr2, _ = vm.generate(torch.Generator().manual_seed(0), g.C[torch.arange(4), "y"].set(XS), (XS,))
    _, info2 = enumerative_gibbs_vmap(torch.Generator().manual_seed(1), tr2, (None, "z"), torch.arange(3))
    _close(info2.log_probs, EXACT_LANES)
    with pytest.raises(ValueError, match="exactly one None"):
        enumerative_gibbs_vmap(torch.Generator(), tr, ("assign", "z"), torch.arange(3))


def test_index_request_into_a_vmap_inside_gen_matches_reference():
    """The repair this slice needed: the handler-only edit passed a changed
    argdiff to every sub-edit, so an ``IndexRequest`` into a vmap inside a
    ``@gen`` body raised; on the clean prefix the arguments are unchanged."""
    tr = _vmapped_trace()
    zs = tr.get_choices()["assign", torch.arange(4), "z"]
    zs = (zs.value if isinstance(zs, g.Mask) else zs).numpy()
    req = g.StaticRequest.d({"assign": g.IndexRequest(2, g.Update(g.C["z"].set(0)))})
    new, w, _rd, _bwd = tr.edit(torch.Generator(), req)

    @gj.gen
    def r_site(x):
        z = gj.categorical(R_LOG_PI) @ "z"
        return gj.normal(R_MUS[z], 1.0) @ "y"

    @gj.gen
    def r_vmapped_model(xs):
        return r_site.vmap(in_axes=(0,))(xs) @ "assign"

    xs = jnp.asarray(XS.numpy())
    r_tr, _ = r_vmapped_model.generate(
        jr.key(0), gj.C["assign", jnp.arange(4), "y"].set(xs) | gj.C["assign", jnp.arange(4), "z"].set(
            jnp.asarray(zs)), (xs,))
    r_req = gj.StaticRequest.d({"assign": gj.IndexRequest(jnp.asarray(2), gj.Update(gj.C["z"].set(0)))})
    _, r_w, _, _ = r_tr.edit(jr.key(1), r_req)
    _close(w, r_w)
    _close(w, EXACT_LANES[2][0] - EXACT_LANES[2][zs[2]])


def mixed_exact(x_obs):
    """z marginalized, mu conjugate in each branch."""
    lw = np.array([np.log(0.7) + norm.logpdf(x_obs, 0.0, np.sqrt(2.0)),
                   np.log(0.3) + norm.logpdf(x_obs, 2.0, np.sqrt(2.0))])
    p = np.exp(lw - logsumexp(lw))
    return p, float(p @ np.array([x_obs / 2.0, (x_obs - 2.0) / 2.0]))


@g.gen
def mixed_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    z = g.flip(0.3) @ "z"
    return g.normal(mu + 2.0 * z.to(torch.float32), 1.0) @ "x"


def test_gibbs_within_mh_sweep_in_law_vmapped_over_chains():
    p_z, mu_mean = mixed_exact(1.4)
    gen = torch.Generator().manual_seed(1)
    moves = [enum_move("z", torch.tensor([False, True])), mh_move(HMC(g.S["mu"], 0.25, 8))]
    n_chains, n_sweeps, burn = 512, 40, 10

    def chain(_):
        tr, _ = mixed_model.generate(gen, g.C["x"].set(1.4), ())
        res = gibbs_sweep(gen, tr, moves, n_sweeps=n_sweeps,
                          record=lambda t: (t.get_choices()["z"].to(torch.float32), t.get_choices()["mu"]))
        return res.history

    zs, mus = torch.func.vmap(chain, randomness="different")(torch.zeros(n_chains))
    assert tuple(zs.shape) == (n_chains, n_sweeps)
    for draws, want in ((zs, p_z[1]), (mus, mu_mean)):
        means = draws[:, burn:].double().mean(dim=1)
        se = float(means.std() / np.sqrt(n_chains))
        assert abs(float(means.mean()) - want) < 4 * se, (float(means.mean()), want, se)


def test_sweep_history_of_a_vmap_move():
    res = gibbs_sweep(torch.Generator().manual_seed(1), _vmapped_trace(),
                      [enum_vmap_move(("assign", None, "z"), torch.arange(3), n_lanes=4)], n_sweeps=10,
                      record=lambda t: t.get_choices()["assign", torch.arange(4), "z"])
    hist = res.history.value if isinstance(res.history, g.Mask) else res.history
    assert tuple(hist.shape) == (10, 4)
    assert gibbs_sweep(torch.Generator(), _vmapped_trace(), [], n_sweeps=2).history is None

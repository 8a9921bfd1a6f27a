"""SMC and GenSP (``inference/sp.py``, ``inference/smc.py``,
``parallel/smc.py``) against ``genjax_tpu`` and exact answers.

Deterministic parts to 1e-5 against the reference on the same choices:
``Target.importance`` weights, ``ChangeTarget``'s reweights of a collection
whose particles are given, ``Marginal.estimate_logpdf`` without an
algorithm under a full choice map. In law, the counterparts of
``tests/inference/test_smc.py`` with its tolerances and particle counts (the
exact-HMM test's counterpart holds ``ImportanceK`` on the scanned
linear-Gaussian SSM against its Kalman log marginal), and of
``tests/parallel/test_parallel.py::test_single_device_matches_kalman``.
Routing: the entry points raise naming ``device="cpu"`` without a card,
and ``run_sharded`` names its roadmap item.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference import ChangeTarget as RefChangeTarget
from genjax_tpu.inference import ImportanceK as RefImportanceK
from genjax_tpu.inference import Target as RefTarget
from genjax_tpu_torch.dists import LGSSMParams, LinearGaussianSSM
from genjax_tpu_torch.inference import ChangeTarget, Importance, ImportanceK, Marginal, Target
from genjax_tpu_torch.models import linear_gaussian_ssm
from genjax_tpu_torch.parallel import SSMParticleFilter
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
LOG_HALF = math.log(0.5)


@g.gen
def flip_model():
    p = g.beta(2.0, 2.0) @ "p"
    return g.flip(p) @ "v"


@gj.gen
def ref_flip_model():
    p = gj.beta(2.0, 2.0) @ "p"
    return gj.flip(p) @ "v"


def _ps(n=7, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.95, size=n).astype(np.float32)


def test_target_importance_weights_match_reference():
    t = Target(flip_model, (), g.C["v"].set(True))
    rt = RefTarget(ref_flip_model, (), gj.C["v"].set(True))
    gen = torch.Generator().manual_seed(0)
    for p in _ps():
        tr, w = t.importance(gen, g.C["p"].set(float(p)))
        _, rw = rt.importance(jax.random.key(0), gj.C["p"].set(p))
        assert abs(float(w) - float(rw)) <= TOL * (1 + abs(float(rw)))
        assert float(tr.get_choices()["p"]) == pytest.approx(float(p))


def test_change_target_reweights_match_reference():
    """Particles given by their ``p``: the reweight to ``v = False`` of each
    is ``new weight - old score + old weight``, as the reference's."""
    ps = _ps(9, 1)
    t1, t2 = Target(flip_model, (), g.C["v"].set(True)), Target(flip_model, (), g.C["v"].set(False))
    rt1, rt2 = RefTarget(ref_flip_model, (), gj.C["v"].set(True)), RefTarget(ref_flip_model, (), gj.C["v"].set(False))
    gen = torch.Generator().manual_seed(0)
    trs, ws = torch.func.vmap(lambda p: t1.importance(gen, g.C["p"].set(p)), randomness="different")(
        torch.from_numpy(ps))
    coll = g.ParticleCollection(trs, ws, torch.tensor(True))
    new = ChangeTarget(ImportanceK(t1, k_particles=9), t2)._reweight_collection(gen, coll)
    keys = jax.random.split(jax.random.key(0), 9)
    rtrs, rws = jax.vmap(lambda k, p: rt1.importance(k, gj.C["p"].set(p)))(keys, jnp.asarray(ps))
    rcoll = gj.ParticleCollection(rtrs, rws, jnp.asarray(True))
    rnew = RefChangeTarget(RefImportanceK(rt1, k_particles=9), rt2)._reweight_collection(jax.random.key(1), rcoll)
    np.testing.assert_allclose(new.get_log_weights().numpy(), np.asarray(rnew.get_log_weights()), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(new.get_particles().get_choices()["p"].numpy(), ps, rtol=1e-6)


def test_marginal_estimate_logpdf_without_algorithm_matches_reference():
    m = flip_model.marginal(selection=g.S["v"])
    rm = ref_flip_model.marginal(selection=gj.S["v"])
    for p in _ps(4, 2):
        for v in (True, False):
            got = m.estimate_logpdf(torch.Generator().manual_seed(0), g.C["p"].set(float(p)) | g.C["v"].set(v))
            want = rm.estimate_logpdf(jax.random.key(0), gj.C["p"].set(p) | gj.C["v"].set(v))
            assert abs(float(got) - float(want)) <= TOL * (1 + abs(float(want)))
    assert g.marginal(g.S["v"])(flip_model) == Marginal(flip_model, g.Const(g.S["v"]), g.Const(None))


# ----- in law: tests/inference/test_smc.py -----

def test_importance_k_convergence():
    target = Target(flip_model, (), g.C["v"].set(True))
    for k, tol in [(10, 3e-1), (100, 1e-1), (1000, 5e-2)]:
        logz = ImportanceK(target, k_particles=k).run_smc(314159, device="cpu").get_log_marginal_likelihood_estimate()
        assert float(logz) == pytest.approx(LOG_HALF, abs=tol), k


def test_importance_one_particle_averages_to_the_marginal():
    target = Target(flip_model, (), g.C["v"].set(True))
    alg = Importance(target)
    gen = torch.Generator().manual_seed(0)
    logzs = torch.stack([alg.run_smc(gen, device="cpu").get_log_marginal_likelihood_estimate()
                         for _ in range(2000)])
    assert float(torch.logsumexp(logzs, 0) - math.log(2000)) == pytest.approx(LOG_HALF, abs=2e-2)


def test_random_weighted_is_posterior_sample():
    target = Target(flip_model, (), g.C["v"].set(True))
    alg = ImportanceK(target, k_particles=100)
    w, chm = alg.random_weighted(torch.Generator().manual_seed(0), target)
    p = chm["p"]
    p = p.unmask() if isinstance(p, g.Mask) else p
    assert 0.0 < float(p) < 1.0 and torch.isfinite(w)
    assert not chm.get_submap("v").has_value()
    lp = ImportanceK(target, k_particles=50).estimate_logpdf(torch.Generator().manual_seed(1), chm, target)
    assert torch.isfinite(lp)
    ess = alg.run_smc(0, device="cpu").effective_sample_size()
    assert 1.0 <= float(ess) <= 100.0


def test_change_target_in_law():
    t1, t2 = Target(flip_model, (), g.C["v"].set(True)), Target(flip_model, (), g.C["v"].set(False))
    same = ChangeTarget(ImportanceK(t1, k_particles=500), t1).run_smc(314159, device="cpu")
    assert float(same.get_log_marginal_likelihood_estimate()) == pytest.approx(LOG_HALF, abs=5e-2)
    other = ChangeTarget(ImportanceK(t1, k_particles=1000), t2).run_smc(314159, device="cpu")
    assert float(other.get_log_marginal_likelihood_estimate()) == pytest.approx(LOG_HALF, abs=5e-2)
    est = ImportanceK(t1, k_particles=1000).log_marginal_likelihood_estimate(0, t2, device="cpu")
    assert float(est) == pytest.approx(LOG_HALF, abs=5e-2)


def test_marginal_with_algorithm():
    alg = ImportanceK(Target(flip_model, (), g.C["v"].set(True)), k_particles=200)
    m = Marginal(flip_model, g.Const(g.S["v"]), g.Const(alg))
    gen = torch.Generator().manual_seed(0)
    lps = torch.func.vmap(lambda _: m.estimate_logpdf(gen, g.C["v"].set(True)), randomness="different")(
        torch.zeros(200))
    assert float(torch.logsumexp(lps, 0) - math.log(200)) == pytest.approx(LOG_HALF, abs=5e-2)
    w, chm = m.random_weighted(gen)
    assert torch.isfinite(w) and chm["v"] is not None


def test_importance_k_with_a_proposal_and_csmc():
    """A proposal ``q`` (another algorithm over the target: nested SMC) and
    the conditional SMC of a retained particle: estimates stay at log 1/2."""
    target = Target(flip_model, (), g.C["v"].set(True))
    q = ImportanceK(target, k_particles=5)
    est = ImportanceK(target, q=q, k_particles=1000).run_smc(1, device="cpu")
    assert float(est.get_log_marginal_likelihood_estimate()) == pytest.approx(LOG_HALF, abs=5e-2)
    coll = ImportanceK(target, k_particles=1000).run_csmc(2, g.C["p"].set(0.25), device="cpu")
    assert float(coll.get_particle(-1).get_choices()["p"]) == pytest.approx(0.25)
    assert float(coll.get_log_marginal_likelihood_estimate()) == pytest.approx(LOG_HALF, abs=5e-2)
    recip = ImportanceK(target, k_particles=1000).estimate_reciprocal_normalizing_constant(
        3, target, g.C["p"].set(0.25), torch.tensor(0.0), device="cpu")
    assert torch.isfinite(recip)


def test_ssm_log_z_matches_kalman_oracle():
    """``ImportanceK`` over the scanned linear-Gaussian SSM (T = 5) against
    the Kalman log marginal of ``dists.LinearGaussianSSM`` (the
    reference's counterpart uses its exact HMM testbed; abs 0.15 as there)."""
    kernel, exact = linear_gaussian_ssm()
    T = 5
    ys = torch.from_numpy(np.random.default_rng(4).normal(size=T).astype(np.float32))
    target = Target(kernel.scan(n=T), (0.0, None), g.C[:, "y"].set(ys))
    est = ImportanceK(target, k_particles=2000).run_smc(314159, device="cpu").get_log_marginal_likelihood_estimate()
    oracle = LinearGaussianSSM.data_logpdf(LGSSMParams.scalar(1.0, 1.0, 1.0, 0.25, 0.0, 1.0), ys[:, None])
    assert float(oracle) == pytest.approx(exact(ys.tolist()), abs=1e-4)
    assert float(est) == pytest.approx(float(oracle), abs=0.15)


# ----- the particle filter: tests/parallel/test_parallel.py -----

def test_particle_filter_matches_kalman():
    kernel, exact = linear_gaussian_ssm()
    T = 10
    ys = torch.sin(torch.linspace(0, 2, T))
    pf = SSMParticleFilter(kernel, n_particles=4096)
    res = pf.run(314159, 0.0, torch.zeros(T), g.C[:, "y"].set(ys), device="cpu")
    assert float(res.log_marginal) == pytest.approx(exact(ys.tolist()), abs=0.1)
    assert tuple(res.carries.shape) == (4096,) and tuple(res.ess_history.shape) == (T,)
    assert bool((res.ess_history <= 4096.0 + 1e-3).all()) and bool((res.ess_history >= 1.0).all())
    # n_steps when xs is None; a resample fired (weights reset) on some step
    res2 = pf.run(1, 0.0, None, g.C[:, "y"].set(ys), n_steps=T, device="cpu")
    assert float(res2.log_marginal) == pytest.approx(exact(ys.tolist()), abs=0.1)
    assert bool((res.ess_history < 0.5 * 4096).any())


@pytest.mark.parametrize("method", ["stratified", "multinomial", "residual"])
def test_particle_filter_other_methods(method):
    kernel, exact = linear_gaussian_ssm()
    ys = torch.ones(6)
    pf = SSMParticleFilter(kernel, n_particles=2048, method=method)
    res = pf.run(0, 0.0, torch.zeros(6), g.C[:, "y"].set(ys), device="cpu")
    assert float(res.log_marginal) == pytest.approx(exact(ys.tolist()), abs=0.15)


def test_entry_points_default_to_the_card():
    """Without a card every entry point that makes particles raises naming
    ``device='cpu'`` with its defaults; a generator on another device than
    the one asked for raises; ``run_sharded`` checks that its particles
    divide over the mesh axis."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    kernel, _ = linear_gaussian_ssm()
    target = Target(flip_model, (), g.C["v"].set(True))
    calls = [
        lambda: SSMParticleFilter(kernel, n_particles=8).run(0, 0.0, torch.zeros(2), g.C[:, "y"].set(torch.zeros(2))),
        lambda: ImportanceK(target, k_particles=4).run_smc(0),
        lambda: ImportanceK(target, k_particles=4).run_csmc(0, g.C["p"].set(0.5)),
        lambda: ImportanceK(target, k_particles=4).log_marginal_likelihood_estimate(0),
        lambda: ImportanceK(target, k_particles=4).estimate_normalizing_constant(0, target),
        lambda: Importance(target).run_smc(0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(ValueError, match="generator lives on cpu"):
        ImportanceK(target, k_particles=4).run_smc(torch.Generator(), device="meta")
    class ThreeRanks:
        def axis_size(self, axis):
            return 3

    with pytest.raises(ValueError, match="must divide over 3 shards"):
        SSMParticleFilter(kernel, n_particles=8).run_sharded(0, 0.0, torch.zeros(2), g.C[:, "y"].set(torch.zeros(2)),
                                                             ThreeRanks())

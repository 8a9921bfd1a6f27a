"""SMC under a key, draw for draw against ``genjax_tpu``: the draws, the
resamplers, importance sampling and GenSP, the particle filters.

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` (both
threefry2x32, and the rbg kind) drive the port's and the reference's SMC
entry points to the same draws:

- ``keys.categorical`` and ``keys.gumbel`` are ``jax.random``'s, with a
  prefix shape, made in slices of its leading axis, and under ``vmap``
  (where an rbg draw takes the first lane's key, as JAX's batching rule
  does);
- the keyed resamplers sum the CDF in XLA's association and draw the
  reference's indices;
- F8: ``ImportanceK``'s ``random_weighted`` and ``estimate_logpdf`` split
  their key as the reference does (they gave every particle the same key);
- ``Importance``, ``ImportanceK``, ``ChangeTarget``, ``Marginal``,
  ``SSMParticleFilter.run``, ``ffbs`` and ``rbpf`` follow the reference's
  splits;
- the audit: every public SMC-family entry point either draws the
  reference's draw under ``key(0)`` or raises ``GFITypeError``.

Indices are equal; weights, scores and log marginals within rtol 1e-5
(atol 1e-6), choices within 1e-5. ``tests/test_torch_keys_population.py``
holds tempered SMC, particle Gibbs and the population drivers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.dists import LGSSMParams as RLGSSMParams
from genjax_tpu.dists import LinearGaussianSSM as RLinearGaussianSSM
from genjax_tpu.dists import ffbs as rffbs
from genjax_tpu.generative.choice_map import ChoiceMap as RChoiceMap
from genjax_tpu.inference import Importance as RImportance
from genjax_tpu.inference import ImportanceK as RImportanceK
from genjax_tpu.inference import Target as RTarget
from genjax_tpu.inference.smc import ChangeTarget as RChangeTarget
from genjax_tpu.inference.sp import marginal as rmarginal
from genjax_tpu.models import linear_gaussian_ssm as rlinear_gaussian_ssm
from genjax_tpu.parallel import SSMParticleFilter as RSSMParticleFilter
from genjax_tpu.parallel import rbpf as rrbpf
from genjax_tpu.parallel import resampling as rresampling
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.dists import LGSSMParams, LinearGaussianSSM, ffbs
from genjax_tpu_torch.generative.choice_map import ChoiceMap
from genjax_tpu_torch.generative.typecheck import GFITypeError
from genjax_tpu_torch.inference import Importance, ImportanceK, Target
from genjax_tpu_torch.inference.smc import ChangeTarget
from genjax_tpu_torch.inference.sp import marginal
from genjax_tpu_torch.models import linear_gaussian_ssm
from genjax_tpu_torch.parallel import SSMParticleFilter, rbpf, sharded_importance
from genjax_tpu_torch.parallel import resampling
from genjax_tpu_torch.parallel.resampling import collective_resample
from torch_threads import _one_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
#: key(0), key(42) and an rbg key: (seed, impl)
KEYS = [(0, "threefry2x32"), (42, "threefry2x32"), (0, "rbg")]
KEY_IDS = ["key0", "key42", "rbg"]


def tk(seed, impl="threefry2x32"):
    return keys.key(seed, device="cpu", impl=impl)


def jk(seed, impl="threefry2x32"):
    return jax.random.key(seed, impl=impl)


def close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


def equal(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))


def distinct(x) -> bool:
    """Not every particle alike (F8 gave them one key)."""
    x = x.detach().reshape(x.shape[0], -1)
    return bool((x != x[:1]).any())


@g.gen
def model():
    mu = g.normal(0.0, 1.0) @ "mu"
    g.normal(mu, 0.5) @ "y"


@gj.gen
def model_ref():
    mu = gj.normal(0.0, 1.0) @ "mu"
    gj.normal(mu, 0.5) @ "y"


def targets(y=1.0):
    return Target(model, (), g.C["y"].set(y)), RTarget(model_ref, (), gj.C["y"].set(y))


# ----------------------------------------------------------------------
# the draws: categorical and gumbel
# ----------------------------------------------------------------------

LOGITS = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)


@pytest.mark.parametrize("axis,shape", [(-1, None), (-1, (3, 5)), (0, (2, 7)), (-1, (40, 5))])
@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_categorical_draws_jax_random_categorical(seed, impl, axis, shape):
    want = jax.random.categorical(jk(seed, impl), jnp.asarray(LOGITS), axis=axis, shape=shape)
    got = keys.categorical(tk(seed, impl), torch.from_numpy(LOGITS), axis=axis, shape=shape)
    equal(got, want)
    assert got.dtype == torch.int64


@pytest.mark.parametrize("chunk", [3, 1000])
@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_a_large_categorical_draw_is_made_in_slices_that_draw_the_same(seed, impl, chunk, monkeypatch):
    logits = np.random.default_rng(1).normal(size=257).astype(np.float32)
    want = jax.random.categorical(jk(seed, impl), jnp.asarray(logits), shape=(301,))
    monkeypatch.setattr(keys, "CATEGORICAL_CHUNK", chunk)
    equal(keys.categorical(tk(seed, impl), torch.from_numpy(logits), shape=(301,)), want)


@pytest.mark.parametrize("chunk", [2**22, 20])
@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_draws_under_vmap_follow_jax_vmap(seed, impl, chunk, monkeypatch):
    """Under ``vmap`` over split keys a threefry lane draws under its own
    key, and an rbg lane takes its block of the first lane's key's draw
    (``rng_bit_generator``'s batching rule), also in slices."""
    monkeypatch.setattr(keys, "CATEGORICAL_CHUNK", chunk)
    jks, tks = jax.random.split(jk(seed, impl), 3), keys.split(tk(seed, impl), 3)
    logits = LOGITS[0]
    want = jax.vmap(lambda k: jax.random.categorical(k, jnp.asarray(logits), shape=(9,)))(jks)
    got = torch.func.vmap(lambda k: keys.categorical(k, torch.from_numpy(logits), shape=(9,)))(tks)
    equal(got, want)
    jks2, tks2 = jax.random.split(jk(seed, impl), (2, 3)), keys.split(tk(seed, impl), (2, 3))
    want = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (4,))))(jks2)
    got = torch.func.vmap(torch.func.vmap(lambda k: keys.normal(k, (4,))))(tks2)
    close(got, want)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_gumbel_draws_jax_random_gumbel(seed, impl):
    close(keys.gumbel(tk(seed, impl), (4, 6)), jax.random.gumbel(jk(seed, impl), (4, 6)), tol=1e-6)


# ----------------------------------------------------------------------
# the resamplers
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 16, 17, 300, 4097])
def test_the_keyed_cdf_sums_in_xlas_association(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    equal(resampling._xla_cumsum(torch.from_numpy(x)).numpy().view(np.int32), np.asarray(jnp.cumsum(x)).view(np.int32))


def log_weights(n, scale, seed=3):
    return (np.random.default_rng(seed).normal(size=n) * scale).astype(np.float32)


METHODS = ["systematic", "stratified", "multinomial", "residual"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seed,impl,n,scale", [(0, "threefry2x32", 64, 1.0), (0, "threefry2x32", 256, 4.0),
                                               (42, "threefry2x32", 256, 1.0), (0, "rbg", 256, 4.0)],
                         ids=["key0-64", "key0-256", "key42-256", "rbg-256"])
def test_resampled_indices_are_the_references(seed, impl, method, n, scale):
    lw = log_weights(n, scale)
    want = rresampling.resample_indices(jk(seed, impl), jnp.asarray(lw), n, method)
    equal(resampling.resample_indices(tk(seed, impl), torch.from_numpy(lw), n, method), want)
    if method in ("systematic", "stratified"):
        counts = {"systematic": resampling.systematic_counts, "stratified": resampling.stratified_counts}[method]
        rcounts = {"systematic": rresampling.systematic_counts, "stratified": rresampling.stratified_counts}[method]
        equal(counts(tk(seed, impl), torch.from_numpy(lw), n), rcounts(jk(seed, impl), jnp.asarray(lw), n))
    particles = {"a": np.arange(n, dtype=np.float32), "b": np.arange(2 * n, dtype=np.float32).reshape(n, 2)}
    got = resampling.resample_particles(tk(seed, impl), {k: torch.from_numpy(v) for k, v in particles.items()},
                                        torch.from_numpy(lw), n, method)
    want = rresampling.resample_particles(jk(seed, impl), {k: jnp.asarray(v) for k, v in particles.items()},
                                          jnp.asarray(lw), n, method)
    close(got["a"], want["a"])
    close(got["b"], want["b"])


def test_an_int_seed_still_seeds_a_generator():
    lw = torch.from_numpy(log_weights(64, 2.0))
    assert torch.equal(resampling.resample_indices(torch.Generator().manual_seed(3), lw, 64, "multinomial"),
                       resampling.resample_indices(torch.Generator().manual_seed(3), lw, 64, "multinomial"))
    k, _ = targets()
    alg = ImportanceK(k, k_particles=16)
    a = alg.run_smc(5, device="cpu").get_log_weights()
    b = alg.run_smc(torch.Generator().manual_seed(5), device="cpu").get_log_weights()
    assert torch.equal(a, b)


# ----------------------------------------------------------------------
# F8 and importance sampling
# ----------------------------------------------------------------------


def test_importance_k_gensp_methods_split_the_key_as_the_reference_does():
    """F8: ``random_weighted`` and ``estimate_logpdf`` handed one key to all
    K particles (``_vmap`` over ``_lanes(gen, k)`` read only the key's
    device), so the eight particles were one: ``(-1.4230, mu = 1.0040)``
    and ``-1.3097``. They split the key as the reference does."""
    target, rtarget = targets()
    alg, ralg = ImportanceK(target, k_particles=8), RImportanceK(rtarget, k_particles=8)
    w, chm = alg.random_weighted(tk(0), target)
    close(w, 0.21636498)
    close(chm["mu"], 0.52784866)
    rw, rchm = ralg.random_weighted(jk(0), rtarget)
    close(w, rw)
    close(chm["mu"], rchm["mu"])
    est = alg.estimate_logpdf(tk(0), g.C["mu"].set(0.3), target)
    close(est, -0.3768115)
    close(est, ralg.estimate_logpdf(jk(0), gj.C["mu"].set(0.3), rtarget))
    # eight distinct particles, the reference's
    col = ChangeTarget(alg, target)._run_smc(keys.split(tk(0))[0])
    rcol = RChangeTarget(ralg, rtarget).run_smc(jax.random.split(jk(0))[0])
    mus = col.get_particles().get_choices()["mu"]
    assert len(set(mus.tolist())) == 8
    close(mus, rcol.get_particles().get_choices()["mu"])


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_importance_and_change_target_split_as_the_reference(seed, impl):
    target, rtarget = targets(0.7)
    other, rother = targets(-0.2)
    k = 16
    cases = [(ImportanceK(target, k_particles=k), RImportanceK(rtarget, k_particles=k)),
             (ImportanceK(target, q=Importance(target), k_particles=k),
              RImportanceK(rtarget, q=RImportance(rtarget), k_particles=k))]
    for alg, ralg in cases:
        col, rcol = alg.run_smc(tk(seed, impl), device="cpu"), ralg.run_smc(jk(seed, impl))
        close(col.get_log_weights(), rcol.get_log_weights())
        close(col.get_particles().get_choices()["mu"], rcol.get_particles().get_choices()["mu"])
        assert distinct(col.get_particles().get_choices()["mu"])
        close(alg.log_marginal_likelihood_estimate(tk(seed, impl), other, device="cpu"),
              ralg.log_marginal_likelihood_estimate(jk(seed, impl), rother))
        close(alg.estimate_normalizing_constant(tk(seed, impl), other, device="cpu"),
              ralg.estimate_normalizing_constant(jk(seed, impl), rother))
        close(col.sample_particle(tk(seed + 1, impl)).get_choices()["mu"],
              rcol.sample_particle(jk(seed + 1, impl)).get_choices()["mu"])
    alg, ralg = cases[0]
    col = alg.run_csmc(tk(seed, impl), g.C["mu"].set(0.25), device="cpu")
    rcol = ralg.run_csmc(jk(seed, impl), gj.C["mu"].set(0.25))
    close(col.get_log_weights(), rcol.get_log_weights())
    close(alg.estimate_reciprocal_normalizing_constant(tk(seed, impl), other, g.C["mu"].set(0.25),
                                                       torch.tensor(-1.5), device="cpu"),
          ralg.estimate_reciprocal_normalizing_constant(jk(seed, impl), rother, gj.C["mu"].set(0.25),
                                                        jnp.asarray(-1.5)))
    close(ChangeTarget(alg, other).run_csmc_for_normalizing_constant(tk(seed, impl), g.C["mu"].set(0.1),
                                                                     torch.tensor(-1.0), device="cpu"),
          RChangeTarget(ralg, rother).run_csmc_for_normalizing_constant(jk(seed, impl), gj.C["mu"].set(0.1),
                                                                        jnp.asarray(-1.0)))
    one, rone = Importance(target, q=Importance(target)), RImportance(rtarget, q=RImportance(rtarget))
    close(one.run_smc(tk(seed, impl), device="cpu").get_log_weights(), rone.run_smc(jk(seed, impl)).get_log_weights())
    close(one.run_csmc(tk(seed, impl), g.C["mu"].set(0.4), device="cpu").get_log_weights(),
          rone.run_csmc(jk(seed, impl), gj.C["mu"].set(0.4)).get_log_weights())


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_marginal_splits_its_key_as_the_reference(seed, impl):
    """``Marginal.random_weighted`` splits its key in three (the simulation,
    the projection, the nested algorithm), as the reference's does."""
    target, rtarget = targets()
    plain, rplain = marginal(g.S["mu"])(model), rmarginal(gj.S["mu"])(model_ref)
    nested = marginal(g.S["mu"], ImportanceK(target, k_particles=8))(model)
    rnested = rmarginal(gj.S["mu"], RImportanceK(rtarget, k_particles=8))(model_ref)
    for m, rm in ((plain, rplain), (nested, rnested)):
        w, chm = m.random_weighted(tk(seed, impl))
        rw, rchm = rm.random_weighted(jk(seed, impl))
        close(w, rw)
        close(chm["mu"], rchm["mu"])
        close(m.estimate_logpdf(tk(seed, impl), g.C["mu"].set(0.3)),
              rm.estimate_logpdf(jk(seed, impl), gj.C["mu"].set(0.3)))
    tr, w = target.importance(tk(seed, impl), ChoiceMap.empty())
    rtr, rw = rtarget.importance(jk(seed, impl), RChoiceMap.empty())
    close(tr.get_choices()["mu"], rtr.get_choices()["mu"])
    close(w, rw)


# ----------------------------------------------------------------------
# the particle filters, ffbs
# ----------------------------------------------------------------------

T = 20
YS = np.random.default_rng(4).normal(size=T).astype(np.float32)


@pytest.mark.parametrize("seed,impl,method", [(0, "threefry2x32", m) for m in METHODS]
                         + [(42, "threefry2x32", "systematic"), (0, "rbg", "stratified")],
                         ids=[f"key0-{m}" for m in METHODS] + ["key42-systematic", "rbg-stratified"])
def test_the_particle_filter_is_the_references(seed, impl, method):
    kernel, _ = linear_gaussian_ssm()
    rkernel, _ = rlinear_gaussian_ssm()
    res = SSMParticleFilter(kernel, n_particles=256, method=method).run(
        tk(seed, impl), 0.0, torch.zeros(T), g.C[:, "y"].set(torch.from_numpy(YS)), device="cpu")
    want = RSSMParticleFilter(rkernel, n_particles=256, method=method).run(
        jk(seed, impl), 0.0, jnp.zeros(T), gj.C[:, "y"].set(jnp.asarray(YS)))
    close(res.log_marginal, want.log_marginal)
    close(res.ess_history, want.ess_history, tol=1e-4)
    close(res.carries, want.carries)
    close(res.log_weights, want.log_weights)
    assert distinct(res.carries)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_ffbs_draws_the_references_path(seed, impl):
    rng = np.random.default_rng(2)
    A, Q = (0.9 * np.eye(2)).astype(np.float32), (0.1 * np.eye(2)).astype(np.float32)
    C, R = rng.normal(size=(1, 2)).astype(np.float32), np.array([[0.2]], np.float32)
    mu0, P0 = np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
    ys = rng.normal(size=(6, 1)).astype(np.float32)
    params = LGSSMParams(*(torch.from_numpy(v) for v in (A, Q, C, R, mu0, P0)))
    rparams = RLGSSMParams(*(jnp.asarray(v) for v in (A, Q, C, R, mu0, P0)))
    zs, lm = ffbs(tk(seed, impl), params, torch.from_numpy(ys))
    rzs, rlm = rffbs(jk(seed, impl), rparams, jnp.asarray(ys))
    close(zs, rzs)
    close(lm, rlm)
    w, v = LinearGaussianSSM.random_weighted(tk(seed, impl), params, torch.from_numpy(ys))
    rw, rv = RLinearGaussianSSM.random_weighted(jk(seed, impl), rparams, jnp.asarray(ys))
    close(v, rv)
    close(w, rw, tol=1e-4)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_rbpf_is_the_references(seed, impl):
    """A two-regime switching random walk: the regime flips with
    probability 0.2, its observation noise 0.3 or 1.0."""
    ys = np.random.default_rng(5).normal(size=(12, 1)).astype(np.float32)

    def matrices(u, xp):
        one = xp.eye(1, dtype=xp.float32)
        return one, 0.5 * one, one, (0.3 + 0.7 * u.astype(xp.float32) if xp is jnp else
                                     0.3 + 0.7 * u.to(torch.float32)) * one

    def sample_regime(k, u_prev, t):
        return torch.where(keys.uniform(k) < 0.2, 1 - u_prev, u_prev)

    def rsample_regime(k, u_prev, t):
        return jnp.where(jax.random.uniform(k) < 0.2, 1 - u_prev, u_prev)

    tmat = type("xp", (), {"eye": staticmethod(lambda n, dtype: torch.eye(n)), "float32": torch.float32})
    res = rbpf(tk(seed, impl), sample_regime, lambda u: matrices(u, tmat), torch.from_numpy(ys), n_particles=64,
               init_regime=torch.tensor(0), mu0=torch.zeros(1), P0=torch.eye(1), device="cpu")
    want = rrbpf(jk(seed, impl), rsample_regime, lambda u: matrices(u, jnp), jnp.asarray(ys), n_particles=64,
                 init_regime=jnp.asarray(0), mu0=jnp.zeros(1), P0=jnp.eye(1))
    equal(res.regimes, want.regimes)
    close(res.log_marginal, want.log_marginal)
    close(res.means, want.means)


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------


def _audit_cases():
    """Each public entry point of this file's modules under ``key(0)``:
    ``(port call, reference call, what to compare)``, or ``(port call,
    None, None)`` for one that raises ``GFITypeError``. The population
    drivers' audit is in ``test_torch_keys_population.py``."""
    target, rtarget = targets()
    alg, ralg = ImportanceK(target, k_particles=8), RImportanceK(rtarget, k_particles=8)
    kernel, _ = linear_gaussian_ssm()
    rkernel, _ = rlinear_gaussian_ssm()
    ys = torch.from_numpy(YS[:6])
    lw = log_weights(32, 1.0)
    pf = SSMParticleFilter(kernel, n_particles=32)
    mus = lambda col: col.get_particles().get_choices()["mu"]  # noqa: E731
    cases = {
        "keys.categorical": (lambda k: keys.categorical(k, torch.from_numpy(lw), shape=(32,)),
                             lambda k: jax.random.categorical(k, jnp.asarray(lw), shape=(32,)), lambda x: x),
        "keys.gumbel": (lambda k: keys.gumbel(k, (8,)), lambda k: jax.random.gumbel(k, (8,)), lambda x: x),
        "ImportanceK.run_smc": (lambda k: alg.run_smc(k, device="cpu"), ralg.run_smc, mus),
        "ImportanceK.run_csmc": (lambda k: alg.run_csmc(k, g.C["mu"].set(0.1), device="cpu"),
                                 lambda k: ralg.run_csmc(k, gj.C["mu"].set(0.1)), mus),
        "ImportanceK.random_weighted": (lambda k: alg.random_weighted(k, target)[1]["mu"],
                                        lambda k: ralg.random_weighted(k, rtarget)[1]["mu"], lambda x: x),
        "SSMParticleFilter.run": (lambda k: pf.run(k, 0.0, torch.zeros(6), g.C[:, "y"].set(ys), device="cpu"),
                                  lambda k: RSSMParticleFilter(rkernel, n_particles=32).run(
                                      k, 0.0, jnp.zeros(6), gj.C[:, "y"].set(jnp.asarray(YS[:6]))),
                                  lambda r: r.carries),
    }
    for method in ("systematic", "stratified", "multinomial", "residual"):
        cases[f"resample_indices({method})"] = (
            lambda k, m=method: resampling.resample_indices(k, torch.from_numpy(lw), 32, m),
            lambda k, m=method: rresampling.resample_indices(k, jnp.asarray(lw), 32, m), lambda x: x)
    cases["SSMParticleFilter.run_sharded"] = (
        lambda k: pf.run_sharded(k, 0.0, torch.zeros(6), g.C[:, "y"].set(ys), None), None, None)
    cases["sharded_importance"] = (lambda k: sharded_importance(lambda gg: target.importance(gg, ChoiceMap.empty()), k, 8, None),
                                   None, None)
    cases["collective_resample"] = (lambda k: collective_resample(k, torch.zeros(8), torch.zeros(8), None), None, None)
    return cases


@pytest.mark.parametrize("name", list(_audit_cases()))
def test_audit_every_entry_point_draws_the_references_draw_or_raises(name):
    call, rcall, view = _audit_cases()[name]
    if rcall is None:
        with pytest.raises(GFITypeError, match="torch.Generator"):
            call(tk(0))
        return
    got, want = view(call(tk(0))), view(rcall(jk(0)))
    if got.dtype == torch.int64:
        equal(got, want)
    else:
        close(got, want)
    if got.dim() >= 1 and got.shape[0] > 1:
        assert distinct(got), f"{name}: every particle alike"


def test_a_key_that_reaches_a_generator_only_entry_raises_a_type_error():
    from genjax_tpu_torch.core.device import chain_generator

    with pytest.raises(TypeError, match="key"):
        chain_generator(tk(0), torch.device("cpu"), "an entry")


def test_the_filters_math_is_exact_in_law():
    """A sanity check of the keyed filter against the Kalman filter's
    exact log marginal, over eight keys at 512 particles."""
    kernel, exact = linear_gaussian_ssm()
    pf = SSMParticleFilter(kernel, n_particles=512)
    lzs = [float(pf.run(keys.fold_in(tk(1), s), 0.0, torch.zeros(T), g.C[:, "y"].set(torch.from_numpy(YS)),
                        device="cpu").log_marginal) for s in range(8)]
    se = np.std(lzs, ddof=1) / math.sqrt(len(lzs))
    assert abs(np.mean(lzs) - exact(YS.tolist())) < 4 * se + 0.05


#: every public function of the slice's modules that takes a source of
#: randomness first (``core/keys.py``'s ``categorical`` and ``gumbel`` are
#: held at the top of this file), each held under a key here or in the
#: population file (the methods:
#: ``SMCAlgorithm``'s, ``Marginal``'s, ``Target.importance``,
#: ``ParticleCollection.sample_particle``, ``LinearGaussianSSM``'s and
#: ``NestedSamplingResult.resample_posterior``, are held above and in the
#: population file)
AUDITED = {
    "genjax_tpu_torch.parallel.resampling": {
        "systematic_counts", "stratified_counts", "systematic_indices", "stratified_indices",
        "multinomial_indices", "residual_indices", "resample_indices", "resample_particles",
        "collective_resample"},
    "genjax_tpu_torch.parallel.smc": {"sharded_importance", "resample_if", "step_streams"},
    "genjax_tpu_torch.parallel.rbpf": {"rbpf"},
    "genjax_tpu_torch.dists.lgssm": {"ffbs"},
    "genjax_tpu_torch.inference.tempered": {"tempered_smc", "adaptive_tempered_smc"},
    "genjax_tpu_torch.inference.pgibbs": {"csmc_sweep", "particle_gibbs", "pmmh"},
    "genjax_tpu_torch.inference.smc2": {"smc2"},
    "genjax_tpu_torch.inference.abc": {"abc_rejection", "abc_smc"},
    "genjax_tpu_torch.inference.smc_chees": {"chees_tempered_smc", "column_tempered_chees"},
    "genjax_tpu_torch.inference.nested": {"nested_sampling", "column_nested_sampling"},
}


@pytest.mark.parametrize("module", sorted(AUDITED))
def test_the_audit_names_every_entry_point_of_the_slice(module):
    """A public function that takes a key, a generator or a seed first is in
    ``AUDITED``, so that one added later is held under a key too."""
    import importlib
    import inspect

    mod = importlib.import_module(module)
    takes = set()
    for name, fn in vars(mod).items():
        if name.startswith("_") or not inspect.isfunction(fn) or fn.__module__ != module:
            continue
        params = list(inspect.signature(fn).parameters)
        if params and params[0] in ("gen", "key", "k", "seed", "stream"):
            takes.add(name)
    # keyword-positioned streams (the column bridges take theirs fifth)
    takes |= {n for n in ("column_tempered_chees", "column_nested_sampling", "nested_sampling")
              if hasattr(mod, n) and getattr(mod, n).__module__ == module}
    assert takes <= AUDITED[module], takes - AUDITED[module]

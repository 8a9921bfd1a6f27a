"""Tempered SMC, particle Gibbs and the population drivers under a key,
draw for draw against ``genjax_tpu``.

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` (both
threefry2x32, and the rbg kind) drive ``tempered_smc``,
``adaptive_tempered_smc``, ``csmc_sweep``, ``particle_gibbs``, ``pmmh``,
``smc2``, ``abc_rejection``, ``abc_smc``, ``chees_tempered_smc``,
``column_tempered_chees``, ``nested_sampling`` and
``column_nested_sampling`` to the reference's draws, and every one of them
either draws the reference's draw under ``key(0)`` or raises
``GFITypeError`` (the audit, with ``test_torch_keys_smc.py``'s).

The adaptive loops amplify the float32 rounding that differs between XLA
and torch (as PT's adaptation does), so they are held at
settings short enough to agree: ``adaptive_tempered_smc`` at most 8 rungs
of 64 particles; ``chees_tempered_smc`` 8 rungs of 64 particles, 2 sweeps a
rung (positions to 1e-4: the step size's and trajectory's adaptation moves
them by up to 7e-5); ``smc2`` 10 steps of 16 x 8 particles; ``abc_smc`` 3
generations of 64; the nested sampler 20 iterations of 16 live points. Each
module is held under all three keys; the column bridges and the DP mixture,
whose reference calls compile longest, under ``key(0)``.
Log weights, scores and log marginals within rtol 1e-5 (atol 1e-6), choices
within 1e-5, indices and regimes equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference import abc_rejection as rabc_rejection
from genjax_tpu.inference import abc_smc as rabc_smc
from genjax_tpu.inference import adaptive_tempered_smc as radaptive_tempered_smc
from genjax_tpu.inference import chees_tempered_smc as rchees_tempered_smc
from genjax_tpu.inference import column_nested_sampling as rcolumn_nested_sampling
from genjax_tpu.inference import column_tempered_chees as rcolumn_tempered_chees
from genjax_tpu.inference import geometric_ladder as rgeometric_ladder
from genjax_tpu.inference import nested_sampling as rnested_sampling
from genjax_tpu.inference import particle_gibbs as rparticle_gibbs
from genjax_tpu.inference import pmmh as rpmmh
from genjax_tpu.inference import smc2 as rsmc2
from genjax_tpu.inference import tempered_smc as rtempered_smc
from genjax_tpu.inference.pgibbs import csmc_sweep as rcsmc_sweep
from genjax_tpu.models import dp_mixture_model as rdp_mixture_model
from genjax_tpu.models import linear_gaussian_ssm as rlinear_gaussian_ssm
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.generative.typecheck import GFITypeError
from genjax_tpu_torch.inference import (
    abc_rejection, abc_smc, adaptive_tempered_smc, chees_tempered_smc, column_nested_sampling,
    column_tempered_chees, geometric_ladder, nested_sampling, particle_gibbs, pmmh, smc2, tempered_smc,
)
from genjax_tpu_torch.inference.pgibbs import csmc_sweep
from genjax_tpu_torch.models import dp_mixture_model, linear_gaussian_ssm
from torch_threads import _one_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
KEYS = [(0, "threefry2x32"), (42, "threefry2x32"), (0, "rbg")]
KEY_IDS = ["key0", "key42", "rbg"]


def tk(seed, impl="threefry2x32"):
    return keys.key(seed, device="cpu", impl=impl)


def jk(seed, impl="threefry2x32"):
    return jax.random.key(seed, impl=impl)


def close(a, b, tol=TOL, atol=1e-6):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=atol)


def distinct(x) -> bool:
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


# ----------------------------------------------------------------------
# tempered SMC
# ----------------------------------------------------------------------


def _tempered(key, rej, port):
    if port:
        return tempered_smc(key, model, g.C["y"].set(1.5), (), n_particles=64, betas=geometric_ladder(6),
                            rejuvenation=rej, n_rejuvenation=2, device="cpu")
    return rtempered_smc(key, model_ref, gj.C["y"].set(1.5), (), n_particles=64, betas=rgeometric_ladder(6),
                         rejuvenation=rej, n_rejuvenation=2)


@pytest.mark.parametrize("request_kind", ["regenerate", "hmc"])
@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_tempered_smc_is_the_references(seed, impl, request_kind):
    rej, rrej = ((g.S["mu"], gj.S["mu"]) if request_kind == "regenerate"
                 else (g.HMC(g.S["mu"], 0.3, L=3), gj.HMC(gj.S["mu"], 0.3, L=3)))
    res, want = _tempered(tk(seed, impl), rej, True), _tempered(jk(seed, impl), rrej, False)
    close(res.log_marginal, want.log_marginal)
    close(res.traces.get_choices()["mu"], want.traces.get_choices()["mu"])
    close(res.log_weights, want.log_weights)
    close(res.accept_history, want.accept_history)
    assert distinct(res.traces.get_choices()["mu"])


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_adaptive_tempered_smc_is_the_references(seed, impl):
    res = adaptive_tempered_smc(tk(seed, impl), model, g.C["y"].set(1.5), (), n_particles=64,
                                rejuvenation=g.HMC(g.S["mu"], 0.15, L=3), max_rungs=8, device="cpu")
    want = radaptive_tempered_smc(jk(seed, impl), model_ref, gj.C["y"].set(1.5), (), n_particles=64,
                                  rejuvenation=gj.HMC(gj.S["mu"], 0.15, L=3), max_rungs=8)
    assert int(res.n_rungs) == int(want.n_rungs)
    close(res.beta_history, want.beta_history)
    close(res.log_marginal, want.log_marginal)
    close(res.traces.get_choices()["mu"], want.traces.get_choices()["mu"])


def test_tempered_smc_on_the_dp_mixture_is_the_references():
    """The DP mixture's sticks are beta draws (gamma's loops under the
    particles' vmap)."""
    data = (np.array([-4.0, 0.0, 4.0])[np.random.default_rng(0).integers(0, 3, 6)]
            + 0.4 * np.random.default_rng(1).normal(size=6)).astype(np.float32)
    res = tempered_smc(tk(0), dp_mixture_model(3), g.C["obs", :, "x"].set(torch.from_numpy(data)),
                       (torch.from_numpy(data),), n_particles=16, betas=geometric_ladder(3), device="cpu")
    want = rtempered_smc(jk(0), rdp_mixture_model(3), gj.C["obs", :, "x"].set(jnp.asarray(data)),
                         (jnp.asarray(data),), n_particles=16, betas=rgeometric_ladder(3))
    close(res.log_marginal, want.log_marginal)
    close(res.ess_history, want.ess_history, tol=1e-4)


# ----------------------------------------------------------------------
# particle Gibbs and PMMH
# ----------------------------------------------------------------------

T = 10
YS = np.random.default_rng(1).normal(size=T).astype(np.float32)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_csmc_sweeps_and_particle_gibbs_are_the_references(seed, impl):
    kernel, _ = linear_gaussian_ssm()
    rkernel, _ = rlinear_gaussian_ssm()
    obs, robs = g.C[:, "y"].set(torch.from_numpy(YS)), gj.C[:, "y"].set(jnp.asarray(YS))
    out = csmc_sweep(tk(seed, impl), kernel, 0.0, torch.zeros(T), obs, None, latent_selection=g.S["z"],
                     n_particles=32)
    rout = rcsmc_sweep(jk(seed, impl), rkernel, 0.0, jnp.zeros(T), robs, None, latent_selection=gj.S["z"],
                       n_particles=32)
    close(out.retained["z"], rout.retained["z"])
    close(out.log_marginal, rout.log_marginal)
    for anc in (True, False) if seed == 0 and impl == "threefry2x32" else (True,):
        res = particle_gibbs(tk(seed, impl), kernel, 0.0, torch.zeros(T), obs, latent_selection=g.S["z"],
                             n_particles=32, n_sweeps=2, ancestor_sampling=anc, device="cpu")
        want = rparticle_gibbs(jk(seed, impl), rkernel, 0.0, jnp.zeros(T), robs, latent_selection=gj.S["z"],
                               n_particles=32, n_sweeps=2, ancestor_sampling=anc)
        close(res.trajectories["z"], want.trajectories["z"])
        close(res.log_marginals, want.log_marginals)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_pmmh_is_the_references(seed, impl):
    prior = lambda p: -0.5 * p["a"] ** 2  # noqa: E731
    res = pmmh(tk(seed, impl), {"a": torch.tensor(0.0), "b": torch.zeros(2)}, prior,
               lambda k, p: -0.5 * (p["a"] - 0.3) ** 2 / 0.1 + keys.normal(k) * 0.01, n_steps=12,
               step_scales=0.5, device="cpu")
    want = rpmmh(jk(seed, impl), {"a": jnp.asarray(0.0), "b": jnp.zeros(2)}, prior,
                 lambda k, p: -0.5 * (p["a"] - 0.3) ** 2 / 0.1 + jax.random.normal(k) * 0.01, n_steps=12,
                 step_scales=0.5)
    close(res.params["a"], want.params["a"])
    close(res.params["b"], want.params["b"])
    close(res.log_zs, want.log_zs)
    close(res.accept_rate, want.accept_rate)


# ----------------------------------------------------------------------
# SMC^2 and ABC
# ----------------------------------------------------------------------


@g.gen
def ar1(c, x):
    a, z = c
    z_new = g.normal(a * z, 0.5) @ "z"
    g.normal(z_new, 0.6) @ "y"
    return ((a, z_new), None)


@gj.gen
def ar1_ref(c, x):
    a, z = c
    z_new = gj.normal(a * z, 0.5) @ "z"
    gj.normal(z_new, 0.6) @ "y"
    return ((a, z_new), None)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_smc2_is_the_references(seed, impl):
    """``ess_threshold`` 0.9, so that the parameters resample and the PMMH
    exchange moves (their fresh filters under ``fold_in``) run."""
    kw = dict(n_theta=16, n_x=8, ess_threshold=0.9, rw_scales=0.15, n_rejuv=2)
    res = smc2(tk(seed, impl), ar1, lambda k: 0.5 + 0.5 * keys.normal(k), lambda a: -2.0 * (a - 0.5) ** 2, 0.0,
               torch.zeros(T), g.C[:, "y"].set(torch.from_numpy(YS)), device="cpu", **kw)
    want = rsmc2(jk(seed, impl), ar1_ref, lambda k: 0.5 + 0.5 * jax.random.normal(k), lambda a: -2.0 * (a - 0.5) ** 2,
                 0.0, jnp.zeros(T), gj.C[:, "y"].set(jnp.asarray(YS)), **kw)
    close(res.log_evidence, want.log_evidence)
    close(res.thetas, want.thetas)
    close(res.ess_history, want.ess_history, tol=1e-4)
    close(res.rejuv_accept_rate, want.rejuv_accept_rate)
    assert float(res.rejuv_accept_rate) > 0 and distinct(res.thetas)


def _distance(xp):
    return lambda tr: xp.abs(tr.get_choices()["y"] - 1.0)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_abc_is_the_references(seed, impl):
    res = abc_rejection(tk(seed, impl), model, (), _distance(torch), n_samples=64, tolerance=0.3, device="cpu")
    want = rabc_rejection(jk(seed, impl), model_ref, (), _distance(jnp), n_samples=64, tolerance=0.3)
    close(res.distances, want.distances)
    assert res.choices.flag.tolist() == np.asarray(want.choices.flag).tolist()
    res, _p = abc_smc(tk(seed, impl), model, (), _distance(torch), ["mu"], n_particles=64, n_generations=3,
                      device="cpu")
    want, _p = rabc_smc(jk(seed, impl), model_ref, (), _distance(jnp), ["mu"], n_particles=64, n_generations=3)
    close(res.params, want.params)
    close(res.tolerance_history, want.tolerance_history)
    close(res.move_accept_history, want.move_accept_history)


# ----------------------------------------------------------------------
# ChEES tempered SMC and nested sampling
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_chees_tempered_smc_is_the_references(seed, impl):
    q0 = np.random.default_rng(8).normal(size=(3, 64)).astype(np.float32)

    def prior(q):
        return -0.5 * (q**2).sum(0)

    def lik(q):
        return -0.5 * (((q - 1.0) / 0.5) ** 2).sum(0)

    kw = dict(max_rungs=8, n_rejuvenation=2)
    res = chees_tempered_smc(tk(seed, impl), prior, lik, torch.from_numpy(q0), **kw)
    want = rchees_tempered_smc(jk(seed, impl), prior, lik, jnp.asarray(q0), **kw)
    assert int(res.n_rungs) == int(want.n_rungs)
    close(res.log_marginal, want.log_marginal)
    close(res.particles, want.particles, tol=1e-4, atol=1e-4)
    close(res.eps_history, want.eps_history, tol=1e-4)


def test_column_tempered_chees_is_the_references():
    kw = dict(max_rungs=8, n_rejuvenation=2)
    res, _p = column_tempered_chees(model, g.C["y"].set(1.0), (), ["mu"], tk(0), 64, device="cpu", **kw)
    want, _p = rcolumn_tempered_chees(model_ref, gj.C["y"].set(1.0), (), ["mu"], jk(0), 64, **kw)
    assert int(res.n_rungs) == int(want.n_rungs)
    close(res.log_marginal, want.log_marginal)
    close(res.particles, want.particles, tol=1e-4, atol=1e-4)


C0 = -0.5 * math.log(2 * math.pi)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_nested_sampling_is_the_references(seed, impl):
    kw = dict(n_live=16, n_iter=20, n_mcmc=3, n_runs=2)
    res = nested_sampling(lambda k, n: keys.normal(k, (1, n)), lambda q: -0.5 * q[0] ** 2 + C0,
                          lambda q: -0.5 * ((q[0] - 0.5) / 0.5) ** 2 - math.log(0.5) + C0, tk(seed, impl),
                          device="cpu", **kw)
    want = rnested_sampling(lambda k, n: jax.random.normal(k, (1, n)), lambda q: -0.5 * q[0] ** 2 + C0,
                            lambda q: -0.5 * ((q[0] - 0.5) / 0.5) ** 2 - jnp.log(0.5) + C0, jk(seed, impl), **kw)
    close(res.log_z, want.log_z)
    close(res.dead, want.dead)
    close(res.accept_rate, want.accept_rate)
    close(res.resample_posterior(tk(seed + 1, impl), 20), want.resample_posterior(jk(seed + 1, impl), 20))


def test_column_nested_sampling_is_the_references():
    res, _p = column_nested_sampling(model, g.C["y"].set(1.0), (), ["mu"], tk(0), n_live=16, n_iter=12,
                                     n_mcmc=2, n_runs=2, device="cpu")
    want, _p = rcolumn_nested_sampling(model_ref, gj.C["y"].set(1.0), (), ["mu"], jk(0), n_live=16,
                                       n_iter=12, n_mcmc=2, n_runs=2)
    close(res.log_z, want.log_z)
    close(res.live, want.live)


# ----------------------------------------------------------------------
# the audit: a mesh takes a generator
# ----------------------------------------------------------------------


def test_smc2_over_a_mesh_raises_gfi_type_error_under_a_key():
    with pytest.raises(GFITypeError, match="torch.Generator"):
        smc2(tk(0), ar1, lambda k: keys.normal(k), lambda a: -a**2, 0.0, torch.zeros(T),
             g.C[:, "y"].set(torch.from_numpy(YS)), n_theta=4, n_x=4, mesh=object())

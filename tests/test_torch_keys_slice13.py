"""Slice 13's Gibbs, involutive, predictive and calibration functions under a
key, draw for draw against ``genjax_tpu``: the Gibbs moves and sweep,
involutive MCMC, posterior predictive draws, simulation-based calibration
and the exact-inference testbed (F9).

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` (both
threefry2x32, and the rbg kind) drive the port's and the reference's
functions to the same draws:

- F9: ``enumerative_gibbs`` splits its key into the enumeration's, the
  draw's and the edit's, ``involutive_mh`` into the auxiliary draw's, the
  edit's and the accept draw's, and ``posterior_predictive`` makes draw
  ``i`` under the ``i``-th of ``split(key, n)`` (it gave every draw the same
  noise);
- ``enumerative_gibbs_vmap`` (whole and in lane batches), ``gibbs_sweep``
  (a key a sweep, each split into a key a move) over the four kinds of move,
  ``sbc_ranks`` and ``inference_test_generator`` follow the reference's
  splits;
- the audit: every public function of these modules is held under
  ``key(0)`` by a test here, and where it makes several draws of one law
  they are not all alike (no key is reused across them).

Indices are equal; choices, weights and log-probabilities within rtol 1e-5
(atol 1e-6).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference import exact_testbed as rtestbed
from genjax_tpu.inference import gibbs as rgibbs
from genjax_tpu.inference.involutive import involutive_mh as rinvolutive_mh
from genjax_tpu.inference.involutive import involutive_move as rinvolutive_move
from genjax_tpu.inference.predictive import posterior_predictive as rposterior_predictive
from genjax_tpu.inference.sbc import sbc_ranks as rsbc_ranks
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.inference import exact_testbed, gibbs
from genjax_tpu_torch.inference.involutive import involutive_mh, involutive_move
from genjax_tpu_torch.inference.predictive import posterior_predictive
from genjax_tpu_torch.inference.sbc import sbc_ranks
from torch_threads import _one_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
#: key(0), key(42) and an rbg key: (seed, impl)
KEYS = [(0, "threefry2x32"), (42, "threefry2x32"), (0, "rbg")]
KEY_IDS = ["key0", "key42", "rbg"]
#: where the reference compiles a program a key kind: key(0) and the rbg key
TWO = [(0, "threefry2x32"), (0, "rbg")]
TWO_IDS = ["key0", "rbg"]


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
    """Not every draw alike (F9 gave them one key)."""
    x = x.detach().reshape(x.shape[0], -1)
    return bool((x != x[:1]).any())


# ----------------------------------------------------------------------
# the models, in both packages
# ----------------------------------------------------------------------


@g.gen
def pred_model():
    mu = g.normal(0.0, 1.0) @ "mu"
    _ = g.normal(mu, 1.0) @ "y"


@gj.gen
def rpred_model():
    mu = gj.normal(0.0, 1.0) @ "mu"
    _ = gj.normal(mu, 1.0) @ "y"


@g.gen
def scale_model():
    return g.log_normal(0.0, 1.0) @ "sigma"


@gj.gen
def rscale_model():
    return gj.log_normal(0.0, 1.0) @ "sigma"


@g.gen
def scale_aux():
    return g.normal(0.0, 0.4) @ "u"


@gj.gen
def rscale_aux():
    return gj.normal(0.0, 0.4) @ "u"


def scale(t, u):
    return g.C["sigma"].set(t["sigma"] * torch.exp(u["u"])), g.C["u"].set(-u["u"])


def rscale(t, u):
    return gj.C["sigma"].set(t["sigma"] * jnp.exp(u["u"])), gj.C["u"].set(-u["u"])


@g.gen
def flip_model():
    z = g.flip(0.5) @ "z"
    _ = g.normal(torch.where(z, 1.0, -1.0), 1.0) @ "x"


@gj.gen
def rflip_model():
    z = gj.flip(0.5) @ "z"
    _ = gj.normal(jnp.where(z, 1.0, -1.0), 1.0) @ "x"


SUPPORT = [False, True]


def test_slice13_drivers_split_the_key_as_the_reference_does():
    """F9 (queue 3): the three cases, which drew something other than the
    reference's draws under a key and raised nothing."""
    # posterior_predictive: a key a draw, not one noise in every draw
    mus = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    got = posterior_predictive(tk(0), pred_model, (), {"mu": torch.from_numpy(mus)})["y"]
    close(got, rposterior_predictive(jk(0), rpred_model, (), {"mu": jnp.asarray(mus)})["y"])
    close(got, [-1.1574776, -1.135625, 0.9609788, 1.4322329])
    # involutive_mh's docstring model, auxiliary and scale involution
    tr, rtr = scale_model.simulate(tk(0), ()), rscale_model.simulate(jk(0), ())
    close(tr.get_choices()["sigma"], rtr.get_choices()["sigma"])
    new, info = involutive_mh(tk(1), tr, scale_aux, scale)
    rnew, rinfo = rinvolutive_mh(jk(1), rtr, rscale_aux, rscale)
    close(new.get_choices()["sigma"], rnew.get_choices()["sigma"])
    close(info.alpha, rinfo.alpha)
    equal(info.accepted, rinfo.accepted)
    # enumerative_gibbs on a flip whose likelihood sees x = 0.3
    tr, _ = flip_model.generate(tk(0), g.C["x"].set(0.3), ())
    rtr, _ = rflip_model.generate(jk(0), gj.C["x"].set(0.3), ())
    got = [int(gibbs.enumerative_gibbs(tk(s), tr, "z", torch.tensor(SUPPORT))[1].index) for s in range(6)]
    want = [int(rgibbs.enumerative_gibbs(jk(s), rtr, "z", jnp.asarray(SUPPORT))[1].index) for s in range(6)]
    assert got == want == [1, 1, 0, 1, 1, 1]


# ----------------------------------------------------------------------
# the Gibbs moves and the sweep
# ----------------------------------------------------------------------


@g.gen
def lane_kernel(_):
    z = g.flip(0.5) @ "z"
    _ = g.normal(torch.where(z, 1.0, -1.0), 1.0) @ "x"


@gj.gen
def rlane_kernel(_):
    z = gj.flip(0.5) @ "z"
    _ = gj.normal(jnp.where(z, 1.0, -1.0), 1.0) @ "x"


LANES = 6
XS = np.linspace(-1.5, 1.5, LANES).astype(np.float32)


@g.gen
def lanes_model():
    _ = lane_kernel.vmap()(torch.zeros(LANES)) @ "assign"


@gj.gen
def rlanes_model():
    _ = rlane_kernel.vmap()(jnp.zeros(LANES)) @ "assign"


def lane_traces(seed, impl):
    tr, _ = lanes_model.generate(tk(seed, impl), g.C["assign", :, "x"].set(torch.from_numpy(XS)), ())
    rtr, _ = rlanes_model.generate(jk(seed, impl), gj.C["assign", :, "x"].set(jnp.asarray(XS)), ())
    return tr, rtr


@pytest.mark.parametrize("seed,impl,lane_batch", [(0, "threefry2x32", None), (42, "threefry2x32", 4),
                                                 (0, "rbg", None)], ids=KEY_IDS)
def test_enumerative_gibbs_vmap_draws_the_references_lanes(seed, impl, lane_batch):
    """Whole, and in lane batches of 4 (the same conditionals and draws)."""
    tr, rtr = lane_traces(seed, impl)
    new, info = gibbs.enumerative_gibbs_vmap(tk(seed + 1, impl), tr, ("assign", None, "z"),
                                             torch.tensor(SUPPORT), lane_batch=lane_batch)
    rnew, rinfo = jax.jit(lambda k: rgibbs.enumerative_gibbs_vmap(k, rtr, ("assign", None, "z"), jnp.asarray(SUPPORT),
                                                                 lane_batch=lane_batch))(jk(seed + 1, impl))
    equal(info.index, rinfo.index)
    close(info.log_probs, rinfo.log_probs)
    equal(new.get_choices()["assign", :, "z"], rnew.get_choices()["assign", :, "z"])


@g.gen
def sweep_model():
    z = g.flip(0.5) @ "z"
    _ = lane_kernel.vmap()(torch.zeros(LANES)) @ "assign"
    s = g.log_normal(0.0, 1.0) @ "sigma"
    _ = g.normal(torch.where(z, 1.0, -1.0), s) @ "x"


@gj.gen
def rsweep_model():
    z = gj.flip(0.5) @ "z"
    _ = rlane_kernel.vmap()(jnp.zeros(LANES)) @ "assign"
    s = gj.log_normal(0.0, 1.0) @ "sigma"
    _ = gj.normal(jnp.where(z, 1.0, -1.0), s) @ "x"


@pytest.mark.parametrize("seed,impl", TWO, ids=TWO_IDS)
def test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move(seed, impl):
    """Four sweeps of an enumerative move, a vmapped enumerative move and an
    MH move on one model, and three of an involutive move and an MH move on
    another, with the record of each."""
    obs = g.C["x"].set(0.4) | g.C["assign", :, "x"].set(torch.from_numpy(XS))
    robs = gj.C["x"].set(0.4) | gj.C["assign", :, "x"].set(jnp.asarray(XS))
    tr, _ = sweep_model.generate(tk(seed, impl), obs, ())
    rtr, _ = rsweep_model.generate(jk(seed, impl), robs, ())
    moves = [gibbs.enum_move("z", torch.tensor(SUPPORT)),
             gibbs.enum_vmap_move(("assign", None, "z"), torch.tensor(SUPPORT)), gibbs.mh_move(g.S["sigma"])]
    rmoves = [rgibbs.enum_move("z", jnp.asarray(SUPPORT)),
              rgibbs.enum_vmap_move(("assign", None, "z"), jnp.asarray(SUPPORT)), rgibbs.mh_move(gj.S["sigma"])]

    def record(t):
        c = t.get_choices()
        return c["z"], c["assign", :, "z"], c["sigma"]

    res = gibbs.gibbs_sweep(tk(seed + 7, impl), tr, moves, 4, record=record)
    rres = rgibbs.gibbs_sweep(jk(seed + 7, impl), rtr, rmoves, 4, record=record)
    equal(res.history[0], rres.history[0])
    equal(res.history[1], rres.history[1])
    close(res.history[2], rres.history[2])
    close(res.trace.get_score(), rres.trace.get_score())

    str_, rstr = scale_model.simulate(tk(seed, impl), ()), rscale_model.simulate(jk(seed, impl), ())
    res = gibbs.gibbs_sweep(tk(seed + 8, impl), str_, [involutive_move(scale_aux, scale), gibbs.mh_move(g.S["sigma"])],
                            3, record=lambda t: t.get_choices()["sigma"])
    rres = rgibbs.gibbs_sweep(jk(seed + 8, impl), rstr, [rinvolutive_move(rscale_aux, rscale),
                                                         rgibbs.mh_move(gj.S["sigma"])],
                              3, record=lambda t: t.get_choices()["sigma"])
    close(res.history, rres.history)
    assert distinct(res.history)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_involutive_mh_splits_the_key_as_the_reference_does(seed, impl):
    tr, rtr = scale_model.simulate(tk(seed, impl), ()), rscale_model.simulate(jk(seed, impl), ())
    for s in range(3):
        new, info = involutive_mh(tk(seed + 10 + s, impl), tr, scale_aux, scale, check=True)
        rnew, rinfo = rinvolutive_mh(jk(seed + 10 + s, impl), rtr, rscale_aux, rscale, check=True)
        close(new.get_choices()["sigma"], rnew.get_choices()["sigma"])
        close(info.alpha, rinfo.alpha)
        close(info.logdet, rinfo.logdet)


# ----------------------------------------------------------------------
# predictive draws, SBC, the testbed
# ----------------------------------------------------------------------


@g.gen
def two_sites():
    mu = g.normal(0.0, 1.0) @ "mu"
    s = g.log_normal(0.0, 0.5) @ "s"
    _ = g.normal(mu, s) @ "y"
    _ = g.flip(0.3) @ "b"


@gj.gen
def rtwo_sites():
    mu = gj.normal(0.0, 1.0) @ "mu"
    s = gj.log_normal(0.0, 0.5) @ "s"
    _ = gj.normal(mu, s) @ "y"
    _ = gj.flip(0.3) @ "b"


@pytest.mark.parametrize("n_draws", [None, 5])
@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_posterior_predictive_makes_a_key_a_draw(seed, impl, n_draws):
    mus = np.random.default_rng(seed).normal(size=12).astype(np.float32)
    got = posterior_predictive(tk(seed, impl), two_sites, (), {"mu": torch.from_numpy(mus)}, n_draws=n_draws)
    want = rposterior_predictive(jk(seed, impl), rtwo_sites, (), {"mu": jnp.asarray(mus)}, n_draws=n_draws)
    for addr in ("mu", "s", "y"):
        close(got[addr], want[addr])
    equal(got["b"], want["b"])
    assert distinct(got["y"]) and distinct(got["s"])


def _sbc_sampler(k, chm):
    return chm["y"] + 0.5 * keys.normal(k, (11, 1))


def _rsbc_sampler(k, chm):
    return chm["y"] + 0.5 * jax.random.normal(k, (11, 1))


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_sbc_ranks_split_a_key_a_simulation(seed, impl):
    res = sbc_ranks(tk(seed, impl), pred_model, (), g.S["mu"], _sbc_sampler, n_sims=16, device="cpu")
    rres = rsbc_ranks(jk(seed, impl), rpred_model, (), gj.S["mu"], _rsbc_sampler, n_sims=16)
    equal(res.ranks, rres.ranks)
    assert res.n_draws == rres.n_draws == 11
    assert distinct(res.ranks)


@pytest.mark.parametrize("seed,impl", TWO, ids=TWO_IDS)
def test_the_testbed_draws_the_references_problem(seed, impl):
    make, _, _ = exact_testbed.build_test_against_exact_inference(8, 5, 1, 1, 0.5, 0.5)
    rmake, _, _ = rtestbed.build_test_against_exact_inference(8, 5, 1, 1, 0.5, 0.5)
    p, rp = make(tk(seed, impl)), rmake(jk(seed, impl))
    equal(p.latent_sequence, rp.latent_sequence)
    equal(p.observation_sequence, rp.observation_sequence)
    close(p.log_posterior, rp.log_posterior)
    close(p.log_data_marginal, rp.log_data_marginal)


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------

#: every public function of these slice-13 modules that takes a source of
#: randomness first, or makes a move or a problem generator that does, with
#: the test above that holds it under ``key(0)`` (and more keys)
AUDITED = {
    "genjax_tpu_torch.inference.gibbs": {
        "enumerative_gibbs": "test_slice13_drivers_split_the_key_as_the_reference_does",
        "enumerative_gibbs_vmap": "test_enumerative_gibbs_vmap_draws_the_references_lanes",
        "gibbs_sweep": "test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move",
        "enum_move": "test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move",
        "enum_vmap_move": "test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move",
        "mh_move": "test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move",
    },
    "genjax_tpu_torch.inference.involutive": {
        "involutive_mh": "test_involutive_mh_splits_the_key_as_the_reference_does",
        "involutive_move": "test_gibbs_sweep_splits_a_key_a_sweep_and_a_key_a_move",
    },
    "genjax_tpu_torch.inference.predictive": {"posterior_predictive": "test_posterior_predictive_makes_a_key_a_draw"},
    "genjax_tpu_torch.inference.sbc": {"sbc_ranks": "test_sbc_ranks_split_a_key_a_simulation"},
    "genjax_tpu_torch.inference.exact_testbed": {
        "build_test_against_exact_inference": "test_the_testbed_draws_the_references_problem",
    },
}
#: the public functions that take no source of randomness
NO_STREAM = {"genjax_tpu_torch.inference.sbc": {"sbc_uniformity"}}


@pytest.mark.parametrize("module", sorted(AUDITED))
def test_the_audit_names_every_entry_point_of_the_slice(module):
    """Every public function of the module is in ``AUDITED`` with the test
    that holds it under a key, or takes no source of randomness, so that one
    added later is held under a key too."""
    mod = importlib.import_module(module)
    public = {n for n, fn in vars(mod).items()
              if not n.startswith("_") and inspect.isfunction(fn) and fn.__module__ == module}
    assert public == set(AUDITED[module]) | NO_STREAM.get(module, set()), public ^ set(AUDITED[module])
    for test in AUDITED[module].values():
        assert test in globals()


def test_a_generator_still_draws_in_sequence():
    """A ``torch.Generator`` keeps its stream: the predictive draws of two
    calls from one generator differ, and one seed gives one result."""
    mus = torch.linspace(0, 1, 8)
    a = posterior_predictive(torch.Generator().manual_seed(3), pred_model, (), {"mu": mus})["y"]
    b = posterior_predictive(torch.Generator().manual_seed(3), pred_model, (), {"mu": mus})["y"]
    assert torch.equal(a, b) and distinct(a)

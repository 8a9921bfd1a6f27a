"""VI under a key, draw for draw against ``genjax_tpu``: the losses,
``fit``, ADVI, MAP and Laplace, Pathfinder, and the two ``jax.random``
draws they add to ``core/keys.py`` (``choice``, ``geometric``).

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` (both
threefry2x32, and the rbg kind) drive the port's and the reference's
functions to the same draws:

- ``ELBO`` and ``IWELBO`` split their key into the model's and the
  transform's, ``PWake`` and ``QWake`` into three; ``IWELBO``'s particles
  are a vmap begun inside the program, whose ``normal_reparam`` lane ``i``
  draws under ``split(k, N)[i]``; ``bench.py::bench_vi``'s ELBO gives the
  reference's gradient under ``key(0)``;
- ``fit`` (the reference's keyword ``key=``) splits a key a step and a key
  an estimate;
- ``advi``, ``column_advi``, ``fit_map``, ``laplace_approximation``,
  ``pathfinder``, ``multi_pathfinder`` and ``column_pathfinder`` and their
  results' ``sample`` and ``sample_choices`` follow the reference's splits;
- the audit: every public function of the four modules that takes a key is
  held here.

Gradients, draws and log-densities within rtol 1e-5 (atol 1e-6), indices
equal. The optimisers run float32 Adam and L-BFGS, whose drift from the
reference's grows with the steps: ``fit`` and ``advi`` (10 steps and
fewer) are held within rtol 1e-4, ``fit_map`` (5 steps) within 1e-5, and
Pathfinder (8 iterations) within rtol 2e-5 and atol 1e-5 on its draws (a
draw near 0 moved by 1.9e-6 in a three-path run) and rtol 1e-4 on its ELBO
trace (a difference of nearly equal numbers).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu.inference as RI
import genjax_tpu_torch as g
import genjax_tpu_torch.inference as I
from genjax_tpu.inference import vi as rvi
from genjax_tpu.inference.sp import Marginal as RMarginal
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.core.pytree import Const
from genjax_tpu_torch.inference import vi
from genjax_tpu_torch.inference.sp import Marginal
from torch_threads import _one_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
OPT_TOL = 1e-4
PF_TOL, PF_ATOL = 2e-5, 1e-5
#: key(0), key(42) and an rbg key: (seed, impl); the optimisers, whose
#: reference runs compile a program a call, take one each
KEYS = [(0, "threefry2x32"), (42, "threefry2x32"), (0, "rbg")]
KEY_IDS = ["key0", "key42", "rbg"]


def tk(seed, impl="threefry2x32"):
    return keys.key(seed, device="cpu", impl=impl)


def jk(seed, impl="threefry2x32"):
    return jax.random.key(seed, impl=impl)


def close(a, b, tol=TOL, atol=1e-6):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=atol)


def equal(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64))


# ----------------------------------------------------------------------
# the losses
# ----------------------------------------------------------------------


@g.gen
def model(phi):
    mu = g.normal(0.0 * phi[0], 1.0) @ "mu"
    _ = g.normal(mu, 0.5) @ "y"


@gj.gen
def rmodel(phi):
    mu = gj.normal(0.0 * phi[0], 1.0) @ "mu"
    _ = gj.normal(mu, 0.5) @ "y"


@g.gen
def guide_fn(target):
    (phi,) = target.args
    _ = vi.normal_reparam(phi[0], torch.exp(phi[1])) @ "mu"


@gj.gen
def rguide_fn(target):
    (phi,) = target.args
    _ = rvi.normal_reparam(phi[0], jnp.exp(phi[1])) @ "mu"


GUIDE = Marginal(guide_fn, Const(g.Selection.all()), Const(None))
RGUIDE = RMarginal(rguide_fn, gj.Pytree.const(gj.Selection.all()), gj.Pytree.const(None))
PHI = np.array([0.3, -0.5], np.float32)


def make_target(phi):
    return I.Target(model, (phi,), g.C["y"].set(1.0))


def rmake_target(phi):
    return RI.Target(rmodel, (phi,), gj.C["y"].set(1.0))


LOSSES = {
    "ELBO": (lambda: vi.ELBO(GUIDE, make_target), lambda: rvi.ELBO(RGUIDE, rmake_target)),
    "IWELBO": (lambda: vi.IWELBO(GUIDE, make_target, 4), lambda: rvi.IWELBO(RGUIDE, rmake_target, 4)),
    "PWake": (lambda: vi.PWake(GUIDE, make_target), lambda: rvi.PWake(RGUIDE, rmake_target)),
    "QWake": (lambda: vi.QWake(GUIDE, GUIDE, make_target), lambda: rvi.QWake(RGUIDE, RGUIDE, rmake_target)),
}


@pytest.mark.parametrize("loss,seed,impl", [("ELBO", 0, "threefry2x32"), ("IWELBO", 0, "threefry2x32"),
                                           ("IWELBO", 0, "rbg"), ("PWake", 0, "threefry2x32"), ("QWake", 0, "rbg")],
                         ids=["ELBO-key0", "IWELBO-key0", "IWELBO-rbg", "PWake-key0", "QWake-rbg"])
def test_the_losses_estimate_the_references_gradient(loss, seed, impl):
    port, ref = (f() for f in LOSSES[loss])
    (got,) = port(tk(seed, impl), (torch.from_numpy(PHI),))
    (want,) = jax.jit(ref)(jk(seed, impl), (jnp.asarray(PHI),))
    close(got, want)


def _bench_vi():
    """``bench.py::bench_vi``'s program in both packages (the port's from
    ``chip_smoke.mixture_vi``, the one definition the card runs)."""
    import chip_smoke

    elbo, _, _ = chip_smoke.mixture_vi(g)

    @gj.gen
    def rmodel_fn(phi):
        z = gj.flip(0.5) @ "z"
        mu = gj.normal(jnp.where(z, 2.0, -2.0), 1.0) @ "mu"
        _ = gj.normal(mu, 0.5) @ "y"

    @gj.gen
    def rguide(target):
        (phi,) = target.args
        z = rvi.flip_reinforce(jax.nn.sigmoid(phi[0])) @ "z"
        zf = jnp.asarray(z, jnp.float32)
        m = zf * phi[1] + (1.0 - zf) * phi[3]
        s = jnp.exp(zf * phi[2] + (1.0 - zf) * phi[4])
        _ = rvi.normal_reparam(m, s) @ "mu"

    rg = RMarginal(rguide, gj.Pytree.const(gj.Selection.all()), gj.Pytree.const(None))
    return elbo, rvi.ELBO(rg, lambda phi: RI.Target(rmodel_fn, (phi,), gj.C["y"].set(1.5)))


def test_bench_vis_elbo_under_split_keys():
    """The reference's value at ``phi = (0, 1, 0, -1, 0)`` under ``key(0)``, and
    a batch of estimates under ``split(key, 8)``, as ``bench_vi`` makes
    its 4,096."""
    elbo, relbo = _bench_vi()
    phi = np.array([0.0, 1.0, 0.0, -1.0, 0.0], np.float32)
    (got,) = elbo(tk(0), (torch.from_numpy(phi),))
    close(got, [1.3017794, -3.5841193, -0.5812894, 0.0, 0.0])
    close(got, jax.jit(relbo)(jk(0), (jnp.asarray(phi),))[0])
    phi0 = np.array([0.0, 1.0, -1.0, -1.0, -1.0], np.float32)
    batch = torch.func.vmap(lambda k: elbo(k, (torch.from_numpy(phi0),))[0])(keys.split(tk(1), 8))
    rbatch = jax.jit(jax.vmap(lambda k: relbo(k, (jnp.asarray(phi0),))[0]))(jax.random.split(jk(1), 8))
    close(batch, rbatch)


GUIDE_DISTS = {
    "flip_enum": (0.3,), "flip_mvd": (0.3,), "flip_reinforce": (0.3,),
    "categorical_enum": (np.array([0.2, -0.1, 0.5], np.float32),), "normal_reinforce": (0.5, 2.0),
    "normal_reparam": (0.5, 2.0), "mv_normal_diag_reparam": (np.zeros(3, np.float32), np.ones(3, np.float32)),
    "geometric_reinforce": (0.3,), "beta_implicit": (2.0, 3.0),
}


@pytest.mark.parametrize("name", list(GUIDE_DISTS))
def test_the_guide_distributions_sample_under_a_key(name):
    args = GUIDE_DISTS[name]
    pa = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    ra = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    for seed, impl in KEYS:
        got = getattr(vi, name).sample(tk(seed, impl), *pa)
        want = getattr(rvi, name).sample(jk(seed, impl), *ra)
        close(got, want)


@pytest.mark.parametrize("stream,seed,impl", [("key", 0, "threefry2x32"), ("gen", 0, "rbg")], ids=["key0", "rbg"])
def test_fit_splits_a_key_a_step_and_a_key_an_estimate(stream, seed, impl):
    port, ref = (f() for f in LOSSES["ELBO"])
    kw = {stream: tk(seed, impl)}
    got = vi.fit(port, torch.from_numpy(PHI), n_steps=6, batch_size=4, **kw)
    want = rvi.fit(ref, jnp.asarray(PHI), key=jk(seed, impl), n_steps=6, batch_size=4)
    close(got, want, OPT_TOL)
    with pytest.raises(ValueError, match="not both"):
        vi.fit(port, torch.from_numpy(PHI), key=tk(0), gen=tk(0), n_steps=1)


# ----------------------------------------------------------------------
# ADVI, MAP and Laplace, Pathfinder
# ----------------------------------------------------------------------

MEAN = np.array([1.0, -0.5, 0.3], np.float32)


def ld(z):
    return -0.5 * torch.sum((z - torch.from_numpy(MEAN)[:, None]) ** 2 / 0.25, dim=0)


def rld(z):
    return -0.5 * jnp.sum((z - jnp.asarray(MEAN)[:, None]) ** 2 / 0.25, axis=0)


@pytest.mark.parametrize("rank,estimator,seed,impl", [("diag", "stl", 0, "threefry2x32"), ("full", "stl", 0, "rbg"),
                                                      ("diag", "entropy", 42, "threefry2x32")],
                         ids=["diag-key0", "full-rbg", "entropy-key42"])
def test_advi_splits_the_key_as_the_reference_does(rank, estimator, seed, impl):
    kw = dict(rank=rank, estimator=estimator, n_steps=10, n_samples=4, n_elbo_samples=16)
    got = I.advi(tk(seed, impl), ld, 3, device="cpu", **kw)
    want = RI.advi(jk(seed, impl), rld, 3, **kw)
    for a, b in ((got.mu, want.mu), (got.scale_tril, want.scale_tril), (got.elbo_trace, want.elbo_trace),
                 (got.elbo, want.elbo)):
        close(a, b, OPT_TOL)
    close(got.sample(tk(seed + 1, impl), 5), want.sample(jk(seed + 1, impl), 5), OPT_TOL)


@g.gen
def ab_model():
    a = g.normal(0.0, 1.0) @ "a"
    b = g.normal(a, 1.0) @ "b"
    _ = g.normal(a + b, 0.5) @ "y"


@gj.gen
def rab_model():
    a = gj.normal(0.0, 1.0) @ "a"
    b = gj.normal(a, 1.0) @ "b"
    _ = gj.normal(a + b, 0.5) @ "y"


def test_column_advi_and_its_draws():
    got = I.column_advi(tk(3), ab_model, g.C["y"].set(1.0), (), ["a", "b"], n_steps=8, n_samples=4,
                        device="cpu")
    want = RI.column_advi(jk(3), rab_model, gj.C["y"].set(1.0), (), ["a", "b"], n_steps=8, n_samples=4)
    close(got.result.mu, want.result.mu, OPT_TOL)
    chm, rchm = got.sample_choices(tk(4), 6), want.sample_choices(jk(4), 6)
    close(chm["a"], rchm["a"], OPT_TOL)
    close(chm["b"], rchm["b"], OPT_TOL)


@pytest.mark.parametrize("seed,impl", [(0, "rbg")], ids=["rbg"])
def test_fit_map_and_laplace_start_where_the_reference_starts(seed, impl):
    sel, rsel = g.S["a"] | g.S["b"], gj.S["a"] | gj.S["b"]
    kw = dict(n_steps=5, n_restarts=3)
    got = I.fit_map(tk(seed, impl), ab_model, g.C["y"].set(1.0), (), sel, device="cpu", **kw)
    want = RI.fit_map(jk(seed, impl), rab_model, gj.C["y"].set(1.0), (), rsel, **kw)
    close(got["a"], want["a"])
    close(got["b"], want["b"])
    close(got.trajectory, want.trajectory)
    lap = I.laplace_approximation(tk(seed, impl), ab_model, g.C["y"].set(1.0), (), sel, device="cpu", **kw)
    rlap = RI.laplace_approximation(jk(seed, impl), rab_model, gj.C["y"].set(1.0), (), rsel, **kw)
    close(lap.mean, rlap.mean)
    close(lap.cov, rlap.cov)
    close(lap.log_marginal, rlap.log_marginal)


PF = dict(n_iters=8, n_draws=6)


@pytest.mark.parametrize("seed,impl", [(0, "threefry2x32")], ids=["key0"])
def test_pathfinder_draws_the_references_start_and_draws(seed, impl):
    got = I.pathfinder(tk(seed, impl), ld, 3, device="cpu", **PF)
    want = importlib.import_module("genjax_tpu.inference.pathfinder").pathfinder(jk(seed, impl), rld, 3, **PF)
    close(got.draws, want.draws, PF_TOL, PF_ATOL)
    close(got.elbo_trace, want.elbo_trace, OPT_TOL)
    close(got.sample(tk(seed + 1, impl), 4), want.sample(jk(seed + 1, impl), 4), PF_TOL, PF_ATOL)


def test_column_pathfinder_and_its_draws():
    """``multi_pathfinder``'s paths (``column_pathfinder`` is it over a
    packer), under an rbg key, whose draws in the paths' vmap follow JAX's
    batching rule."""
    kw = dict(n_paths=3, n_resample=7, **PF)
    got = I.column_pathfinder(tk(5, "rbg"), ab_model, g.C["y"].set(1.0), (), ["a", "b"], device="cpu", **kw)
    want = RI.column_pathfinder(jk(5, "rbg"), rab_model, gj.C["y"].set(1.0), (), ["a", "b"], **kw)
    close(got.result.paths.draws, want.result.paths.draws, PF_TOL, PF_ATOL)
    close(got.result.draws, want.result.draws, PF_TOL, PF_ATOL)
    chm, rchm = got.sample_choices(tk(6, "rbg"), 9), want.sample_choices(jk(6, "rbg"), 9)
    close(chm["a"], rchm["a"], PF_TOL, PF_ATOL)


# ----------------------------------------------------------------------
# core/keys.py: choice and geometric
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_choice_and_geometric_are_jax_randoms(seed, impl):
    k, j = tk(seed, impl), jk(seed, impl)
    equal(keys.choice(k, 7, (5,)), jax.random.choice(j, 7, (5,)))
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    close(keys.choice(k, torch.from_numpy(a), (2, 3), axis=1), jax.random.choice(j, jnp.asarray(a), (2, 3), axis=1))
    p = np.array([0.3, 0.05, 0.9], np.float32)
    equal(keys.geometric(k, torch.from_numpy(p)), jax.random.geometric(j, jnp.asarray(p)))
    equal(keys.geometric(k, 0.2, (50,)), jax.random.geometric(j, 0.2, (50,)))
    with pytest.raises(TypeError, match="torch.Generator"):
        keys.choice(k, 7, (3,), replace=False)


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------

#: every public function of the VI modules that takes a source of
#: randomness first (a loss's estimator takes it first; ``fit`` as
#: ``key=``), with the test that holds it under a key
AUDITED = {
    "genjax_tpu_torch.inference.vi": {
        "ELBO": "test_the_losses_estimate_the_references_gradient",
        "IWELBO": "test_the_losses_estimate_the_references_gradient",
        "PWake": "test_the_losses_estimate_the_references_gradient",
        "QWake": "test_the_losses_estimate_the_references_gradient",
        "fit": "test_fit_splits_a_key_a_step_and_a_key_an_estimate",
        "adev_distribution": "test_the_guide_distributions_sample_under_a_key",
    },
    "genjax_tpu_torch.inference.advi": {
        "advi": "test_advi_splits_the_key_as_the_reference_does",
        "column_advi": "test_column_advi_and_its_draws",
    },
    "genjax_tpu_torch.inference.learning": {
        "fit_map": "test_fit_map_and_laplace_start_where_the_reference_starts",
        "laplace_approximation": "test_fit_map_and_laplace_start_where_the_reference_starts",
    },
    "genjax_tpu_torch.inference.pathfinder": {
        "pathfinder": "test_pathfinder_draws_the_references_start_and_draws",
        "multi_pathfinder": "test_column_pathfinder_and_its_draws",
        "column_pathfinder": "test_column_pathfinder_and_its_draws",
    },
}
#: the same for ``core/keys.py``: the draws this slice adds are held above,
#: the rest by ``test_torch_keys*.py`` of the earlier slices
KEYS_HELD = {"choice", "geometric"}


@pytest.mark.parametrize("module", sorted(AUDITED))
def test_the_audit_names_every_entry_point(module):
    mod = importlib.import_module(module)
    public = set()
    for name, fn in vars(mod).items():
        if name.startswith("_") or not inspect.isfunction(fn) or fn.__module__ != module:
            continue
        params = list(inspect.signature(fn).parameters)
        if (params and params[0] in ("gen", "key", "k", "seed", "stream")) or "key" in params:
            public.add(name)
    assert public <= set(AUDITED[module]), public - set(AUDITED[module])
    for test in AUDITED[module].values():
        assert test in globals()


def test_every_key_draw_of_core_keys_is_held():
    held_before = {"key", "split", "fold_in", "bits", "uniform", "normal", "randint", "bernoulli", "gumbel",
                   "categorical", "gamma", "loggamma", "beta", "dirichlet", "chisquare", "t", "erfinv",
                   "threefry2x32", "entry_stream", "sampler_stream", "split_stream", "vmap_streams", "split_each",
                   "split_pairs", "sweep_streams", "normal_from", "uniform_from"}
    public = {n for n, fn in vars(keys).items()
              if not n.startswith("_") and inspect.isfunction(fn) and fn.__module__ == keys.__name__}
    assert public <= held_before | KEYS_HELD, public - held_before - KEYS_HELD

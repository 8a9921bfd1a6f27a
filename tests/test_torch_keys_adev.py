"""ADEV under a key, draw for draw against ``genjax_tpu/adev``.

From the same seed, ``core.keys.key(s)`` and ``jax.random.key(s)`` (both
threefry2x32, and the rbg kind) drive the port's transform and the
reference's CPS interpreter to the same estimates: every strategy splits
the key as its reference does (a tail call into its draw's key and its
continuation's, ``REINFORCE`` and ``flip_mvd`` into their continuation's
and their draw's), the enumerations hand their continuations the
reference's keys (``flip_enum`` one key to both branches, the parallel
enumerations ``split(key, n)``), ``baseline`` and ``add_cost`` pass the key
on, and a ``normal_reparam`` vmapped inside the program draws lane ``i``
under ``split(k, lanes)[i]``. The programs write ``torch.where`` where the
reference's write ``jnp.where`` (no ``lax.cond``: the reference splits its
key at a cond, which the port's programs have no counterpart of).

Where the reference's pure continuation (``flip_mvd``'s other branch)
reaches a later draw, it draws under ``fold_in(key, i)``, ``i`` the draw's
equation index in the reference's staged program: the port raises
``GFITypeError`` there, and holds ``flip_mvd`` draw for draw where its pure
continuation draws nothing.

Gradients, estimates and tangents within rtol 1e-5 (atol 1e-6), except
``beta_implicit``'s gradient: torch's implicit gamma derivative
(``_standard_gamma_grad``) and JAX's (``random_gamma_grad``) are two series
for one function, which agree to 2e-4 here; its draws are equal to 1e-5.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu.adev as RA
import genjax_tpu_torch.adev as A
from genjax_tpu_torch.adev import core as adev_core
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.generative.typecheck import GFITypeError
from torch_threads import _one_thread  # noqa: F401

jax.config.update("jax_platforms", "cpu")

TOL = 1e-5
BETA_GRAD_TOL = 2e-4
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


def flat(tree):
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x) for x in jax.tree_util.tree_leaves(tree)]


def same_tree(got, want, tol=TOL):
    g, w = flat(got), flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        close(a, b, tol)


def where(b, x, y):
    return torch.where(b, x, y)


def rwhere(b, x, y):
    return jnp.where(b, x, y)


# ----------------------------------------------------------------------
# the programs: each a pair (port, reference) over the same arguments,
# written once with the package's primitives P and its where
# ----------------------------------------------------------------------


def _quad(P, w, mu):
    return (P.normal_reparam(mu, 1.0) - 2.0) ** 2


def _reinforce_then_reparam(P, w, p):
    return w(P.flip_reinforce(p), 1.0, 0.0) + P.normal_reparam(0.0, 1.0)


def _enum_with_draws(P, w, p):
    x = P.normal_reparam(p, 0.5)
    b = P.flip_enum(p)
    return w(b, P.normal_reparam(2.0 * x, 0.3), P.normal_reparam(-1.0, 0.3) * x) + P.normal_reparam(0.0, 1.0)


def _two_enums(P, w, p):
    b1 = P.flip_enum(p)
    x = P.normal_reparam(w(b1, 1.0, -1.0) * p, 1.0)
    b2 = P.flip_enum(0.5 * p)
    return w(b2, x * x, x) + P.normal_reparam(x, 0.5)


def _enum_parallel(P, w, p):
    b = P.flip_enum_parallel(p)
    return w(b, 5.0, 1.0) * P.normal_reparam(p, 1.0) + P.uniform()


def _categorical_enum(P, w, logits):
    i = P.categorical_enum_parallel(logits)
    return (1.0 * i) ** 2 + P.normal_reparam(logits[0], 1.0) * i


def _mvd_held(P, w, p):
    x = P.normal_reparam(p, 1.0)
    b = P.flip_mvd(p)
    return w(b, x * x, 2.0 * x)


def _mvd_reaching_a_later_draw(P, w, p):
    b = P.flip_mvd(p)
    return w(b, P.normal_reparam(0.0, 1.0), 1.0)


def _baselines(P, w, p):
    b = P.baseline(P.flip_reinforce)(0.4, p)
    x = P.baseline(P.normal_reparam)(0.1, p, 1.0)
    c = P.baseline(P.flip_enum)(0.7, p)
    return w(b, x, 2.0) + w(c, 1.0, x * x) + P.normal_reparam(x, 0.2)


def _baseline_mvd(P, w, p):
    x = P.normal_reparam(p, 1.0)
    b = P.baseline(P.flip_mvd)(0.3, p)
    return w(b, x, 3.0)


def _add_cost(P, w, p):
    x = P.normal_reparam(p, 1.0)
    P.add_cost(x * x)
    b = P.flip_enum(p)
    P.add_cost(w(b, x, -x))
    return P.normal_reparam(x, 0.5)


def _vmapped_reparam(P, w, mu):
    vm = torch.func.vmap if P is A else jax.vmap
    xs = vm(lambda m: P.normal_reparam(m, 1.0))(mu * MUS[P is A])
    return (xs * xs).sum() + P.normal_reparam(mu, 1.0)


def _reinforces(P, w, p):
    n = P.normal_reinforce(p, 1.0)
    k = P.geometric_reinforce(0.3 + 0.2 * p)
    return n * n + 1.0 * k + w(P.flip_reinforce(p), n, 0.0)


def _mv(P, w, mu):
    ones = torch.ones(3) if P is A else jnp.ones(3)
    a = P.mv_normal_diag_reparam(mu * ones, 0.5 * ones)
    cov = COV[P is A]
    b = P.mv_normal_reparam(mu * ones, cov)
    return (a * b).sum()


def _beta(P, w, ab):
    return P.beta_implicit(ab[0], ab[1]) * P.normal_reparam(ab[0], 1.0)


MUS = {True: torch.tensor([0.5, -1.0, 2.0, 0.0]), False: jnp.asarray([0.5, -1.0, 2.0, 0.0])}
_C = np.array([[1.0, 0.3, 0.1], [0.3, 2.0, 0.2], [0.1, 0.2, 0.5]], np.float32)
COV = {True: torch.from_numpy(_C), False: jnp.asarray(_C)}

PROGRAMS = {
    "normal_reparam": (_quad, 0.5),
    "flip_reinforce": (_reinforce_then_reparam, 0.3),
    "flip_enum": (_enum_with_draws, 0.3),
    "two_flip_enums": (_two_enums, 0.6),
    "flip_enum_parallel": (_enum_parallel, 0.25),
    "categorical_enum_parallel": (_categorical_enum, np.array([0.1, -0.4, 0.8], np.float32)),
    "flip_mvd": (_mvd_held, 0.35),
    "baseline": (_baselines, 0.45),
    "baseline_flip_mvd": (_baseline_mvd, 0.55),
    "add_cost": (_add_cost, 0.4),
    "vmapped_normal_reparam": (_vmapped_reparam, 0.7),
    "reinforce_samplers": (_reinforces, 0.3),
    "mv_normal_reparams": (_mv, 0.2),
}


def _pair(body):
    return (A.expectation(lambda *a: body(A, where, *a)), RA.expectation(lambda *a: body(RA, rwhere, *a)))


def _arg(x, port: bool):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x) if port else jnp.asarray(x)
    return x


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_every_strategy_estimates_the_references_gradient(name, seed, impl):
    body, arg = PROGRAMS[name]
    port, ref = _pair(body)
    got = port.grad_estimate(tk(seed, impl), (_arg(arg, True),))
    want = ref.grad_estimate(jk(seed, impl), (_arg(arg, False),))
    same_tree(got, want)


def test_the_two_programs_written_out():
    """The reference's values under ``key(0)``, written out (the programs
    are held against the reference under more keys above)."""
    for body, arg, want in ((_quad, 0.5, -5.5149555), (_reinforce_then_reparam, 0.3, -1.2925605)):
        port, _ = _pair(body)
        close(port.grad_estimate(tk(0), (arg,))[0], want)


@pytest.mark.parametrize("seed,impl", KEYS, ids=KEY_IDS)
def test_beta_implicit_draws_the_references_beta(seed, impl):
    port, ref = _pair(_beta)
    ab = np.array([2.0, 3.0], np.float32)
    close(port.estimate(tk(seed, impl), (torch.from_numpy(ab),)), ref.estimate(jk(seed, impl), (jnp.asarray(ab),)))
    same_tree(port.grad_estimate(tk(seed, impl), (torch.from_numpy(ab),)),
              ref.grad_estimate(jk(seed, impl), (jnp.asarray(ab),)), BETA_GRAD_TOL)


@pytest.mark.parametrize("seed,impl", [(0, "threefry2x32"), (0, "rbg")], ids=["key0", "rbg"])
@pytest.mark.parametrize("name", ["flip_enum", "two_flip_enums", "add_cost", "flip_mvd"])
def test_estimate_and_jvp_estimate_follow_the_key(name, seed, impl):
    body, arg = PROGRAMS[name]
    port, ref = _pair(body)
    close(port.estimate(tk(seed, impl), (arg,)), ref.estimate(jk(seed, impl), (arg,)))
    dual = port.jvp_estimate(tk(seed, impl), (A.Dual(arg, 1.0),))
    rdual = ref.jvp_estimate(jk(seed, impl), (RA.Dual(jnp.float32(arg), jnp.float32(1.0)),))
    close(dual.primal, rdual.primal)
    close(dual.tangent, rdual.tangent)


def test_a_batch_of_estimates_under_split_keys():
    """``torch.func.vmap`` over ``split(key, n)``, as the reference's
    ``bench_vi`` batches its estimates with ``jax.vmap``."""
    port, ref = _pair(_two_enums)
    got = torch.func.vmap(lambda k: port.grad_estimate(k, (0.6,))[0])(keys.split(tk(5), 6))
    want = jax.jit(jax.vmap(lambda k: ref.grad_estimate(k, (0.6,))[0]))(jax.random.split(jk(5), 6))
    close(got, want)
    assert len(set(np.round(got.numpy(), 5).tolist())) > 1


def test_flip_mvd_raises_where_its_pure_continuation_reaches_a_later_draw():
    port, _ = _pair(_mvd_reaching_a_later_draw)
    with pytest.raises(GFITypeError, match="torch.Generator"):
        port.grad_estimate(tk(0), (0.3,))
    # a generator draws it, in law, as before
    (g,) = port.grad_estimate(torch.Generator().manual_seed(0), (0.3,))
    assert torch.isfinite(g)


def test_a_vmap_nested_in_the_programs_vmap_raises_under_a_key():
    @A.expectation
    def nested(mu):
        inner = lambda m: torch.func.vmap(lambda x: A.normal_reparam(x, 1.0))(m * torch.ones(2))  # noqa: E731
        return torch.func.vmap(inner)(mu * torch.ones(3)).sum()

    with pytest.raises(GFITypeError, match="torch.Generator"):
        nested.grad_estimate(tk(0), (0.5,))


PRIMS = {
    "flip_enum": (0.3,), "flip_mvd": (0.3,), "flip_reinforce": (0.3,), "flip_enum_parallel": (0.7,),
    "geometric_reinforce": (0.3,), "normal_reinforce": (0.5, 2.0), "normal_reparam": (0.5, 2.0), "uniform": (),
    "mv_normal_diag_reparam": (np.zeros(3, np.float32), np.ones(3, np.float32)),
    "mv_normal_reparam": (np.zeros(3, np.float32), _C),
    "categorical_enum_parallel": (np.array([0.1, 0.5, -0.2], np.float32),),
    "beta_implicit": (2.0, 3.0),
}


@pytest.mark.parametrize("name", list(PRIMS))
def test_a_draw_outside_a_transform_samples_under_its_key(name):
    args = PRIMS[name]
    for seed, impl in KEYS:
        got = getattr(A, name)(*(_arg(a, True) for a in args), gen=tk(seed, impl))
        want = jax.jit(lambda k: RA.core.sample_primitive(getattr(RA, name), *(_arg(a, False) for a in args),
                                                          key=k))(jk(seed, impl))
        close(got, want)


def test_the_generator_helpers_refuse_a_key():
    for fn in (adev_core.fork, lambda k: adev_core.derived_seed(k, b"salt")):
        with pytest.raises(GFITypeError, match="torch.Generator"):
            fn(tk(0))


#: every public function of the two ADEV modules, with what holds it here
#: under a key: the transform's entry points are ``Expectation``'s methods,
#: ``transform_forward`` and ``ADEVProgram.jvp_estimate`` (held above)
AUDITED = {
    "genjax_tpu_torch.adev.core": {
        "sample_primitive": "test_a_draw_outside_a_transform_samples_under_its_key",
        "transform_forward": "test_transform_forward_follows_the_key",
        "expectation": "test_every_strategy_estimates_the_references_gradient",
        "fork": "test_the_generator_helpers_refuse_a_key",
        "derived_seed": "test_the_generator_helpers_refuse_a_key",
    },
    "genjax_tpu_torch.adev.primitives": {
        "reinforce": "test_every_strategy_estimates_the_references_gradient",
        "baseline": "test_every_strategy_estimates_the_references_gradient",
        "add_cost": "test_every_strategy_estimates_the_references_gradient",
    },
}


@pytest.mark.parametrize("module", sorted(AUDITED))
def test_the_audit_names_every_public_function(module):
    mod = importlib.import_module(module)
    public = {n for n, fn in vars(mod).items()
              if not n.startswith("_") and inspect.isfunction(fn) and fn.__module__ == module}
    assert public == set(AUDITED[module]), public ^ set(AUDITED[module])
    for test in AUDITED[module].values():
        assert test in globals()


def test_transform_forward_follows_the_key():
    body, arg = PROGRAMS["two_flip_enums"]
    port = adev_core.transform_forward(lambda p: body(A, where, p))(tk(3), (A.Dual(arg, 1.0),))
    ref = RA.core.transform_forward(lambda p: body(RA, rwhere, p))(jk(3), (RA.Dual(jnp.float32(arg), jnp.float32(1.0)),))
    close(port.primal, ref.primal)
    close(port.tangent, ref.tangent)


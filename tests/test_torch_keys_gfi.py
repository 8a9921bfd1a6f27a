"""The trace path under a key, draw for draw against ``genjax_tpu``.

From the same seed, ``genjax_tpu_torch.core.keys.key(s)`` and
``jax.random.key(s)`` drive the port and the reference to the same draws:
the GFI of small ``@gen`` models (``simulate``, ``generate``,
``importance``, ``project`` and the ``Regenerate`` and ``Update`` edits), the
``vmap``, ``scan`` and ``switch`` combinators over them, ``mh`` and
``run_chains``, every catalog distribution whose reference sampler a key
reproduces (the others raise ``GFITypeError``), the flagship's ``generate``
then ``mh(HMC(...))`` at 8 chains, and ``entry()`` itself at its 256 chains.
Choices, scores and weights are held to 1e-5, accept flags and discrete
draws equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu.dists.catalog as R
import genjax_tpu_torch as g
import genjax_tpu_torch.dists.catalog as P
from genjax_tpu_torch.core import keys
from genjax_tpu_torch.generative.typecheck import GFITypeError
from test_torch_catalog import CASES
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def tk(seed):
    return keys.key(seed, device="cpu")


def jk(seed):
    return jax.random.key(seed)


def close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=1e-6)


def same_choices(chm, ref_chm, addrs):
    for addr in addrs:
        v = chm[addr]
        v = v.unmask() if isinstance(v, g.Mask) else v
        rv = ref_chm[addr]
        rv = rv.unmask() if isinstance(rv, gj.Mask) else rv
        close(v.to(torch.float32), np.asarray(rv, np.float32))


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"
    b = g.flip(0.3) @ "b"
    return g.normal(x, 0.5) @ "y" + b.to(torch.float32)


@gj.gen
def model_ref(mu):
    x = gj.normal(mu, 1.0) @ "x"
    b = gj.flip(0.3) @ "b"
    return gj.normal(x, 0.5) @ "y" + b.astype(jnp.float32)


@g.gen
def outer():
    z = model(0.5) @ "inner"
    return g.log_normal(z, 0.2) @ "w"


@gj.gen
def outer_ref():
    z = model_ref(0.5) @ "inner"
    return gj.log_normal(z, 0.2) @ "w"


ADDRS = ["x", "b", "y"]
OUTER = [("inner", "x"), ("inner", "b"), ("inner", "y"), "w"]


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_simulate(seed):
    tr, rt = model.simulate(tk(seed), (0.2,)), model_ref.simulate(jk(seed), (0.2,))
    same_choices(tr.get_choices(), rt.get_choices(), ADDRS)
    close(tr.get_score(), rt.get_score())
    close(tr.get_retval(), rt.get_retval())
    tr, rt = outer.simulate(tk(seed), ()), outer_ref.simulate(jk(seed), ())
    same_choices(tr.get_choices(), rt.get_choices(), OUTER)
    close(tr.get_score(), rt.get_score())


@pytest.mark.parametrize("seed", [1, 2])
def test_generate_and_importance(seed):
    obs, ref_obs = g.C["y"].set(0.4), gj.C["y"].set(0.4)
    for method in ("generate", "importance"):
        tr, w = getattr(model, method)(tk(seed), obs, (0.2,))
        rt, rw = getattr(model_ref, method)(jk(seed), ref_obs, (0.2,))
        same_choices(tr.get_choices(), rt.get_choices(), ADDRS)
        close(w, rw)
        close(tr.get_score(), rt.get_score())
    tr, w = outer.generate(tk(seed), g.C["w"].set(1.5), ())
    rt, rw = outer_ref.generate(jk(seed), gj.C["w"].set(1.5), ())
    same_choices(tr.get_choices(), rt.get_choices(), OUTER)
    close(w, rw)


def test_project_and_edits():
    tr, rt = model.simulate(tk(3), (0.2,)), model_ref.simulate(jk(3), (0.2,))
    close(tr.project(tk(4), g.S["x"]), rt.project(jk(4), gj.S["x"]))
    for req, ref_req in [
        (g.Regenerate(g.S["x"]), gj.Regenerate(gj.S["x"])),
        (g.Regenerate(g.S["b"] | g.S["y"]), gj.Regenerate(gj.S["b"] | gj.S["y"])),
        (g.Update(g.C["x"].set(0.5)), gj.Update(gj.C["x"].set(0.5))),
    ]:
        new, w, _rd, _bwd = tr.edit(tk(5), req)
        ref_new, rw, _rd, _bwd = rt.edit(jk(5), ref_req)
        same_choices(new.get_choices(), ref_new.get_choices(), ADDRS)
        close(w, rw)
        close(new.get_score(), ref_new.get_score())
    tr, rt = outer.simulate(tk(6), ()), outer_ref.simulate(jk(6), ())
    new, w, _rd, _bwd = tr.edit(tk(8), g.Regenerate(g.S["inner", "x"]))
    ref_new, rw, _rd, _bwd = rt.edit(jk(8), gj.Regenerate(gj.S["inner", "x"]))
    same_choices(new.get_choices(), ref_new.get_choices(), OUTER)
    close(w, rw)


@g.gen
def step(c, x):
    z = g.normal(c, 1.0) @ "z"
    return z, z + x


@gj.gen
def step_ref(c, x):
    z = gj.normal(c, 1.0) @ "z"
    return z, z + x


COMBINATORS = {
    "vmap": (model.vmap(), model_ref.vmap(), (torch.tensor([0.0, 1.0, -1.0]),), (jnp.asarray([0.0, 1.0, -1.0]),)),
    "scan": (step.scan(n=4), step_ref.scan(n=4), (0.0, torch.zeros(4)), (0.0, jnp.zeros(4))),
    "switch": (g.switch(model, model), gj.switch(model_ref, model_ref), (torch.tensor(1), (0.0,), (3.0,)),
               (jnp.int32(1), (0.0,), (3.0,))),
}


@pytest.mark.parametrize("name", sorted(COMBINATORS))
def test_combinators(name):
    gf, ref, args, ref_args = COMBINATORS[name]
    tr, rt = gf.simulate(tk(11), args), ref.simulate(jk(11), ref_args)
    close(tr.get_score(), rt.get_score())
    close(pytree_leaf(tr.get_retval()), pytree_leaf(rt.get_retval()))
    tr2, w = gf.generate(tk(12), g.ChoiceMap.empty(), args)
    rt2, rw = ref.generate(jk(12), gj.ChoiceMap.empty(), ref_args)
    close(tr2.get_score(), rt2.get_score())
    new, w, _rd, _bwd = tr.edit(tk(13), g.Regenerate(g.Selection.all()))
    ref_new, rw, _rd, _bwd = rt.edit(jk(13), gj.Regenerate(gj.Selection.all()))
    close(w, rw)
    close(new.get_score(), ref_new.get_score())
    close(pytree_leaf(new.get_retval()), pytree_leaf(ref_new.get_retval()))


def pytree_leaf(v):
    """The first leaf of a return value (a scan's is a pair)."""
    while isinstance(v, (tuple, list)):
        v = v[0]
    return v


def test_mh_and_run_chains():
    tr, rt = model.simulate(tk(20), (0.2,)), model_ref.simulate(jk(20), (0.2,))
    for seed in range(21, 25):
        tr, acc = g.mh(tk(seed), tr, g.S["x"])
        rt, racc = gj.mh(jk(seed), rt, gj.S["x"])
        assert bool(acc) == bool(racc)
        same_choices(tr.get_choices(), rt.get_choices(), ADDRS)
    res = g.run_chains(tk(30), lambda k: model.simulate(k, (0.2,)), g.S["x"], 3, 5, device="cpu",
                       record=lambda t: t.get_choices()["x"])
    ref = gj.run_chains(jk(30), lambda k: model_ref.simulate(k, (0.2,)), gj.S["x"], 3, 5,
                        record=lambda t: t.get_choices()["x"])
    close(res.history, ref.history)
    close(res.accept_rate, ref.accept_rate)


# ----------------------------------------------------------------------
# the catalog under a key
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_distribution_draws_the_reference_draw_or_raises(name):
    _v, args = CASES[name]
    port, ref = getattr(P, name), getattr(R, name)
    if name in P.UNKEYED:
        with pytest.raises(GFITypeError, match=f"{name}.*torch.Generator"):
            port.sample(tk(0), *args)
        with pytest.raises(GFITypeError):
            port.simulate(tk(0), args)
        return
    for seed, shape in [(0, ()), (5, (4,))]:
        got = port.sample(tk(seed), *args, sample_shape=shape)
        want = np.asarray(ref.sample(jk(seed), *args, sample_shape=shape))
        assert tuple(got.shape) == want.shape
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
        else:
            close(got, want)
    tr, rt = port.simulate(tk(9), args), ref.simulate(jk(9), args)
    close(tr.get_score(), rt.get_score())


def test_the_catalog_splits_into_reproduced_and_listed():
    assert set(P._KEYED) | set(P.UNKEYED) == set(CASES) and not set(P._KEYED) & set(P.UNKEYED)
    for name in ("normal", "log_normal", "mv_normal_diag", "uniform", "flip", "categorical", "exponential"):
        assert name in P._KEYED
    tdist = g.torch_distribution(torch.distributions.Normal)
    with pytest.raises(GFITypeError, match="torch.Generator"):
        tdist.sample(tk(0), 0.0, 1.0)


# ----------------------------------------------------------------------
# the flagship: entry()'s transition
# ----------------------------------------------------------------------


def _flagship():
    from genjax_tpu_torch.models import hierarchical_regression

    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return hierarchical_regression(torch.from_numpy(X)), g.C["y"].set(torch.from_numpy(y))


def _port_step(regression, obs):
    def one(k):
        k0, k1 = keys.split(k).unbind(-2)
        tr, w = regression.generate(k0, obs, ())
        new, accepted = g.mh(k1, tr, g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5))
        return tr.get_choices()["w"], w, new.get_choices()["w"], new.get_choices()["tau"], new.get_score(), accepted

    return one


def test_flagship_at_8_chains_draw_for_draw():
    import __graft_entry__ as entry

    regression, obs = _flagship()
    w0, w_gen, w1, tau1, score1, acc = torch.func.vmap(_port_step(regression, obs))(keys.split(tk(0), 8))
    ref_reg, y = entry._flagship_model()

    def one(k):
        k0, k1 = jax.random.split(k)
        tr, w = ref_reg.generate(k0, gj.C["y"].set(y), ())
        new, accepted = gj.mh(k1, tr, gj.HMC(gj.S["w"] | gj.S["tau"], 0.02, L=5))
        return tr.get_choices()["w"], w, new.get_choices()["w"], new.get_choices()["tau"], new.get_score(), accepted

    r_w0, r_wgen, r_w1, r_tau1, r_score1, r_acc = jax.vmap(one)(jax.random.split(jk(0), 8))
    close(w0, r_w0)
    close(w_gen, r_wgen)
    close(w1, r_w1)
    close(tau1, r_tau1)
    close(score1, r_score1)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(r_acc))


def test_entry_at_256_chains():
    """``entry()``'s batched transition under ``key(0)``: mean ``w`` and
    mean accept equal the reference's to 1e-5."""
    import __graft_entry__ as entry

    fn, (key,) = entry.entry()
    ref_w, ref_acc = fn(key)
    regression, obs = _flagship()
    _w0, _wg, w1, _tau, _s, acc = torch.func.vmap(_port_step(regression, obs))(keys.split(tk(0), 256))
    close(w1.mean(0), ref_w)
    close(acc.to(torch.float32).mean(), ref_acc)


def test_a_key_and_a_trace_on_different_devices_raise():
    """An entry point that receives a trace runs where it lives: a key on
    another device raises, naming the key."""
    tr = model.simulate(tk(40), (0.2,))
    elsewhere = keys.key(0, device="meta")
    for call in (lambda: g.mh(elsewhere, tr, g.S["x"]), lambda: tr.edit(elsewhere, g.Regenerate(g.S["x"])),
                 lambda: g.mh_accept(elsewhere, tr, tr, torch.tensor(0.0))):
        with pytest.raises(ValueError, match="the trace lives on cpu and the key on meta"):
            call()
    with pytest.raises(ValueError, match="the key lives on meta"):
        g.run_chains(elsewhere, lambda k: model.simulate(k, (0.2,)), g.S["x"], 1, 2, device="cpu")
    trs = torch.func.vmap(lambda k: model.simulate(k, (0.2,)))(keys.split(tk(42), 2))
    with pytest.raises(ValueError, match="the trace lives on cpu and the key on meta"):
        g.run_chains_hmc(elsewhere, trs, g.S["x"], eps=0.1)
    # a key on the traces' device draws what the reference's run_chains_hmc draws
    new, acc = g.run_chains_hmc(tk(41), trs, g.S["x"], eps=0.1)
    ref = jax.vmap(lambda k: model_ref.simulate(k, (0.2,)))(jax.random.split(jk(42), 2))
    want, want_acc = gj.run_chains_hmc(jk(41), ref, gj.S["x"], eps=0.1)
    close(new.get_choices()["x"], want.get_choices()["x"])
    close(acc, want_acc)

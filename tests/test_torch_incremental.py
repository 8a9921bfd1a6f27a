"""The incremental edit of the port's ``@gen`` bodies and ``Dimap``, against
``genjax_tpu``.

The port's counterparts of ``tests/generative_functions/test_incremental_speed.py``
(the staged edit's cost and weights), ``test_staged_edit_fallback.py`` and
``test_staged_fallback_conservative.py`` (the fallback). XLA's FLOP count has
no torch counterpart, so the cost is the number of aten ops an edit runs,
counted by a ``TorchDispatchMode``, held to the reference's ratios; the
sub-edits dispatched are read from ``StaticGenerativeFunction.edit``. Both
packages edit the same traces, made by ``generate`` from the same numpy
choices; weights agree to 1e-5 and round trips cancel to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu_torch.core.changes import ChangeMode, changed_through
from genjax_tpu_torch.core.diff import Diff, NoChange, UnknownChange
from genjax_tpu_torch.lang.static_lang import StaticGenerativeFunction, forced_clean_prefix
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4
EDIT = StaticGenerativeFunction.edit


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=tol, atol=tol)


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn):
    with _AtenOps() as counter:
        fn()
    return counter.n


def both(mod_fn, flat):
    """The same trace in both packages: each model ``generate``d under the
    full choices ``flat`` (numpy)."""
    jm, tm = mod_fn(gj), mod_fn(g)
    jtr, _ = jm.generate(jax.random.key(0), gj.ChoiceMap.d({k: jnp.asarray(v) for k, v in flat.items()}), ())
    ttr, _ = tm.generate(gen_at(0), g.ChoiceMap.d({k: torch.as_tensor(v) for k, v in flat.items()}), ())
    _close(ttr.get_score(), jtr.get_score())
    return jtr, ttr


def update_both(jtr, ttr, values: dict):
    jnew, jw, jrd, jbwd = jtr.edit(jax.random.key(1), gj.Update(gj.ChoiceMap.d({k: jnp.asarray(v) for k, v in values.items()})))
    tnew, tw, trd, tbwd = ttr.edit(gen_at(1), g.Update(g.ChoiceMap.d({k: torch.as_tensor(v) for k, v in values.items()})))
    _close(tw, jw)
    _close(tnew.get_score(), jnew.get_score())
    return (jnew, jw, jrd, jbwd), (tnew, tw, trd, tbwd)


# ----------------------------------------------------------------------
# cost: aten ops and sub-edits
# ----------------------------------------------------------------------

N_WIDE, D = 50, 16


def wide(m, xp):
    @m.gen
    def body():
        for i in range(N_WIDE):
            m.normal(xp.full((D,), float(i)), 1.0) @ f"a{i}"
        return 0.0

    return body


def _wide_choices():
    rng = np.random.default_rng(0)
    return {f"a{i}": (i + rng.normal(size=D)).astype(np.float32) for i in range(N_WIDE)}


def test_editing_two_of_n_does_not_rescore_the_rest():
    """Editing 2 of 50 addresses runs fewer than 1/8 of the aten ops of
    editing all 50, dispatches 2 sub-edits, and weighs what the reference
    weighs."""
    jtr, ttr = both(lambda m: wide(m, jnp if m is gj else _TorchFull), _wide_choices())
    v = np.full(D, 0.5, np.float32)
    two = {"a0": v, "a49": v}
    every = {f"a{i}": v for i in range(N_WIDE)}
    update_both(jtr, ttr, two)
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
    update_both(jtr, ttr, every)
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", N_WIDE)

    def edit(values):
        return lambda: ttr.edit(gen_at(1), g.Update(g.ChoiceMap.d({k: torch.as_tensor(x) for k, x in values.items()})))

    f_two, f_all = aten_ops(edit(two)), aten_ops(edit(every))
    assert f_all > 8.0 * f_two, (f_two, f_all)


class _TorchFull:
    @staticmethod
    def full(shape, v):
        return torch.full(shape, v)


N_CHAIN = 12


def chain(m, d=D):
    zeros = jnp.zeros(d) if m is gj else torch.zeros(d)

    @m.gen
    def body():
        x = m.normal(zeros, 1.0) @ "a0"
        for i in range(1, N_CHAIN):
            x = m.normal(x, 1.0) @ f"a{i}"
        return x

    return body


def _chain_choices():
    rng = np.random.default_rng(1)
    return {f"a{i}": rng.normal(size=D).astype(np.float32) for i in range(N_CHAIN)}


def test_chain_cascade_stops_where_values_stop_changing():
    """A head edit re-scores ``a0`` and ``a1`` (whose value stays), a tail
    edit ``a11`` alone; their aten ops are within 3x of each other."""
    jtr, ttr = both(chain, _chain_choices())
    v = np.full(D, 0.5, np.float32)
    (_, _, jrd, _), (_, _, trd, _) = update_both(jtr, ttr, {"a0": v})
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
    assert trd.tangent is NoChange and gj.Diff.static_check_no_change(jrd)
    (_, _, jrd, _), (_, _, trd, _) = update_both(jtr, ttr, {f"a{N_CHAIN - 1}": v})
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 1)
    assert trd.tangent is UnknownChange and not gj.Diff.static_check_no_change(jrd)

    def edit(addr):
        return lambda: ttr.edit(gen_at(1), g.Update(g.C[addr].set(torch.as_tensor(v))))

    f_first, f_last = aten_ops(edit("a0")), aten_ops(edit(f"a{N_CHAIN - 1}"))
    assert f_first < 3.0 * f_last and f_last < 3.0 * f_first, (f_first, f_last)


def small_chain(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "a0"
        y = m.normal(x, 1.0) @ "a1"
        return m.normal(y, 1.0) @ "a2"

    return body


def test_edit_weight_matches_hand_computation():
    from scipy.stats import norm

    flat = {"a0": np.float32(-0.3), "a1": np.float32(0.8), "a2": np.float32(1.1)}
    jtr, ttr = both(small_chain, flat)
    (_, jw, _, _), (tnew, tw, _, tbwd) = update_both(jtr, ttr, {"a0": np.float32(0.5)})
    x0, y0 = 0.0 + flat["a0"], 0.0 + flat["a1"]
    expected = norm.logpdf(0.5, 0, 1) - norm.logpdf(x0, 0, 1) + norm.logpdf(y0, 0.5, 1) - norm.logpdf(y0, x0, 1)
    _close(tw, expected)
    _close(jw, expected)
    score, _ = small_chain(g).assess(tnew.get_choices(), ())
    _close(tnew.get_score(), score)
    back, wb, _, _ = tnew.edit(gen_at(2), tbwd)
    assert abs(float(tw + wb)) <= ROUND_TRIP_TOL
    _close(back.get_score(), ttr.get_score(), ROUND_TRIP_TOL)


def test_the_clean_prefix_rule_gives_the_same_edit():
    """Forcing the clean-prefix rule changes which subtraces are reused,
    never the weight, the new choices or the backward request."""
    _, ttr = both(chain, _chain_choices())
    req = g.Update(g.C["a3"].set(torch.full((D,), 0.25)))
    new, w, rd, bwd = ttr.edit(gen_at(1), req)
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
    with forced_clean_prefix():
        new_c, w_c, rd_c, bwd_c = ttr.edit(gen_at(1), req)
    assert (EDIT.last_rule, EDIT.last_rule_reason, EDIT.last_dispatched) == ("clean_prefix", "forced", N_CHAIN - 3)
    _close(w, w_c)
    for i in range(N_CHAIN):
        assert torch.equal(new.get_choices()[f"a{i}"], new_c.get_choices()[f"a{i}"])
    assert torch.equal(bwd.constraint["a3"], bwd_c.constraint["a3"])
    assert rd.tangent is NoChange and rd_c.tangent is UnknownChange


def test_regenerate_and_unchanged_edit():
    """``Regenerate`` of one address redraws it alone and re-scores its
    dependent; an empty ``Update`` dispatches nothing and reports no
    change."""
    _, ttr = both(small_chain, {"a0": np.float32(0.1), "a1": np.float32(0.2), "a2": np.float32(0.3)})
    new, w, _, bwd = ttr.edit(gen_at(5), g.Regenerate(g.S["a1"]))
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
    assert new.get_inner_trace("a0") is ttr.get_inner_trace("a0")
    score, _ = small_chain(g).assess(new.get_choices(), ())
    _close(new.get_score(), score)
    new, w, rd, _ = ttr.edit(gen_at(5), g.Update(g.ChoiceMap.empty()))
    assert (EDIT.last_rule, EDIT.last_dispatched, float(w)) == ("incremental", 0, 0.0)
    assert rd.tangent is NoChange


# ----------------------------------------------------------------------
# the degrade cases: the clean-prefix rule, the reference's weights
# ----------------------------------------------------------------------


def branchy(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "x"
        if x > 0:  # Python control flow on a sampled value
            y = m.normal(2.0, 1.0) @ "y"
        else:
            y = m.normal(-2.0, 1.0) @ "y"
        return m.normal(y, 0.5) @ "z"

    return body


def item_read(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "x"
        shift = x.item() if m is g else float(x)  # the value leaves for Python
        return m.normal(shift * 2.0, 0.5) @ "y"

    return body


def view_write(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "x"
        if m is gj:
            buf = jnp.zeros(2).at[0].set(x)
        else:
            buf = torch.zeros(2)
            buf[0:1].copy_(x.reshape(1))  # a write into a view of ``buf``
        return m.normal(buf.sum(), 0.5) @ "y"

    return body


def fresh_write(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "x"
        if m is gj:
            buf = jnp.zeros(2).at[0].set(x)
        else:
            buf = torch.zeros(2)
            buf[0] = x  # a write into a tensor with no alias
        return m.normal(buf.sum(), 0.5) @ "y"

    return body


def inner_vmap(m):
    @m.gen
    def body():
        x = m.normal(0.0, 1.0) @ "x"
        vmap = jax.vmap if m is gj else torch.func.vmap
        twice = vmap(lambda a: a * 2.0)(x.reshape(1)).sum()  # a transform the body enters
        return m.normal(twice, 0.5) @ "y"

    return body


@pytest.mark.parametrize(
    "model,flat,rule",
    [
        (branchy, {"x": 0.4, "y": 1.7, "z": 1.2}, "clean_prefix"),
        (item_read, {"x": 0.4, "y": 0.9}, "clean_prefix"),
        (view_write, {"x": 0.4, "y": 0.9}, "clean_prefix"),
        (inner_vmap, {"x": 0.4, "y": 0.9}, "clean_prefix"),
        (fresh_write, {"x": 0.4, "y": 0.9}, "incremental"),
    ],
    ids=["if-on-edited", "item", "view-write", "inner-vmap", "fresh-write"],
)
def test_degrade_cases_take_the_clean_prefix_with_the_reference_weights(model, flat, rule):
    flat = {k: np.float32(v) for k, v in flat.items()}
    jtr, ttr = both(model, flat)
    (_, _, _, _), (tnew, tw, _, tbwd) = update_both(jtr, ttr, {"x": np.float32(-0.6)})
    assert EDIT.last_rule == rule, EDIT.last_rule_reason
    back, wb, _, _ = tnew.edit(gen_at(2), tbwd)
    assert abs(float(tw + wb)) <= ROUND_TRIP_TOL
    _close(back.get_score(), ttr.get_score(), ROUND_TRIP_TOL)
    # an edit that changes nothing the body reads to Python stays incremental
    update_both(jtr, ttr, {list(flat)[-1]: np.float32(0.3)})
    assert EDIT.last_rule == "incremental"


def test_write_into_a_tensor_a_callee_returned_a_view_of():
    """A callee returns a view of its argument, and the body then writes an
    edited value into the argument: the view changed, which the callee's
    unseen sub-edit cannot report, so the edit takes the clean-prefix rule.
    Torch alone (JAX writes nothing in place): held to the clean-prefix
    weight and to ``assess`` of the new choices."""

    @g.gen
    def inner(t):
        g.normal(0.0, 1.0) @ "a"
        return t[:1]  # a view of its argument

    @g.gen
    def model():
        t = torch.zeros(1)
        z = g.normal(0.0, 1.0) @ "z"
        v = inner(t) @ "in"
        t.add_(z)  # v now holds z
        return g.normal(v.sum(), 1.0) @ "y"

    zero = torch.tensor(0.0)
    tr, _ = model.generate(gen_at(0), g.ChoiceMap.d({"z": zero, "y": zero, ("in", "a"): zero}), ())
    req = g.Update(g.C["z"].set(torch.tensor(2.0)) | g.C["in", "a"].set(torch.tensor(0.5)))
    new, w, _, _ = tr.edit(gen_at(1), req)
    assert EDIT.last_rule == "clean_prefix", EDIT.last_rule_reason
    with forced_clean_prefix():
        forced, fw, _, _ = tr.edit(gen_at(1), req)
    _close(w, -4.125)
    _close(w, fw)
    score, _ = model.assess(new.get_choices(), ())
    _close(score, -6.8818, 1e-4)
    _close(new.get_score(), score)
    _close(forced.get_score(), score)


def _chain_through(levels, leaf_value):
    def make_last(v):
        return lambda: v

    fn = make_last(leaf_value)
    for _ in range(levels - 1):

        def make_link(nxt):
            return lambda: nxt()

        fn = make_link(fn)
    return fn


def deep_model(m, levels):
    @m.gen
    def body(mu):
        root = m.normal(mu, 1.0) @ "root"
        reach = _chain_through(levels, root)

        @m.gen
        def leaf():
            return m.normal(reach(), 0.7) @ "c"

        return leaf() @ "dep"

    return body


@pytest.mark.parametrize("levels", [1, 12])
def test_closure_captured_changed_value_degrades(levels):
    """A local ``@gen`` that reaches the edited ``root`` through Python
    closure cells re-scores ``c`` under the new ``root``: the edit degrades
    (as the reference's staging refuses such a body) and weighs what the
    reference weighs."""
    jm, tm = deep_model(gj, levels), deep_model(g, levels)
    jtr, _ = jm.generate(jax.random.key(0), gj.C["root"].set(0.2) | gj.C["dep", "c"].set(-0.4), (0.3,))
    ttr, _ = tm.generate(gen_at(0), g.C["root"].set(0.2) | g.C["dep", "c"].set(-0.4), (0.3,))
    _close(ttr.get_score(), jtr.get_score())
    # a traced value, as in the reference's own test: a Python number there
    # is staged as a constant, which its closure check does not see
    _, jw, _, _ = jtr.edit(jax.random.key(1), gj.Update(gj.C["root"].set(jnp.float32(2.5))))
    tnew, tw, _, _ = ttr.edit(gen_at(1), g.Update(g.C["root"].set(2.5)))
    assert EDIT.last_rule == "clean_prefix", EDIT.last_rule_reason
    _close(tw, jw)
    score, _ = tm.assess(tnew.get_choices(), (0.3,))
    _close(tnew.get_score(), score, ROUND_TRIP_TOL)


def test_unchanged_closure_capture_stays_incremental():
    """A local ``@gen`` capturing a value the edit leaves alone is reused."""
    tm = deep_model(g, 1)
    ttr, _ = tm.generate(gen_at(0), g.C["root"].set(0.2) | g.C["dep", "c"].set(-0.4), (0.3,))
    new, w, _, _ = ttr.edit(gen_at(1), g.Update(g.C["dep", "c"].set(0.1)))
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 1)
    _close(new.get_score(), ttr.get_score() + w)


def test_vmapped_edit_has_the_rule_and_weights_of_the_unvmapped_one():
    flats = [{"a0": np.float32(0.1 * k - 0.2), "a1": np.float32(0.3 - 0.2 * k), "a2": np.float32(0.5 * k)} for k in range(3)]
    m = small_chain(g)
    singles = [both(small_chain, flat)[1] for flat in flats]
    stacked = {k: torch.tensor([f[k] for f in flats]) for k in flats[0]}
    trs = torch.func.vmap(
        lambda a0, a1, a2: m.generate(gen_at(0), g.C["a0"].set(a0) | g.C["a1"].set(a1) | g.C["a2"].set(a2), ())[0],
        randomness="different",
    )(stacked["a0"], stacked["a1"], stacked["a2"])
    req = g.Update(g.C["a0"].set(torch.tensor(0.5)))
    _, ws = torch.func.vmap(lambda tr: tr.edit(gen_at(1), req)[:2], randomness="different")(trs)
    assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
    for k, tr in enumerate(singles):
        _, w, _, _ = tr.edit(gen_at(1), req)
        assert (EDIT.last_rule, EDIT.last_dispatched) == ("incremental", 2)
        _close(ws[k], w)
    @g.gen
    def view_write_arg(base):
        x = g.normal(0.0, 1.0) @ "x"
        buf = base.clone()
        buf[0:1].copy_(x.reshape(1))  # a write into a view of ``buf``
        return g.normal(buf.sum(), 0.5) @ "y"

    bases = torch.zeros(2, 2)
    trs = torch.func.vmap(
        lambda b, x: view_write_arg.generate(gen_at(0), g.C["x"].set(x) | g.C["y"].set(x * 2.0), (b,))[0],
        randomness="different",
    )(bases, torch.tensor([0.1, -0.3]))
    req = g.Update(g.C["x"].set(torch.tensor(0.7)))
    ws = torch.func.vmap(lambda tr: tr.edit(gen_at(1), req)[1], randomness="different")(trs)
    assert EDIT.last_rule == "clean_prefix"
    for k, x in enumerate((0.1, -0.3)):
        tr, _ = view_write_arg.generate(gen_at(0), g.C["x"].set(torch.tensor(x)) | g.C["y"].set(torch.tensor(x * 2.0)), (bases[k],))
        assert tr.edit(gen_at(1), req)[1] == pytest.approx(float(ws[k]), abs=TOL)
        assert EDIT.last_rule == "clean_prefix"
    assert EDIT.last_rule == "clean_prefix"


# ----------------------------------------------------------------------
# the ChangeMode itself
# ----------------------------------------------------------------------


def test_change_mode_marks_dependents_and_degrades_on_escape():
    mode = ChangeMode()
    a, b = torch.ones(3), torch.ones(3)
    mode.mark(a)
    with mode:
        c, d = a * 2.0, b + 1.0
        e = torch.stack([c, d])
        parts = list(e)
        s = e.sum(0)
        shape = e.shape
    assert [mode.is_changed(t) for t in (c, d, e, s, *parts)] == [True, False, True, True, True, True]
    assert shape == (2, 3) and mode.degraded is None
    with mode:
        fresh = torch.zeros(3)
        fresh[1] = c[0]
        view = torch.zeros(3)[1:]
    assert mode.is_changed(fresh) and not mode.is_changed(view) and mode.degraded is None
    with mode:
        bool(c[0] > 0)
    assert mode.degraded == "__bool__ read an edited value"
    assert mode.is_changed(b)  # every value counts as changed once degraded


# ----------------------------------------------------------------------
# Dimap: changed_through on pre and post
# ----------------------------------------------------------------------


def _pre(m):
    return lambda a, b, c: (a * 2.0, b, jnp.zeros(2) if m is gj else torch.zeros(2))


def _post(args, r):
    a, b, _ = args
    return (r + b, a)


@pytest.mark.parametrize("flags", [(False, True, False), (True, False, False), (False, False, True)])
def test_changed_through_pre_and_post_match_the_reference(flags):
    from genjax_tpu.core.diff import changed_through as jchanged_through

    vals = (np.float32(0.5), np.float32(-1.0), np.arange(2, dtype=np.float32))
    t_args = tuple(Diff(torch.as_tensor(v), UnknownChange if f else NoChange) for v, f in zip(vals, flags))
    j_args = tuple(gj.Diff(jnp.asarray(v), gj.UnknownChange if f else gj.NoChange) for v, f in zip(vals, flags))
    for fn_t, fn_j, tdiffs, jdiffs in [
        (_pre(g), _pre(gj), t_args, j_args),
        (_post, _post, (t_args, Diff.no_change(torch.tensor(1.0))), (j_args, gj.Diff.no_change(jnp.asarray(1.0)))),
        (_post, _post, (t_args, Diff.unknown_change(torch.tensor(1.0))), (j_args, gj.Diff.unknown_change(jnp.asarray(1.0)))),
    ]:
        got = [d.tangent.name for d in torch.utils._pytree.tree_leaves(changed_through(fn_t, tdiffs), is_leaf=lambda x: isinstance(x, Diff))]
        want = [d.tangent.name for d in jax.tree_util.tree_leaves(jchanged_through(fn_j, jdiffs), is_leaf=lambda x: isinstance(x, gj.Diff))]
        assert got == want, (got, want)


def dimapped(m):
    @m.gen
    def inner(mu, s):
        x = m.normal(mu, s) @ "x"
        return m.normal(x, 1.0) @ "y"

    return inner.dimap(pre=lambda mu, s: (mu * 2.0, s), post=lambda args, r: (r, args[1] + 1.0))


def test_dimap_edit_matches_the_reference():
    """A changed scale with the mean unchanged: the inner mean stays
    ``NoChange``; the retdiff flags and the weight are the reference's."""
    jm, tm = dimapped(gj), dimapped(g)
    jtr, _ = jm.generate(jax.random.key(0), gj.C["x"].set(0.3) | gj.C["y"].set(0.9), (0.2, 1.0))
    ttr, _ = tm.generate(gen_at(0), g.C["x"].set(0.3) | g.C["y"].set(0.9), (0.2, 1.0))
    for req_t, req_j in [
        (g.Update(g.ChoiceMap.empty()), gj.Update(gj.ChoiceMap.empty())),
        (g.Update(g.C["y"].set(0.1)), gj.Update(gj.C["y"].set(0.1))),
    ]:
        t_ad = (Diff.no_change(torch.tensor(0.2)), Diff.unknown_change(torch.tensor(2.0)))
        j_ad = (gj.Diff.no_change(jnp.asarray(0.2)), gj.Diff.unknown_change(jnp.asarray(2.0)))
        tnew, tw, trd, _ = tm.edit(gen_at(1), ttr, req_t, t_ad)
        jnew, jw, jrd, _ = jm.edit(jax.random.key(1), jtr, req_j, j_ad)
        _close(tw, jw)
        _close(tnew.get_score(), jnew.get_score())
        got = [d.tangent.name for d in trd]
        want = [d.tangent.name for d in jrd]
        assert got == want, (got, want)

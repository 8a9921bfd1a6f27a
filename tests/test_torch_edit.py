"""The port's edit path against ``genjax_tpu``: choice-map filtering,
``update``, ``project``, ``Regenerate``, ``importance`` and ``propose``.

The same choices (made with numpy seeds, carried across as numpy) go through
the reference's GFI and the port's; weights, scores and discards agree to
1e-5. Every edit's backward request, applied to the new trace, restores the
old choices and cancels the forward weight to 1e-4 (the SMCP3 identity).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.models import hierarchical_regression as jax_hier
from genjax_tpu.models import linear_regression as jax_linear
from genjax_tpu_torch.core.changes import changed_through
from genjax_tpu_torch.core.diff import Diff, NoChange, UnknownChange
from genjax_tpu_torch.generative.choice_map import FilteredChm
from genjax_tpu_torch.models import hierarchical_regression, linear_regression

TOL = 1e-5  # weights, scores and discards against the reference
ROUND_TRIP_TOL = 1e-4  # forward weight + backward weight


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------
# filter / filter_eager / merge / complement / get_selection
# ----------------------------------------------------------------------

SELECTIONS = {
    "or": lambda m: m.S["x"] | m.S["y", "z"],
    "and": lambda m: (m.S["x"] | m.S["y"]) & m.S["y"],
    "not": lambda m: ~(m.S["x"] | m.S["y", "z"]),
    "complement": lambda m: (m.S["x"] | m.S["y", "z"]).complement(),
    "wildcard": lambda m: m.S[..., "z"],
    "all": lambda m: m.S.all(),
    "none": lambda m: m.S.none(),
}
ADDRS = [("x",), ("y",), ("y", "z"), ("w", "z"), ("w",), ("other",), ("nope",)]


def _grid_chm(mod):
    return (
        mod.C["x"].set(1.0) | mod.C["y", "z"].set(2.0) | mod.C["w", "z"].set(3.0)
        | mod.C["other"].set(4.0)
    )


def _same_reads(tc, jc):
    for addr in ADDRS:
        assert (addr in tc) == (addr in jc), addr
        if addr in jc:
            assert float(tc[addr]) == float(jc[addr]), addr


@pytest.mark.parametrize("how", ["filter", "filter_eager"])
@pytest.mark.parametrize("name", sorted(SELECTIONS))
def test_filter_reads_match_jax(name, how):
    jc = getattr(_grid_chm(gj), how)(SELECTIONS[name](gj))
    tc = getattr(_grid_chm(g), how)(SELECTIONS[name](g))
    _same_reads(tc, jc)
    assert tc.static_is_empty() == jc.static_is_empty()
    for addr in ADDRS:
        assert tc.get_submap(*addr).static_is_empty() == jc.get_submap(*addr).static_is_empty(), addr


@pytest.mark.parametrize("name", sorted(SELECTIONS))
def test_merge_of_the_two_halves_reads_as_the_whole(name):
    """``filter(sel).merge(filter(~sel))`` reads as the unfiltered map, in
    both packages; the eager filter carries no unselected leaf."""
    sel = SELECTIONS[name](g)
    chm = _grid_chm(g)
    _same_reads(chm.filter(sel).merge(chm.filter(~sel)), _grid_chm(gj))
    _same_reads(chm.filter_eager(sel) | chm.filter_eager(~sel), _grid_chm(gj))
    n_selected = sum(addr in chm.filter(sel) for addr in ADDRS)
    assert len(torch.utils._pytree.tree_leaves(chm.filter_eager(sel))) == n_selected


def test_get_selection_matches_jax():
    jsel, tsel = _grid_chm(gj).get_selection(), _grid_chm(g).get_selection()
    for addr in ADDRS:
        assert (addr in tsel) == (addr in jsel), addr
    _same_reads(_grid_chm(g).filter(tsel), _grid_chm(gj).filter(jsel))


def test_filter_is_lazy_and_filters_compose():
    chm = _grid_chm(g)
    lazy = chm.filter(g.S["x"] | g.S["other"])
    assert isinstance(lazy, FilteredChm) and len(torch.utils._pytree.tree_leaves(lazy)) == 4
    twice = lazy.filter(g.S["x"])
    assert ("x",) in twice and ("other",) not in twice
    assert twice.filter_eager(g.S.all()).static_addresses() == ("x",)
    assert chm.filter(True) is chm and chm.filter(False).static_is_empty()


# ----------------------------------------------------------------------
# Diff
# ----------------------------------------------------------------------


def test_diff_matches_jax():
    from genjax_tpu.core.diff import Diff as JDiff

    args = (1.0, (2.0, 3.0))
    for mod in (Diff, JDiff):
        assert mod.static_check_no_change(mod.tree_diff_no_change(args))
        assert not mod.static_check_no_change(mod.tree_diff_unknown_change(args))
        assert mod.static_check_tree_diff(mod.tree_diff_no_change(args))
        assert not mod.static_check_tree_diff(args)
        assert mod.tree_primal(mod.tree_diff_unknown_change(args)) == args
        assert mod.static_check_no_change(args) and mod.static_check_no_change(())
        mixed = (mod.no_change(1.0), mod.unknown_change(2.0))
        assert [repr(t) for t in mod.tree_tangent(mixed)] == ["NoChange", "UnknownChange"]
    assert Diff.no_change(Diff.unknown_change(1.0)).primal == 1.0
    assert Diff.tree_diff((1.0, 2.0), (NoChange, UnknownChange))[1].tangent is UnknownChange
    from genjax_tpu.core.diff import changed_through as jchanged_through

    x, y = np.float32(1.5), np.float32(-2.0)
    fn = lambda a, b: (a * 2.0, b + 1.0, a + b)  # noqa: E731
    got = changed_through(fn, (Diff.no_change(torch.tensor(x)), Diff.unknown_change(torch.tensor(y))))
    want = jchanged_through(fn, (JDiff.no_change(jnp.asarray(x)), JDiff.unknown_change(jnp.asarray(y))))
    assert [d.tangent.name for d in got] == [d.tangent.name for d in want] == ["NoChange", "UnknownChange", "UnknownChange"]


# ----------------------------------------------------------------------
# update / project / Regenerate / importance / propose on the models
# ----------------------------------------------------------------------


def _flagship():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    return jax_hier(X), hierarchical_regression(X), 8, 16


def _linear():
    X = np.random.default_rng(2).normal(size=(12, 3)).astype(np.float32)
    return jax_linear(X, obs_scale=0.5)[0], linear_regression(X, obs_scale=0.5)[0], 3, 12


MODELS = {"flagship": _flagship, "linear_regression": _linear}


def _choices(name, seed):
    """Full choices of the model from a numpy seed, as ``{address: ndarray}``."""
    _, _, d, n = MODELS[name]()
    rng = np.random.default_rng(seed)
    out = {"w": rng.normal(size=d).astype(np.float32), "y": rng.normal(size=n).astype(np.float32)}
    if name == "flagship":
        out["tau"] = np.float32(rng.uniform(0.5, 1.5))
    return out


def _traces(name, seed):
    """The same trace in both packages: ``generate`` under the full choices."""
    jm, tm, _, _ = MODELS[name]()
    flat = _choices(name, seed)
    jtr, _ = jm.generate(jax.random.key(0), gj.ChoiceMap.d({k: jnp.asarray(v) for k, v in flat.items()}), ())
    ttr, _ = tm.generate(gen_at(0), g.ChoiceMap.d({k: torch.as_tensor(v) for k, v in flat.items()}), ())
    np.testing.assert_allclose(float(ttr.get_score()), float(jtr.get_score()), rtol=TOL)
    return jtr, ttr


def _constraint(mod, name, addrs, seed):
    as_array = jnp.asarray if mod is gj else torch.as_tensor
    flat = _choices(name, seed)
    return mod.ChoiceMap.d({a: as_array(flat[a]) for a in addrs})


UPDATES = [
    ("flagship", ("w",)), ("flagship", ("tau",)), ("flagship", ("tau", "w")), ("flagship", ("y",)),
    ("flagship", ()), ("linear_regression", ("w",)), ("linear_regression", ("y",)),
]


@pytest.mark.parametrize("name,addrs", UPDATES, ids=lambda v: "+".join(v) if isinstance(v, tuple) else v)
def test_update_matches_jax(name, addrs):
    jtr, ttr = _traces(name, 10)
    j_new, j_w, j_rd, j_discard = jtr.update(jax.random.key(1), _constraint(gj, name, addrs, 11))
    t_new, t_w, t_rd, t_discard = ttr.update(gen_at(1), _constraint(g, name, addrs, 11))
    np.testing.assert_allclose(float(t_w), float(j_w), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(t_new.get_score()), float(j_new.get_score()), rtol=TOL)
    for a in ("tau", "w", "y"):
        assert (a in t_discard) == (a in j_discard) == (a in addrs)
        if a in addrs:
            np.testing.assert_allclose(np.asarray(t_discard[a]), np.asarray(j_discard[a]), rtol=TOL)
            np.testing.assert_array_equal(np.asarray(t_new[a]), _choices(name, 11)[a])
    # the retval (``y``) changes only where ``y`` itself is updated: an
    # update of ``w`` or ``tau`` re-scores ``y`` and leaves its value
    assert Diff.static_check_no_change(t_rd) == gj.Diff.static_check_no_change(j_rd) == ("y" not in addrs)


PROJECTIONS = {
    "w": lambda m: m.S["w"],
    "tau|y": lambda m: m.S["tau"] | m.S["y"],
    "all": lambda m: m.S.all(),
    "none": lambda m: m.S.none(),
}


@pytest.mark.parametrize("sel", sorted(PROJECTIONS))
def test_project_matches_jax(sel):
    jtr, ttr = _traces("flagship", 12)
    j_p = jtr.project(jax.random.key(2), PROJECTIONS[sel](gj))
    t_p = ttr.project(gen_at(2), PROJECTIONS[sel](g))
    np.testing.assert_allclose(float(t_p), float(j_p), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,addr", [("flagship", "tau"), ("flagship", "w"), ("linear_regression", "w")])
def test_regenerate_weight_matches_jax_update_to_the_same_values(name, addr):
    """The port regenerates; its new values, fed to the reference's
    ``update``, give the same weight (a Regenerate's weight is the joint
    ratio), and new score = old score + weight."""
    jtr, ttr = _traces(name, 13)
    t_new, t_w, _, t_bwd = ttr.edit(gen_at(3), g.Regenerate(g.S[addr]))
    assert not torch.equal(t_new[addr], ttr[addr])
    others = [a for a in ("tau", "w", "y") if a != addr and a in ttr.get_choices()]
    for a in others:
        assert torch.equal(t_new[a], ttr[a])
    _, j_w, _, _ = jtr.update(jax.random.key(3), gj.C[addr].set(jnp.asarray(t_new[addr].numpy())))
    np.testing.assert_allclose(float(t_w), float(j_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_new.get_score()), float(ttr.get_score() + t_w), rtol=1e-5)
    assert isinstance(t_bwd, g.StaticRequest)


def test_importance_and_propose():
    jm, tm, _, _ = _flagship()
    y = _choices("flagship", 14)["y"]
    tr, w = tm.importance(gen_at(4), g.C["y"].set(torch.as_tensor(y)), ())
    j_lik = gj.mv_normal_diag.logpdf(
        jnp.asarray(y), jnp.asarray(tm.X) @ jnp.asarray(tr["w"].numpy()), 0.25 * jnp.ones(16)
    )
    np.testing.assert_allclose(float(w), float(j_lik), rtol=TOL)
    chm, score, retval = tm.propose(gen_at(5), ())
    j_score, _ = jm.assess(gj.ChoiceMap.d({a: jnp.asarray(chm[a].numpy()) for a in ("tau", "w", "y")}), ())
    np.testing.assert_allclose(float(score), float(j_score), rtol=TOL)
    assert torch.equal(retval, chm["y"])
    # the closure forwards the GFI with its arguments applied
    c_tr, c_w = tm().importance(gen_at(4), g.C["y"].set(torch.as_tensor(y)))
    assert torch.equal(c_tr["w"], tr["w"]) and torch.equal(c_w, w)
    assert set(tm().propose(gen_at(5))[0].static_addresses()) == {"tau", "w", "y"}
    assert float(tm().assess(chm)[0]) == pytest.approx(float(score), rel=1e-6)
    assert tm().simulate(gen_at(6))["w"].shape == (8,) and tm()(gen_at(6)).shape == (16,)


# ----------------------------------------------------------------------
# the edit round trip, and what an edit reuses
# ----------------------------------------------------------------------

REQUESTS = {
    "Update": lambda: g.Update(_constraint(g, "flagship", ("tau", "w"), 21)),
    "Update-late": lambda: g.Update(_constraint(g, "flagship", ("y",), 21)),
    "Regenerate": lambda: g.Regenerate(g.S["w"]),
    "Regenerate-all": lambda: g.Regenerate(g.S.all()),
    "StaticRequest": lambda: g.StaticRequest.d({
        "tau": g.Regenerate(g.S.all()),
        "w": g.Update(g.ChoiceMap.entry(torch.as_tensor(_choices("flagship", 22)["w"]))),
    }),
    "Empty": lambda: g.EmptyRequest(),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_edit_round_trip_cancels(name):
    _, tr = _traces("flagship", 20)
    new_tr, w, _, bwd = tr.edit(gen_at(7), REQUESTS[name]())
    back_tr, w_back, _, _ = new_tr.edit(gen_at(8), bwd)
    assert abs(float(w) + float(w_back)) < ROUND_TRIP_TOL
    for a in ("tau", "w", "y"):
        torch.testing.assert_close(back_tr[a], tr[a], rtol=0, atol=0)
    torch.testing.assert_close(back_tr.get_score(), tr.get_score(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        float(new_tr.get_score()), float(tm_assess(new_tr)), rtol=TOL
    )


def tm_assess(tr):
    return tr.get_gen_fn().assess(tr.get_choices(), tr.get_args())[0]


def test_update_of_a_late_address_reuses_the_clean_prefix():
    _, tr = _traces("flagship", 23)
    new_tr, w, rd, discard = tr.update(gen_at(9), _constraint(g, "flagship", ("y",), 24))
    assert new_tr.get_subtrace("tau") is tr.get_subtrace("tau")
    assert new_tr.get_subtrace("w") is tr.get_subtrace("w")
    assert new_tr.get_subtrace("y") is not tr.get_subtrace("y")
    assert discard.static_addresses() == ("y",)
    # an early address makes everything after it score again
    newer, _, _, _ = tr.update(gen_at(9), _constraint(g, "flagship", ("tau",), 24))
    assert newer.get_subtrace("w") is not tr.get_subtrace("w")
    # nothing asked, nothing changed: the same subtraces, weight 0, no change
    same, w0, rd0, _ = tr.update(gen_at(9), g.ChoiceMap.empty())
    assert all(a is b for a, b in zip(same.subtraces, tr.subtraces))
    assert float(w0) == 0.0 and Diff.static_check_no_change(rd0)


def test_changed_arguments_score_again():
    @g.gen
    def model(shift):
        x = g.normal(shift, 1.0) @ "x"
        return x + shift

    @gj.gen
    def jmodel(shift):
        x = gj.normal(shift, 1.0) @ "x"
        return x + shift

    tr, _ = model.generate(gen_at(0), g.C["x"].set(0.3), (0.0,))
    jtr, _ = jmodel.generate(jax.random.key(0), gj.C["x"].set(0.3), (0.0,))
    from genjax_tpu.core.diff import Diff as JDiff

    new_tr, w, rd, _ = tr.edit(gen_at(1), g.EmptyRequest(), (Diff.unknown_change(1.0),))
    _, j_w, _, _ = jtr.edit(jax.random.key(1), gj.EmptyRequest(), (JDiff.unknown_change(1.0),))
    np.testing.assert_allclose(float(w), float(j_w), rtol=TOL)
    assert float(new_tr.get_retval()) == pytest.approx(1.3) and not Diff.static_check_no_change(rd)
    assert float(new_tr.get_args()[0]) == 1.0


def test_requests_a_function_cannot_serve_raise():
    _, tr = _traces("flagship", 25)
    with pytest.raises(g.NotSupportedEditRequest):
        tr.get_gen_fn().edit(gen_at(0), tr, g.EmptyRequest(), ())
    with pytest.raises(g.NotSupportedEditRequest):
        g.normal.edit(gen_at(0), tr.get_subtrace("tau"), g.StaticRequest.d({}), ())
    with pytest.raises(g.MissingAddress):
        tr.get_subtrace("nope")
    with pytest.raises(NotImplementedError, match="no subtraces"):
        tr.get_subtrace("tau", "x")
    assert tr.get_sample()["tau"] is tr["tau"]


def test_diff_annotate_maps_the_diffs():
    _, tr = _traces("flagship", 26)
    seen = {}
    req = g.Regenerate(g.S["w"]).dimap(
        lambda ad: seen.setdefault("args", ad), lambda rd: seen.setdefault("ret", rd)
    )
    new_tr, _, rd, _ = tr.edit(gen_at(2), req)
    assert seen["args"] == () and rd is seen["ret"]
    assert isinstance(g.Regenerate(g.S["w"]).map(lambda d: d), g.DiffAnnotate)
    assert isinstance(g.Regenerate(g.S["w"]).contramap(lambda d: d), g.DiffAnnotate)


def test_traces_record_tensor_leaves_only():
    """Python numbers in arguments and constraints become tensors when a
    trace is recorded, and an absent return value is no leaf: what
    ``torch.func.vmap`` and the MH accept's leafwise select need."""
    @g.gen
    def model():
        mu = g.normal(0.0, 1.0) @ "mu"
        g.normal(mu, 0.5) @ "y"

    tr, _ = model.generate(gen_at(0), g.C["y"].set(1.0), ())
    leaves = torch.utils._pytree.tree_leaves(tr)
    assert leaves and all(isinstance(leaf, torch.Tensor) for leaf in leaves)
    assert tr.get_retval() is None and float(tr["y"]) == 1.0
    new_tr, _, _, _ = tr.update(gen_at(1), g.C["mu"].set(0.25))
    new_leaves, spec = torch.utils._pytree.tree_flatten(new_tr)
    assert spec == torch.utils._pytree.tree_structure(tr)
    assert [leaf.dtype for leaf in new_leaves] == [leaf.dtype for leaf in leaves]


def test_recorded_numbers_keep_their_type_and_sign():
    """A number is made a tensor once for each device and shared by the
    traces that record it; numbers that compare equal (0.0 and -0.0; 1, 1.0
    and True) stay apart."""
    from genjax_tpu_torch.generative.trace import tensor_leaves

    out = tensor_leaves((0.0, -0.0, 1, 1.0, True, np.float32(2.5), torch.ones(2)))
    assert [o.dtype for o in out[:5]] == [torch.float32, torch.float32, torch.int64, torch.float32, torch.bool]
    assert math.copysign(1.0, float(out[0])) == 1.0 and math.copysign(1.0, float(out[1])) == -1.0
    assert float(out[5]) == 2.5 and out[6].shape == (2,)
    assert tensor_leaves((1.0,))[0] is out[3]
    nested = tensor_leaves({"a": (1.5, [2])})
    assert float(nested["a"][0]) == 1.5 and nested["a"][1][0].dtype == torch.int64


def test_an_edit_that_asks_nothing_weighs_a_tensor_zero():
    """On the clean path no address adds to the weight; it is still a tensor
    where the trace lives (as ``project`` of nothing is), and a generator on
    another card than the trace's is refused like one on another device
    type."""
    from genjax_tpu_torch.generative.trace import _same_device
    from genjax_tpu_torch.lang.static_lang import _on

    rng = np.random.default_rng(0)
    model = hierarchical_regression(rng.normal(size=(16, 8)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=16).astype(np.float32))
    tr, _ = model.generate(gen_at(0), g.C["y"].set(y), ())
    new_tr, w, _rd, _bwd = tr.edit(gen_at(1), g.Update(g.ChoiceMap.empty()))
    assert isinstance(w, torch.Tensor) and w.dtype == torch.float32 and float(w) == 0.0
    assert new_tr.subtraces[0] is tr.subtraces[0]
    p = tr.project(None, g.S["no such address"])
    assert isinstance(p, torch.Tensor) and float(p) == 0.0
    assert _on(torch.device("meta"), 0.0).device.type == "meta"
    assert _on(torch.device("meta"), w) is w
    cuda = torch.device
    assert _same_device(cuda("cuda:0"), cuda("cuda:0")) and _same_device(cuda("cuda"), cuda("cuda:1"))
    assert not _same_device(cuda("cuda:0"), cuda("cuda:1")) and not _same_device(cuda("cpu"), cuda("cuda"))


# ----------------------------------------------------------------------
# every ported distribution serves the edits
# ----------------------------------------------------------------------

DISTS = {
    "normal": (lambda m, a: (a([0.5, -1.0]), 2.0), lambda a: a([0.1, 0.2])),
    "log_normal": (lambda m, a: (0.0, 0.5), lambda a: a(1.3)),
    "mv_normal_diag": (lambda m, a: (a([0.0, 1.0]), a([1.0, 2.0])), lambda a: a([0.3, 0.4])),
    "mv_normal": (lambda m, a: (a([0.0, 1.0]), a([[2.0, 0.5], [0.5, 1.0]])), lambda a: a([0.3, 0.4])),
    "beta": (lambda m, a: (2.0, 3.0), lambda a: a(0.4)),
    "flip": (lambda m, a: (0.3,), lambda a: a(True)),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_edits_match_jax_and_cancel(name):
    make_args, make_value = DISTS[name]
    t_args, j_args = make_args(torch, torch.tensor), make_args(jnp, jnp.asarray)
    t_dist, j_dist = getattr(g, name), getattr(gj, name)
    ttr = t_dist.simulate(gen_at(0), t_args)
    jtr, _ = j_dist.generate(
        jax.random.key(0), gj.ChoiceMap.entry(jnp.asarray(ttr.get_retval().numpy())), j_args)
    np.testing.assert_allclose(np.asarray(ttr.get_score()), np.asarray(jtr.get_score()), rtol=TOL, atol=TOL)

    t_new, t_w, _, t_discard = ttr.update(gen_at(1), g.ChoiceMap.entry(make_value(torch.tensor)))
    j_new, j_w, _, _ = jtr.update(jax.random.key(1), gj.ChoiceMap.entry(make_value(jnp.asarray)))
    np.testing.assert_allclose(np.asarray(t_w), np.asarray(j_w), rtol=TOL, atol=TOL)
    assert torch.equal(t_discard.get_value(), ttr.get_retval())
    np.testing.assert_allclose(
        np.asarray(ttr.project(gen_at(2), g.S.all())), np.asarray(jtr.project(jax.random.key(2), gj.S.all())),
        rtol=TOL, atol=TOL)
    assert float(torch.as_tensor(ttr.project(gen_at(2), g.S.none())).sum()) == 0.0

    for request in (g.Update(g.ChoiceMap.entry(make_value(torch.tensor))), g.Regenerate(g.S.all()),
                    g.Regenerate(g.S.none())):
        new, w, _, bwd = ttr.edit(gen_at(3), request)
        back, w_back, _, _ = new.edit(gen_at(4), bwd)
        assert float((w + w_back).abs().max()) < ROUND_TRIP_TOL
        assert torch.equal(back.get_retval(), ttr.get_retval())
    same, w0, rd, _ = ttr.edit(gen_at(3), g.Regenerate(g.S.none()))
    assert same is ttr and Diff.static_check_no_change(rd)

"""Edits through the port's combinators, held against ``genjax_tpu``.

Mirrors the combinator cases of ``tests/generative_functions/
test_edit_fuzz.py`` (edit sequences over every combinator, flag and index
flips, a Regenerate that moves a switch index), of
``test_edit_weight_changed_args.py`` (the substitution identity under
changed arguments through deep compositions) and of ``test_edge_cases.py``
(``TestMaskedConstraints``, ``TestSwitchIndexChange``,
``TestVectorizedMask``), as fixed grids rather than drawn ones. Where a
move's weight is deterministic (an ``Update``, an ``IndexRequest``, a flag
flip) it is held against the reference's on the same choices to 1e-5;
every backward request restores the score and cancels the weight. The scan
and the sparse ``Update`` also hold the reference's O(1) claim: the
kernel's edit runs twice for an ``IndexRequest``, whatever T is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu_torch.core.diff import Diff, NoChange, UnknownChange
from genjax_tpu_torch.lang.static_lang import StaticGenerativeFunction
from torch_chm_bridge import to_jax
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def unmask(v):
    return v.unmask() if isinstance(v, (g.Mask, gj.Mask)) else v


def read(chm, path):
    return unmask(chm.get_submap(*path).get_value())


def _close(a, b, tol=TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol + tol * abs(b), (a, b)


def blocks(m):
    @m.gen
    def base_block(mu):
        a = m.normal(mu, 1.0) @ "a"
        b = m.normal(a * 0.5, 0.8) @ "b"
        return a + b

    @m.gen
    def branch_pos(mu):
        return m.normal(mu, 1.0) @ "x"

    @m.gen
    def branch_neg(mu):
        return m.normal(-mu, 0.5) @ "x"

    @m.gen
    def kern(c, x):
        z = m.normal(0.6 * c + x, 1.0) @ "z"
        return (z, z)

    return base_block, branch_pos, branch_neg, kern


def fuzz_models(m, A):
    base_block, branch_pos, branch_neg, kern = blocks(m)
    return {
        "scan": (kern.scan(n=3), (0.0, A(np.linspace(-1, 1, 3))), [(i, "z") for i in range(3)]),
        "vmap": (base_block.vmap(in_axes=(0,)), (A(np.linspace(-1, 1, 2)),),
                 [(i, a) for i in range(2) for a in ("a", "b")]),
        "switch": (m.switch(branch_pos, branch_neg), (1, (0.3,), (0.3,)), [("x",)]),
        "or_else": (m.or_else(branch_pos, branch_neg), (False, (0.3,), (0.3,)), [("x",)]),
        "mask": (base_block.mask(), (True, 0.3), [("a",), ("b",)]),
        "mix": (m.mix(branch_pos, branch_neg), (A(np.log([0.4, 0.6])), (0.3,), (0.3,)),
                [("component_sample", "x")]),
        "dimap": (base_block.dimap(pre=lambda u, v: (u + v,), post=lambda args, r: r * 2.0),
                  (0.1, 0.2), [("a",), ("b",)]),
        "repeat": (base_block.repeat(n=2), (0.3,), [(1, "a"), (0, "b")]),
    }


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


PORT = fuzz_models(g, _t)
REF = fuzz_models(gj, jnp.asarray)


@pytest.mark.parametrize("name", list(PORT))
@pytest.mark.parametrize("step", [0, 1])
def test_update_sequence_against_reference(name, step):
    """Two Updates in a row: the substitution identity, value placement,
    the reference's weight on the same choices, and the round trip."""
    model, args, paths = PORT[name]
    ref_model, ref_args, _ = REF[name]
    tr = model.simulate(gen_at(step), args)
    rng = np.random.default_rng(step)
    for i in range(2):
        path = paths[(step + i) % len(paths)]
        v = float(rng.uniform(-2, 2))
        new_tr, w, _rd, bwd = tr.edit(gen_at(10 + i), g.Update(g.C[path].set(torch.tensor(v))))
        score, _ = model.assess(new_tr.get_choices(), args)
        _close(new_tr.get_score(), score, ROUND_TRIP_TOL)
        _close(new_tr.get_score(), tr.get_score() + w, ROUND_TRIP_TOL)
        assert float(read(new_tr.get_choices(), path)) == pytest.approx(v, abs=1e-6)
        ref_tr, _ = ref_model.generate(jax.random.key(0), to_jax(tr.get_choices()), ref_args)
        _, ref_w, _, _ = ref_tr.edit(jax.random.key(1), gj.Update(gj.C[path].set(jnp.float32(v))))
        _close(w, ref_w)
        back, wb, _, _ = new_tr.edit(gen_at(20 + i), bwd)
        _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)
        assert abs(float(w + wb)) <= ROUND_TRIP_TOL
        tr = new_tr


@pytest.mark.parametrize("name", ["scan", "vmap", "switch", "or_else", "mix", "dimap", "repeat"])
def test_regenerate_round_trip(name):
    """A Regenerate of one address: assess-consistent, and its backward
    request restores the score and cancels the weight."""
    model, args, paths = PORT[name]
    tr = model.simulate(gen_at(3), args)
    new_tr, w, _rd, bwd = tr.edit(gen_at(4), g.Regenerate(g.S[paths[-1]]))
    score, _ = model.assess(new_tr.get_choices(), args)
    _close(new_tr.get_score(), score, ROUND_TRIP_TOL)
    back, wb, _, _ = new_tr.edit(gen_at(5), bwd)
    _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)
    assert abs(float(w + wb)) <= ROUND_TRIP_TOL


# ----------------------------------------------------------------------
# structural flips: mask flags, switch and or_else indices, dimap arguments
# ----------------------------------------------------------------------


def structural(m, A, I, tree_map):
    """The knobs in package ``m``: ``(gen_fn, states, make_args,
    make_argdiffs, update_paths)``; ``make_argdiffs(s, changed)`` moves the
    knob to ``s`` with every other argument unchanged."""
    base_block, branch_pos, branch_neg, _ = blocks(m)
    mm = base_block.mask()
    sw = m.switch(branch_pos, branch_neg)
    oe = m.or_else(branch_pos, branch_neg)
    dm = base_block.dimap(pre=lambda u, v: (u + v,), post=lambda args, r: r * 2.0)

    def knob(make):
        def argdiffs(s, changed):
            args = make(s)
            first = m.Diff(args[0], m.UnknownChange if changed else m.NoChange)
            return (first, *tree_map(lambda x: m.Diff(x, m.NoChange), args[1:]))
        return argdiffs

    mk_mask = lambda s: (A(s), 0.3)  # noqa: E731
    mk_sw = lambda s: (I(s), (0.3,), (0.3,))  # noqa: E731
    mk_oe = lambda s: (A(s), (0.3,), (0.3,))  # noqa: E731
    mk_dm = lambda s: (A(np.float32(s)), 0.2)  # noqa: E731
    return {
        "mask": (mm, [True, False], mk_mask, knob(mk_mask), [("a",), ("b",)]),
        "switch": (sw, [0, 1], mk_sw, knob(mk_sw), [("x",)]),
        "or_else": (oe, [True, False], mk_oe, knob(mk_oe), [("x",)]),
        "dimap": (dm, [-0.5, 0.8], mk_dm, knob(mk_dm), [("a",), ("b",)]),
    }


S_PORT = structural(g, lambda x: torch.as_tensor(np.asarray(x)), torch.tensor, torch.utils._pytree.tree_map)
S_REF = structural(gj, jnp.asarray, jnp.asarray, jax.tree_util.tree_map)


@pytest.mark.parametrize("kind", list(S_PORT))
@pytest.mark.parametrize("move", ["flip", "update", "flip+update"])
def test_structural_flips(kind, move):
    """Each knob moved from its first state to its second, with and without
    a value update: consistency at the new arguments, and the backward
    request under reversed argdiffs restores the old score. Where the move
    draws nothing fresh (a mask flip, any dimap move, a same-index update),
    its weight is the reference's on the same choices."""
    model, states, make_args, make_argdiffs, paths = S_PORT[kind]
    ref_model, _, ref_make_args, ref_make_argdiffs, _ = S_REF[kind]
    old, new = states[0], (states[1] if "flip" in move else states[0])
    changed = new != old
    tr = model.simulate(gen_at(0), make_args(old))
    if "update" in move:
        req, ref_req = g.Update(g.C[paths[0]].set(torch.tensor(0.7))), gj.Update(gj.C[paths[0]].set(jnp.float32(0.7)))
    else:
        req, ref_req = g.Update(g.ChoiceMap.empty()), gj.Update(gj.ChoiceMap.empty())
    new_tr, w, _rd, bwd = model.edit(gen_at(1), tr, req, make_argdiffs(new, changed))
    assert bool(torch.isfinite(torch.as_tensor(w)))
    if kind == "mask" and not new:
        assert float(new_tr.get_score()) == 0.0
    else:
        score, _ = model.assess(new_tr.get_choices(), make_args(new))
        _close(new_tr.get_score(), score, ROUND_TRIP_TOL)
    back, _wb, _, _ = model.edit(gen_at(2), new_tr, bwd, make_argdiffs(old, changed))
    _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)
    if kind in ("mask", "dimap") or not changed:
        ref_tr, _ = ref_model.generate(jax.random.key(0), to_jax(tr.get_choices()), ref_make_args(old))
        _, ref_w, _, _ = ref_model.edit(jax.random.key(1), ref_tr, ref_req, ref_make_argdiffs(new, changed))
        _close(w, ref_w)


def test_regenerate_through_switch_index():
    """A Regenerate of the index drawn upstream moves the switch (deviation
    11): the new trace is assess-consistent and the backward request
    restores the score."""
    _, branch_pos, branch_neg, _ = blocks(g)
    sw = g.switch(branch_pos, branch_neg)

    @g.gen
    def model(mu):
        z = g.categorical(torch.log(torch.tensor([0.5, 0.5]))) @ "z"
        v = sw(z, (mu,), (mu,)) @ "v"
        return g.normal(v, 1.0) @ "obs"

    for seed in range(4):
        tr = model.simulate(gen_at(seed), (0.3,))
        new_tr, _w, _rd, bwd = tr.edit(gen_at(seed + 10), g.Regenerate(g.S["z"]))
        score, _ = model.assess(new_tr.get_choices(), (0.3,))
        _close(new_tr.get_score(), score, ROUND_TRIP_TOL)
        back, _wb, _, _ = new_tr.edit(gen_at(seed + 20), bwd)
        _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)


# ----------------------------------------------------------------------
# changed arguments through deep compositions (substitution identity)
# ----------------------------------------------------------------------


def _substitution_check(model, args, new_args, tr, constraint, argdiffs=None):
    if argdiffs is None:
        argdiffs = Diff.tree_diff_unknown_change(new_args)
    new_tr, w, _, _ = model.edit(gen_at(11), tr, g.Update(constraint), argdiffs)
    new_score, _ = model.assess(new_tr.get_choices(), new_args)
    old_score, _ = model.assess(tr.get_choices(), args)
    _close(w, new_score - old_score, 1e-4)
    _close(new_tr.get_score(), new_score, 1e-4)
    return w


def test_scan_changed_init_carry():
    @g.gen
    def kern(c, x):
        z = g.normal(0.8 * c + x, 1.0) @ "z"
        return (z, z)

    @gj.gen
    def kern_ref(c, x):
        z = gj.normal(0.8 * c + x, 1.0) @ "z"
        return (z, z)

    xs = torch.linspace(-1, 1, 6)
    tr = kern.scan().simulate(gen_at(0), (0.0, xs))
    w = _substitution_check(kern.scan(), (0.0, xs), (1.0, xs), tr, g.C[2, "z"].set(0.3))
    jxs = jnp.asarray(xs.numpy())
    ref_tr, _ = kern_ref.scan().generate(jax.random.key(0), to_jax(tr.get_choices()), (0.0, jxs))
    _, ref_w, _, _ = kern_ref.scan().edit(
        jax.random.key(1), ref_tr, gj.Update(gj.C[2, "z"].set(0.3)), gj.Diff.tree_diff_unknown_change((1.0, jxs))
    )
    _close(w, ref_w)


def test_vmap_changed_args():
    @g.gen
    def point(mu):
        return g.normal(mu, 1.0) @ "x"

    vm = point.vmap(in_axes=(0,))
    mus = torch.arange(4.0)
    tr = vm.simulate(gen_at(1), (mus,))
    _substitution_check(vm, (mus,), (mus + 0.5,), tr, g.C[1, "x"].set(0.9))


def test_scan_in_switch_in_vmap():
    @g.gen
    def kern_a(c, x):
        z = g.normal(0.5 * c, 1.0) @ "z"
        return (z, z)

    @g.gen
    def kern_b(c, x):
        z = g.normal(c + 1.0, 2.0) @ "z"
        return (z, z)

    sw = g.switch(kern_a.scan(n=3), kern_b.scan(n=3))

    @g.gen
    def per_lane(idx, init):
        return sw(idx, (init, None), (init, None)) @ "seq"

    vm = per_lane.vmap(in_axes=(0, 0))
    idxs, inits = torch.tensor([0, 1, 0]), torch.tensor([0.0, 1.0, -1.0])
    tr = vm.simulate(gen_at(2), (idxs, inits))
    _substitution_check(
        vm, (idxs, inits), (idxs, inits + 0.3), tr, g.C[1, "seq", 1, "z"].set(0.25),
        argdiffs=(Diff.no_change(idxs), Diff.unknown_change(inits + 0.3)),
    )


def test_switch_same_index_changed_branch_arg():
    @g.gen
    def b0(mu):
        return g.normal(mu, 1.0) @ "a"

    @g.gen
    def b1(mu):
        return g.normal(mu, 2.0) @ "b"

    sw = g.switch(b0, b1)
    for idx in (0, torch.tensor(0)):
        tr = sw.simulate(gen_at(3), (idx, (0.5,), (0.5,)))
        argdiffs = (Diff.no_change(idx), Diff.unknown_change((1.5,)), Diff.no_change((0.5,)))
        _substitution_check(sw, (idx, (0.5,), (0.5,)), (idx, (1.5,), (0.5,)), tr, g.ChoiceMap.empty(),
                            argdiffs=argdiffs)


# ----------------------------------------------------------------------
# edge cases: masked constraints, switch index change, vectorised masks
# ----------------------------------------------------------------------


@g.gen
def simple():
    x = g.normal(0.0, 1.0) @ "x"
    y = g.normal(x, 0.5) @ "y"
    return y


class TestMaskedConstraints:
    def test_generate_with_masked_constraint_valid(self):
        chm = g.C["x"].set(g.Mask(torch.tensor(1.5), torch.tensor(True)))
        tr, w = simple.generate(gen_at(0), chm, ())
        assert float(tr.get_choices()["x"]) == 1.5
        _close(w, g.normal.logpdf(1.5, 0.0, 1.0))

    def test_generate_with_masked_constraint_invalid(self):
        chm = g.C["x"].set(g.Mask(torch.tensor(1.5), torch.tensor(False)))
        tr, w = simple.generate(gen_at(1), chm, ())
        assert float(w) == 0.0
        assert float(tr.get_choices()["x"]) != 1.5

    def test_update_with_masked_constraint(self):
        tr = simple.simulate(gen_at(2), ())
        old_x = float(tr.get_choices()["x"])
        for flag, expected in ((False, old_x), (True, 2.0)):
            chm = g.C["x"].set(g.Mask(torch.tensor(2.0), torch.tensor(flag)))
            new_tr, w, _, discard = tr.update(gen_at(3), chm)
            assert float(new_tr.get_choices()["x"]) == expected
            _close(new_tr.get_score(), tr.get_score() + w, ROUND_TRIP_TOL)
            back, wb, _, _ = new_tr.update(gen_at(4), discard)
            assert float(back.get_choices()["x"]) == pytest.approx(old_x)
            assert abs(float(w + wb)) <= ROUND_TRIP_TOL

    def test_per_lane_masks_match_reference(self):
        """A vector of flags over a batch of constraints, lane by lane, to
        the reference's weights."""
        vals = np.array([0.5, -1.0, 2.0], np.float32)
        flags = np.array([True, False, True])
        ws = torch.func.vmap(
            lambda v, f: simple.generate(gen_at(5), g.C["y"].set(g.Mask(v, f)) | g.C["x"].set(v), ())[1],
            randomness="different",
        )(torch.from_numpy(vals), torch.from_numpy(flags))
        for i in range(3):
            ref_chm = gj.C["y"].set(gj.Mask(jnp.float32(vals[i]), jnp.asarray(flags[i]))) | gj.C["x"].set(
                jnp.float32(vals[i])
            )
            if flags[i]:
                _, ref_w = simple_ref().generate(jax.random.key(0), ref_chm, ())
                _close(ws[i], ref_w)
            else:
                _close(ws[i], gj.normal.logpdf(vals[i], 0.0, 1.0))

    def test_regenerate_with_tensor_selection_flag(self):
        tr = simple.simulate(gen_at(6), ())
        sel = g.S["x"].mask(torch.tensor(False))
        new_tr, w, _, bwd = tr.edit(gen_at(7), g.Regenerate(sel))
        assert float(new_tr.get_choices()["x"]) == float(tr.get_choices()["x"])
        sel = g.S["x"].mask(torch.tensor(True))
        new_tr, w, _, bwd = tr.edit(gen_at(8), g.Regenerate(sel))
        back, wb, _, _ = new_tr.edit(gen_at(9), bwd)
        assert float(back.get_choices()["x"]) == float(tr.get_choices()["x"])
        assert abs(float(w + wb)) <= ROUND_TRIP_TOL
        assert float(tr.project(gen_at(0), g.S["x"].mask(torch.tensor(False)))) == 0.0


def simple_ref():
    @gj.gen
    def simple_j():
        x = gj.normal(0.0, 1.0) @ "x"
        y = gj.normal(x, 0.5) @ "y"
        return y

    return simple_j


class TestSwitchIndexChange:
    def test_edit_with_changed_index(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "n"

        @g.gen
        def b1():
            return g.normal(5.0, 1.0) @ "m"

        sw = g.switch(b0, b1)
        for to_idx, from_idx in ((1, 0), (torch.tensor(1), torch.tensor(0))):
            tr = sw.simulate(gen_at(0), (from_idx, (), ()))
            argdiffs = (Diff(to_idx, UnknownChange), Diff((), NoChange), Diff((), NoChange))
            new_tr, w, _rd, _bwd = sw.edit(gen_at(1), tr, g.Update(g.ChoiceMap.empty()), argdiffs)
            assert abs(float(unmask(new_tr.get_choices()["m"])) - 5.0) < 5.0
            _close(w, -tr.get_score(), 1e-4)
            donor = sw.simulate(gen_at(9), (to_idx, (), ()))
            full_tr, full_w, _, full_bwd = sw.edit(gen_at(2), tr, g.Update(donor.get_choices()), argdiffs)
            _close(full_w, full_tr.get_score() - tr.get_score(), 1e-4)
            back_argdiffs = (Diff(from_idx, UnknownChange), Diff((), NoChange), Diff((), NoChange))
            back, wb, _, _ = sw.edit(gen_at(3), full_tr, full_bwd, back_argdiffs)
            assert abs(float(full_w + wb)) <= 1e-5
            _close(back.get_score(), tr.get_score(), 1e-5)


class TestVectorizedMask:
    def test_unmask_with_vector_flags(self):
        m = g.Mask(torch.arange(4.0), torch.tensor([True, False, True, False]))
        assert torch.equal(m.unmask(default=torch.full((4,), -1.0)), torch.tensor([0.0, -1.0, 2.0, -1.0]))

    def test_mask_or_prefers_valid(self):
        a = g.Mask(torch.tensor(1.0), torch.tensor(False))
        b = g.Mask(torch.tensor(2.0), torch.tensor(True))
        c = a | b
        assert bool(c.primal_flag()) and float(c.value) == 2.0

    def test_mask_xor_against_reference(self):
        f1 = np.array([True, True, False, False])
        f2 = np.array([True, False, True, False])
        v1, v2 = np.arange(4.0, dtype=np.float32), 10 + np.arange(4.0, dtype=np.float32)
        for op in ("__or__", "__xor__"):
            t = getattr(g.Mask(torch.from_numpy(v1), torch.from_numpy(f1)), op)(
                g.Mask(torch.from_numpy(v2), torch.from_numpy(f2))
            )
            r = getattr(gj.Mask(jnp.asarray(v1), jnp.asarray(f1)), op)(gj.Mask(jnp.asarray(v2), jnp.asarray(f2)))
            np.testing.assert_array_equal(t.flag.numpy(), np.asarray(r.flag))
            np.testing.assert_array_equal(t.value.numpy(), np.asarray(r.value))

    def test_indexed_choice_map_reads_against_reference(self):
        """Dense, scalar and 1-D indexed maps, read at concrete and tensor
        addresses, negative ones included: the port reads what the
        reference reads."""
        vals = np.arange(5.0, dtype=np.float32)
        maps = [
            (g.C[:, "y"].set(torch.from_numpy(vals)), gj.C[:, "y"].set(jnp.asarray(vals))),
            (g.C[3, "y"].set(torch.tensor(7.0)), gj.C[3, "y"].set(jnp.float32(7.0))),
            (g.C[torch.tensor([1, 4]), "y"].set(torch.tensor([8.0, 9.0])),
             gj.C[jnp.asarray([1, 4]), "y"].set(jnp.asarray([8.0, 9.0]))),
        ]
        for tc, jc in maps:
            for addr in (0, 1, 3, 4, -1):
                for tensor_addr in (False, True):
                    ta = torch.tensor(addr) if tensor_addr else addr
                    ja = jnp.asarray(addr) if tensor_addr else addr
                    t, j = tc.get_submap(ta, "y").get_value(), jc.get_submap(ja, "y").get_value()
                    if j is None:
                        assert t is None
                        continue
                    tf = t.flag if isinstance(t, g.Mask) else True
                    jf = j.flag if isinstance(j, gj.Mask) else True
                    assert bool(tf) == bool(jf), (addr, tensor_addr)
                    if bool(jf):
                        assert float(unmask(t)) == float(unmask(j))

    def test_shape_selection_and_exists_flag_against_reference(self):
        """The reachable-address selection of a choice map and whether it
        holds a value, node kind by node kind, as the reference computes
        them on the same map."""
        from genjax_tpu.generative import choice_map as jchm

        from genjax_tpu_torch.generative import choice_map as tchm

        _, branch_pos, branch_neg, kern = blocks(g)
        scan_chm = kern.scan(n=3).simulate(gen_at(0), (0.0, torch.zeros(3))).get_choices()
        sw_chm = g.switch(branch_pos, branch_neg).simulate(gen_at(1), (torch.tensor(1), (0.3,), (0.3,))).get_choices()
        maps = [
            scan_chm,
            sw_chm,
            g.C["a", "b"].set(1.0) | g.C[2, "c"].set(2.0),
            g.C["x"].set(1.0).mask(torch.tensor(False)),
            g.C["x"].set(g.Mask(torch.tensor(1.0), torch.tensor(True))),
            g.ChoiceMap.empty(),
        ]
        addrs = [("z",), (0, "z"), (2, "z"), ("x",), ("a", "b"), (2, "c"), (1, "c"), ("b",)]
        for chm in maps:
            jc = to_jax(chm)
            assert bool(tchm.exists_flag(chm)) == bool(jchm.exists_flag(jc))
            ts, js = tchm.shape_selection(chm), jchm.shape_selection(jc)
            for addr in addrs:
                assert bool(ts[addr]) == bool(js[addr]), (chm, addr)

    def test_selection_checks_against_reference(self):
        for idx in (np.array([1, 3]), np.array([2])):
            ts, js = g.S[torch.from_numpy(idx), "z"], gj.S[jnp.asarray(idx), "z"]
            for t in range(4):
                for addr in (t, torch.tensor(t)):
                    ja = jnp.asarray(t) if isinstance(addr, torch.Tensor) else t
                    assert bool(ts(addr, "z").check()) == bool(js(ja, "z").check())
                    assert bool(ts(addr).check()) == bool(js(ja).check())
        assert g.S.leaf().check() is True and g.S.leaf()("x").check() is False


# ----------------------------------------------------------------------
# the scan's O(1) IndexRequest and O(k) sparse Update
# ----------------------------------------------------------------------


@pytest.fixture
def edit_calls(monkeypatch):
    """Counts ``StaticGenerativeFunction.edit`` calls: the scan kernel's
    re-runs."""
    calls = []
    inner = StaticGenerativeFunction.edit

    def counting(self, *a, **k):
        calls.append(1)
        return inner(self, *a, **k)

    monkeypatch.setattr(StaticGenerativeFunction, "edit", counting)
    return calls


@pytest.mark.parametrize("idx_kind", ["int", "tensor"])
def test_index_request_runs_the_kernel_twice_whatever_t(edit_calls, idx_kind):
    from genjax_tpu_torch.models import linear_gaussian_ssm

    kernel, _ = linear_gaussian_ssm()
    counts = []
    for T in (8, 64):
        model = kernel.scan(n=T)
        ys = torch.zeros(T)
        tr, _ = model.generate(gen_at(T), g.C[:, "y"].set(ys), (0.0, None))
        idx = 5 if idx_kind == "int" else torch.tensor(5)
        edit_calls.clear()
        new_tr, w, _, bwd = tr.edit(gen_at(1), g.IndexRequest(idx, g.Update(g.C["z"].set(0.4))))
        counts.append(len(edit_calls))
        _close(new_tr.get_score(), tr.get_score() + w, ROUND_TRIP_TOL)
        score, _ = model.assess(new_tr.get_choices(), (0.0, None))
        _close(new_tr.get_score(), score, ROUND_TRIP_TOL)
    assert counts == [2, 2]


def test_sparse_update_is_slice_local(edit_calls):
    """An Update of observations at k steps re-runs the kernel k times (one
    vmapped edit of the k steps), since the carry does not read ``y``; its
    weight is the dense walk's and the reference's."""
    from genjax_tpu_torch.models import linear_gaussian_ssm
    from genjax_tpu.models import linear_gaussian_ssm as ref_ssm

    kernel, _ = linear_gaussian_ssm()
    model = kernel.scan(n=8)
    tr = model.simulate(gen_at(0), (0.0, None))
    idx = torch.tensor([2, 5])
    constraint = g.C[idx, "y"].set(torch.tensor([0.3, -0.7]))
    edit_calls.clear()
    new_tr, w, rd, bwd = tr.edit(gen_at(1), g.Update(constraint))
    assert len(edit_calls) == 1  # one vmapped kernel edit, not 8
    assert Diff.static_check_no_change(rd[0])
    dense_tr, dense_w, _, _ = tr.edit(gen_at(1), g.Update(constraint | g.C[0, "z"].set(tr.get_choices()[0, "z"])))
    _close(w, dense_w)
    assert float(new_tr.get_choices()[5, "y"]) == pytest.approx(-0.7)
    ref_kernel, _ = ref_ssm()
    ref_tr, _ = ref_kernel.scan(n=8).generate(jax.random.key(0), to_jax(tr.get_choices()), (0.0, None))
    _, ref_w, _, _ = ref_tr.edit(
        jax.random.key(1), gj.Update(gj.C[jnp.asarray([2, 5]), "y"].set(jnp.asarray([0.3, -0.7])))
    )
    _close(w, ref_w)
    back, wb, _, _ = new_tr.edit(gen_at(2), bwd)
    assert abs(float(w + wb)) <= ROUND_TRIP_TOL
    _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)


# ----------------------------------------------------------------------
# retdiffs of a body that routes values, and the one-step edit's locality
# ----------------------------------------------------------------------


@g.gen
def routed(mu):
    a = g.normal(mu, 1.0) @ "a"
    b = g.normal(-mu, 1.0) @ "b"
    c = g.flip(0.5) @ "c"
    y = g.normal(a, 0.5) @ "y"
    return (a if bool(c) else b), y


def _routed_trace(c):
    chm = g.C["a"].set(0.3) | g.C["b"].set(-1.2) | g.C["c"].set(c) | g.C["y"].set(0.1)
    return routed.generate(gen_at(0), chm, (0.2,))[0]


def test_retdiff_of_a_data_dependent_return():
    """Flipping ``c`` sends the reused ``b`` where ``a`` stood: that position
    changed, though its value is a reused subtrace's. An edit that leaves the
    routing alone keeps the reused value's position unchanged."""
    tr = _routed_trace(True)
    new_tr, _w, rd, _ = tr.edit(gen_at(1), g.Update(g.C["c"].set(False)), Diff.no_change((0.2,)))
    assert float(new_tr.get_retval()[0]) == pytest.approx(-1.2)
    assert rd[0].tangent is UnknownChange
    new_tr, _w, rd, _ = tr.edit(gen_at(1), g.Update(g.C["y"].set(0.7)), Diff.no_change((0.2,)))
    assert float(new_tr.get_retval()[0]) == pytest.approx(0.3)
    assert rd[0].tangent is NoChange
    assert rd[1].tangent is UnknownChange


@g.gen
def routed_kernel(carry, _x):
    a = g.normal(0.0, 1.0) @ "a"
    b = g.normal(2.0, 1.0) @ "b"
    c = g.flip(0.5) @ "c"
    y = g.normal(carry, 0.5) @ "y"
    return (a if bool(c) else b), y


@pytest.mark.parametrize("idx", [1, torch.tensor(1)], ids=["int", "tensor"])
def test_index_request_rescores_the_next_step_of_a_routed_carry(idx):
    """An ``IndexRequest`` that flips ``c`` at step 1 moves the carry into
    step 2, whose ``y`` is re-scored: the weight is the change of ``assess``
    and the backward request cancels it."""
    model = routed_kernel.scan(n=4)
    tr = model.simulate(gen_at(3), (0.0, None))
    c1 = bool(tr.get_choices()[1, "c"])
    new_tr, w, rd, bwd = tr.edit(gen_at(4), g.IndexRequest(idx, g.Update(g.C["c"].set(not c1))))
    old_score, _ = model.assess(tr.get_choices(), (0.0, None))
    new_score, _ = model.assess(new_tr.get_choices(), (0.0, None))
    _close(w, new_score - old_score)
    _close(new_tr.get_score(), new_score)
    back, wb, _, _ = new_tr.edit(gen_at(5), bwd)
    assert abs(float(w + wb)) <= ROUND_TRIP_TOL
    _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)


@g.gen
def summing_kernel(carry, _x):
    z = g.normal(carry, 1.0) @ "z"
    return carry + z, z


def test_index_request_refuses_a_carry_changed_beyond_one_step():
    """A carry that sums every step changes past step ``idx + 1``: the
    one-step edit raises outside ``torch.func`` transforms and, under
    ``torch.func.vmap``, leaves a NaN weight in each lane at fault. An edit
    of the last step has no next step and goes through."""
    model = summing_kernel.scan(n=4)
    tr = model.simulate(gen_at(6), (0.0, None))
    req = g.IndexRequest(1, g.Update(g.C["z"].set(0.9)))
    with pytest.raises(g.NotSupportedEditRequest, match="beyond one step"):
        tr.edit(gen_at(7), req)
    new_tr, w, _, _ = tr.edit(gen_at(7), g.IndexRequest(3, g.Update(g.C["z"].set(0.9))))
    _close(new_tr.get_score(), tr.get_score() + w, ROUND_TRIP_TOL)

    trs = torch.func.vmap(
        lambda _: model.simulate(gen_at(8), (0.0, None)), randomness="different"
    )(torch.zeros(3))
    idxs = torch.tensor([1, 3, 0])
    _, ws, _, _ = torch.func.vmap(
        lambda t, i: t.edit(gen_at(9), g.IndexRequest(i, g.Update(g.C["z"].set(0.9)))),
        randomness="different",
    )(trs, idxs)
    assert torch.isnan(ws).tolist() == [True, False, True]

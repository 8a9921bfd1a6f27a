"""The port's combinators, case by case, against ``genjax_tpu``.

Mirrors ``tests/generative_functions/test_combinators.py``: scores, assess,
importance weights and edit weights of ``vmap``, ``scan``, ``switch``,
``mask``, ``dimap``, ``repeat``, ``or_else``, ``mix`` and the derived
scans, each checked against the hand-computed log-density of the same
choices (the reference test's closed forms) and, where a weight is
deterministic, against the reference's own on the same choices, to 1e-5.
Random draws differ (a ``torch.Generator`` in sequence against split
keys), so random quantities are held in law.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu_torch.core.diff import Diff, NoChange, UnknownChange
from torch_chm_bridge import to_jax
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def lp(v, mu, sigma):
    return float(stats.norm.logpdf(float(v), float(mu), sigma))


def approx(x, rel=TOL, abs=1e-6):
    return pytest.approx(float(x), rel=rel, abs=abs)


def unmask(v):
    return v.unmask() if isinstance(v, g.Mask) else v


@g.gen
def two_normals(mu):
    x = g.normal(mu, 1.0) @ "x"
    y = g.normal(x, 0.5) @ "y"
    return y


@gj.gen
def two_normals_ref(mu):
    x = gj.normal(mu, 1.0) @ "x"
    y = gj.normal(x, 0.5) @ "y"
    return y


@g.gen
def rw_kernel(c, x):
    z = g.normal(c, 1.0) @ "z"
    return (z, z + x)


@gj.gen
def rw_kernel_ref(c, x):
    z = gj.normal(c, 1.0) @ "z"
    return (z, z + x)


@g.gen
def branch_normal():
    return g.normal(0.0, 1.0) @ "n"


@g.gen
def branch_flip():
    f = g.flip(0.3) @ "f"
    return f.to(torch.float32)


class TestVmap:
    def test_simulate_score_is_sum_of_lanes(self):
        vm = two_normals.vmap(in_axes=(0,))
        mus = torch.arange(4.0)
        tr = vm.simulate(gen_at(0), (mus,))
        chm = tr.get_choices()
        expected = sum(
            lp(chm[i, "x"], mus[i], 1.0) + lp(chm[i, "y"], chm[i, "x"], 0.5) for i in range(4)
        )
        assert tr.get_score() == approx(expected)
        ref, _ = two_normals_ref.vmap(in_axes=(0,)).assess(to_jax(chm), (jnp.arange(4.0),))
        assert tr.get_score() == approx(ref)

    def test_assess_matches_simulate(self):
        vm = two_normals.vmap(in_axes=(0,))
        mus = torch.arange(3.0)
        tr = vm.simulate(gen_at(1), (mus,))
        score, retval = vm.assess(tr.get_choices(), (mus,))
        assert score == approx(tr.get_score())
        assert torch.allclose(retval, tr.get_retval())

    def test_generate_weight_identity(self):
        vm = two_normals.vmap(in_axes=(0,))
        tr, w = vm.generate(gen_at(2), g.C[1, "x"].set(0.7), (torch.zeros(3),))
        assert float(unmask(tr.get_choices()[1, "x"])) == approx(0.7)
        assert w == approx(lp(0.7, 0.0, 1.0))

    def test_update_weight_identity(self):
        vm = two_normals.vmap(in_axes=(0,))
        tr = vm.simulate(gen_at(3), (torch.zeros(2),))
        chm = tr.get_choices()
        old_x0, y0 = chm[0, "x"], chm[0, "y"]
        new_tr, w, _rd, discard = tr.update(gen_at(4), g.C[0, "x"].set(2.0))
        expected = lp(2.0, 0, 1) + lp(y0, 2.0, 0.5) - lp(old_x0, 0, 1) - lp(y0, old_x0, 0.5)
        assert w == approx(expected, rel=1e-4)
        assert new_tr.get_score() == approx(tr.get_score() + w, rel=1e-4)
        assert float(unmask(discard[0, "x"])) == approx(old_x0)
        ref_tr, _ = two_normals_ref.vmap(in_axes=(0,)).generate(
            jax.random.key(0), to_jax(chm), (jnp.zeros(2),)
        )
        _, ref_w, _, _ = ref_tr.update(jax.random.key(1), gj.C[0, "x"].set(2.0))
        assert w == approx(ref_w)

    def test_index_edit_matches_dense_update(self):
        vm = two_normals.vmap(in_axes=(0,))
        tr = vm.simulate(gen_at(5), (torch.zeros(8),))
        req = g.IndexRequest(torch.tensor(3), g.Update(g.C["x"].set(1.5)))
        new_tr, w, _rd, bwd = tr.edit(gen_at(6), req)
        dense_tr, dense_w, _, _ = tr.update(gen_at(6), g.C[3, "x"].set(1.5))
        assert w == approx(dense_w, rel=1e-4)
        assert new_tr.get_score() == approx(dense_tr.get_score(), rel=1e-4)
        assert float(new_tr.get_choices()[3, "x"]) == approx(1.5)
        assert isinstance(bwd, g.IndexRequest)
        back, wb, _, _ = new_tr.edit(gen_at(7), bwd)
        assert float(w + wb) == pytest.approx(0.0, abs=1e-5)

    def test_project_all_none(self):
        tr = two_normals.vmap(in_axes=(0,)).simulate(gen_at(8), (torch.zeros(3),))
        assert tr.project(gen_at(1), g.Selection.all()) == approx(tr.get_score())
        assert float(tr.project(gen_at(1), g.Selection.none())) == 0.0

    def test_project_subselection(self):
        tr = two_normals.vmap(in_axes=(0,)).simulate(gen_at(9), (torch.zeros(3),))
        w = tr.project(gen_at(1), g.S[1, "x"])
        assert w == approx(lp(tr.get_choices()[1, "x"], 0.0, 1.0))

    def test_uninferable_axis_size_raises(self):
        with pytest.raises(ValueError, match="axis size"):
            two_normals.vmap(in_axes=(None,)).simulate(gen_at(0), (0.0,))
        tr = two_normals.vmap(in_axes=(None,), axis_size=3).simulate(gen_at(0), (0.0,))
        assert tuple(tr.get_retval().shape) == (3,)


class TestScan:
    def test_simulate_score(self):
        sc = rw_kernel.scan()
        tr = sc.simulate(gen_at(0), (0.0, torch.ones(5)))
        chm = tr.get_choices()
        zs = [float(chm[t, "z"]) for t in range(5)]
        expected = lp(zs[0], 0.0, 1.0) + sum(lp(zs[t], zs[t - 1], 1.0) for t in range(1, 5))
        assert tr.get_score() == approx(expected)
        c_final, ys = tr.get_retval()
        assert float(c_final) == approx(zs[-1])
        assert tuple(ys.shape) == (5,)
        ref, (ref_c, ref_ys) = rw_kernel_ref.scan().assess(to_jax(chm), (0.0, jnp.ones(5)))
        assert tr.get_score() == approx(ref)
        np.testing.assert_allclose(ys.numpy(), np.asarray(ref_ys), rtol=1e-6)

    def test_assess_matches(self):
        sc = rw_kernel.scan()
        tr = sc.simulate(gen_at(1), (0.0, torch.zeros(4)))
        score, (c_final, ys) = sc.assess(tr.get_choices(), (0.0, torch.zeros(4)))
        assert score == approx(tr.get_score())

    def test_generate_partial_constraint(self):
        tr, w = rw_kernel.scan().generate(gen_at(2), g.C[1, "z"].set(0.3), (0.0, torch.zeros(3)))
        chm = tr.get_choices()
        assert float(chm[1, "z"]) == approx(0.3)
        assert w == approx(lp(0.3, chm[0, "z"], 1.0))

    def test_update_weight_and_carry_propagation(self):
        tr = rw_kernel.scan().simulate(gen_at(3), (0.0, torch.zeros(3)))
        chm = tr.get_choices()
        new_tr, w, _rd, _discard = tr.update(gen_at(4), g.C[0, "z"].set(1.0))
        new_chm = new_tr.get_choices()
        assert float(new_chm[0, "z"]) == approx(1.0)
        assert float(new_chm[1, "z"]) == approx(chm[1, "z"])
        assert new_tr.get_score() == approx(tr.get_score() + w, rel=1e-4)
        ref_tr, _ = rw_kernel_ref.scan().generate(jax.random.key(0), to_jax(chm), (0.0, jnp.zeros(3)))
        _, ref_w, _, _ = ref_tr.update(jax.random.key(1), gj.C[0, "z"].set(1.0))
        assert w == approx(ref_w)

    @pytest.mark.parametrize("idx", [2, torch.tensor(2)], ids=["int", "tensor"])
    def test_index_edit_weight(self, idx):
        tr = rw_kernel.scan().simulate(gen_at(5), (0.0, torch.zeros(6)))
        chm = tr.get_choices()
        req = g.IndexRequest(idx, g.Update(g.C["z"].set(0.9)))
        new_tr, w, _rd, bwd = tr.edit(gen_at(6), req)
        z1, z2, z3 = chm[1, "z"], chm[2, "z"], chm[3, "z"]
        expected = lp(0.9, z1, 1) - lp(z2, z1, 1) + lp(z3, 0.9, 1) - lp(z3, z2, 1)
        assert w == approx(expected, rel=1e-4)
        assert new_tr.get_score() == approx(tr.get_score() + w, rel=1e-4)
        assert isinstance(bwd, g.IndexRequest)
        ref_tr, _ = rw_kernel_ref.scan().generate(jax.random.key(0), to_jax(chm), (0.0, jnp.zeros(6)))
        _, ref_w, _, _ = ref_tr.edit(
            jax.random.key(1), gj.IndexRequest(jnp.asarray(2), gj.Update(gj.C["z"].set(0.9)))
        )
        assert w == approx(ref_w)

    def test_project(self):
        tr = rw_kernel.scan().simulate(gen_at(7), (0.0, torch.zeros(4)))
        chm = tr.get_choices()
        w = tr.project(gen_at(1), g.S[2, "z"])
        assert w == approx(lp(chm[2, "z"], chm[1, "z"], 1.0))
        w_idx = tr.project(gen_at(1), g.S[torch.tensor([1, 3]), "z"])
        expected = lp(chm[1, "z"], chm[0, "z"], 1.0) + lp(chm[3, "z"], chm[2, "z"], 1.0)
        assert w_idx == approx(expected)

    def test_length_needs_n_or_xs(self):
        with pytest.raises(ValueError, match="cannot be inferred"):
            rw_kernel.scan().simulate(gen_at(0), (0.0, None))


class TestSwitch:
    def test_simulate_concrete_index(self):
        tr = g.switch(branch_normal, branch_flip).simulate(gen_at(0), (0, (), ()))
        n = unmask(tr.get_choices()["n"])
        assert tr.get_score() == approx(lp(n, 0.0, 1.0))
        assert "f" not in tr.get_choices()  # only the selected branch ran

    def test_simulate_tensor_index(self):
        tr = g.switch(branch_normal, branch_flip).simulate(gen_at(1), (torch.tensor(1), (), ()))
        f = tr.get_choices()["f"]
        assert isinstance(f, g.Mask) and bool(f.flag)
        p = 0.3 if bool(f.value) else 0.7
        assert tr.get_score() == approx(np.log(p))
        assert not bool(tr.get_choices()["n"].flag)

    def test_assess(self):
        sw = g.switch(branch_normal, branch_flip)
        tr = sw.simulate(gen_at(2), (torch.tensor(0), (), ()))
        score, _ = sw.assess(tr.get_choices(), (torch.tensor(0), (), ()))
        assert score == approx(tr.get_score())

    def test_generate_constrained(self):
        _tr, w = g.switch(branch_normal, branch_flip).generate(gen_at(3), g.C["n"].set(0.5), (0, (), ()))
        assert w == approx(lp(0.5, 0.0, 1.0))

    def test_update_same_index(self):
        tr = g.switch(branch_normal, branch_flip).simulate(gen_at(4), (0, (), ()))
        new_tr, w, _rd, _bwd = tr.update(gen_at(5), g.C["n"].set(1.0))
        assert w == approx(lp(1.0, 0.0, 1.0) - tr.get_score(), rel=1e-4)
        assert float(new_tr.get_choices()["n"]) == approx(1.0)

    def test_tensor_index_selects_per_lane(self):
        """Under vmap each lane picks its own branch: the batch's score is
        each lane's branch's."""
        sw = g.switch(branch_normal, branch_flip)
        idx = torch.tensor([0, 1, 1, 0])
        trs = torch.func.vmap(lambda i: sw.simulate(gen_at(0), (i, (), ())), randomness="different")(idx)
        for lane in range(4):
            tr = torch.utils._pytree.tree_map(lambda v: v[lane], trs)
            if lane in (0, 3):
                expected = lp(tr.subtraces[0].get_retval(), 0.0, 1.0)
            else:
                expected = np.log(0.3 if bool(tr.subtraces[1].get_choices()["f"]) else 0.7)
            assert tr.get_score() == approx(expected)


class TestMask:
    def test_false_score_zero(self):
        tr = two_normals.mask().simulate(gen_at(0), (False, 0.0))
        assert float(tr.get_score()) == 0.0
        assert isinstance(tr.get_retval(), g.Mask)

    def test_true_matches_inner(self):
        tr = two_normals.mask().simulate(gen_at(1), (True, 0.0))
        inner = two_normals.simulate(gen_at(1), (0.0,))
        assert tr.get_score() == approx(inner.get_score())

    def test_tensor_flag(self):
        tr = two_normals.mask().simulate(gen_at(2), (torch.tensor(True), 0.0))
        assert float(tr.get_score()) != 0.0

    def test_edit_flag_transitions(self):
        mm = two_normals.mask()

        def argdiffs(flag):
            return (Diff(torch.tensor(flag), UnknownChange), Diff(0.0, NoChange))

        tr = mm.simulate(gen_at(3), (torch.tensor(True), 0.0))
        inner_score = tr.inner.get_score()
        new_tr, w, _, _ = mm.edit(gen_at(4), tr, g.Update(g.ChoiceMap.empty()), argdiffs(False))
        assert w == approx(-inner_score)
        assert float(new_tr.get_score()) == 0.0

        tr_off = mm.simulate(gen_at(5), (torch.tensor(False), 0.0))
        new_tr, w, _, _ = mm.edit(gen_at(6), tr_off, g.Update(g.ChoiceMap.empty()), argdiffs(False))
        assert float(w) == 0.0 and float(new_tr.get_score()) == 0.0

        new_tr, w, _, _ = mm.edit(gen_at(7), tr_off, g.Update(g.ChoiceMap.empty()), argdiffs(True))
        assert w == approx(new_tr.get_score()) and float(new_tr.get_score()) != 0.0

        new_tr, w, _, _ = mm.edit(gen_at(8), tr, g.Update(g.C["x"].set(0.7)), argdiffs(True))
        assert w == approx(new_tr.get_score() - tr.get_score(), rel=1e-4)
        assert float(unmask(new_tr.get_choices()["x"])) == approx(0.7)

    def test_assess(self):
        mm = two_normals.mask()
        tr = mm.simulate(gen_at(9), (True, 0.0))
        score, _ = mm.assess(tr.inner.get_choices(), (True, 0.0))
        assert score == approx(tr.get_score())


class TestDimap:
    def test_pre_post(self):
        dm = two_normals.dimap(pre=lambda a, b: (a + b,), post=lambda args, r: r * 2.0)
        tr = dm.simulate(gen_at(0), (1.0, 2.0))
        inner = two_normals.simulate(gen_at(0), (3.0,))
        assert tr.get_score() == approx(inner.get_score())
        assert tr.get_retval() == approx(2.0 * inner.get_retval())

    def test_update_through_dimap(self):
        tr = two_normals.contramap(lambda a: (a * 2.0,)).simulate(gen_at(1), (0.5,))
        new_tr, w, _rd, _ = tr.update(gen_at(2), g.C["x"].set(0.0))
        assert float(new_tr.get_choices()["x"]) == 0.0
        assert new_tr.get_score() == approx(tr.get_score() + w, rel=1e-4)

    def test_conservative_argdiffs(self):
        """A changed input marks every inner argument changed; none marks
        none: the inner trace is then reused untouched."""
        dm = two_normals.contramap(lambda a: (a * 2.0,))
        tr = dm.simulate(gen_at(3), (0.5,))
        same, w, rd, _ = dm.edit(gen_at(4), tr, g.Update(g.ChoiceMap.empty()), (Diff(0.5, NoChange),))
        assert float(w) == 0.0 and Diff.static_check_no_change(rd)
        moved, w, rd, _ = dm.edit(gen_at(5), tr, g.Update(g.ChoiceMap.empty()), (Diff(1.0, UnknownChange),))
        assert not Diff.static_check_no_change(rd)
        assert w == approx(moved.get_score() - tr.get_score(), rel=1e-4)


class TestRepeat:
    def test_iid_score(self):
        tr = two_normals.repeat(n=5).simulate(gen_at(0), (0.0,))
        assert tuple(tr.get_retval().shape) == (5,)
        chm = tr.get_choices()
        expected = sum(lp(chm[i, "x"], 0.0, 1.0) + lp(chm[i, "y"], chm[i, "x"], 0.5) for i in range(5))
        assert tr.get_score() == approx(expected)

    def test_update_one_lane(self):
        tr = two_normals.repeat(n=3).simulate(gen_at(1), (0.0,))
        new_tr, w, _rd, _ = tr.update(gen_at(2), g.C[1, "x"].set(0.0))
        assert float(unmask(new_tr.get_choices()[1, "x"])) == 0.0
        assert new_tr.get_score() == approx(tr.get_score() + w, rel=1e-4)


class TestOrElse:
    def test_branches(self):
        oe = g.or_else(branch_normal, branch_flip)
        tr_if = oe.simulate(gen_at(0), (torch.tensor(True), (), ()))
        assert "n" in tr_if.get_choices()
        tr_else = oe.simulate(gen_at(1), (torch.tensor(False), (), ()))
        assert tr_else.get_choices()["f"] is not None
        concrete = oe.simulate(gen_at(2), (True, (), ()))
        assert "n" in concrete.get_choices() and "f" not in concrete.get_choices()

    def test_unchanged_flag_changed_arg_keeps_choices(self):
        """A changed branch argument with the flag unchanged keeps the
        unconstrained choice and weighs the Update (the reference's
        behaviour, which its staged ``changed_through`` gives): the port's
        dimap marks the index changed, and the switch edits a lane whose
        index is in fact the old one as unchanged."""

        @g.gen
        def branch_if(mu):
            x = g.normal(mu, 1.0) @ "x"
            return g.normal(x, 1.0) @ "y"

        @g.gen
        def branch_else(mu):
            return g.normal(mu, 2.0) @ "z"

        m = g.or_else(branch_if, branch_else)
        for flag in (True, torch.tensor(True)):
            tr = m.simulate(gen_at(3), (flag, (0.0,), (0.0,)))
            old_x = float(unmask(tr.get_choices()["x"]))
            argdiffs = (Diff(flag, NoChange), (Diff(0.5, UnknownChange),), (Diff(0.0, NoChange),))
            new_tr, w, _rd, _bwd = m.edit(gen_at(4), tr, g.Update(g.C.kw(y=1.0)), argdiffs)
            assert float(unmask(new_tr.get_choices()["x"])) == approx(old_x)
            assert w == approx(new_tr.get_score() - tr.get_score(), rel=1e-4)


class TestMix:
    def test_structure_and_score(self):
        mx = g.mix(branch_normal, branch_normal)
        logits = torch.log(torch.tensor([0.25, 0.75]))
        tr = mx.simulate(gen_at(0), (logits, (), ()))
        chm = tr.get_choices()
        idx = int(unmask(chm["mixture_component"]))
        n = unmask(chm["component_sample", "n"])
        assert tr.get_score() == approx(float(logits[idx]) + lp(n, 0.0, 1.0), rel=1e-4)

    def test_component_frequencies(self):
        mx = g.mix(branch_normal, branch_normal)
        logits = torch.log(torch.tensor([0.25, 0.75]))
        trs = torch.func.vmap(lambda _: mx.simulate(gen_at(1), (logits, (), ())), randomness="different")(
            torch.zeros(4000)
        )
        share = float(trs.get_choices()["mixture_component"].float().mean())
        assert abs(share - 0.75) < 4 * np.sqrt(0.75 * 0.25 / 4000)


class TestDerivedScan:
    def test_accumulate(self):
        @g.gen
        def acc_k(c, x):
            return g.normal(c + x, 0.01) @ "a"

        out = acc_k.accumulate().simulate(gen_at(0), (0.0, torch.ones(4))).get_retval()
        assert tuple(out.shape) == (5,) and float(out[0]) == 0.0

    def test_reduce(self):
        @g.gen
        def add_k(c, x):
            return g.normal(c + x, 0.01) @ "a"

        assert add_k.reduce().simulate(gen_at(1), (0.0, torch.ones(4))).get_retval() == pytest.approx(4.0, abs=0.2)

    def test_iterate(self):
        @g.gen
        def walk(x):
            return g.normal(x, 1.0) @ "s"

        assert tuple(walk.iterate(n=3).simulate(gen_at(2), (0.0,)).get_retval().shape) == (4,)

    def test_iterate_final(self):
        @g.gen
        def walk(x):
            return g.normal(x, 0.01) @ "s"

        assert walk.iterate_final(n=10).simulate(gen_at(3), (5.0,)).get_retval() == pytest.approx(5.0, abs=0.5)

    def test_masked_iterate(self):
        @g.gen
        def walk(x):
            return g.normal(x, 1.0) @ "s"

        tr = walk.masked_iterate().simulate(gen_at(4), (0.0, torch.tensor([True, True, False])))
        out = tr.get_retval()
        assert tuple(out.shape) == (4,) and float(out[3]) == float(out[2])

    def test_masked_iterate_final_score(self):
        @g.gen
        def walk(x):
            return g.normal(x, 1.0) @ "s"

        tr = walk.masked_iterate_final().simulate(gen_at(5), (0.0, torch.tensor([True, False, False])))
        s0 = unmask(tr.get_choices()[0, "s"])
        assert tr.get_score() == approx(lp(s0, 0.0, 1.0), rel=1e-4)


class TestNestedCombinators:
    def test_vmap_of_scan(self):
        vm = rw_kernel.scan().vmap(in_axes=(0, 0))
        inits, xs = torch.zeros(3), torch.zeros((3, 4))
        tr = vm.simulate(gen_at(0), (inits, xs))
        chm = tr.get_choices()
        assert tuple(chm[1, 2, "z"].shape) == ()
        score, _ = vm.assess(chm, (inits, xs))
        assert score == approx(tr.get_score())

    def test_scan_of_switch_in_gen(self):
        @g.gen
        def hybrid(c, x):
            b = g.flip(0.5) @ "b"
            v = g.switch(branch_normal, branch_flip)(b.to(torch.int64), (), ()) @ "v"
            return (c + v, v)

        sc = hybrid.scan()
        tr = sc.simulate(gen_at(1), (0.0, torch.zeros(3)))
        score, _ = sc.assess(tr.get_choices(), (0.0, torch.zeros(3)))
        assert score == approx(tr.get_score(), rel=1e-4)


class TestLosslessBackwardRequests:
    def test_scan_regenerate_roundtrip(self):
        sc = rw_kernel.scan()
        tr = sc.simulate(gen_at(0), (0.0, torch.zeros(4)))
        nd = Diff.tree_diff_no_change(tr.get_args())
        new_tr, w1, _, bwd = sc.edit(gen_at(1), tr, g.Regenerate(g.S[..., "z"]), nd)
        assert isinstance(bwd, g.VectorRequest)
        back, w2, _, _ = new_tr.edit(gen_at(9), bwd)
        for t in range(4):
            assert float(back.get_choices()[t, "z"]) == approx(tr.get_choices()[t, "z"])
        assert float(w1 + w2) == pytest.approx(0.0, abs=1e-4)

    def test_vmap_regenerate_roundtrip(self):
        vm = two_normals.vmap(in_axes=(0,))
        tr = vm.simulate(gen_at(2), (torch.zeros(3),))
        nd = Diff.tree_diff_no_change(tr.get_args())
        new_tr, w1, _, bwd = vm.edit(gen_at(3), tr, g.Regenerate(g.S[..., "x"]), nd)
        back, w2, _, _ = new_tr.edit(gen_at(9), bwd)
        for i in range(3):
            assert float(back.get_choices()[i, "x"]) == approx(tr.get_choices()[i, "x"])
        assert float(w1 + w2) == pytest.approx(0.0, abs=1e-4)

    def test_scan_sparse_regenerate_roundtrip(self):
        """One step regenerated: the steps' backward requests differ in
        structure, and ride as one request a step."""
        sc = rw_kernel.scan()
        tr = sc.simulate(gen_at(4), (0.0, torch.zeros(4)))
        nd = Diff.tree_diff_no_change(tr.get_args())
        new_tr, w1, _, bwd = sc.edit(gen_at(5), tr, g.Regenerate(g.S[2, "z"]), nd)
        assert float(new_tr.get_choices()[1, "z"]) == float(tr.get_choices()[1, "z"])
        back, w2, _, _ = new_tr.edit(gen_at(6), bwd)
        assert float(back.get_choices()[2, "z"]) == approx(tr.get_choices()[2, "z"])
        assert float(w1 + w2) == pytest.approx(0.0, abs=1e-4)


class TestScanIndexEditRetvalConsistency:
    @pytest.mark.parametrize("idx", [2, torch.tensor(2)], ids=["int", "tensor"])
    def test_next_slice_y_spliced(self, idx):
        @g.gen
        def kern(c, x):
            z = g.normal(c, 1.0) @ "z"
            return (z, c)  # y is the INCOMING carry

        tr, _ = kern.scan(n=6).generate(gen_at(0), g.ChoiceMap.empty(), (0.0, None))
        new_tr, _w, _rd, _bwd = tr.edit(gen_at(1), g.IndexRequest(idx, g.Update(g.C["z"].set(7.5))), ())
        _, ys = new_tr.get_retval()
        assert float(ys[3]) == 7.5
        assert float(new_tr.get_inner_trace(3).get_retval()[1]) == 7.5

    def test_last_index_has_no_next_splice(self):
        @g.gen
        def kern(c, x):
            z = g.normal(c, 1.0) @ "z"
            return (z, c)

        tr, _ = kern.scan(n=4).generate(gen_at(0), g.ChoiceMap.empty(), (0.0, None))
        old_ys = tr.get_retval()[1]
        new_tr, _w, _rd, _bwd = tr.edit(gen_at(1), g.IndexRequest(3, g.Update(g.C["z"].set(2.0))), ())
        carry_out, ys = new_tr.get_retval()
        assert torch.equal(ys[:3], old_ys[:3])
        assert float(carry_out) == 2.0


class TestSwitchEdit:
    def test_index_change_edit(self):
        @g.gen
        def b0():
            return g.normal(0.0, 1.0) @ "a"

        @g.gen
        def b1():
            return g.normal(0.0, 1.0) @ "b"

        sw = g.switch(b0, b1)
        tr = sw.simulate(gen_at(0), (0, (), ()))
        new_tr, _w, _rd, _bwd = sw.edit(gen_at(1), tr, g.Update(g.C.kw(b=0.3)), (Diff(1, UnknownChange), (), ()))
        assert float(unmask(new_tr.get_choices()["b"])) == approx(0.3)


# ----------------------------------------------------------------------
# branches that return nothing (F6): switch, mix and or_else under a tensor
# index and under vmap, held against the reference on the same constraints
# ----------------------------------------------------------------------


@g.gen
def silent0(mu):
    _ = g.normal(mu, 1.0) @ "x"


@g.gen
def silent1(mu):
    _ = g.normal(0.0, 2.0) @ "x"


@gj.gen
def silent0_ref(mu):
    _ = gj.normal(mu, 1.0) @ "x"


@gj.gen
def silent1_ref(mu):
    _ = gj.normal(0.0, 2.0) @ "x"


@g.gen
def field0(mu):
    return {"a": g.normal(mu, 1.0) @ "x", "b": None}


@g.gen
def field1(mu):
    return {"a": g.normal(0.0, 2.0) @ "x", "b": None}


@gj.gen
def field0_ref(mu):
    return {"a": gj.normal(mu, 1.0) @ "x", "b": None}


@gj.gen
def field1_ref(mu):
    return {"a": gj.normal(0.0, 2.0) @ "x", "b": None}


def _silent_case(name):
    """(port gen fn, reference gen fn, port args, reference args, port
    constraint, reference constraint, port edit constraint, reference edit
    constraint) of one of F6's five cases."""
    mu = (0.3,)
    if name == "switch":
        return (g.switch(silent0, silent1), gj.switch(silent0_ref, silent1_ref),
                (torch.tensor(1), mu, mu), (jnp.int32(1), mu, mu),
                g.C["x"].set(0.5), gj.C["x"].set(0.5), g.C["x"].set(0.7), gj.C["x"].set(0.7))
    if name == "dict":
        return (g.switch(field0, field1), gj.switch(field0_ref, field1_ref),
                (torch.tensor(0), mu, mu), (jnp.int32(0), mu, mu),
                g.C["x"].set(0.5), gj.C["x"].set(0.5), g.C["x"].set(0.7), gj.C["x"].set(0.7))
    if name == "or_else":
        return (g.or_else(silent0, silent1), gj.or_else(silent0_ref, silent1_ref),
                (torch.tensor(False), mu, mu), (jnp.bool_(False), mu, mu),
                g.C["x"].set(0.5), gj.C["x"].set(0.5), g.C["x"].set(0.7), gj.C["x"].set(0.7))
    if name == "mix":
        logits = [np.log(0.25), np.log(0.75)]
        return (g.mix(silent0, silent1), gj.mix(silent0_ref, silent1_ref),
                (torch.tensor(logits, dtype=torch.float32), mu, mu), (jnp.asarray(logits, jnp.float32), mu, mu),
                g.C["mixture_component"].set(1) | g.C["component_sample", "x"].set(0.5),
                gj.C["mixture_component"].set(1) | gj.C["component_sample", "x"].set(0.5),
                g.C["component_sample", "x"].set(0.7), gj.C["component_sample", "x"].set(0.7))
    assert name == "vmap"
    xs, ys = [0.5, -0.2, 1.0], [0.7, 0.1, -0.4]
    return (g.switch(silent0, silent1).vmap(in_axes=(0, None, None)),
            gj.switch(silent0_ref, silent1_ref).vmap(in_axes=(0, None, None)),
            (torch.tensor([0, 1, 0]), mu, mu), (jnp.asarray([0, 1, 0], jnp.int32), mu, mu),
            g.C[:, "x"].set(torch.tensor(xs)), gj.C[:, "x"].set(jnp.asarray(xs)),
            g.C[:, "x"].set(torch.tensor(ys)), gj.C[:, "x"].set(jnp.asarray(ys)))


def _nothing(retval, name):
    if name == "dict":
        return retval["b"] is None
    return retval is None


SILENT = ["switch", "dict", "or_else", "mix", "vmap"]


class TestBranchesReturningNothing:
    @pytest.mark.parametrize("name", SILENT)
    def test_simulate_and_assess(self, name):
        gf, ref, args, ref_args, *_ = _silent_case(name)
        tr = gf.simulate(gen_at(0), args)
        assert _nothing(tr.get_retval(), name)
        chm = tr.get_choices()
        ref_score, _ = ref.assess(to_jax(chm), ref_args)
        assert tr.get_score() == approx(ref_score)
        score, retval = gf.assess(chm, args)
        assert score == approx(ref_score) and _nothing(retval, name)

    @pytest.mark.parametrize("name", SILENT)
    def test_generate_project_and_edit(self, name):
        gf, ref, args, ref_args, chm, ref_chm, new, ref_new = _silent_case(name)
        tr, w = gf.generate(gen_at(1), chm, args)
        ref_tr, ref_w = ref.generate(jax.random.key(1), ref_chm, ref_args)
        assert w == approx(ref_w) and tr.get_score() == approx(ref_tr.get_score())
        assert _nothing(tr.get_retval(), name)
        sel = g.Selection.all()
        assert tr.project(gen_at(2), sel) == approx(ref_tr.project(jax.random.key(2), gj.Selection.all()))
        new_tr, w, _rd, _bwd = tr.update(gen_at(3), new)
        ref_new_tr, ref_w, _rd, _bwd = ref_tr.update(jax.random.key(3), ref_new)
        assert w == approx(ref_w) and new_tr.get_score() == approx(ref_new_tr.get_score())
        assert _nothing(new_tr.get_retval(), name)

    def test_edit_to_a_new_index(self):
        """The switch's edit across an index change: the kept and the fresh
        traces are chosen between (``FlagOp.where``), ``None`` retval and
        all."""
        gf, ref, args, ref_args, chm, ref_chm, new, ref_new = _silent_case("switch")
        tr, _ = gf.generate(gen_at(4), chm, args)
        ref_tr, _ = ref.generate(jax.random.key(4), ref_chm, ref_args)
        argdiffs = (Diff(torch.tensor(0), UnknownChange), (Diff(0.3, NoChange),), (Diff(0.3, NoChange),))
        new_tr, w, _rd, _bwd = gf.edit(gen_at(5), tr, g.Update(new), argdiffs)
        import genjax_tpu.core.diff as jdiff

        ref_argdiffs = (jdiff.Diff(jnp.int32(0), jdiff.UnknownChange),
                        (jdiff.Diff(0.3, jdiff.NoChange),), (jdiff.Diff(0.3, jdiff.NoChange),))
        ref_new_tr, ref_w, _rd, _bwd = ref.edit(jax.random.key(5), ref_tr, gj.Update(ref_new), ref_argdiffs)
        assert w == approx(ref_w) and new_tr.get_score() == approx(ref_new_tr.get_score())
        assert new_tr.get_retval() is None

    def test_only_some_branches_returning_nothing_raises(self):
        gf = g.switch(silent0, branch_normal)
        with pytest.raises(ValueError, match="some are None"):
            gf.simulate(gen_at(6), (torch.tensor(1), (0.3,), ()))

    @pytest.mark.parametrize("name", SILENT)
    def test_traces_cross_an_outer_vmap(self, name):
        """A batch of the five cases' traces: ``torch.func.vmap`` takes a
        trace whose return value is ``None`` or holds a ``None`` field, as
        ``jax.vmap`` takes the reference's."""
        gf, _ref, args, *_ = _silent_case(name)
        trs = torch.func.vmap(lambda _: gf.simulate(gen_at(7), args), randomness="different")(torch.zeros(3))
        assert _nothing(trs.get_retval(), name)
        scores = torch.func.vmap(lambda tr: gf.assess(tr.get_choices(), args)[0])(trs)
        own = torch.func.vmap(lambda tr: tr.get_score())(trs)
        assert torch.allclose(scores, own, atol=1e-6)

"""The GFI contract of the port's combinators, held against ``genjax_tpu``.

Every combinator configuration of
``tests/generative_functions/test_gfi_contract.py`` (the Kalman model
``lgssm-in-static`` and the GP, which are not combinators, left out) is
built in both packages. The port's invariants are the reference test's:
``simulate`` scores what ``assess`` scores; ``generate`` under the full
choices weighs the score; ``generate`` under nothing weighs 0; ``project``
of all and none; an ``Update`` round trip cancels and restores the score.
Each deterministic quantity is also held against the reference on the same
choices (carried across node for node) to 1e-5: ``assess``, the ``generate``
weight and the ``Update`` weight. And each configuration runs under
``torch.func.vmap`` over a few lanes, as ``chip_smoke.py``'s
``[combinators]`` phase runs it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from torch_chm_bridge import leaves_close, to_jax
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
ROUND_TRIP_TOL = 1e-4


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def zoo(m, A, I):
    """The configurations in package ``m``; ``A`` makes a float array of
    ``m``'s, ``I`` an int (index) one."""

    @m.gen
    def leaf(mu):
        x = m.normal(mu, 1.0) @ "x"
        y = m.normal(x, 0.5) @ "y"
        return x + y

    @m.gen
    def kern(c, _x):
        z = m.normal(0.7 * c, 1.0) @ "z"
        return (z, z)

    @m.gen
    def b0():
        return m.normal(0.0, 1.0) @ "a"

    @m.gen
    def b1():
        return m.normal(1.0, 2.0) @ "b"

    @m.gen
    def nested(mu):
        a = leaf(mu) @ "sub"
        return m.normal(a, 1.0) @ "top"

    sw = m.switch(b0, b1)

    @m.gen
    def switch_in_static(idx):
        return sw(idx, (), ()) @ "sw"

    @m.gen
    def step(x):
        return m.normal(0.5 * x, 1.0) @ "w"

    @m.gen
    def acc_step(c, x):
        return m.normal(c + x, 1.0) @ "w"

    sv = kern.scan(n=4)
    return {
        "static": (leaf, (0.3,)),
        "nested-static": (nested, (0.3,)),
        "vmap": (leaf.vmap(in_axes=(0,)), (A([0.0, 1.0, 2.0]),)),
        "scan": (sv, (0.0, A(np.zeros(4)))),
        "vmap-of-scan": (sv.vmap(in_axes=(0, None)), (A([0.0, 1.0]), A(np.zeros(4)))),
        "switch": (sw, (0, (), ())),
        "switch-tensor-index": (sw, (I(1), (), ())),
        "switch-traced-in-static": (switch_in_static, (I(1),)),
        "mask-on": (m.mask_combinator(leaf), (True, 0.3)),
        "mask-tensor-off": (m.mask_combinator(leaf), (A(False), 0.3)),
        "dimap": (leaf.dimap(pre=lambda a: (a * 2.0,), post=lambda args, r: r + 1.0), (0.15,)),
        "repeat": (leaf.repeat(n=3), (0.3,)),
        "or_else": (b0.or_else(b1), (True, (), ())),
        "or_else-tensor-flag": (b0.or_else(b1), (A(False), (), ())),
        "mix": (m.mix(b0, b1), (A(np.zeros(2)), (), ())),
        "iterate": (step.iterate(n=3), (0.5,)),
        "iterate_final": (step.iterate_final(n=3), (0.5,)),
        "accumulate": (acc_step.accumulate(), (0.0, A(np.ones(3)))),
        "reduce": (acc_step.reduce(), (0.0, A(np.ones(3)))),
        "masked_iterate_final": (step.masked_iterate_final(), (0.5, A([True, False, True]))),
    }


def _torch_array(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.float32) if x.dtype == np.float64 else x)


PORT = zoo(g, _torch_array, lambda i: torch.tensor(i))
REF = zoo(gj, jnp.asarray, lambda i: jnp.asarray(i))
IDS = list(PORT)


def _close(a, b, tol=TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol + tol * abs(b), (a, b)


@pytest.mark.parametrize("name", IDS)
class TestContract:
    def test_simulate_assess_consistency(self, name):
        model, args = PORT[name]
        tr = model.simulate(gen_at(0), args)
        score, retval = model.assess(tr.get_choices(), args)
        _close(score, tr.get_score())
        for a, b in zip(torch.utils._pytree.tree_leaves(tr.get_retval()),
                        torch.utils._pytree.tree_leaves(retval)):
            assert torch.allclose(torch.as_tensor(a, dtype=torch.float32),
                                  torch.as_tensor(b, dtype=torch.float32), atol=1e-5), name

    def test_assess_matches_reference(self, name):
        model, args = PORT[name]
        ref_model, ref_args = REF[name]
        tr = model.simulate(gen_at(1), args)
        ref_score, ref_retval = ref_model.assess(to_jax(tr.get_choices()), ref_args)
        _close(tr.get_score(), ref_score)
        leaves_close(tr.get_retval(), ref_retval)

    def test_generate_full_constraint_recovers_score(self, name):
        model, args = PORT[name]
        ref_model, ref_args = REF[name]
        tr = model.simulate(gen_at(2), args)
        new_tr, w = model.generate(gen_at(7), tr.get_choices(), args)
        _close(w, tr.get_score())
        _close(new_tr.get_score(), tr.get_score())
        _ref_tr, ref_w = ref_model.generate(jax.random.key(7), to_jax(tr.get_choices()), ref_args)
        _close(w, ref_w)

    def test_generate_empty_weight_zero(self, name):
        model, args = PORT[name]
        _tr, w = model.generate(gen_at(3), g.ChoiceMap.empty(), args)
        assert abs(float(w)) <= 1e-6, name

    def test_project_all_none(self, name):
        model, args = PORT[name]
        tr = model.simulate(gen_at(4), args)
        _close(tr.project(gen_at(1), g.Selection.all()), tr.get_score())
        assert abs(float(tr.project(gen_at(1), g.Selection.none()))) <= 1e-6, name

    def test_update_roundtrip_against_reference(self, name):
        model, args = PORT[name]
        ref_model, ref_args = REF[name]
        tr = model.simulate(gen_at(5), args)
        donor = model.simulate(gen_at(6), args)
        new_tr, w, _rd, bwd = model.edit(
            gen_at(8), tr, g.Update(donor.get_choices()), g.Diff.tree_diff_no_change(args)
        )
        _close(new_tr.get_score(), tr.get_score() + w, ROUND_TRIP_TOL)
        _close(new_tr.get_score(), donor.get_score(), ROUND_TRIP_TOL)
        back, wb, _, _ = new_tr.edit(gen_at(9), bwd)
        assert abs(float(w + wb)) <= ROUND_TRIP_TOL, name
        _close(back.get_score(), tr.get_score(), ROUND_TRIP_TOL)
        # the reference's weight for the same move between the same choices
        ref_tr, _ = ref_model.generate(jax.random.key(1), to_jax(tr.get_choices()), ref_args)
        _, ref_w, _, _ = ref_model.edit(
            jax.random.key(2), ref_tr, gj.Update(to_jax(donor.get_choices())),
            gj.Diff.tree_diff_no_change(ref_args),
        )
        _close(w, ref_w)

    def test_vmapped_lanes(self, name):
        """Three lanes under ``torch.func.vmap``: generate under each lane's
        full choices weighs its ``assess``, and an ``Update`` round trip
        cancels lane by lane."""
        model, args = PORT[name]
        gen = gen_at(10)
        lanes = torch.zeros(3)
        sim = torch.func.vmap(lambda _: model.simulate(gen, args), randomness="different")
        trs, donors = sim(lanes), sim(lanes)
        scores = torch.func.vmap(lambda tr: model.assess(tr.get_choices(), args)[0])(trs)
        ws = torch.func.vmap(
            lambda tr: model.generate(gen, tr.get_choices(), args)[1], randomness="different"
        )(trs)
        own = torch.func.vmap(lambda tr: tr.get_score())(trs)
        assert torch.allclose(scores, own, atol=1e-4) and torch.allclose(ws, own, atol=1e-4), name

        def forward(tr, donor):
            new_tr, w, _rd, bwd = model.edit(
                gen, tr, g.Update(donor.get_choices()), g.Diff.tree_diff_no_change(args)
            )
            return new_tr, w, bwd

        new_trs, w, bwds = torch.func.vmap(forward, randomness="different")(trs, donors)
        wb = torch.func.vmap(lambda tr, b: tr.edit(gen, b)[1], randomness="different")(new_trs, bwds)
        assert torch.allclose(w + wb, torch.zeros(3), atol=ROUND_TRIP_TOL), name

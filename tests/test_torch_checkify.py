"""Runtime checks of the port (``do_checkify``), against ``genjax_tpu``.

The port's counterpart of ``tests/core/test_constraint_validation.py``, case
by case, ``switch`` siblings included: a misspelled constraint address is an
error under ``do_checkify()`` and silently ignored outside it, in both
packages. Beyond it, the checks on tensor flags: an invalid ``Mask``
unmasked, a false masked flag in ``assess`` and a typo that a tensor flag
decides raise from inside one and two ``torch.func.vmap``s.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.checkify import do_checkify as jdo_checkify
from genjax_tpu.generative.choice_map import ChoiceMapInvalidAddress as JInvalid
from genjax_tpu_torch.checkify import CheckError, check, checkify_enabled, do_checkify, optional_check
from genjax_tpu_torch.generative.choice_map import ChoiceMapInvalidAddress, exists_flag, shape_selection
from torch_threads import _one_thread  # noqa: F401


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def models(m):
    @m.gen
    def model(mu):
        x = m.normal(mu, 1.0) @ "x"
        m.flip(0.5) @ "y"
        return x

    @m.gen
    def nested(mu):
        a = model(mu) @ "sub"
        return m.normal(a, 1.0) @ "top"

    return model, nested


TM, TN = models(g)
JM, JN = models(gj)


class TestInvalidSubset:
    def test_reference_example(self):
        for m, model in ((g, TM), (gj, JM)):
            extras = m.ChoiceMap.d({"y": 1, "z": 2}).invalid_subset(model, (0.0,))
            assert extras is not None and "z" in extras and "y" not in extras

    def test_valid_constraint_returns_none(self):
        for m, model in ((g, TM), (gj, JM)):
            assert (m.C["x"].set(1.0) | m.C["y"].set(True)).invalid_subset(model, (0.0,)) is None

    def test_nested_typo_detected(self):
        for m, nested in ((g, TN), (gj, JN)):
            extras = m.C["sub", "typo"].set(1.0).invalid_subset(nested, (0.0,))
            assert extras is not None and ("sub", "typo") in extras
            assert (m.C["sub", "x"].set(1.0) | m.C["top"].set(0.5)).invalid_subset(nested, (0.0,)) is None

    def test_value_where_submap_expected(self):
        for m, nested in ((g, TN), (gj, JN)):
            assert m.C["sub"].set(1.0).invalid_subset(nested, (0.0,)) is not None

    def test_scan_constraint_validation(self):
        for m, zeros in ((g, torch.zeros), (gj, jnp.zeros)):
            @m.gen
            def kern(c, x):
                z = m.normal(c, 1.0) @ "z"
                return (z, z)

            sc = kern.scan(n=4)
            assert m.C[:, "z"].set(zeros(4)).invalid_subset(sc, (0.0, None)) is None
            assert m.C[:, "nope"].set(zeros(4)).invalid_subset(sc, (0.0, None)) is not None


class TestGenerateValidation:
    def test_typo_raises_under_checkify(self):
        with jdo_checkify(), pytest.raises(JInvalid):
            JM.generate(jax.random.key(0), gj.C["typo"].set(1.0), (0.0,))
        with do_checkify(), pytest.raises(ChoiceMapInvalidAddress):
            TM.generate(gen_at(0), g.C["typo"].set(1.0), (0.0,))

    def test_valid_constraint_passes_under_checkify(self):
        with do_checkify():
            _, w = TM.generate(gen_at(0), g.C["x"].set(1.0), (0.0,))
        with jdo_checkify():
            _, jw = JM.generate(jax.random.key(0), gj.C["x"].set(1.0), (0.0,))
        assert float(w) == pytest.approx(float(jw), abs=1e-5)

    def test_no_checkify_no_validation(self):
        _, w = TM.generate(gen_at(0), g.C["typo"].set(1.0), (0.0,))
        _, jw = JM.generate(jax.random.key(0), gj.C["typo"].set(1.0), (0.0,))
        assert float(w) == float(jw) == 0.0

    def test_assess_extra_address_raises_under_checkify(self):
        with do_checkify(), pytest.raises(ChoiceMapInvalidAddress):
            TM.assess(g.C["x"].set(1.0) | g.C["y"].set(True) | g.C["zz"].set(2.0), (0.0,))
        with jdo_checkify(), pytest.raises(JInvalid):
            JM.assess(gj.C["x"].set(1.0) | gj.C["y"].set(True) | gj.C["zz"].set(2.0), (0.0,))

    def test_switch_sibling_addresses_not_flagged(self):
        ws = []
        for m, gen in ((g, gen_at(0)), (gj, jax.random.key(0))):
            @m.gen
            def b0():
                return m.normal(0.0, 1.0) @ "a"

            @m.gen
            def b1():
                return m.normal(0.0, 1.0) @ "b"

            with (do_checkify() if m is g else jdo_checkify()):
                # constraining branch 1's address while branch 0 runs is
                # legitimate switch usage: no false positive
                _, w = m.switch(b0, b1).generate(gen, m.C["b"].set(0.3), (0, (), ()))
            ws.append(float(w))
        assert ws[0] == ws[1] == 0.0

    def test_distribution_subaddressed_constraint_raises(self):
        with do_checkify(), pytest.raises(ChoiceMapInvalidAddress):
            g.normal.generate(gen_at(0), g.C["oops"].set(1.0), (0.0, 1.0))
        with jdo_checkify(), pytest.raises(JInvalid):
            gj.normal.generate(jax.random.key(0), gj.C["oops"].set(1.0), (0.0, 1.0))

    def test_nested_generate_typo_detected_at_top_level(self):
        with do_checkify(), pytest.raises(ChoiceMapInvalidAddress):
            TN.generate(gen_at(0), g.C["sub", "typo"].set(1.0), (0.0,))


class TestShapeSelectionAndExists:
    def test_shape_selection_covers_model(self):
        sel = shape_selection(TM.get_zero_trace(0.0).get_choices())
        assert sel["x"] and sel["y"] and not sel["z"]

    def test_exists_flag_static(self):
        assert exists_flag(g.C["x"].set(1.0)) is True
        assert exists_flag(g.ChoiceMap.empty()) is False
        assert bool(exists_flag(g.C["x"].set(1.0).mask(torch.tensor(True))))


# ----------------------------------------------------------------------
# checks on tensor flags, under torch.func.vmap
# ----------------------------------------------------------------------


def twice(fn):
    return torch.func.vmap(torch.func.vmap(fn))


class TestTensorFlags:
    def test_unmask_of_an_invalid_mask(self):
        flags = torch.tensor([[True, False], [True, True]])
        values = torch.ones(2, 2)
        unmask = lambda v, f: g.Mask(v, f).unmask()  # noqa: E731
        assert torch.equal(twice(unmask)(values, flags), values)  # off: no check
        with do_checkify():
            with pytest.raises(CheckError, match="unmask an invalid Mask"):
                torch.func.vmap(unmask)(values[0], flags[0])
            with pytest.raises(CheckError, match="unmask an invalid Mask"):
                twice(unmask)(values, flags)
            assert torch.equal(twice(unmask)(values, torch.ones(2, 2, dtype=torch.bool)), values)
            with pytest.raises(CheckError):
                g.Mask(1.0, False).unmask()

    def test_assess_of_a_false_masked_flag(self):
        flags = torch.tensor([True, False])
        assess = lambda f: g.normal.assess(g.ChoiceMap.entry(g.Mask(torch.tensor(0.5), f)), (0.0, 1.0))[0]  # noqa: E731
        plain = torch.func.vmap(assess)(flags)
        assert plain.shape == (2,)
        with do_checkify():
            with pytest.raises(CheckError, match="masked constraint"):
                torch.func.vmap(assess)(flags)
            with pytest.raises(CheckError, match="masked constraint"):
                twice(assess)(flags.reshape(1, 2))
            torch.func.vmap(assess)(torch.tensor([True, True]))

    def test_typo_decided_by_a_tensor_flag(self):
        def gen_typo(f):
            return TM.generate(gen_at(0), g.C["typo"].set(torch.tensor(1.0)).mask(f), (0.0,))[1]

        flags = torch.tensor([False, True])
        torch.func.vmap(gen_typo, randomness="different")(flags)
        with do_checkify():
            with pytest.raises(ChoiceMapInvalidAddress):
                torch.func.vmap(gen_typo, randomness="different")(flags)
            torch.func.vmap(gen_typo, randomness="different")(torch.tensor([False, False]))

    def test_check_and_gate(self):
        assert not checkify_enabled()
        optional_check(lambda: check(False, "never run"))
        with do_checkify():
            assert checkify_enabled()
            with pytest.raises(CheckError, match="flag"):
                optional_check(lambda: check(torch.tensor([True, False]), "flag"))
        assert not checkify_enabled()

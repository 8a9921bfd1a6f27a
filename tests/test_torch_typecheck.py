"""Type checks at the port's interface boundary (``typecheck``), against
``genjax_tpu``.

The port's counterpart of ``tests/core/test_typecheck.py``, case by case:
both packages reject the same wrong values at ``simulate``, ``generate`` and
``assess`` with the same kind of message (the port names a
``torch.Generator`` where the reference names a PRNG key), and pass valid
calls, under ``vmap`` too. The reference's ``install_import_hook`` needs
``typeguard``, which the port does not use: it raises ``ImportError``.
"""

import jax
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.typecheck import GFITypeError as JGFITypeError
from genjax_tpu_torch.typecheck import (
    GFITypeError,
    check_args,
    check_constraint,
    check_key,
    check_selection,
    install_import_hook,
)
from torch_threads import _one_thread  # noqa: F401


def model_of(m):
    @m.gen
    def model(mu):
        return m.normal(mu, 1.0) @ "x"

    return model


TM, JM = model_of(g), model_of(gj)
GEN = torch.Generator().manual_seed(0)
KEY = jax.random.key(0)


class TestBoundaryChecks:
    def test_simulate_rejects_non_key(self):
        with pytest.raises(GFITypeError, match="torch.Generator"):
            TM.simulate(42, (0.0,))
        with pytest.raises(JGFITypeError, match="PRNG key"):
            JM.simulate(42, (0.0,))

    def test_simulate_rejects_non_tuple_args(self):
        with pytest.raises(GFITypeError, match="tuple"):
            TM.simulate(GEN, 0.0)
        with pytest.raises(JGFITypeError, match="tuple"):
            JM.simulate(KEY, 0.0)

    def test_generate_rejects_dict_constraint(self):
        with pytest.raises(GFITypeError, match="ChoiceMap.d"):
            TM.generate(GEN, {"x": 1.0}, (0.0,))
        with pytest.raises(JGFITypeError, match="ChoiceMap.d"):
            JM.generate(KEY, {"x": 1.0}, (0.0,))

    def test_assess_rejects_non_choicemap(self):
        with pytest.raises(GFITypeError, match="ChoiceMap"):
            TM.assess([("x", 1.0)], (0.0,))
        with pytest.raises(JGFITypeError, match="ChoiceMap"):
            JM.assess([("x", 1.0)], (0.0,))

    def test_a_generator_of_any_device_is_accepted(self):
        # the counterpart of the reference's legacy uint32 keys: the check
        # is on the kind, not on a device
        tr = TM.simulate(torch.Generator(device="cpu").manual_seed(3), (0.0,))
        assert torch.isfinite(tr.get_score())

    def test_valid_calls_unaffected(self):
        TM.simulate(GEN, (0.0,))
        _, w = TM.generate(GEN, g.C["x"].set(1.0), (0.0,))
        s, _ = TM.assess(g.C["x"].set(1.0), (0.0,))
        js, _ = JM.assess(gj.C["x"].set(1.0), (0.0,))
        assert float(s) == pytest.approx(float(js), abs=1e-5)
        assert float(w) == pytest.approx(float(s), abs=1e-6)

    def test_checks_work_under_vmap(self):
        scores = torch.func.vmap(lambda mu: TM.simulate(GEN, (mu,)).get_score(), randomness="different")(torch.zeros(4))
        assert scores.shape == (4,) and bool(torch.isfinite(scores).all())
        jscores = jax.vmap(lambda k: JM.simulate(k, (0.0,)).get_score())(jax.random.split(KEY, 4))
        assert jscores.shape == (4,)

    def test_the_checks_alone(self):
        check_key(GEN, "x")
        check_args((), "x")
        check_constraint(g.ChoiceMap.empty(), "x")
        check_selection(g.S["x"], "x")
        with pytest.raises(GFITypeError, match="Selection"):
            check_selection("x", "regenerate")
        assert issubclass(GFITypeError, TypeError)


def test_install_import_hook_needs_typeguard():
    with pytest.raises(ImportError, match="typeguard"):
        install_import_hook()

"""The port's time-travel debugger, against ``genjax_tpu``.

The port's counterpart of ``tests/debug/test_time_travel.py``, its seven
tests case by case: both packages record the same frames in the same order
with the same arguments and local values, and agree on final values after
``remix``. Beyond it: a remix of a program that draws from a named
generator draws its prefix again bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.debug import rec as jrec
from genjax_tpu.debug import tag as jtag
from genjax_tpu.debug import time_machine as jtime_machine
from genjax_tpu_torch.debug import rec, tag, time_machine
from torch_threads import _one_thread  # noqa: F401


def program_of(rec_, tag_):
    def program(x):
        y = rec_(lambda a: a * 2.0, "double")(x)
        z = rec_(lambda a: a + 10.0, "add10")(y)
        return tag_(z * z, "squared")

    return program


program, jprogram = program_of(rec, tag), program_of(jrec, jtag)


def both(x=3.0):
    return time_machine(program)(torch.tensor(x)), jtime_machine(jprogram)(x)


class TestTimeMachine:
    def test_final_retval(self):
        dbg, jdbg = both()
        assert float(dbg.final_retval) == float(jdbg.final_retval) == pytest.approx(256.0)

    def test_all_frames_captured(self):
        dbg, jdbg = both()
        tags = [f.debug_tag for f in dbg.sequence]
        assert tags == [f.debug_tag for f in jdbg.sequence] == ["_enter", "double", "add10", "squared", "_exit"]

    def test_jump_and_frame(self):
        dbg, jdbg = both()
        (tag_, frame), (jtag_, jframe) = dbg.jump("add10").frame(), jdbg.jump("add10").frame()
        assert tag_ == jtag_ == "add10"
        assert float(frame.args[0]) == float(jframe.args[0]) == pytest.approx(6.0)
        assert float(frame.local_retval) == float(jframe.local_retval) == pytest.approx(16.0)
        for f, jf in zip(dbg.sequence, jdbg.sequence):
            np.testing.assert_allclose(
                [float(a) for a in f.args], [float(a) for a in jf.args], rtol=1e-6
            )
            assert float(f.local_retval) == pytest.approx(float(jf.local_retval), rel=1e-6)

    def test_fwd_bwd(self):
        dbg = both()[0].jump("add10")
        assert dbg.fwd().frame()[0] == "squared"
        assert dbg.bwd().frame()[0] == "double"
        first = dbg.jump("_enter")
        assert first.bwd().frame()[0] == "_enter"
        last = dbg.jump("_exit")
        assert last.fwd().frame()[0] == "_exit"

    def test_remix_reexecutes_from_frame(self):
        dbg, jdbg = both()
        remixed = dbg.jump("add10").remix(torch.tensor(100.0))
        jremixed = jdbg.jump("add10").remix(100.0)
        assert float(remixed.final_retval) == float(jremixed.final_retval) == pytest.approx(110.0**2)
        assert remixed.sequence[1].debug_tag == jremixed.sequence[1].debug_tag == "double"
        assert [f.debug_tag for f in remixed.sequence] == [f.debug_tag for f in jremixed.sequence]
        # a remix of a remix keeps the first one's replacement upstream
        again = remixed.jump("squared")(torch.tensor(3.0))
        assert float(again.final_retval) == 3.0 and remixed(torch.tensor(0.0)).final_retval == 100.0
        assert dbg(torch.tensor(1.0)).final_retval == float(jdbg(1.0).final_retval)

    def test_with_array_computation(self):
        def prog_of(tag_, xp):
            def prog(x):
                s = tag_(xp.sum(x**2), "ss")
                return s + tag_(xp.mean(x), "mean")

            return prog

        dbg = time_machine(prog_of(tag, torch))(torch.arange(4.0))
        jdbg = jtime_machine(prog_of(jtag, jnp))(jnp.arange(4.0))
        assert float(dbg.final_retval) == float(jdbg.final_retval) == pytest.approx(14.0 + 1.5)
        assert [f.debug_tag for f in dbg.sequence] == [f.debug_tag for f in jdbg.sequence] == [
            "_enter", "ss", "mean", "_exit"]

    def test_model_debugging(self):
        """Record points inside a ``@gen`` body's deterministic code; the
        generator named in ``streams`` starts every run where the first did,
        so a remix draws the prefix again bit for bit."""

        def model_of(m, tag_):
            @m.gen
            def model(mu):
                x = m.normal(mu, 1.0) @ "x"
                shifted = tag_(x + 100.0, "shifted")
                return m.normal(shifted, 0.5) @ "y"

            return model

        gen = torch.Generator().manual_seed(0)
        model = model_of(g, tag)
        run = lambda mu: model.simulate(gen, (mu,)).get_choices()  # noqa: E731
        dbg = time_machine(lambda mu: _xy(run(mu)), streams=(gen,))(torch.tensor(0.0))
        jmodel = model_of(gj, jtag)
        jdbg = jtime_machine(lambda mu: jmodel.simulate(jax.random.key(0), (mu,)).get_retval())(0.0)
        tags = [f.debug_tag for f in dbg.sequence]
        assert "shifted" in tags and tags == [f.debug_tag for f in jdbg.sequence]
        at = dbg.jump("shifted")
        x = dbg.final_retval[0]
        assert torch.equal(at.frame()[1].args[0], x + 100.0)
        remixed = at.remix(torch.tensor(-50.0))
        assert torch.equal(remixed.final_retval[0], x)  # the prefix's draw, bit for bit
        assert abs(float(remixed.final_retval[1]) + 50.0) < 5.0
        assert torch.equal(dbg.jump("_enter").remix(torch.tensor(0.0)).final_retval[0], x)


def _xy(chm):
    return chm["x"], chm["y"]

"""Expressivity patterns: conditionals, masking, mixtures, iteration.

Counterpart of ``examples/12_expressivity.py``: how fixed-shape programs
express models whose structure is random.
"""

import math

import torch
from scipy import stats as st

import genjax_tpu_torch as g

from ._common import batch, cli, device_of


def _plain(v):
    return v.unmask() if isinstance(v, g.Mask) else v


def conditionals(gen):
    """Stochastic branching: or_else / switch select whole sub-programs by a
    (possibly tensor) condition."""

    @g.gen
    def spike():
        return g.normal(0.0, 0.1) @ "v"

    @g.gen
    def slab():
        return g.normal(0.0, 10.0) @ "v"

    @g.gen
    def spike_and_slab(p_spike):
        use_spike = g.flip(p_spike) @ "is_spike"
        v = spike.or_else(slab)(use_spike, (), ()) @ "value"
        return v

    tr = spike_and_slab.simulate(gen, (0.9,))
    assert math.isfinite(float(tr.get_score()))
    # density accounting follows the taken branch
    chm = tr.get_choices()
    is_spike = bool(chm["is_spike"])
    v = float(_plain(chm["value", "v"]))
    branch_scale = 0.1 if is_spike else 10.0
    expected = st.bernoulli.logpmf(is_spike, 0.9) + st.norm.logpdf(v, 0.0, branch_scale)
    assert abs(float(tr.get_score()) - expected) <= 1e-5 + 1e-5 * abs(expected)


def masking(gen):
    """Existence uncertainty as data: the mask combinator keeps a
    sub-program's shape while zeroing its density when inactive."""

    @g.gen
    def maybe_outlier(x):
        return g.normal(x, 5.0) @ "noise"

    mm = maybe_outlier.mask()
    on = mm.simulate(gen, (True, 1.0))
    off = mm.simulate(gen, (False, 1.0))
    assert float(off.get_score()) == 0.0
    assert float(on.get_score()) != 0.0
    # the retval is a Mask: consume it with unmask(default)
    assert isinstance(off.get_retval(), g.Mask)
    assert float(off.get_retval().unmask(default=torch.tensor(-1.0, device=gen.device))) == -1.0


def mixtures(gen):
    """mix() builds a mixture generative function: a categorical component
    choice and a switch over component families."""

    @g.gen
    def narrow():
        return g.normal(-3.0, 0.5) @ "x"

    @g.gen
    def wide():
        return g.normal(3.0, 2.0) @ "x"

    m = g.mix(narrow, wide)
    logits = torch.log(torch.tensor([0.25, 0.75], device=gen.device))
    trs = batch(lambda: m.simulate(gen, (logits, (), ())), 2048, gen.device)
    comps = trs.get_choices()["mixture_component"]
    assert abs(float(torch.mean(comps.float())) - 0.75) < 0.05
    # assess matches the mixture's component-conditional density
    tr0 = m.simulate(torch.Generator(device=gen.device).manual_seed(1), (logits, (), ()))
    score, _ = m.assess(tr0.get_choices(), (logits, (), ()))
    assert torch.allclose(score, tr0.get_score(), atol=1e-5)


def iteration(gen):
    """Dynamic-length iteration inside fixed shapes: masked_iterate runs a
    kernel for a runtime number of steps through per-step activity flags."""

    @g.gen
    def halve(x):
        return g.normal(0.5 * x, 0.01) @ "x"

    mi = halve.masked_iterate_final()
    # 3 active steps out of a static budget of 5
    flags = torch.tensor([True, True, True, False, False], device=gen.device)
    tr = mi.simulate(gen, (8.0, flags))
    assert torch.allclose(torch.as_tensor(tr.get_retval()), torch.tensor(1.0, device=gen.device), atol=0.2)
    # all 5 budget slots exist in the trace; only 3 carry density
    score, _ = mi.assess(tr.get_choices(), (8.0, flags))
    assert torch.allclose(score, tr.get_score(), atol=1e-4)


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(7)
    conditionals(gen)
    masking(gen)
    mixtures(gen)
    iteration(gen)
    print("expressivity cookbook: all sections OK")


if __name__ == "__main__":
    cli(main)

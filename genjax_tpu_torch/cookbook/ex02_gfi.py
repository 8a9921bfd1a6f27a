"""The Generative Function Interface, end to end.

Counterpart of ``examples/02_gfi.py``: simulate / assess / generate /
update with argdiffs / project / propose and the trace accessors, each step
asserted. ``main`` returns the deterministic numbers it checked (scores and
weights, with the choices they were taken at), which the tests hold to the
reference's on the same inputs.
"""

import math

import torch
from scipy import stats as st

import genjax_tpu_torch as g

from ._common import cli, device_of


@g.gen
def model(mu):
    x = g.normal(mu, 1.0) @ "x"
    y = g.normal(x, 0.5) @ "y"
    return y


def main(device="cuda"):
    device = device_of(device)
    gen = torch.Generator(device=device).manual_seed(0)

    # 1) simulate: sample a traced execution
    tr = model.simulate(gen, (0.0,))
    x, y = (float(tr.get_choices()[a]) for a in ("x", "y"))

    # 2) log probabilities
    # 2.1 score of the trace = log-joint of its choices
    expected = st.norm.logpdf(x, 0.0, 1.0) + st.norm.logpdf(y, x, 0.5)
    assert abs(float(tr.get_score()) - float(expected)) < 1e-5
    # 2.2 log-probability of a COMPLETE assignment via assess
    chm = g.C.d({"x": 1.0, "y": 1.2})
    score, retval = model.assess(chm, (0.0,))
    exact = st.norm.logpdf(1.0, 0.0, 1.0) + st.norm.logpdf(1.2, 1.0, 0.5)
    assert abs(float(score) - float(exact)) < 1e-5
    assert float(retval) == 1.2

    # 3) generate: sample conditioned on (partial) observations
    tr_c, w = model.importance(gen, g.C["y"].set(2.0), (0.0,))
    # the weight is the observation's density given the sampled latents
    x_c = float(tr_c.get_choices()["x"])
    assert abs(float(w) - float(st.norm.logpdf(2.0, x_c, 0.5))) < 1e-5
    assert float(tr_c.get_choices()["y"]) == 2.0

    # 4) update: incremental trace edits with argdiffs
    # 4.1 constraint-only update (arguments unchanged)
    new_tr, w_up, _retdiff, discard = tr.update(gen, g.C["x"].set(0.5))
    # the discard holds the replaced value; weight = score delta
    assert float(discard["x"]) == x
    assert abs(float(w_up) - (float(new_tr.get_score()) - float(tr.get_score()))) < 1e-5
    # untouched choices keep their values
    assert float(new_tr.get_choices()["y"]) == y
    # 4.2 changed arguments, stated with Diff: only "x" depends on mu
    new_tr2, w_arg, _rd, _bwd = model.edit(gen, tr, g.Update(g.C.empty()), (g.Diff.unknown_change(1.0),))
    delta = st.norm.logpdf(x, 1.0, 1.0) - st.norm.logpdf(x, 0.0, 1.0)
    assert abs(float(w_arg) - float(delta)) < 1e-5
    # the relation new_score = old_score + weight holds for updates
    assert abs(float(new_tr2.get_score()) - (float(tr.get_score()) + float(w_arg))) < 1e-5

    # regenerate: resample selected addresses from the prior (a fresh
    # stream; the reference takes a fresh key)
    re_tr, w_re, _rd, bwd = tr.edit(torch.Generator(device=device).manual_seed(99), g.Regenerate(g.S["x"]))
    assert float(re_tr.get_choices()["x"]) != x
    # SMCP3: applying the backward request cancels the forward weight
    back, w_b, _, _ = re_tr.edit(torch.Generator(device=device).manual_seed(100), bwd)
    assert abs(float(w_re) + float(w_b)) < 1e-4

    # project: density of a sub-selection
    px = float(tr.project(gen, g.S["x"]))
    assert abs(px - float(st.norm.logpdf(x, 0.0, 1.0))) < 1e-5
    assert abs(float(tr.project(gen, g.Selection.all())) - float(tr.get_score())) < 1e-5

    # 5) convenience methods
    # 5.1 propose: (choices, score, retval) without building a trace
    choices, score_p, retval_p = model.propose(gen, (0.0,))
    assert math.isfinite(float(score_p))
    # 5.2/5.3 trace accessors; the arguments come back as the tensors the
    # trace recorded ("traces record tensor leaves", ROADMAP.md,
    # Deviations of the trace path)
    assert tr.get_gen_fn() is model
    assert tuple(float(a) for a in tr.get_args()) == (0.0,)
    # 5.4 subtrace access by address
    sub = tr.get_subtrace("x")
    assert float(sub.get_retval()) == x

    print("GFI cookbook: all sections OK")
    return {"x": x, "y": y, "score": float(tr.get_score()), "assess": float(score), "x_c": x_c,
            "importance": float(w), "update": float(w_up), "argdiff": float(w_arg), "project": px}


if __name__ == "__main__":
    cli(main)

"""The time-travel debugger.

Counterpart of ``examples/07_debugging.py``: step through a computation at
tagged record points, rewind, and re-mix from the middle with new values.
Each continuation runs the instrumented program again, where the reference
resumes a snapshot of a staged jaxpr ("the time-travel debugger re-runs the
instrumented program for each continuation", ``ROADMAP.md``, Deviations of
slice 15).
"""

import torch

from genjax_tpu_torch.debug import rec, tag, time_machine

from ._common import cli, device_of


def pipeline(x):
    doubled = rec(lambda a: a * 2.0, "double")(x)
    shifted = rec(lambda a: a + 10.0, "shift")(doubled)
    return tag(shifted**2, "squared")


def main(device="cuda"):
    device = device_of(device)
    dbg = time_machine(pipeline)(torch.tensor(3.0, device=device))
    print("final:", float(dbg.final_retval))
    print("recorded frames:", [f.debug_tag for f in dbg.sequence])

    # jump to a point and inspect
    at = dbg.jump("shift")
    tag_, frame = at.frame()
    print(f"at {tag_}: args={[float(a) for a in frame.args]} local={float(frame.local_retval)}")

    # step around
    print("fwd ->", at.fwd().frame()[0], " bwd ->", at.bwd().frame()[0])

    # remix: rerun from `shift` with a different input
    alt = at.remix(torch.tensor(100.0, device=device))
    print("remixed final:", float(alt.final_retval), "(= (100+10)^2)")


if __name__ == "__main__":
    cli(main)

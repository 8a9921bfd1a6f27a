"""Time the trace path's transitions (``chip_smoke.py``'s ``[timing GFI]``
trace stage) in one or more checkouts, on the host clock.

A call is ``steps`` transitions of ``torch.func.vmap(mh(HMC(S["w"] |
S["tau"], 0.02, L=5)))`` over ``chains`` flagship traces, and then as many of
``mh(Regenerate(S["tau"]))``; each transition ends in a ``@gen`` edit.
Two checkouts of the port share a package name, so each timing runs in a
process of its own with its checkout first on ``sys.path``; the checkouts
take turns (A B B A ...), so that a drift of the host's load falls on both.

    python scripts/time_trace_stage.py [--device cuda] [--chains 65536]
        [--steps 20] [--reps 5] [--rounds 2] ROOT [ROOT ...]

Each line gives the checkout and the median and extremes of ``reps`` calls
in ms, each call ended by a device synchronise. With ``--device cuda`` the
first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def child(root: str, device: str, chains: int, steps: int, reps: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import genjax_tpu_torch as g
    from genjax_tpu_torch.models import hierarchical_regression

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    model = hierarchical_regression(X)
    obs = g.C["y"].set(torch.as_tensor(y, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    trs0 = torch.func.vmap(lambda _: model.generate(gen, obs, ())[0], randomness="different")(
        torch.zeros(chains, device=dev))
    out = []
    for name, request in (("mh(HMC)", g.HMC(g.S["w"] | g.S["tau"], 0.02, L=5)),
                          ("mh(Regenerate(tau))", g.Regenerate(g.S["tau"]))):
        step = torch.func.vmap(lambda tr: g.mh(gen, tr, request), randomness="different")

        def call():
            trs = trs0
            for _ in range(steps):
                trs, _acc = step(trs)

        call()
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        out.append(f"{name} median {times[len(times) // 2]:.3f} ms (min {times[0]:.3f}, max {times[-1]:.3f})")
    print(f"{root}: {steps} transitions of {chains} traces ({device}, {reps} calls): " + "; ".join(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.device, a.chains, a.steps, a.reps)
        return 0
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0], flush=True)
    for r in range(a.rounds):
        for root in (a.roots if r % 2 == 0 else a.roots[::-1]):
            subprocess.run(
                [sys.executable, __file__, "--child", "--device", a.device, "--chains", str(a.chains),
                 "--steps", str(a.steps), "--reps", str(a.reps), root],
                check=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

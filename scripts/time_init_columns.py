"""Time ``genjax_tpu_torch``'s ``init_columns`` (a vmapped ``generate`` of the
flagship, packed as columns) in one or more checkouts, on the host clock.

Two checkouts of the port share a package name, so each timing runs in a
process of its own with its checkout first on ``sys.path``. The checkouts
take turns (A B B A A B ...), so that a drift of the host's load falls on
both; compare the medians of one run only.

    python scripts/time_init_columns.py [--device cuda] [--chains 65536]
        [--reps 300] [--rounds 3] ROOT [ROOT ...]

Each line gives the checkout, the median and the quartiles of ``reps`` calls
in ms, each call ended by a device synchronise. With ``--device cuda`` the
first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def child(root: str, device: str, chains: int, reps: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import genjax_tpu_torch as g
    from genjax_tpu_torch.kernels.model_interface import ColumnPacker, init_columns
    from genjax_tpu_torch.models import hierarchical_regression

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    model = hierarchical_regression(X)
    obs = g.C["y"].set(y)
    packer = ColumnPacker(model, obs, (), ["tau", "w"])
    for _ in range(30):
        init_columns(model, obs, (), packer, chains, 0, dev)
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        init_columns(model, obs, (), packer, chains, 0, dev)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    q1, med, q3 = (times[len(times) * k // 4] for k in (1, 2, 3))
    print(f"{root}: init_columns({chains} chains, {device}) median {med:.4f} ms "
          f"(quartiles {q1:.4f}, {q3:.4f}; {reps} calls)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.device, a.chains, a.reps)
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
                 "--reps", str(a.reps), root],
                check=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time one cookbook (``genjax_tpu_torch/cookbook/exNN_*.py``) in one or more
checkouts of the port, on the host clock.

Two checkouts share a package name, so each run is a process of its own
with its checkout first on ``sys.path``. A first process in each checkout
builds its kernels (``kernels/_build.py``), so no timed run pays a build;
then the checkouts take turns (A B B A ...), a process each, and each run
times the cookbook's ``main(device)`` to its last device synchronise.

    python scripts/time_cookbook.py [--device cuda] [--rounds 2]
        --name ex22_gp_workflow ROOT [ROOT ...]

Each line gives the checkout and the seconds of one run. With ``--device
cuda`` the first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time


def child(root: str, name: str, device: str, build: bool) -> None:
    sys.path.insert(0, root)
    import torch

    if build:
        from genjax_tpu_torch.kernels import elliptical, hmc, nuts_pallas

        for lib in (hmc._lib, nuts_pallas._lib, elliptical._lib):
            lib()
        return
    t0 = time.perf_counter()
    importlib.import_module(f"genjax_tpu_torch.cookbook.{name}").main(device)
    if device == "cuda":
        torch.cuda.synchronize()
    print(f"{root}: {name} main({device!r}) {time.perf_counter() - t0:.2f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--name", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0], a.name, a.device, a.build)
        return 0
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0], flush=True)
    runs = [(root, True) for root in a.roots] if a.device == "cuda" else []
    for r in range(a.rounds):
        runs += [(root, False) for root in (a.roots if r % 2 == 0 else a.roots[::-1])]
    for root, build in runs:
        subprocess.run(
            [sys.executable, __file__, "--child", "--name", a.name, "--device", a.device, root]
            + (["--build"] if build else []),
            check=True, stdout=None if not build else subprocess.DEVNULL,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the cookbooks share: the ``--device`` flag, a batch of draws under
``torch.func.vmap``, and a world of one rank for the mesh narratives."""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Callable

import torch
import torch.distributed as dist

from ..core.device import entry_device


def device_of(device) -> torch.device:
    """The cookbook's device: the card by default, which raises without one
    (``core/device.py::entry_device``), or the CPU when asked for."""
    return entry_device(device, "cookbook")


def cli(main: Callable) -> None:
    """Run ``main(device=...)`` with the ``--device`` flag (default
    ``cuda``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(device=parser.parse_args().device)


def batch(fn: Callable, n: int, device) -> object:
    """``n`` independent runs of ``fn()`` (a draw from a generator it
    closes over) stacked on a leading axis: one vmapped program."""
    return torch.func.vmap(lambda _: fn(), randomness="different")(torch.zeros(n, device=device))


@contextlib.contextmanager
def world_of_one(device: torch.device):
    """A process group for a cookbook that builds a mesh: the caller's, if
    one is up (a launcher's world of many ranks), else a world of one rank
    made here (NCCL on the card, gloo on the CPU) and torn down after."""
    if dist.is_initialized():
        yield
        return
    from ..parallel import initialize_distributed

    tmp = tempfile.mkdtemp(prefix="genjax_world_")
    initialize_distributed(rank=0, world_size=1, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                           device_type=device.type)
    try:
        yield
    finally:
        dist.destroy_process_group()

"""The device an entry point runs on.

The port's entry points that launch CUDA kernels, or that stand beside them
on the card (the GP closed forms), run on the card unless the caller asks
for the CPU. Where the card is asked for and torch sees none, they raise
rather than run on the CPU.
"""

from __future__ import annotations

import torch


def entry_device(device, entry: str) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card raises a
    ``RuntimeError`` naming ``entry`` and ``device='cpu'``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} run on the card by default (device='cuda'), and torch sees no CUDA "
            "device here; pass device='cpu' to run on the CPU"
        )
    return device

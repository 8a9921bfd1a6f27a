"""The device an entry point runs on.

The port's entry points that launch CUDA kernels, or that stand beside them
on the card (the GP closed forms), run on the card unless the caller asks
for the CPU. Where the card is asked for and torch sees none, they raise
rather than run on the CPU. An entry point that receives its chains runs
where they live, and a generator on another device raises
(``chain_generator``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree


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


def is_key(x) -> bool:
    """Whether ``x`` is a key (``core/keys.py``): an int64 tensor with a last
    axis of 2 (threefry2x32) or 4 (rbg)."""
    return isinstance(x, torch.Tensor) and x.dtype == torch.int64 and x.dim() >= 1 and x.shape[-1] in (2, 4)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one; a device named without an index matches
    any card of its type."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def chain_generator(seed, device: torch.device, entry: str) -> torch.Generator:
    """The random stream of chains that live on ``device``: ``seed`` itself
    if it is a ``torch.Generator`` there, a new generator there seeded with
    the int ``seed`` otherwise. A generator on another device raises a
    ``ValueError`` naming ``entry``: the chains are not moved to it. A key
    (``is_key``) raises a ``TypeError`` naming ``entry``: an entry point that draws under a key
    takes it before it gets here."""
    if is_key(seed):
        raise TypeError(
            f"{entry}: drawing under a key is not reproduced here; pass a torch.Generator or an int seed"
        )
    if isinstance(seed, torch.Generator):
        if not same_device(seed.device, device):
            raise ValueError(
                f"{entry}: the generator lives on {seed.device} and the chains on {device}; "
                "make the generator on the chains' device (torch.Generator(device=...))"
            )
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def entry_generator(seed, device, entry: str) -> tuple[torch.Generator, torch.device]:
    """``entry_device`` and ``chain_generator`` together: the device an
    entry point that makes its chains or particles runs on, and its
    generator there."""
    device = entry_device(device, entry)
    return chain_generator(seed, device, entry), device


def to_device(tree: Any, device: torch.device) -> Any:
    """``tree`` with its tensor leaves on ``device``; other leaves as they
    are."""
    return pytree.tree_map(lambda v: v.to(device) if isinstance(v, torch.Tensor) else v, tree)


_MASK64 = 2**64 - 1


def stream_seed(base: int, s: int) -> int:
    """The seed of stream ``s`` of a run whose base seed is ``base``:
    splitmix64 of ``(base, s)``. A draw's stream in ``sample_posterior``
    (so that where a run is cut into segments changes nothing any draw
    consumes) and a rank's stream in the scale-out layer are both this.
    Every bit depends on both, the low 32 bits too, which are all that a
    CPU generator keeps of a seed."""
    x = (((base << 32) | s) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def int_seed(gen: torch.Generator) -> int:
    """An int seed in ``[0, 2**30)`` drawn from ``gen``: one host read."""
    return int(torch.randint(0, 2**30, (), generator=gen, device=gen.device))

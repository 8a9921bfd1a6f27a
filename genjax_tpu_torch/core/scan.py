"""The log-depth inclusive scan the temporally parallel passes share.

Torch has no ``lax.associative_scan``. The Kalman family's parallel filter
and smoother (``dists/lgssm.py``) and the discrete HMM's parallel forward
pass and Viterbi (``dists/hmm_tools.py``) compose their per-step elements
with this one scan, written in plain tensor ops so it runs where its
elements live.

>>> import torch
>>> associative_scan(lambda a, b: (a[0] + b[0],), (torch.arange(1.0, 6.0),))[0]
tensor([ 1.,  3.,  6., 10., 15.])
>>> reverse_scan(lambda a, b: (a[0] + b[0],), (torch.arange(1.0, 6.0),))[0]
tensor([15., 14., 12.,  9.,  5.])
"""

from __future__ import annotations

from typing import Callable

import torch


def associative_scan(fn: Callable, elems: tuple) -> tuple:
    """The inclusive scan of ``elems`` (a tuple of tensors sharing their
    leading axis) under the associative ``fn(earlier, later)``, which takes
    and returns element tuples batched along that axis: pairs combine, the
    scan recurses on the pairs, and the even positions are filled from the
    odd ones, so the depth is O(log T)."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = fn(tuple(o[:-1] for o in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[0] = e[0]
        full[2::2] = ev
        full[1::2] = od
        out.append(full)
    return tuple(out)


def reverse_scan(fn: Callable, elems: tuple) -> tuple:
    """``associative_scan`` along the reversed leading axis: position ``t``
    holds the fold of ``elems[t:]``, combined as ``fn`` combines the
    reversed sequence (pass ``lambda a, b: fn(b, a)`` for the ordered suffix
    product)."""
    flipped = associative_scan(fn, tuple(torch.flip(e, dims=(0,)) for e in elems))
    return tuple(torch.flip(e, dims=(0,)) for e in flipped)

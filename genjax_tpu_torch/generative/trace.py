"""The ``Trace`` abstract base: a record of one execution of a generative
function.

Counterpart of ``genjax_tpu/generative/trace.py``. ``get_score()`` is
``log P(choices; args)`` for exact-density generative functions. Every field
of a recorded trace is a tensor leaf (``tensor_leaves``), so a batch of
traces is a trace whose leaves carry a chain axis, and ``torch.func.vmap``
takes traces in and gives traces out. ``edit``, ``update`` and ``project``
run where the trace lives, with a ``torch.Generator`` on the same device.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.device import same_device as _same_device
from ..core.keys import is_key
from ..core.diff import Diff
from ..core.pytree import Pytree, none_free
from .concepts import Arguments, EditRequest, Retdiff, Score, Weight


@functools.lru_cache(maxsize=256)
def _scalar_tensor(kind: type, x, negative: bool, device) -> torch.Tensor:
    # filled on the device: no copy from the host to wait for. Traces never
    # write into their leaves, so one tensor serves every trace that records
    # this number
    dtype = {bool: torch.bool, int: torch.int64, float: torch.float32}[kind]
    return torch.full((), x, dtype=dtype, device=device)


def _tensor_leaf(x: Any, device) -> Any:
    if isinstance(x, (bool, int, float)):
        # the sign is part of the key: -0.0 equals 0.0 and hashes the same
        return _scalar_tensor(type(x), x, math.copysign(1.0, x) < 0, device)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(x, device=device)
    return x


def tensor_leaves(tree: Any, device=None) -> Any:
    """``tree`` with its Python numbers and numpy arrays made tensors on
    ``device`` (floats become float32), its tuples' ``None`` entries taken
    out of the leaves (``none_free``), and every other leaf as it is.
    ``torch.func.vmap`` takes and returns tensor leaves only, and the MH
    accept selects leaf by leaf between an old trace and a new one, so traces
    record tensors. ``device`` may be a function that finds it, called only
    when a leaf needs one."""

    def one(x):
        if isinstance(x, torch.Tensor):
            return x
        return _tensor_leaf(x, device() if callable(device) else device)

    # the usual trees (a tensor, a flat tuple of tensors and numbers) without
    # the cost of a general flatten
    if isinstance(tree, torch.Tensor):
        return tree
    if type(tree) is tuple and all(isinstance(x, (torch.Tensor, bool, int, float)) for x in tree):
        return tuple(one(x) for x in tree)
    return pytree.tree_map(one, none_free(tree))


def trace_device(tree: Any) -> torch.device | None:
    """The device of the first tensor leaf of ``tree``, or None."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def check_same_device(gen, tr: Any, what: str) -> None:
    """A key or a generator on another device than the trace raises: an
    entry point that receives traces runs where they live and moves
    nothing."""
    device = trace_device(tr)
    if device is not None and not _same_device(device, gen.device):
        if is_key(gen):
            raise ValueError(
                f"{what}: the trace lives on {device} and the key on {gen.device}; "
                "make the key on the trace's device (keys.key(seed, device=...))"
            )
        raise ValueError(
            f"{what}: the trace lives on {device} and the generator on {gen.device}; "
            "make the generator on the trace's device (torch.Generator(device=...))"
        )


class Trace(Pytree):
    @abc.abstractmethod
    def get_args(self) -> Arguments:
        ...

    @abc.abstractmethod
    def get_retval(self) -> Any:
        ...

    @abc.abstractmethod
    def get_score(self) -> Score:
        ...

    @abc.abstractmethod
    def get_choices(self) -> Any:
        """The addressed random choices as a ChoiceMap."""

    @abc.abstractmethod
    def get_gen_fn(self) -> Any:
        ...

    # ----- derived -----

    def get_sample(self) -> Any:
        return self.get_choices()

    def edit(
        self, gen: torch.Generator, request: EditRequest, argdiffs: Any = None
    ) -> tuple["Trace", Weight, Retdiff, EditRequest]:
        check_same_device(gen, self, "Trace.edit")
        if argdiffs is None:
            argdiffs = Diff.tree_diff_no_change(self.get_args())
        return request.edit(gen, self, argdiffs)

    def update(
        self, gen: torch.Generator, constraint: Any, argdiffs: Any = None
    ) -> tuple["Trace", Weight, Retdiff, Any]:
        """Constraint-driven edit; the last element is the backward request's
        constraint (the *discard*), as Gen's update returns it."""
        return self.get_gen_fn().update(gen, self, constraint, argdiffs)

    def project(self, gen: torch.Generator, selection: Any) -> Weight:
        return self.get_gen_fn().project(gen, self, selection)

    def get_subtrace(self, *addresses) -> "Trace":
        tr: Trace = self
        for addr in addresses:
            if isinstance(addr, tuple):
                # a tuple may itself BE the recorded address (a model tracing
                # at ``@ ("a", "b")`` stores it whole)
                recorded = getattr(tr, "addresses", None)
                if recorded is not None and addr in recorded:
                    tr = tr.get_inner_trace(addr)
                    continue
                for comp in addr:
                    tr = tr.get_inner_trace(comp)
            else:
                tr = tr.get_inner_trace(addr)
        return tr

    def with_gen_fn(self, gen_fn) -> "Trace":
        """A copy of this trace bound to ``gen_fn`` (same choices, score,
        retval). Edit paths use it when the callee itself carries changed
        dynamic leaves: the sub-edit must score under the NEW closure values,
        not the stale ones the previous trace recorded."""
        return dataclasses.replace(self, gen_fn=gen_fn)

    def get_inner_trace(self, address: Any) -> "Trace":
        raise NotImplementedError(
            f"{type(self).__name__} has no subtraces (not a compound trace)."
        )

    def __getitem__(self, addr):
        return self.get_choices()[addr]

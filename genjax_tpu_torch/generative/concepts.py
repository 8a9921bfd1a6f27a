"""GFI value concepts and the edit-request base classes.

Counterpart of ``genjax_tpu/generative/concepts.py``: the value aliases
(``Weight``, ``Score``, ``Arguments``), ``EditRequest`` and its primitive
requests ``Update``, ``Regenerate``, ``IndexRequest`` and ``VectorRequest``,
``EmptyRequest``, ``DiffAnnotate``, and ``dispatch_edit``.

Weights follow SMCP3 semantics: for an edit moving ``(x, args)`` to
``(x', args')`` the returned weight is
``log [ P(x'; args') q(x; bwd) / P(x; args) q(x'; fwd) ]``, so importance
weights of particle collections stay properly calibrated under edits. The
source of randomness is a ``torch.Generator`` where the reference takes a
key.
"""

from __future__ import annotations

import abc
import dataclasses
import types
from typing import Any, Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.diff import Argdiffs, Diff, Retdiff
from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from .choice_map import ChoiceMap

Weight = torch.Tensor
Score = torch.Tensor
Arguments = tuple
Retval = Any

__all__ = [
    "Argdiffs",
    "Arguments",
    "DiffAnnotate",
    "EditRequest",
    "EmptyRequest",
    "IndexRequest",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "Retdiff",
    "Retval",
    "Score",
    "Update",
    "VectorRequest",
    "Weight",
]


class NotSupportedEditRequest(GenJAXError):
    """Raised when a generative function cannot serve an edit request."""


def _identity(d):
    return d


class EditRequest(Pytree):
    """A request to transform a trace into a new trace, with SMCP3 weight
    accounting. ``edit`` returns ``(new_trace, weight, retdiff, bwd_request)``
    where applying ``bwd_request`` to ``new_trace`` recovers the original."""

    @abc.abstractmethod
    def edit(
        self, gen: torch.Generator, tr: "Trace", argdiffs: Argdiffs
    ) -> tuple["Trace", Weight, Retdiff, "EditRequest"]:
        ...

    def dimap(
        self, argdiff_fn: Callable = _identity, retdiff_fn: Callable = _identity
    ) -> "DiffAnnotate":
        return DiffAnnotate(self, argdiff_fn, retdiff_fn)

    def map(self, retdiff_fn: Callable) -> "DiffAnnotate":
        return DiffAnnotate(self, _identity, retdiff_fn)

    def contramap(self, argdiff_fn: Callable) -> "DiffAnnotate":
        return DiffAnnotate(self, argdiff_fn, _identity)


class PrimitiveEditRequest(EditRequest):
    """An edit request whose semantics the generative function implements:
    defers to ``gen_fn.edit``."""

    def edit(self, gen, tr, argdiffs):
        return tr.get_gen_fn().edit(gen, tr, self, argdiffs)


def _leaf_same(a, b) -> bool:
    """Can these two pytree leaves be proven identical without reading a
    tensor? (Tensors are not value-compared: that would cost a device
    read-back per edit.)"""
    if a is b:
        return True
    scalars = (int, float, bool, str)
    if isinstance(a, scalars) and isinstance(b, scalars):
        return a == b
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return False


def source_changed_flags(new_source, old_source) -> list:
    """Per-leaf changed flags between a callee's current closure and the one
    recorded in the previous trace (conservative: what cannot be proven the
    same counts as changed)."""
    new_leaves = pytree.tree_leaves(new_source)
    old_leaves = pytree.tree_leaves(old_source)
    if len(new_leaves) != len(old_leaves):
        return [True] * len(new_leaves)
    return [not _leaf_same(a, b) for a, b in zip(new_leaves, old_leaves)]


def merge_gen_fn(old_gf, new_gf):
    """The CURRENT callee's dynamic leaves in the PREVIOUS trace's static
    structure. A body that defines a local ``@gen`` function makes a fresh
    function object (a static field of the tree's structure) on every
    execution; recorded verbatim, it would make the edited trace's structure
    differ from the original's and break old-against-new ``tree_map`` (the MH
    accept). Falls back to ``old_gf`` when the structures are incompatible."""
    new_leaves, new_spec = pytree.tree_flatten(new_gf)
    old_spec = pytree.tree_structure(old_gf)
    if new_spec == old_spec:
        return new_gf
    if old_spec.num_leaves == len(new_leaves):
        try:
            return pytree.tree_unflatten(new_leaves, old_spec)
        except Exception:
            return old_gf
    return old_gf


def python_closure_mismatch(old, new, depth: int = 0) -> bool:
    """Do ``old`` and ``new`` differ in values reachable only through PYTHON
    closures (``fn.__closure__`` cells), which the pytree system does not
    see? Distinct function objects with captures cannot be proven equal, so
    the walk reports a mismatch for them."""
    if depth > 8 or old is new:
        return False
    if isinstance(old, types.FunctionType) and isinstance(new, types.FunctionType):
        oc = old.__closure__ or ()
        nc = new.__closure__ or ()
        return len(oc) != len(nc) or len(nc) > 0
    if type(old) is not type(new):
        return True
    if dataclasses.is_dataclass(new) and not isinstance(new, type):
        return any(
            python_closure_mismatch(getattr(old, f.name, None), getattr(new, f.name, None), depth + 1)
            for f in dataclasses.fields(new)
        )
    if isinstance(new, (tuple, list)):
        if len(old) != len(new):
            return True
        return any(python_closure_mismatch(a, b, depth + 1) for a, b in zip(old, new))
    return False


def dispatch_edit(gen_fn, gen, tr, request: "EditRequest", argdiffs):
    """Run ``request`` on ``tr``, scoring under the CURRENT ``gen_fn``.

    The static language routes sub-edits through this, so a callee whose
    dynamic closure leaves changed scores under the new values: the trace's
    recorded gen_fn is stale then. The callee is merged structurally with the
    trace's (``merge_gen_fn``); where it reaches values through Python
    closures, the new callee scores the edit verbatim and the result is
    rebound to the old structure, to keep trace structures stable."""
    old_gf = tr.get_gen_fn()
    merged = merge_gen_fn(old_gf, gen_fn)
    capture_mismatch = python_closure_mismatch(old_gf, gen_fn)
    scored_gf = gen_fn if capture_mismatch else merged
    if isinstance(request, EmptyRequest):
        # EmptyRequest's no-op shortcut holds only while the callee's closure
        # is unchanged too; else fall through to an empty Update
        if (
            Diff.static_check_no_change(argdiffs)
            and not capture_mismatch
            and not any(source_changed_flags(scored_gf, old_gf))
        ):
            return tr, _zero_like_score(tr), Diff.tree_diff_no_change(tr.get_retval()), EmptyRequest()
        request = Update(ChoiceMap.empty())
    if isinstance(request, PrimitiveEditRequest):
        out = scored_gf.edit(gen, tr, request, argdiffs)
    else:
        out = request.edit(gen, tr.with_gen_fn(scored_gf), argdiffs)
    if capture_mismatch:
        new_tr, w, rd, bwd = out
        out = (new_tr.with_gen_fn(merged), w, rd, bwd)
    return out


def _zero_like_score(tr) -> torch.Tensor:
    return torch.zeros_like(tr.get_score())


@Pytree.dataclass
class Update(PrimitiveEditRequest):
    """Constraint-driven edit: overwrite addressed choices with the values in
    ``constraint``."""

    constraint: Any  # ChoiceMap


@Pytree.dataclass
class Regenerate(PrimitiveEditRequest):
    """Resample the selected addresses from their priors."""

    selection: Any  # Selection


@Pytree.dataclass(init=False)
class IndexRequest(PrimitiveEditRequest):
    """Apply a sub-request at one index of a ``Scan`` or ``Vmap`` trace: the
    edit re-runs the kernel O(1) times, whatever the length. The index is a
    Python int or an int tensor (which may differ by lane under
    ``torch.func.vmap``); a Python int rides in the tree's context."""

    request: EditRequest
    dyn_index: Any  # None | int tensor
    static_index: Any = Pytree.static(default=None)  # None | int

    def __init__(self, index, request: EditRequest):
        concrete = isinstance(index, int) and not isinstance(index, bool)
        object.__setattr__(self, "request", request)
        object.__setattr__(self, "dyn_index", None if concrete else index)
        object.__setattr__(self, "static_index", index if concrete else None)

    @property
    def index(self):
        return self.static_index if self.static_index is not None else self.dyn_index


@Pytree.dataclass
class VectorRequest(PrimitiveEditRequest):
    """Per-lane (vmap) or per-step (scan) edit requests: one request pytree
    whose tensor leaves carry the lane or step axis in front, slice ``t``
    being the request for lane or step ``t``. A scan whose steps' backward
    requests differ in structure returns them as a tuple, one a step."""

    request: Any  # EditRequest | tuple[EditRequest, ...]

    def at(self, t: int) -> EditRequest:
        if isinstance(self.request, tuple):
            return self.request[t]
        return pytree.tree_map(lambda v: v[t], self.request)


@Pytree.dataclass
class EmptyRequest(EditRequest):
    """No-op unless argdiffs changed, in which case it falls back to an empty
    Update."""

    def edit(self, gen, tr, argdiffs):
        if Diff.static_check_no_change(argdiffs):
            return tr, _zero_like_score(tr), Diff.tree_diff_no_change(tr.get_retval()), EmptyRequest()
        return Update(ChoiceMap.empty()).edit(gen, tr, argdiffs)


@Pytree.dataclass
class DiffAnnotate(EditRequest):
    """Unsafe coercion of argdiff and retdiff annotations around an inner
    request. The caller asserts the coercions are sound."""

    request: EditRequest
    argdiff_fn: Callable = Pytree.static(default=_identity)
    retdiff_fn: Callable = Pytree.static(default=_identity)

    def edit(self, gen, tr, argdiffs):
        new_tr, w, retdiff, bwd = self.request.edit(gen, tr, self.argdiff_fn(argdiffs))
        return new_tr, w, self.retdiff_fn(retdiff), bwd

"""``Dimap`` combinator: map the arguments in and the return value out.

Counterpart of ``genjax_tpu/combinators/dimap.py``: ``DimapTrace``,
``DimapCombinator`` and the decorators ``dimap``, ``map`` and
``contramap``. The choices are the inner function's.

An edit carries change tangents through ``pre`` and ``post`` leaf by leaf
with ``changed_through`` (``core/changes.py``), which runs each under a
``ChangeMode`` where the reference reads its jaxpr: an inner argument stays
``NoChange`` unless it depends on a changed outer leaf. Where the change
cannot be followed (``changed_through`` gives None: a changed leaf that is
no tensor, a value read to Python), the edit takes the conservative rule: an
edit whose inputs are all unchanged marks the inner arguments (and, where
the inner edit reports no change, the return value) ``NoChange``, and any
changed input marks every one of them ``UnknownChange``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.changes import changed_through
from ..core.diff import Diff
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import EditRequest, Retdiff, Weight
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device


def _identity_args(*args):
    return args


def _identity_post(_args, retval):
    return retval


@Pytree.dataclass
class DimapTrace(Trace):
    gen_fn: "DimapCombinator"
    inner: Trace
    args: tuple
    retval: Any

    def __post_init__(self):
        device = lambda: trace_device(self.inner)  # noqa: E731
        object.__setattr__(self, "args", tensor_leaves(self.args, device))
        object.__setattr__(self, "retval", tensor_leaves(self.retval, device))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_score(self):
        return self.inner.get_score()

    def get_gen_fn(self) -> "DimapCombinator":
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices()

    def get_inner_trace(self, address) -> Trace:
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class DimapCombinator(GenerativeFunction):
    gen_fn: GenerativeFunction
    pre: Callable = Pytree.static(default=_identity_args)
    post: Callable = Pytree.static(default=_identity_post)
    info: str | None = Pytree.static(default=None)

    def _pre(self, args: tuple) -> tuple:
        inner_args = self.pre(*args)
        if not isinstance(inner_args, tuple):
            raise TypeError(f"dimap pre ({self.info}) must return an argument tuple.")
        return inner_args

    def simulate(self, gen: torch.Generator, args: tuple) -> DimapTrace:
        inner = self.gen_fn.simulate(gen, self._pre(args))
        return DimapTrace(self, inner, args, self.post(args, inner.get_retval()))

    def assess(self, chm: ChoiceMap, args: tuple):
        score, retval = self.gen_fn.assess(chm, self._pre(args))
        return score, self.post(args, retval)

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        inner, w = self.gen_fn.generate(gen, constraint, self._pre(args))
        return DimapTrace(self, inner, args, self.post(args, inner.get_retval())), w

    def project(self, gen: torch.Generator, trace: DimapTrace, selection: Selection) -> Weight:
        return self.gen_fn.project(gen, trace.inner, selection)

    def edit(
        self, gen: torch.Generator, trace: DimapTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[DimapTrace, Weight, Retdiff, EditRequest]:
        primals = Diff.tree_primal(argdiffs)
        no_change = Diff.static_check_no_change(argdiffs)
        if no_change:
            inner_argdiffs = Diff.tree_diff_no_change(self._pre(primals))
        else:
            inner_argdiffs = changed_through(lambda *a: self._pre(a), argdiffs)
            if inner_argdiffs is None:
                inner_argdiffs = Diff.tree_diff_unknown_change(self._pre(primals))
        new_inner, w, inner_retdiff, bwd = self.gen_fn.edit(gen, trace.inner, request, inner_argdiffs)
        retdiff = changed_through(lambda a, r: self.post(a, r), (argdiffs, inner_retdiff))
        if retdiff is None:
            new_retval = self.post(primals, Diff.tree_primal(inner_retdiff))
            retdiff = (
                Diff.tree_diff_no_change(new_retval)
                if no_change and Diff.static_check_no_change(inner_retdiff)
                else Diff.tree_diff_unknown_change(new_retval)
            )
        new_retval = Diff.tree_primal(retdiff)
        return DimapTrace(self, new_inner, primals, new_retval), w, retdiff, bwd


def dimap(*, pre: Callable = _identity_args, post: Callable = _identity_post, info: str | None = None):
    """Decorator form: map the arguments in with ``pre`` and the return value
    out with ``post``; the choices are unchanged.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.dimap(pre=lambda a: (a * 2.0,), post=lambda args, r: r + 100.0)
    ... @g.gen
    ... def shifted(mu):
    ...     return g.normal(mu, 0.01) @ "x"
    >>> tr = shifted.simulate(torch.Generator().manual_seed(0), (1.0,))
    >>> bool(abs(tr.get_retval() - 102.0) < 1.0)  # pre doubles, post +100
    True
    """

    def decorator(gen_fn: GenerativeFunction) -> DimapCombinator:
        return DimapCombinator(gen_fn, pre, post, info)

    return decorator


def map(f: Callable, *, info: str | None = None):
    """Post-transform the return value."""

    def decorator(gen_fn: GenerativeFunction) -> DimapCombinator:
        return DimapCombinator(gen_fn, post=lambda _args, retval: f(retval), info=info)

    return decorator


def contramap(f: Callable, *, info: str | None = None):
    """Pre-transform the arguments."""

    def decorator(gen_fn: GenerativeFunction) -> DimapCombinator:
        return DimapCombinator(gen_fn, pre=f, info=info)

    return decorator

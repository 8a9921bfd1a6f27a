"""``Mask`` combinator: a generative function whose existence is gated by a
boolean.

Counterpart of ``genjax_tpu/combinators/mask_comb.py``: ``MaskTrace``,
``MaskCombinator`` and ``mask``. The masked function takes one extra
leading boolean argument. Where it is false the inner function still runs
(fixed shapes) but contributes no score, and its retval and choices are
``Mask``-wrapped invalid. A score is gated by selection, so an inner
``-inf`` under a false flag gives 0, not NaN.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.diff import Diff
from ..core.pytree import Pytree
from ..core.staging import FlagOp
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import EditRequest, NotSupportedEditRequest, Retdiff, Update, Weight
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device


def _gate(check, w: torch.Tensor) -> torch.Tensor:
    """``w`` where ``check`` holds, else 0."""
    return FlagOp.where(check, w, torch.zeros_like(w))


@Pytree.dataclass(init=False)
class MaskTrace(Trace):
    """The inner trace and the flag; a Python bool flag rides in the tree's
    context, so the trace's choices read concretely."""

    gen_fn: "MaskCombinator"
    inner: Trace
    dyn_check: Any
    static_check: Any = Pytree.static(default=None)  # None | bool

    def __init__(self, gen_fn: "MaskCombinator", inner: Trace, check):
        object.__setattr__(self, "gen_fn", gen_fn)
        object.__setattr__(self, "inner", inner)
        concrete = isinstance(check, bool)
        dyn = None if concrete else tensor_leaves(check, lambda: trace_device(inner))
        object.__setattr__(self, "dyn_check", dyn)
        object.__setattr__(self, "static_check", check if concrete else None)

    @property
    def check(self):
        return self.static_check if self.static_check is not None else self.dyn_check

    def get_args(self) -> tuple:
        return (self.check, *self.inner.get_args())

    def get_retval(self) -> Mask:
        return Mask(self.inner.get_retval(), self.check)

    def get_score(self):
        return _gate(self.check, self.inner.get_score())

    def get_gen_fn(self) -> "MaskCombinator":
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return self.inner.get_choices().mask(self.check)

    def get_inner_trace(self, address) -> Trace:
        return self.inner.get_inner_trace(address)


@Pytree.dataclass
class MaskCombinator(GenerativeFunction):
    gen_fn: GenerativeFunction

    def simulate(self, gen: torch.Generator, args: tuple) -> MaskTrace:
        return MaskTrace(self, self.gen_fn.simulate(gen, tuple(args[1:])), args[0])

    def assess(self, chm: ChoiceMap, args: tuple):
        check = args[0]
        score, retval = self.gen_fn.assess(chm, tuple(args[1:]))
        return _gate(check, score), Mask(retval, check)

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        check = args[0]
        inner, w = self.gen_fn.generate(gen, constraint, tuple(args[1:]))
        return MaskTrace(self, inner, check), _gate(check, w)

    def project(self, gen: torch.Generator, trace: MaskTrace, selection: Selection) -> Weight:
        return _gate(trace.check, self.gen_fn.project(gen, trace.inner, selection))

    def edit(
        self, gen: torch.Generator, trace: MaskTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[MaskTrace, Weight, Retdiff, EditRequest]:
        if not isinstance(request, Update):
            raise NotSupportedEditRequest(f"MaskCombinator cannot serve {type(request).__name__}.")
        check_diff, inner_argdiffs = argdiffs[0], tuple(argdiffs[1:])
        post = Diff.tree_primal(check_diff)
        pre = trace.check
        original = trace.inner
        new_inner, weight, retdiff, bwd = self.gen_fn.edit(gen, original, request, inner_argdiffs)
        # the four flag transitions: False->True, the new score enters;
        # True->False, the old score leaves; False->False, 0; True->True, the
        # inner move's weight
        new_score = new_inner.get_score()
        final = FlagOp.where(
            post,
            FlagOp.where(pre, weight, new_score),
            FlagOp.where(pre, -original.get_score(), torch.zeros_like(weight)),
        )
        # deviation 10 (ARCHITECTURE.md): the backward constraint is not
        # masked by the new flag; the inner edit always runs, so its restore
        # values must apply on the way back
        bwd_chm = bwd.constraint if isinstance(bwd, Update) else ChoiceMap.empty()
        return MaskTrace(self, new_inner, post), final, Mask(retdiff, check_diff), Update(bwd_chm)


def mask(gen_fn: GenerativeFunction) -> MaskCombinator:
    """Decorator form: ``mask(gen_fn)`` takes ``(flag, *args)``."""
    return MaskCombinator(gen_fn)

"""``Switch`` combinator: a branch chosen at run time among generative
functions with different address spaces.

Counterpart of ``genjax_tpu/combinators/switch.py``: ``SwitchTrace``,
``SwitchCombinator`` over ``core.staging.multi_switch`` and ``tree_choose``,
and ``switch``. Arguments are ``(idx, args_0, ..., args_{n-1})``.

A Python int ``idx`` runs only its branch: the trace holds that branch's
subtrace alone and records the index in its context, so its choices read
concretely. A tensor ``idx`` (which may differ by lane under
``torch.func.vmap``) runs every branch and selects per lane, so every
branch draws from the generator, and the stream differs from the
reference's, which runs one. The trace then holds every branch's subtrace.

Kept from ``ARCHITECTURE.md``: deviation 6 (an index change weighs
``generate`` of the new branch under the constraint against the old score,
and its backward request is the old trace's choices) and deviation 11
(``Regenerate`` through a switch). Where the index's change tangent says
changed, a lane whose index is in fact the old one is edited as unchanged:
the handler-only edit marks an index changed whenever an input to it did.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.checkify import suppress_constraint_validation
from ..core.diff import Diff, NoChange
from ..core.pytree import Pytree
from ..core.staging import FlagOp, is_concrete_index, multi_switch, tree_choose
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import (
    EditRequest,
    NotSupportedEditRequest,
    Regenerate,
    Retdiff,
    Update,
    Weight,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device


@Pytree.dataclass
class SwitchTrace(Trace):
    """One subtrace a branch under a tensor index; under a Python int index
    (``branch``, in the context) that branch's subtrace alone."""

    gen_fn: "SwitchCombinator"
    args: tuple
    subtraces: tuple
    retval: Any
    score: Any
    branch: Any = Pytree.static(default=None)  # None | int

    def __post_init__(self):
        device = lambda: trace_device(self.subtraces)  # noqa: E731
        object.__setattr__(self, "args", tensor_leaves(self.args, device))
        object.__setattr__(self, "retval", tensor_leaves(self.retval, device))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_score(self):
        return self.score

    def get_gen_fn(self) -> "SwitchCombinator":
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        if self.branch is not None:
            return self.subtraces[0].get_choices()
        return ChoiceMap.switch(self.args[0], [tr.get_choices() for tr in self.subtraces])

    def subtrace(self, i: int) -> Trace | None:
        """Branch ``i``'s subtrace, or None where the trace has none."""
        if self.branch is None:
            return self.subtraces[i]
        return self.subtraces[0] if i == self.branch else None

    def get_inner_trace(self, address) -> Trace:
        if self.branch is not None:
            return self.subtraces[0].get_inner_trace(address)
        raise NotImplementedError(
            "get_inner_trace on a Switch with a tensor index; read the subtraces field."
        )


def _index(idx):
    """A concrete index stays a Python int; anything else is a tensor."""
    return idx if is_concrete_index(idx) else torch.as_tensor(idx)


@Pytree.dataclass
class SwitchCombinator(GenerativeFunction):
    branches: tuple

    def _split(self, args: tuple):
        idx, branch_args = args[0], tuple(args[1:])
        if len(branch_args) != len(self.branches):
            raise ValueError(
                f"switch: got {len(branch_args)} branch argument tuples for "
                f"{len(self.branches)} branches."
            )
        return _index(idx), branch_args

    def _trace(self, args, idx, subtraces: list, retval, score) -> SwitchTrace:
        if is_concrete_index(idx):
            return SwitchTrace(self, args, (subtraces[idx],), retval, score, idx)
        return SwitchTrace(self, args, tuple(subtraces), retval, score)

    # ----- GFI -----

    def simulate(self, gen: torch.Generator, args: tuple) -> SwitchTrace:
        idx, branch_args = self._split(args)
        subtraces = multi_switch(idx, [f.simulate for f in self.branches], [(gen, a) for a in branch_args])
        retval, score = tree_choose(
            idx, [None if tr is None else (tr.get_retval(), tr.get_score()) for tr in subtraces]
        )
        return self._trace(args, idx, subtraces, retval, score)

    def assess(self, chm: ChoiceMap, args: tuple):
        idx, branch_args = self._split(args)
        # every branch sees the whole constraint: a sibling branch's
        # addresses are no typos for constraint validation
        with suppress_constraint_validation():
            outs = multi_switch(idx, [f.assess for f in self.branches], [(chm, a) for a in branch_args])
        return tree_choose(idx, outs)

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        idx, branch_args = self._split(args)
        with suppress_constraint_validation():
            rets = multi_switch(
                idx, [f.generate for f in self.branches], [(gen, constraint, a) for a in branch_args]
            )
        retval, score, weight = tree_choose(
            idx, [None if r is None else (r[0].get_retval(), r[0].get_score(), r[1]) for r in rets]
        )
        return self._trace(args, idx, [None if r is None else r[0] for r in rets], retval, score), weight

    def project(self, gen: torch.Generator, trace: SwitchTrace, selection: Selection) -> Weight:
        idx = trace.branch if trace.branch is not None else trace.args[0]
        ws = multi_switch(
            idx, [f.project for f in self.branches],
            [(gen, trace.subtrace(i), selection) for i in range(len(self.branches))],
        )
        return tree_choose(idx, ws)

    # ----- edits -----

    def edit(
        self, gen: torch.Generator, trace: SwitchTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[SwitchTrace, Weight, Retdiff, EditRequest]:
        if not isinstance(request, (Update, Regenerate)):
            raise NotSupportedEditRequest(f"SwitchCombinator cannot serve {type(request).__name__}.")
        idx_diff, branch_argdiffs = argdiffs[0], tuple(argdiffs[1:])
        primals = Diff.tree_primal(argdiffs)
        old_idx = trace.branch if trace.branch is not None else trace.args[0]
        if Diff.tree_tangent(idx_diff) is NoChange:
            new_idx = old_idx
            same: Any = True
        else:
            new_idx = _index(primals[0])
            if is_concrete_index(new_idx) and is_concrete_index(old_idx):
                same = new_idx == old_idx
            else:
                same = torch.as_tensor(new_idx) == torch.as_tensor(old_idx, device=torch.as_tensor(new_idx).device)
        n = len(self.branches)

        def kept(i):
            # the branch's own edit, where the lane keeps its index
            def fn(ad):
                return self.branches[i].edit(gen, trace.subtrace(i), request, ad)
            return fn

        def fresh(i):
            # the branch made anew: generate under the constraint (Update) or
            # from the prior (Regenerate); its weight against the old score
            def fn(ad):
                constraint = request.constraint if isinstance(request, Update) else ChoiceMap.empty()
                tr, w = self.branches[i].generate(gen, constraint, Diff.tree_primal(ad))
                return tr, w - trace.get_score(), None, None
            return fn

        def branch(i):
            has_old = trace.subtrace(i) is not None
            if same is True:
                return kept(i)
            if same is False or not has_old:
                return fresh(i)

            def both(ad):
                k_tr, k_w, _rd, _bwd = kept(i)(ad)
                f_tr, f_w, _, _ = fresh(i)(ad)
                return FlagOp.where(same, k_tr, f_tr), FlagOp.where(same, k_w, f_w), None, None
            return both

        with suppress_constraint_validation():
            rets = multi_switch(new_idx, [branch(i) for i in range(n)], [(ad,) for ad in branch_argdiffs])
        score, weight, retval = tree_choose(
            new_idx,
            [None if r is None else (r[0].get_score(), r[1], r[0].get_retval()) for r in rets],
        )
        if same is True and isinstance(request, Update):
            bwd_chms = [
                ChoiceMap.empty() if r is None or not isinstance(r[3], Update) else r[3].constraint
                for r in rets
            ]
            bwd = Update(bwd_chms[new_idx] if is_concrete_index(new_idx)
                         else ChoiceMap.switch(new_idx, bwd_chms))
        else:
            # restores every old value: the index-change backward move
            # (deviation 6), and Regenerate's (deviation 11)
            bwd = Update(trace.get_choices())
        new_tr = self._trace(primals, new_idx, [None if r is None else r[0] for r in rets], retval, score)
        return new_tr, weight, Diff.tree_diff_unknown_change(retval), bwd


def switch(*branches: GenerativeFunction) -> SwitchCombinator:
    """Build a ``SwitchCombinator``; its arguments are ``(index,
    branch0_args, branch1_args, ...)``:

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> near = g.gen(lambda: g.normal(0.0, 0.1) @ "v")
    >>> far = g.gen(lambda: g.normal(100.0, 0.1) @ "v")
    >>> sw = g.switch(near, far)
    >>> tr = sw.simulate(torch.Generator().manual_seed(0), (1, (), ()))
    >>> bool(tr.get_retval() > 50.0)   # index 1 picked `far`
    True
    """
    return SwitchCombinator(tuple(branches))

"""``Scan`` combinator: a kernel ``(carry, x) -> (carry, y)`` over a sequence.

Counterpart of ``genjax_tpu/combinators/scan.py``: ``ScanTrace``,
``ScanCombinator`` (``simulate``, ``generate``, ``assess``, ``project``; the
sparse ``Update``, the dense walk ``_edit_dense`` serving ``Update``,
``Regenerate`` and ``VectorRequest``, and the one-step ``_edit_index``) and
the decorators ``scan``, ``accumulate``, ``reduce``, ``iterate``,
``iterate_final``, ``masked_iterate``, ``masked_iterate_final`` and
``prepend_initial_acc``.

The steps run as a Python loop (torch has no ``lax.scan``), each reading its
constraint at the Python int ``t``, so a dense or concretely indexed
constraint gives concrete values; the per-step traces are stacked leaf by
leaf with the time axis in front (``torch.stack``). Under a key, step ``t``
draws from ``fold_in(key, t)``, as the reference's steps do; one
``torch.Generator``, drawn from in sequence, serves every step. The dense walk's backward request is the steps' stacked
requests where they agree in structure; where they differ, an ``Update``'s
is the union of its steps' constraints at their indices, and any other
request a ``VectorRequest`` of one request a step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.diff import Diff
from ..core.pytree import Pytree, none_free
from ..core.staging import FlagOp
from ..generative.choice_map import ChoiceMap, IndexedChm
from ..generative.concepts import (
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    Regenerate,
    Retdiff,
    Update,
    VectorRequest,
    Weight,
    dispatch_edit,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device
from .vmap import put, stacked_score


def _step(gen, t):
    """The randomness of step ``t``: ``fold_in(key, t)`` under a key, as the
    reference's steps draw, the caller's generator itself otherwise."""
    return keys.fold_in(gen, t) if keys.is_key(gen) else gen


def _at(tree, t):
    """Step ``t`` of a tree whose leaves carry the time axis in front."""
    return None if tree is None else pytree.tree_map(lambda v: v[t], none_free(tree))


def _stack(items: list):
    """The steps' trees stacked leaf by leaf, time axis in front."""
    if all(x is None for x in items):
        return None
    items = [none_free(x) for x in items]
    return pytree.tree_map(lambda *vs: torch.stack([torch.as_tensor(v) for v in vs]), *items)


def _uniform(items: list) -> bool:
    spec = pytree.tree_structure(none_free(items[0]))
    return all(pytree.tree_structure(none_free(x)) == spec for x in items[1:])


@Pytree.dataclass
class ScanTrace(Trace):
    """Trace of a scanned kernel: one inner trace with the time axis in front
    of every leaf, and the retval ``(final_carry, stacked_ys)``."""

    gen_fn: "ScanCombinator"
    inner: Trace
    args: tuple
    retval: Any
    length: int = Pytree.static()

    def __post_init__(self):
        device = lambda: trace_device(self.inner)  # noqa: E731
        object.__setattr__(self, "args", tensor_leaves(self.args, device))
        object.__setattr__(self, "retval", tensor_leaves(self.retval, device))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_gen_fn(self) -> "ScanCombinator":
        return self.gen_fn

    def get_score(self):
        return stacked_score(self.inner)

    def get_choices(self) -> ChoiceMap:
        return IndexedChm.build(self.inner.get_choices(), None)

    def get_inner_trace(self, address) -> Trace:
        return _at(self.inner, address)


@Pytree.dataclass
class ScanCombinator(GenerativeFunction):
    """Lift a kernel ``(c, x) -> (c, y)`` to ``(c, [x]) -> (c, [y])``."""

    gen_fn: GenerativeFunction
    length: int | None = Pytree.static(default=None)

    def _static_length(self, xs) -> int:
        if xs is not None:
            for leaf in pytree.tree_leaves(none_free(xs)):
                return int(torch.as_tensor(leaf).shape[0])
        if self.length is None:
            raise ValueError(
                "scan: no `n` given and the scanned input is None — the sequence length "
                "cannot be inferred."
            )
        return self.length

    def _run(self, step: Callable, args: tuple):
        """``step(t, carry, x) -> (trace, extra)`` over the sequence: the
        stacked traces, the final carry, the stacked ys and the extras."""
        init, xs = args
        n = self._static_length(xs)
        c, trs, ys, extras = init, [], [], []
        for t in range(n):
            tr, extra = step(t, c, _at(xs, t))
            c, y = tr.get_retval()
            trs.append(tr)
            ys.append(y)
            extras.append(extra)
        return n, _stack(trs), c, _stack(ys), extras

    # ----- GFI -----

    def simulate(self, gen: torch.Generator, args: tuple) -> ScanTrace:
        n, inner, c, ys, _ = self._run(lambda t, c, x: (self.gen_fn.simulate(_step(gen, t), (c, x)), None), args)
        return ScanTrace(self, inner, args, (c, ys), n)

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        n, inner, c, ys, ws = self._run(
            lambda t, c, x: self.gen_fn.generate(_step(gen, t), constraint.get_submap(t), (c, x)), args
        )
        return ScanTrace(self, inner, args, (c, ys), n), torch.stack(ws).sum(0)

    def assess(self, chm: ChoiceMap, args: tuple):
        init, xs = args
        c, scores, ys = init, [], []
        for t in range(self._static_length(xs)):
            score, (c, y) = self.gen_fn.assess(chm.get_submap(t), (c, _at(xs, t)))
            scores.append(score)
            ys.append(y)
        return torch.stack(scores).sum(0), (c, _stack(ys))

    def project(self, gen: torch.Generator, trace: ScanTrace, selection: Selection) -> Weight:
        ws = [
            self.gen_fn.project(_step(gen, t), _at(trace.inner, t), selection.get_subselection(t))
            for t in range(trace.length)
        ]
        return torch.stack(ws).sum(0)

    # ----- edits -----

    def edit(
        self, gen: torch.Generator, trace: ScanTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[ScanTrace, Weight, Retdiff, EditRequest]:
        if isinstance(request, Update):
            fast = self._try_edit_update_sparse(gen, trace, request.constraint, argdiffs)
            if fast is not None:
                return fast
            return self._edit_dense(
                gen, trace, argdiffs, lambda t: Update(request.constraint.get_submap(t))
            )
        if isinstance(request, Regenerate):
            return self._edit_dense(
                gen, trace, argdiffs, lambda t: Regenerate(request.selection.get_subselection(t))
            )
        if isinstance(request, IndexRequest):
            return self._edit_index(gen, trace, request.index, request.request, argdiffs)
        if isinstance(request, VectorRequest):
            return self._edit_dense(gen, trace, argdiffs, request.at)
        raise NotSupportedEditRequest(f"ScanCombinator cannot serve {type(request).__name__}.")

    def _try_edit_update_sparse(self, gen, trace: ScanTrace, constraint: ChoiceMap, argdiffs):
        """The O(k) Update of k steps named by a sparsely indexed constraint
        (``C[idx, "y"]``): when the arguments are unchanged and the kernel's
        edit leaves its carry unchanged (by the retdiff it reports, e.g. an
        observation the carry does not read), no step touches another, so
        the k step traces are gathered, edited under ``torch.func.vmap`` and
        put back. None where that does not hold: the caller walks densely."""
        if not Diff.static_check_no_change(argdiffs):
            return None
        if not isinstance(constraint, IndexedChm) or constraint.idx is None:
            return None
        idx = constraint.idx
        device = trace_device(trace.inner)
        scalar = not isinstance(idx, torch.Tensor) or idx.ndim == 0
        idx_arr = torch.atleast_1d(torch.as_tensor(idx, device=device))
        if scalar:
            submaps = pytree.tree_map(lambda v: torch.as_tensor(v, device=device)[None], constraint.inner)
        else:
            submaps = pytree.tree_map(lambda v: torch.as_tensor(v, device=device), constraint.inner)
        slice_trs = pytree.tree_map(lambda v: v[idx_arr], trace.inner)

        def edit_one(g, tr, chm):
            # scored under the combinator's current kernel: the slice trace's
            # recorded one may hold stale closure leaves
            return dispatch_edit(
                self.gen_fn, g, tr, Update(chm), Diff.tree_diff_no_change(tr.get_args())
            )

        if keys.is_key(gen):
            # step ``i`` edits under ``fold_in(key, i)``, as the reference's
            new_slices, ws, retdiffs, bwds = torch.func.vmap(edit_one)(
                keys.fold_in(gen, idx_arr), slice_trs, submaps
            )
        else:
            new_slices, ws, retdiffs, bwds = torch.func.vmap(
                lambda tr, chm: edit_one(gen, tr, chm), randomness="different"
            )(slice_trs, submaps)
        carry_rd, y_rd = retdiffs
        if not Diff.static_check_no_change(carry_rd):
            return None  # the edit moves the carry: slice-local editing is unsound
        new_inner = pytree.tree_map(lambda v, s: v.index_copy(0, idx_arr, s), trace.inner, new_slices)
        old_carry, old_ys = trace.get_retval()
        new_ys = pytree.tree_map(
            lambda old, new: old.index_copy(0, idx_arr, new.to(old.dtype)), none_free(old_ys),
            none_free(Diff.tree_primal(y_rd)),
        )
        new_tr = ScanTrace(self, new_inner, trace.args, (old_carry, new_ys), trace.length)
        if isinstance(bwds, Update):
            bwd_chm = bwds.constraint
            if scalar:
                bwd_chm = pytree.tree_map(lambda v: v[0], bwd_chm)
            bwd: EditRequest = Update(IndexedChm.build(bwd_chm, idx if scalar else idx_arr))
        else:
            bwd = VectorRequest(bwds)
        retdiff = (Diff.no_change(old_carry), Diff.unknown_change(new_ys))
        return new_tr, ws.sum(0), retdiff, bwd

    def _edit_dense(self, gen, trace: ScanTrace, argdiffs, subrequest_at: Callable):
        """The O(T) walk: each step edits its old trace under the (possibly
        changed) carry with its sub-request."""
        primals = Diff.tree_primal(argdiffs)

        def step(t, c, x):
            new_tr, w, _rd, bwd = dispatch_edit(
                self.gen_fn, _step(gen, t), _at(trace.inner, t), subrequest_at(t),
                Diff.tree_diff_unknown_change((c, x)),
            )
            return new_tr, (w, bwd)

        n, inner, c, ys, extras = self._run(step, primals)
        new_tr = ScanTrace(self, inner, primals, (c, ys), n)
        ws = torch.stack([w for w, _ in extras]).sum(0)
        return new_tr, ws, Diff.tree_diff_unknown_change((c, ys)), _steps_bwd([b for _, b in extras])

    def _edit_index(self, gen, trace: ScanTrace, idx, request: EditRequest, argdiffs):
        """The one-step edit: step ``idx`` serves ``request``, then step
        ``idx + 1`` (clipped at T - 1) is re-scored under the new carry by an
        empty Update, so the kernel runs twice whatever T is. The carry out
        of step ``idx + 1`` must be unchanged: the kernel's carry may depend
        on the edited choices for one step only (``_carry_local``)."""
        if not Diff.static_check_no_change(argdiffs):
            raise NotSupportedEditRequest("IndexRequest into Scan requires unchanged arguments.")
        n = trace.length
        old_carry, old_ys = trace.get_retval()
        slice_tr = pytree.tree_map(lambda v: v[idx], trace.inner)
        new_slice, w, retdiff, bwd = dispatch_edit(
            self.gen_fn, gen, slice_tr, request, Diff.tree_diff_no_change(slice_tr.get_args())
        )
        carry_rd, y_rd = retdiff
        new_inner = pytree.tree_map(lambda v, s: put(v, idx, s), trace.inner, new_slice)
        new_ys = pytree.tree_map(lambda v, s: put(v, idx, s), none_free(old_ys), none_free(Diff.tree_primal(y_rd)))
        if isinstance(idx, int):
            has_next: Any = idx + 1 < n
            nxt: Any = min(idx + 1, n - 1)
            last: Any = idx == n - 1
        else:
            has_next = idx + 1 < n
            nxt = torch.clamp(idx + 1, max=n - 1)
            last = idx == n - 1
        weight = w
        if has_next is not False:
            next_slice = pytree.tree_map(lambda v: v[nxt], trace.inner)
            _c, next_x = next_slice.get_args()
            next_new, next_w, next_rd, _ = dispatch_edit(
                self.gen_fn, _step(gen, 1), next_slice, Update(ChoiceMap.empty()),
                (carry_rd, Diff.no_change(next_x)),
            )
            keep = lambda new, old: FlagOp.where(has_next, new, old)  # noqa: E731
            new_inner = pytree.tree_map(
                lambda v, s: put(v, nxt, keep(s, v[nxt])), new_inner, next_new
            )
            # the next step's y may read the incoming carry: put it back too
            new_ys = pytree.tree_map(
                lambda v, s: put(v, nxt, keep(s, v[nxt])), new_ys,
                none_free(Diff.tree_primal(next_rd[1])),
            )
            weight = w + FlagOp.where(has_next, next_w, torch.zeros_like(next_w))
            weight = _carry_local(
                weight, has_next, next_slice.get_retval()[0], Diff.tree_primal(next_rd[0])
            )
        new_carry = FlagOp.where(last, Diff.tree_primal(carry_rd), old_carry)
        new_tr = ScanTrace(self, new_inner, trace.args, (new_carry, new_ys), n)
        retdiff_out = (Diff.unknown_change(new_carry), Diff.unknown_change(new_ys))
        return new_tr, weight, retdiff_out, IndexRequest(idx, bwd)


def _carry_local(weight, has_next, old_carry, new_carry):
    """The one-step edit's locality check: the carry out of step ``idx + 1``
    must equal the old one (to ``torch.isclose``), else the steps after it
    are stale and the weight wrong. Outside ``torch.func`` transforms a
    violation raises; under one, where no value may steer Python, the
    weight of each lane at fault becomes NaN."""
    pairs = zip(pytree.tree_leaves(none_free(old_carry)), pytree.tree_leaves(none_free(new_carry)))
    same = torch.ones((), dtype=torch.bool, device=weight.device)
    for old, new in pairs:
        old, new = torch.as_tensor(old), torch.as_tensor(new)
        if old.is_floating_point():
            # ``torch.isclose``'s test, spelt out: isclose has no vmap batching rule
            close = (new - old).abs() <= 1e-8 + 1e-5 * old.abs()
        else:
            close = new == old
        same = same & close.all()
    ok = FlagOp.or_(FlagOp.not_(has_next), same)
    if torch._C._functorch.peek_interpreter_stack() is None:
        if not bool(ok):
            raise NotSupportedEditRequest(
                "IndexRequest into Scan: the carry changed beyond one step."
            )
        return weight
    return torch.where(ok, weight, torch.full_like(weight, float("nan")))


def _steps_bwd(bwds: list) -> EditRequest:
    """The dense walk's backward request from its steps' ones."""
    if all(isinstance(b, Update) for b in bwds):
        chms = [b.constraint for b in bwds]
        if _uniform(chms):
            return Update(IndexedChm.build(_stack(chms), None))
        acc = ChoiceMap.empty()
        for t, chm in enumerate(chms):
            acc = acc | IndexedChm.build(chm, t)
        return Update(acc)
    return VectorRequest(_stack(bwds) if _uniform(bwds) else tuple(bwds))


# ----------------------------------------------------------------------
# decorators
# ----------------------------------------------------------------------


def scan(*, n: int | None = None):
    """``(c, a) -> (c, b)`` kernel => ``(c, [a]) -> (c, [b])``. The kernel's
    choices stack along a leading time axis; index into them with the step:

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.scan(n=5)
    ... @g.gen
    ... def walk(pos, _):
    ...     step = g.normal(pos, 1.0) @ "step"
    ...     return step, pos
    >>> tr = walk.simulate(torch.Generator().manual_seed(0), (0.0, None))
    >>> tuple(tr.get_choices()[2, "step"].shape)   # index by step
    ()
    >>> final, history = tr.get_retval()
    >>> tuple(history.shape)
    (5,)
    """

    def decorator(gen_fn: GenerativeFunction) -> ScanCombinator:
        return ScanCombinator(gen_fn, length=n)

    return decorator


def prepend_initial_acc(args, ret):
    """The initial accumulator put in front of the stacked accumulations."""

    def cat(init, rest):
        rest = torch.as_tensor(rest)
        init = torch.as_tensor(init, device=rest.device).to(rest.dtype)
        return torch.cat([init.unsqueeze(0), rest], dim=0)

    return pytree.tree_map(cat, args[0], ret)


def accumulate():
    """``(c, a) -> c`` kernel => ``(c, [a]) -> [c]``: every accumulation, the
    initial one included (``itertools.accumulate``)."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.map(lambda c: (c, c), info="accumulate: dup carry")
            .scan()
            .dimap(
                pre=lambda *args: args,
                post=lambda args, ret: prepend_initial_acc(args, ret[1]),
                info="accumulate: prepend initial",
            )
        )

    return decorator


def reduce():
    """``(c, a) -> c`` kernel => ``(c, [a]) -> c``: the final accumulation
    (``functools.reduce``)."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.map(lambda c: (c, None), info="reduce: carry only")
            .scan()
            .map(lambda ret: ret[0], info="reduce: final carry")
        )

    return decorator


def iterate(*, n: int):
    """``a -> a`` kernel => ``a -> [a]``: n applications, all n + 1 states."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.dimap(
                pre=lambda c, _x: (c,), post=lambda _args, c: (c, c),
                info="iterate: ignore scan input",
            )
            .scan(n=n)
            .dimap(
                pre=lambda c: (c, None),
                post=lambda args, ret: prepend_initial_acc(args, ret[1]),
                info="iterate: prepend initial",
            )
        )

    return decorator


def iterate_final(*, n: int):
    """``a -> a`` kernel => ``a -> a``: n applications, the final state."""

    def decorator(gen_fn: GenerativeFunction):
        return (
            gen_fn.dimap(
                pre=lambda c, _x: (c,), post=lambda _args, c: (c, None),
                info="iterate_final: ignore scan input",
            )
            .scan(n=n)
            .dimap(
                pre=lambda c: (c, None), post=lambda _args, ret: ret[0],
                info="iterate_final: final carry",
            )
        )

    return decorator


def _masked_step(gen_fn: GenerativeFunction, emit_all: bool, info: str):
    """The masked kernel ``(c, flag) -> (c', y)``: step applies the kernel
    only where ``flag`` holds, else keeps ``c``."""
    from .mask_comb import MaskCombinator

    masked = MaskCombinator(
        gen_fn.dimap(pre=lambda c: (c,), post=lambda _args, c: c, info=f"{info}: kernel")
    )

    def step_post(args, masked_ret):
        c, _flag = args
        new_c = masked_ret.unmask(default=c)
        return (new_c, new_c if emit_all else None)

    return masked.dimap(pre=lambda c, flag: (flag, c), post=step_post, info=f"{info}: step")


def masked_iterate():
    """``a -> a`` kernel => ``(a, [flag]) -> [a]``: step t applies the kernel
    only where ``flag[t]`` holds, in fixed shapes."""

    def decorator(gen_fn: GenerativeFunction):
        return _masked_step(gen_fn, True, "masked_iterate").scan().dimap(
            pre=lambda *args: args,
            post=lambda args, ret: prepend_initial_acc(args, ret[1]),
            info="masked_iterate: prepend initial",
        )

    return decorator


def masked_iterate_final():
    """``a -> a`` kernel => ``(a, [flag]) -> a``: the masked iteration's
    final state."""

    def decorator(gen_fn: GenerativeFunction):
        return _masked_step(gen_fn, False, "masked_iterate_final").scan().map(
            lambda ret: ret[0], info="masked_iterate_final: final"
        )

    return decorator

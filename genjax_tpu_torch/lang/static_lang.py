"""The ``@gen`` static modeling language.

Counterpart of ``genjax_tpu/lang/static_lang.py``: each GFI method runs the
model's Python body under a handler on the handler stack
(``core/handlers.py``), which serves every addressed call. An edit
(``Update``, ``Regenerate``, ``StaticRequest``) runs the body again under an
edit handler and a ``ChangeMode`` (``core/changes.py``), which carries the
reference's change propagation (``genjax_tpu/lang/staged_edit.py``) over to
the ops as they run: only the addresses the request touches and their true
dependents are edited again, every other subtrace is reused untouched. Where
the change cannot be followed (a changed value read to Python, a write into
an aliased tensor, a callee reaching a changed value through a Python
closure), the edit degrades to the clean-prefix rule, which reuses only the
subtraces before the first address the request changes, as the reference
falls back where its body does not stage. Under a key (``core/keys.py``)
the addressed calls draw as the reference's do: the ``n``-th call in the
body's order gets ``fold_in(key, n)``, a reused subtrace counting too, and
``project`` folds in each address's position. Under a ``torch.Generator``
every draw shares the caller's generator, whose state advances with each
addressed draw.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.changes import ChangeMode, diffs_of, mark_diffs
from ..core.diff import Diff, NoChange, leaf_changes
from ..core.checkify import check, constraint_validation_active
from ..core.handlers import AddressReuse, MissingAddress, TraceHandler, active_handler, handle
from ..core.pytree import Closure, Pytree
from ..core.staging import FlagOp
from ..generative.choice_map import ChoiceMap, ChoiceMapInvalidAddress, exists_flag
from ..generative.concepts import (
    EditRequest,
    EmptyRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Retdiff,
    Update,
    Weight,
    dispatch_edit,
    python_closure_mismatch,
    source_changed_flags,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import NoneSel, Selection
from ..generative.trace import Trace, tensor_leaves, trace_device
from ..generative.typecheck import check_args, check_constraint, check_key


def _path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


@Pytree.dataclass
class StaticRequest(PrimitiveEditRequest):
    """Heterogeneous per-address edit requests for a static model. A
    ``PrimitiveEditRequest``: ``edit`` defers to the generative function, so
    ``dispatch_edit`` can route it through the CURRENT callee."""

    subrequests: tuple
    addresses: tuple = Pytree.static()

    @staticmethod
    def d(mapping: dict) -> "StaticRequest":
        return StaticRequest(tuple(mapping.values()), tuple(mapping.keys()))

    def get(self, addr) -> EditRequest:
        try:
            return self.subrequests[self.addresses.index(addr)]
        except ValueError:
            return EmptyRequest()


def _on(device, total) -> torch.Tensor:
    """A sum of scores or weights as a tensor: a sum no address added to is
    still the Python 0.0 it began as, and becomes a float32 zero on
    ``device``, where the trace or the choices live. ``device`` may be a
    function that finds it, called only then."""
    if isinstance(total, torch.Tensor):
        return total
    return torch.full((), float(total), device=device() if callable(device) else device)


@Pytree.dataclass
class StaticTrace(Trace):
    gen_fn: "StaticGenerativeFunction"
    args: tuple
    retval: Any
    subtraces: tuple
    addresses: tuple = Pytree.static()

    def __post_init__(self):
        # a recorded trace holds tensor leaves only (``tensor_leaves``)
        device = functools.partial(trace_device, self.subtraces)
        object.__setattr__(self, "args", tensor_leaves(self.args, device))
        object.__setattr__(self, "retval", tensor_leaves(self.retval, device))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_gen_fn(self) -> "StaticGenerativeFunction":
        return self.gen_fn

    def get_score(self):
        return _on(functools.partial(trace_device, self), sum(tr.get_score() for tr in self.subtraces))

    def get_choices(self) -> ChoiceMap:
        acc = ChoiceMap.empty()
        for addr, tr in zip(self.addresses, self.subtraces):
            acc |= tr.get_choices().extend(*_path(addr))
        return acc

    def get_inner_trace(self, address) -> Trace:
        try:
            return self.subtraces[self.addresses.index(address)]
        except ValueError as e:
            raise MissingAddress(f"No subtrace at address {address!r}") from e


class StaticHandler(TraceHandler):
    """Base: address-reuse detection, subtrace recording and the randomness
    of each addressed call."""

    def __init__(self, gen: torch.Generator | None):
        self.gen = gen
        self.count = 0
        self.addresses: list = []
        self.subtraces: list[Trace] = []

    def fresh(self):
        """The randomness of the next addressed call: ``fold_in(key, n)``
        for the ``n``-th call under a key, the caller's generator itself
        otherwise."""
        n = self.count
        self.count += 1
        return keys.fold_in(self.gen, n) if keys.is_key(self.gen) else self.gen

    def visit(self, addr) -> None:
        if addr in self.addresses:
            raise AddressReuse(f"Address {addr!r} was traced twice.")
        self.addresses.append(addr)

    def record(self, tr: Trace) -> Any:
        self.subtraces.append(tr)
        return tr.get_retval()


class SimulateHandler(StaticHandler):
    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        return self.record(gen_fn.simulate(self.fresh(), args))


class AssessHandler(StaticHandler):
    def __init__(self, chm: ChoiceMap):
        super().__init__(None)
        self.chm = chm
        self.score: Any = 0.0

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.chm.get_submap(*_path(addr))
        if submap.static_is_empty():
            raise MissingAddress(f"assess: no constraint at address {addr!r}")
        score, retval = gen_fn.assess(submap, args)
        self.score = self.score + score
        return retval


class GenerateHandler(StaticHandler):
    def __init__(self, gen: torch.Generator, constraint: ChoiceMap):
        super().__init__(gen)
        self.constraint = constraint
        self.weight: Any = 0.0

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        submap = self.constraint.get_submap(*_path(addr))
        tr, w = gen_fn.generate(self.fresh(), submap, args)
        self.weight = self.weight + w
        return self.record(tr)


class EditHandler(StaticHandler):
    """Shared machinery of the Update, Regenerate and StaticRequest edits:
    runs the body again, editing each old subtrace with a per-address
    sub-request, under one of two rules.

    The incremental rule (``mode`` given and not degraded): the body runs
    under a ``ChangeMode``, which marks the values that depend on a changed
    one. An addressed call whose arguments and callee carry no mark, and
    whose sub-request is trivial, reuses its old subtrace untouched (weight
    0, no re-scoring, no draw from the generator) and returns the old retval
    unmarked; any other call is edited with per-leaf argdiffs from the marks,
    and the retval leaves its retdiff reports changed are marked. So only
    the addresses the request touches and their true dependents run again.

    The clean-prefix rule (no mode, or once it degraded): in a static body,
    execution order equals dependency order, so until the first address
    whose sub-request does something (and while the top-level arguments are
    unchanged), every address's arguments equal the previous trace's; those
    subtraces are reused untouched, and every later one is edited with its
    arguments marked changed."""

    def __init__(self, gen: torch.Generator, prev: StaticTrace, args_unchanged: bool, mode: ChangeMode | None = None):
        super().__init__(gen)
        self.prev = prev
        self.weight: Any = 0.0
        self.bwd: dict = {}
        # False once an upstream address may have changed a value
        self.clean = args_unchanged
        self.mode = mode
        # sub-edits dispatched (the addresses that ran again)
        self.dispatched = 0

    def subrequest(self, addr) -> EditRequest:
        raise NotImplementedError

    @staticmethod
    def _is_trivial(request: EditRequest) -> bool:
        if isinstance(request, EmptyRequest):
            return True
        if isinstance(request, Update):
            return request.constraint.static_is_empty()
        if isinstance(request, Regenerate):
            return isinstance(request.selection, NoneSel)
        return False

    def handle_trace(self, addr, gen_fn, args):
        mode = self.mode
        if mode is None:
            return self._edit_at(addr, gen_fn, args, None)
        if mode.degraded is None:
            mode.handed_off(args, gen_fn)
        with mode.paused():
            return self._edit_at(addr, gen_fn, args, mode)

    def _edit_at(self, addr, gen_fn, args, mode: ChangeMode | None):
        self.visit(addr)
        # drawn here, whether the call is edited or reused, so that the key
        # counter stays aligned with the reference's
        gen = self.fresh()
        sub_tr = self.prev.get_inner_trace(addr)
        request = self.subrequest(addr)
        trivial = self._is_trivial(request)
        callee_changed = False
        if mode is not None and mode.degraded is None:
            callee_changed = mode.any_changed(gen_fn)
            if (
                not callee_changed
                and python_closure_mismatch(sub_tr.get_gen_fn(), gen_fn)
                and mode.captures_changed(gen_fn)
            ):
                mode.degrade(f"the callee at {addr!r} reaches an edited value through a Python closure")
        if mode is None or mode.degraded is not None:
            if self.clean and trivial:
                # nothing upstream changed, nothing requested here: reuse
                self.bwd[addr] = EmptyRequest()
                return self.record(sub_tr)
            # On the clean prefix this address's arguments are the previous
            # trace's, so they are marked unchanged (an ``IndexRequest`` into
            # a vmap or scan needs them so)
            argdiffs = Diff.tree_diff_no_change(args) if self.clean else Diff.tree_diff_unknown_change(args)
        else:
            if not callee_changed and trivial and not mode.any_changed(args):
                self.bwd[addr] = EmptyRequest()
                return self.record(sub_tr)
            # a changed leaf of the callee itself: argdiffs cannot say what
            # it touches, so every argument counts as changed
            argdiffs = Diff.tree_diff_unknown_change(args) if callee_changed else diffs_of(mode, args)
        # dispatch through the CURRENT callee: the body ran again with the new
        # arguments, so ``gen_fn`` carries any closed-over dynamic values the
        # previous subtrace is stale on
        new_tr, w, retdiff, bwd = dispatch_edit(gen_fn, gen, sub_tr, request, argdiffs)
        self.dispatched += 1
        self.weight = self.weight + w
        self.bwd[addr] = bwd
        if not trivial:
            self.clean = False
        retval = self.record(new_tr)
        if mode is not None and mode.degraded is None:
            self._mark_retval(mode, retval, retdiff)
        return retval

    @staticmethod
    def _mark_retval(mode: ChangeMode, retval, retdiff) -> None:
        """Mark the leaves of a sub-edit's retval that its retdiff reports
        changed (all of them where the two do not line up)."""
        if isinstance(retdiff, Diff) and isinstance(retval, torch.Tensor):
            pairs = [(retval, retdiff.tangent is not NoChange)]  # a draw's value
        else:
            pairs = leaf_changes(retdiff)
            leaves = [v for v in pytree.tree_leaves(retval) if v is not None]
            if pairs is None or len(pairs) != len(leaves):
                pairs = [(v, True) for v in leaves]
            pairs = [(v, changed) for v, (_, changed) in zip(leaves, pairs)]
        for v, changed in pairs:
            if changed and not mode.mark(v):
                mode.degrade(f"a sub-edit changed a {type(v).__name__}, which is no tensor")

    def bwd_request(self) -> EditRequest:
        # per-address backward requests, so that applying the backward request
        # restores the original trace and cancels the forward weight
        return StaticRequest.d(self.bwd)


class UpdateHandler(EditHandler):
    def __init__(self, gen, prev, constraint: ChoiceMap, args_unchanged=False, mode=None):
        super().__init__(gen, prev, args_unchanged, mode)
        self.constraint = constraint

    def subrequest(self, addr) -> EditRequest:
        return Update(self.constraint.get_submap(*_path(addr)))

    def bwd_request(self) -> Update:
        return _assemble_update_bwd(self.bwd)


class RegenerateHandler(EditHandler):
    def __init__(self, gen, prev, selection: Selection, args_unchanged=False, mode=None):
        super().__init__(gen, prev, args_unchanged, mode)
        self.selection = selection

    def subrequest(self, addr) -> EditRequest:
        return Regenerate(self.selection(*_path(addr)))


class StaticRequestHandler(EditHandler):
    def __init__(self, gen, prev, request: StaticRequest, args_unchanged=False, mode=None):
        super().__init__(gen, prev, args_unchanged, mode)
        self.request = request

    def subrequest(self, addr) -> EditRequest:
        return self.request.get(addr)


@Pytree.dataclass
class StaticGenerativeFunction(GenerativeFunction):
    """A generative function built from a Python body containing addressed
    calls (``gen_fn(args) @ "addr"``)."""

    source: Closure

    def run(self, handler: StaticHandler, args: tuple):
        with handle(handler):
            return self.source(*args)

    def simulate(self, gen: torch.Generator, args: tuple) -> StaticTrace:
        check_key(gen, "simulate")
        check_args(args, "simulate")
        h = SimulateHandler(gen)
        retval = self.run(h, args)
        return StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))

    def assess(self, chm: ChoiceMap, args: tuple):
        check_constraint(chm, "assess")
        check_args(args, "assess")
        _maybe_validate_constraint(self, chm, args, "assess")
        h = AssessHandler(chm)
        retval = self.run(h, args)
        return _on(functools.partial(trace_device, (chm, args)), h.score), retval

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        check_key(gen, "generate")
        check_constraint(constraint, "generate")
        check_args(args, "generate")
        _maybe_validate_constraint(self, constraint, args, "generate")
        h = GenerateHandler(gen, constraint)
        retval = self.run(h, args)
        tr = StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))
        return tr, _on(gen.device, h.weight)

    def project(self, gen: torch.Generator | None, trace: StaticTrace, selection: Selection) -> Weight:
        total: Any = 0.0
        for i, (addr, sub_tr) in enumerate(zip(trace.addresses, trace.subtraces)):
            sub_gen = keys.fold_in(gen, i) if keys.is_key(gen) else gen
            total = total + sub_tr.project(sub_gen, selection(*_path(addr)))
        return _on(trace_device(trace), total)

    def edit(
        self, gen: torch.Generator, trace: StaticTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[StaticTrace, Weight, Retdiff, EditRequest]:
        """Edit ``trace`` with ``request`` under the incremental rule
        (``EditHandler``), or under the clean-prefix rule where the change
        cannot be followed: the body reaches values through a Python closure
        that may differ from the trace's, a changed argument or closure leaf
        is no tensor, or the ``ChangeMode`` degraded while the body ran (from
        then on). Both give the same weights, traces and backward requests;
        the rule that served the edit is recorded on
        ``StaticGenerativeFunction.edit.last_rule`` (with
        ``last_rule_reason``), and the sub-edits it dispatched on
        ``last_dispatched``."""
        if not isinstance(request, (Update, Regenerate, StaticRequest)):
            raise NotSupportedEditRequest(
                f"StaticGenerativeFunction cannot serve {type(request).__name__}."
            )
        check_key(gen, "edit")
        primals = Diff.tree_primal(argdiffs)
        old_source = trace.get_gen_fn().source
        closure_flags = source_changed_flags(self.source, old_source)
        closure_mismatch = python_closure_mismatch(old_source, self.source)
        unchanged = Diff.static_check_no_change(argdiffs) and not any(closure_flags) and not closure_mismatch
        mode = ChangeMode()
        if _FORCED_CLEAN_PREFIX:
            mode.degrade("forced")
        elif closure_mismatch:
            mode.degrade("the body reaches values through a Python closure that may have changed")
        else:
            reason = mark_diffs(mode, argdiffs)
            closure = pytree.tree_leaves(self.source)
            if reason is None and any(f and not mode.mark(v) for v, f in zip(closure, closure_flags)):
                reason = "a changed closure leaf is no tensor"
            if reason is not None:
                mode.degrade(reason)
        h = self._edit_handler(gen, trace, request, unchanged, mode)
        with mode if mode.degraded is None else contextlib.nullcontext():
            retval = self.run(h, primals)
        new_tr = StaticTrace(self, primals, retval, tuple(h.subtraces), tuple(h.addresses))
        if mode.degraded is None:
            retdiff = diffs_of(mode, new_tr.retval)
        elif h.clean:
            # the clean path throughout (arguments unchanged, every
            # sub-request trivial): the deterministic body gave the old retval
            retdiff = Diff.tree_diff_no_change(new_tr.retval)
        else:
            retdiff = Diff.tree_diff_unknown_change(new_tr.retval)
        _record_rule(mode.degraded, h.dispatched)
        return new_tr, _on(gen.device, h.weight), retdiff, h.bwd_request()

    def _edit_via_handler(self, gen, trace, request, argdiffs):
        """The edit under the clean-prefix rule alone (the rule the
        incremental edit degrades to)."""
        with forced_clean_prefix():
            return self.edit(gen, trace, request, argdiffs)

    @staticmethod
    def _edit_handler(gen, trace, request, unchanged: bool, mode: ChangeMode) -> EditHandler:
        live = mode if mode.degraded is None else None
        if isinstance(request, Update):
            return UpdateHandler(gen, trace, request.constraint, unchanged, live)
        if isinstance(request, Regenerate):
            return RegenerateHandler(gen, trace, request.selection, unchanged, live)
        return StaticRequestHandler(gen, trace, request, unchanged, live)


_FORCED_CLEAN_PREFIX = False


@contextlib.contextmanager
def forced_clean_prefix():
    """Serve every ``@gen`` edit in this extent with the clean-prefix rule,
    as a degraded edit is served: the reference point against which tests
    and ``chip_smoke.py`` hold the incremental rule's weights and time. Not
    a switch for users: both rules give the same results."""
    global _FORCED_CLEAN_PREFIX
    before, _FORCED_CLEAN_PREFIX = _FORCED_CLEAN_PREFIX, True
    try:
        yield
    finally:
        _FORCED_CLEAN_PREFIX = before


def _record_rule(degraded: str | None, dispatched: int) -> None:
    edit = StaticGenerativeFunction.edit
    edit.last_rule = "incremental" if degraded is None else "clean_prefix"
    edit.last_rule_reason = degraded
    edit.last_dispatched = dispatched


StaticGenerativeFunction.edit.last_rule = None
StaticGenerativeFunction.edit.last_rule_reason = None
StaticGenerativeFunction.edit.last_dispatched = None


def _maybe_validate_constraint(gen_fn, constraint: ChoiceMap, args: tuple, what: str) -> None:
    """Under ``do_checkify()``: reject a constraint with addresses the model
    never samples (``ChoiceMap.invalid_subset``). An extra that is there
    for sure raises ``ChoiceMapInvalidAddress`` at once; one that a tensor
    flag or index decides is checked on the device (``core/checkify.py``).
    Only at the top of a GFI call: not inside an enclosing body, whose
    submaps were scoped already, and not where ``switch`` hands a constraint
    to branches with other addresses (``suppress_constraint_validation``)."""
    if not constraint_validation_active() or active_handler() is not None or constraint.static_is_empty():
        return
    extras = constraint.invalid_subset(gen_fn, args)
    if extras is None:
        return
    flag = exists_flag(extras)
    message = f"{what}: the constraint holds addresses the model never samples: {extras}"
    if FlagOp.concrete_true(flag):
        raise ChoiceMapInvalidAddress(message)
    check(FlagOp.not_(flag), message, ChoiceMapInvalidAddress)


def _assemble_update_bwd(bwd: dict) -> Update:
    """Collect per-address backward Updates into one discard choice map."""
    acc = ChoiceMap.empty()
    for addr, req in bwd.items():
        if isinstance(req, Update) and not req.constraint.static_is_empty():
            acc |= req.constraint.extend(*_path(addr))
    return Update(acc)


def trace(addr, gen_fn, args: tuple = ()):
    """The trace intrinsic in function form: ``trace(addr, gen_fn, args)``
    is ``gen_fn(*args) @ addr``."""
    from ..core.handlers import dispatch_trace

    return dispatch_trace(addr, gen_fn, args)


def gen(fn: Callable) -> StaticGenerativeFunction:
    """Decorator: a Python function with addressed calls becomes a
    ``StaticGenerativeFunction``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.gen
    ... def pair(shift):
    ...     x = g.normal(shift, 1.0) @ "x"
    ...     return x + shift
    >>> @g.gen
    ... def model():
    ...     a = pair(1.0) @ "sub"       # generative functions nest
    ...     b = g.flip(0.5) @ "b"
    ...     return a
    >>> tr = model.simulate(torch.Generator().manual_seed(0), ())
    >>> chm = tr.get_choices()
    >>> bool(torch.isclose(tr.get_retval(), chm["sub", "x"] + 1.0))
    True
    >>> chm["b"].dtype
    torch.bool
    """
    return StaticGenerativeFunction(fn if isinstance(fn, Closure) else Closure((), fn))

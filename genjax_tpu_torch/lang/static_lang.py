"""The ``@gen`` static modeling language.

Counterpart of ``genjax_tpu/lang/static_lang.py``: each GFI method runs the
model's Python body under a handler on the handler stack
(``core/handlers.py``), which serves every addressed call. An edit
(``Update``, ``Regenerate``, ``StaticRequest``) runs the body again under an
edit handler, which edits each old subtrace with its address's sub-request
and reuses, untouched, every subtrace before the first address that the
request changes. The reference's staged edit, which reads the body's jaxpr
to re-score only true dependents, has no counterpart yet: weights, traces
and backward requests are the same, only the cost of an edit differs. Random
draws share the caller's ``torch.Generator``, whose state advances with each
addressed draw, in place of the reference's ``fold_in`` key counter.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.diff import Diff, NoChange, UnknownChange
from ..core.handlers import AddressReuse, MissingAddress, TraceHandler, handle
from ..core.pytree import Closure, Pytree
from ..generative.choice_map import ChoiceMap
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


def _path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _check_generator(gen, what: str) -> None:
    if not isinstance(gen, torch.Generator):
        raise TypeError(
            f"{what}: expected a torch.Generator as the source of randomness, "
            f"got {type(gen).__name__}"
        )


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
    """Base: address-reuse detection and subtrace recording."""

    def __init__(self, gen: torch.Generator | None):
        self.gen = gen
        self.addresses: list = []
        self.subtraces: list[Trace] = []

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
        return self.record(gen_fn.simulate(self.gen, args))


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
        tr, w = gen_fn.generate(self.gen, submap, args)
        self.weight = self.weight + w
        return self.record(tr)


class EditHandler(StaticHandler):
    """Shared machinery of the Update, Regenerate and StaticRequest edits:
    runs the body again, editing each old subtrace with a per-address
    sub-request.

    Clean prefix: in a static body, execution order equals dependency order,
    so until the first address whose sub-request does something (and while
    the top-level arguments are unchanged), every address's arguments equal
    the previous trace's; those subtraces are reused untouched (weight 0, no
    re-scoring, no draw from the generator)."""

    def __init__(self, gen: torch.Generator, prev: StaticTrace, args_unchanged: bool):
        super().__init__(gen)
        self.prev = prev
        self.weight: Any = 0.0
        self.bwd: dict = {}
        # False once an upstream address may have changed a value
        self.clean = args_unchanged
        self.args_unchanged = args_unchanged
        # the ids of the retval leaves of the subtraces reused untouched
        self.reused: set[int] = set()

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
        self.visit(addr)
        sub_tr = self.prev.get_inner_trace(addr)
        request = self.subrequest(addr)
        trivial = self._is_trivial(request)
        if self.clean and trivial:
            # nothing upstream changed, nothing requested here: reuse
            self.bwd[addr] = EmptyRequest()
            self.reused.update(id(v) for v in pytree.tree_leaves(sub_tr.get_retval()))
            return self.record(sub_tr)
        # dispatch through the CURRENT callee: the body ran again with the new
        # arguments, so ``gen_fn`` carries any closed-over dynamic values the
        # previous subtrace is stale on. On the clean prefix this address's
        # arguments are the previous trace's, so they are marked unchanged
        # (an ``IndexRequest`` into a vmap or scan needs them so)
        argdiffs = Diff.tree_diff_no_change(args) if self.clean else Diff.tree_diff_unknown_change(args)
        new_tr, w, _retdiff, bwd = dispatch_edit(gen_fn, self.gen, sub_tr, request, argdiffs)
        self.weight = self.weight + w
        self.bwd[addr] = bwd
        if not trivial:
            self.clean = False
        return self.record(new_tr)

    def bwd_request(self) -> EditRequest:
        # per-address backward requests, so that applying the backward request
        # restores the original trace and cancels the forward weight
        return StaticRequest.d(self.bwd)


class UpdateHandler(EditHandler):
    def __init__(self, gen, prev, constraint: ChoiceMap, args_unchanged=False):
        super().__init__(gen, prev, args_unchanged)
        self.constraint = constraint

    def subrequest(self, addr) -> EditRequest:
        return Update(self.constraint.get_submap(*_path(addr)))

    def bwd_request(self) -> Update:
        return _assemble_update_bwd(self.bwd)


class RegenerateHandler(EditHandler):
    def __init__(self, gen, prev, selection: Selection, args_unchanged=False):
        super().__init__(gen, prev, args_unchanged)
        self.selection = selection

    def subrequest(self, addr) -> EditRequest:
        return Regenerate(self.selection(*_path(addr)))


class ReplayHandler(StaticHandler):
    """Runs the body again on a trace's own subtraces without editing them:
    each address returns its old subtrace's retval. The body, a deterministic
    function of its arguments and those retvals, takes the trace's old path
    and builds its old retval from the very objects the trace holds."""

    def __init__(self, prev: StaticTrace):
        super().__init__(None)
        self.prev = prev

    def handle_trace(self, addr, gen_fn, args):
        self.visit(addr)
        return self.prev.get_inner_trace(addr).get_retval()


class StaticRequestHandler(EditHandler):
    def __init__(self, gen, prev, request: StaticRequest, args_unchanged=False):
        super().__init__(gen, prev, args_unchanged)
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
        _check_generator(gen, "simulate")
        h = SimulateHandler(gen)
        retval = self.run(h, args)
        return StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))

    def assess(self, chm: ChoiceMap, args: tuple):
        h = AssessHandler(chm)
        retval = self.run(h, args)
        return _on(functools.partial(trace_device, (chm, args)), h.score), retval

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        _check_generator(gen, "generate")
        h = GenerateHandler(gen, constraint)
        retval = self.run(h, args)
        tr = StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))
        return tr, _on(gen.device, h.weight)

    def project(self, gen: torch.Generator | None, trace: StaticTrace, selection: Selection) -> Weight:
        total: Any = 0.0
        for addr, sub_tr in zip(trace.addresses, trace.subtraces):
            total = total + sub_tr.project(gen, selection(*_path(addr)))
        return _on(trace_device(trace), total)

    def edit(
        self, gen: torch.Generator, trace: StaticTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[StaticTrace, Weight, Retdiff, EditRequest]:
        if not isinstance(request, (Update, Regenerate, StaticRequest)):
            raise NotSupportedEditRequest(
                f"StaticGenerativeFunction cannot serve {type(request).__name__}."
            )
        return self._edit_via_handler(gen, trace, request, argdiffs)

    def _edit_via_handler(self, gen, trace, request, argdiffs):
        """The edit that runs the body under the handler stack (clean-prefix
        reuse, conservative argdiffs)."""
        _check_generator(gen, "edit")
        primals = Diff.tree_primal(argdiffs)
        old_source = trace.get_gen_fn().source
        unchanged = (
            Diff.static_check_no_change(argdiffs)
            and not any(source_changed_flags(self.source, old_source))
            and not python_closure_mismatch(old_source, self.source)
        )
        if isinstance(request, Update):
            h: EditHandler = UpdateHandler(gen, trace, request.constraint, unchanged)
        elif isinstance(request, Regenerate):
            h = RegenerateHandler(gen, trace, request.selection, unchanged)
        else:
            h = StaticRequestHandler(gen, trace, request, unchanged)
        retval = self.run(h, primals)
        new_tr = StaticTrace(self, primals, retval, tuple(h.subtraces), tuple(h.addresses))
        retdiff = self._retdiff(h, trace, primals, new_tr.retval)
        return new_tr, _on(gen.device, h.weight), retdiff, h.bwd_request()

    def _retdiff(self, h: EditHandler, trace: StaticTrace, primals: tuple, retval) -> Any:
        """The edited body's retdiff. On the clean path throughout (arguments
        unchanged, every sub-request trivial) the deterministic body gave the
        old retval again. Else, where the arguments are unchanged and the new
        retval holds a reused subtrace's value, the body is replayed on the
        old trace (``ReplayHandler``): a leaf is unchanged where the old run
        put the very same object at that position. The new run alone cannot
        tell, since a body may route a reused value to where another one
        stood (``a if c else b`` with ``c`` edited). Every other leaf is
        marked changed."""
        if h.clean:
            return Diff.tree_diff_no_change(retval)
        new_leaves, spec = pytree.tree_flatten(retval)
        if not h.args_unchanged or not any(id(v) in h.reused for v in new_leaves):
            return Diff.tree_diff_unknown_change(retval)
        try:
            replayed = self.run(ReplayHandler(trace), primals)
        except MissingAddress:
            return Diff.tree_diff_unknown_change(retval)
        old_leaves, old_spec = pytree.tree_flatten(
            tensor_leaves(replayed, functools.partial(trace_device, trace))
        )
        if old_spec != spec:
            return Diff.tree_diff_unknown_change(retval)
        return pytree.tree_unflatten(
            [
                None if v is None else Diff(v, NoChange if v is old else UnknownChange)
                for v, old in zip(new_leaves, old_leaves)
            ],
            spec,
        )


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

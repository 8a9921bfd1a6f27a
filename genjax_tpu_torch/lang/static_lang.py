"""The ``@gen`` static modeling language.

Counterpart of ``genjax_tpu/lang/static_lang.py``: each GFI method runs the
model's Python body under a handler on the handler stack
(``core/handlers.py``), which serves every addressed call. The simulate,
assess and generate handlers are ported; the edit handlers wait for the
trace-path slice. Random draws share the caller's ``torch.Generator``, whose
state advances with each addressed draw, in place of the reference's
``fold_in`` key counter.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core.handlers import AddressReuse, MissingAddress, TraceHandler, handle
from ..core.pytree import Closure, Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.trace import Trace


def _path(addr) -> tuple:
    return addr if isinstance(addr, tuple) else (addr,)


def _check_generator(gen, what: str) -> None:
    if not isinstance(gen, torch.Generator):
        raise TypeError(
            f"{what}: expected a torch.Generator as the source of randomness, "
            f"got {type(gen).__name__}"
        )


@Pytree.dataclass
class StaticTrace(Trace):
    gen_fn: "StaticGenerativeFunction"
    args: tuple
    retval: Any
    subtraces: tuple
    addresses: tuple = Pytree.static()

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.retval

    def get_gen_fn(self) -> "StaticGenerativeFunction":
        return self.gen_fn

    def get_score(self):
        return torch.as_tensor(sum(tr.get_score() for tr in self.subtraces))

    def get_choices(self) -> ChoiceMap:
        acc = ChoiceMap.empty()
        for addr, tr in zip(self.addresses, self.subtraces):
            acc |= tr.get_choices().extend(*_path(addr))
        return acc


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
        return torch.as_tensor(h.score), retval

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        _check_generator(gen, "generate")
        h = GenerateHandler(gen, constraint)
        retval = self.run(h, args)
        tr = StaticTrace(self, args, retval, tuple(h.subtraces), tuple(h.addresses))
        return tr, torch.as_tensor(h.weight)


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

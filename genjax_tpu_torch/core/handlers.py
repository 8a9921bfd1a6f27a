"""Effect-handler dispatch for the ``@gen`` language.

Counterpart of ``genjax_tpu/core/handlers.py``: each GFI method runs the
model's Python body with a handler installed on a dynamic stack, and every
addressed call ``gen_fn(args) @ addr`` is dispatched to the innermost
handler. A handler may also serve named effects (``core/primitive.py``):
``initial_style_bind`` sends each to the innermost handler that
``serves`` it. ``StatefulHandler`` and ``stateful`` are the reference's
names for ``TraceHandler`` and ``handle``.
"""

from __future__ import annotations

import abc
from typing import Any

_HANDLER_STACK: list["TraceHandler"] = []


class GenJAXError(Exception):
    pass


class AddressReuse(GenJAXError):
    """An address was traced twice in one generative function body."""


class MissingAddress(GenJAXError):
    """``assess``/``generate`` required a constraint that was not provided."""


class NotTracedError(GenJAXError):
    """An ``@ addr`` binding executed outside any GFI method."""


class TraceHandler(abc.ABC):
    """Receives each addressed generative-function call in a model body."""

    @abc.abstractmethod
    def handle_trace(self, addr: Any, gen_fn: Any, args: tuple) -> Any:
        """Process one ``gen_fn(*args) @ addr`` binding; returns the retval."""

    def serves(self, prim: Any) -> bool:
        """Does this handler serve the named effect ``prim``?"""
        return False

    def handle_primitive(self, prim: Any, fn: Any, args: tuple, params: dict) -> Any:
        raise NotImplementedError


class EffectHandler(TraceHandler):
    """A handler of named effects alone: it passes addressed calls to the
    handler below it, and does not count as one for ``active_handler``."""

    def handle_trace(self, addr: Any, gen_fn: Any, args: tuple) -> Any:
        below = _HANDLER_STACK[: _HANDLER_STACK.index(self)]
        for h in reversed(below):
            if not isinstance(h, EffectHandler):
                return h.handle_trace(addr, gen_fn, args)
        raise NotTracedError(f"Address binding {addr!r} executed outside a generative function interpretation.")


def active_handler() -> TraceHandler | None:
    """The innermost handler of addressed calls, or None."""
    for h in reversed(_HANDLER_STACK):
        if not isinstance(h, EffectHandler):
            return h
    return None


def innermost_serving(prim: Any) -> TraceHandler | None:
    """The innermost installed handler that serves the effect ``prim``."""
    for h in reversed(_HANDLER_STACK):
        if h.serves(prim):
            return h
    return None


def innermost_handler(kind: type) -> TraceHandler | None:
    """The innermost installed handler of type ``kind``, under any handlers
    installed above it (the ADEV transform sees draws made deep inside the
    GFI methods its program calls)."""
    for h in reversed(_HANDLER_STACK):
        if isinstance(h, kind):
            return h
    return None


class handle:
    """Context manager installing a handler for the dynamic extent of a model
    body execution."""

    def __init__(self, handler: TraceHandler):
        self.handler = handler

    def __enter__(self):
        _HANDLER_STACK.append(self.handler)
        return self.handler

    def __exit__(self, *exc):
        popped = _HANDLER_STACK.pop()
        if popped is not self.handler:
            raise GenJAXError("handler stack corrupted: popped a foreign handler")
        return False


def dispatch_trace(addr: Any, gen_fn: Any, args: tuple) -> Any:
    h = _HANDLER_STACK[-1] if _HANDLER_STACK else None
    if h is None:
        raise NotTracedError(
            f"Address binding {addr!r} executed outside a generative function "
            "interpretation. Addressed calls (`gen_fn(args) @ addr`) only make "
            "sense inside a @gen body run through the GFI."
        )
    return h.handle_trace(addr, gen_fn, args)


# the reference's names (``genjax_tpu/core/handlers.py:107-112``)
StatefulHandler = TraceHandler
stateful = handle

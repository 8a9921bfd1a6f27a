"""Effect-handler dispatch for the ``@gen`` language.

Counterpart of ``genjax_tpu/core/handlers.py``: each GFI method runs the
model's Python body with a handler installed on a dynamic stack, and every
addressed call ``gen_fn(args) @ addr`` is dispatched to the innermost
handler.
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


def active_handler() -> TraceHandler | None:
    return _HANDLER_STACK[-1] if _HANDLER_STACK else None


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
    h = active_handler()
    if h is None:
        raise NotTracedError(
            f"Address binding {addr!r} executed outside a generative function "
            "interpretation. Addressed calls (`gen_fn(args) @ addr`) only make "
            "sense inside a @gen body run through the GFI."
        )
    return h.handle_trace(addr, gen_fn, args)

"""Named effects, bound around a call.

Counterpart of ``genjax_tpu/core/primitive.py``. The reference's initial-style
primitive stages a function to a jaxpr and binds a JAX primitive that
carries it, so that an interpreter can later re-open the call. The port
stages nothing: a primitive is a named effect on the handler stack
(``core/handlers.py``), and ``initial_style_bind`` sends ``(prim, fn, args,
params)`` to the innermost handler that serves the primitive, which decides
what the call does (the time-travel debugger records it, or runs another
call in its place). With no such handler the call runs as it is.
"""

from __future__ import annotations

from typing import Any, Callable

from .handlers import innermost_serving


class InitialStylePrimitive:
    """A named effect. Handlers recognise it by identity."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"InitialStylePrimitive({self.name!r})"


def initial_style_primitive(name: str) -> InitialStylePrimitive:
    return InitialStylePrimitive(name)


def initial_style_bind(prim: InitialStylePrimitive, **params) -> Callable:
    """``initial_style_bind(prim, **params)(fn)(*args)``: the call
    ``fn(*args)``, served by the innermost handler of ``prim``.

    >>> double_p = initial_style_primitive("double")
    >>> initial_style_bind(double_p, tag="t")(lambda x: 2 * x)(4)
    8
    """

    def bind(fn: Callable) -> Callable:
        def wrapped(*args: Any) -> Any:
            h = innermost_serving(prim)
            if h is None:
                return fn(*args)
            return h.handle_primitive(prim, fn, args, params)

        return wrapped

    return bind

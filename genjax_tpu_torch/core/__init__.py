"""Substrate: pytree dataclasses, the effect-handler stack, change
tangents and their propagation, named effects and staging."""

from .changes import ChangeMode, changed_through
from .diff import Diff, NoChange, UnknownChange
from .environment import Environment
from .handlers import (
    AddressReuse,
    GenJAXError,
    MissingAddress,
    NotTracedError,
    StatefulHandler,
    TraceHandler,
    dispatch_trace,
    handle,
    stateful,
)
from .primitive import InitialStylePrimitive, initial_style_bind, initial_style_primitive
from .pytree import Closure, Const, Pytree, PythonicPytree, nth
from .staging import ShapeDtype, get_shaped_aval, stage, to_shape_fn
from .typing_ import Address, AddressComponent, R

__all__ = [
    "Address",
    "AddressComponent",
    "ChangeMode",
    "Environment",
    "InitialStylePrimitive",
    "PythonicPytree",
    "R",
    "ShapeDtype",
    "StatefulHandler",
    "changed_through",
    "get_shaped_aval",
    "initial_style_bind",
    "initial_style_primitive",
    "nth",
    "stage",
    "stateful",
    "to_shape_fn",
    "AddressReuse",
    "Closure",
    "Const",
    "Diff",
    "GenJAXError",
    "MissingAddress",
    "NoChange",
    "NotTracedError",
    "Pytree",
    "TraceHandler",
    "UnknownChange",
    "dispatch_trace",
    "handle",
]

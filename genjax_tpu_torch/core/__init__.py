"""Substrate: pytree dataclasses and the effect-handler stack."""

from .diff import Diff, NoChange, UnknownChange
from .handlers import (
    AddressReuse,
    GenJAXError,
    MissingAddress,
    NotTracedError,
    TraceHandler,
    dispatch_trace,
    handle,
)
from .pytree import Closure, Const, Pytree

__all__ = [
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

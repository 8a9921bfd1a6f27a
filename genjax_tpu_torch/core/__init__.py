"""Substrate: pytree dataclasses and the effect-handler stack."""

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
    "GenJAXError",
    "MissingAddress",
    "NotTracedError",
    "Pytree",
    "TraceHandler",
    "dispatch_trace",
    "handle",
]

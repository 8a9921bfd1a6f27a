"""The ``@gen`` modeling language."""

from .static_lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen

__all__ = ["StaticGenerativeFunction", "StaticRequest", "StaticTrace", "gen"]

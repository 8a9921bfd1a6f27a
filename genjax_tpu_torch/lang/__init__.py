"""The ``@gen`` modeling language."""

from .static_lang import StaticGenerativeFunction, StaticTrace, gen

__all__ = ["StaticGenerativeFunction", "StaticTrace", "gen"]

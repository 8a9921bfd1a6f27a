"""The ``@gen`` modeling language."""

from .static_lang import StaticGenerativeFunction, StaticRequest, StaticTrace, gen, trace

__all__ = ["StaticGenerativeFunction", "StaticRequest", "StaticTrace", "gen", "trace"]

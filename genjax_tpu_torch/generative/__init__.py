"""Generative core: GFI, traces, choice maps, selections, masks."""

from .choice_map import C, ChoiceMap, ChoiceMapNoValueAtAddress
from .concepts import Arguments, Score, Weight
from .gfi import GenerativeFunction, GenerativeFunctionClosure
from .mask import Mask
from .selection import S, Selection
from .trace import Trace

__all__ = [
    "Arguments",
    "C",
    "ChoiceMap",
    "ChoiceMapNoValueAtAddress",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "Mask",
    "S",
    "Score",
    "Selection",
    "Trace",
    "Weight",
]

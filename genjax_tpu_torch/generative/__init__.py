"""Generative core: GFI, traces, choice maps, selections, masks."""

from .choice_map import C, ChoiceMap, ChoiceMapNoValueAtAddress
from .concepts import (
    Arguments,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Score,
    Update,
    Weight,
)
from .gfi import GenerativeFunction, GenerativeFunctionClosure
from .mask import Mask
from .selection import S, Selection
from .trace import Trace

__all__ = [
    "Arguments",
    "C",
    "ChoiceMap",
    "ChoiceMapNoValueAtAddress",
    "DiffAnnotate",
    "EditRequest",
    "EmptyRequest",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "Mask",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "S",
    "Score",
    "Selection",
    "Trace",
    "Update",
    "Weight",
]

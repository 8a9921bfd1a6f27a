"""Generative core: GFI, traces, choice maps, selections, masks."""

from .choice_map import C, ChoiceMap, ChoiceMapNoValueAtAddress
from .concepts import (
    Arguments,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Score,
    Update,
    VectorRequest,
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
    "IndexRequest",
    "Mask",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "S",
    "Score",
    "Selection",
    "Trace",
    "Update",
    "VectorRequest",
    "Weight",
]

"""Generative core: GFI, traces, choice maps, selections, masks."""

from .choice_map import (
    C,
    ChoiceMap,
    ChoiceMapBuilder,
    ChoiceMapNoValueAtAddress,
    EmptyChm,
    IndexedChm,
    StaticChm,
    SwitchChm,
    ValueChm,
)
from .concepts import (
    Argdiffs,
    Arguments,
    DiffAnnotate,
    EditRequest,
    EmptyRequest,
    IndexRequest,
    NotSupportedEditRequest,
    PrimitiveEditRequest,
    Regenerate,
    Retdiff,
    Retval,
    Score,
    Update,
    VectorRequest,
    Weight,
)
from .gfi import GenerativeFunction, GenerativeFunctionClosure
from .mask import Mask
from .selection import AllSel, ChmSel, LeafSel, NoneSel, S, Selection, SelectionBuilder
from .trace import Trace

__all__ = [
    "AllSel",
    "Argdiffs",
    "Arguments",
    "C",
    "ChmSel",
    "ChoiceMap",
    "ChoiceMapBuilder",
    "ChoiceMapNoValueAtAddress",
    "DiffAnnotate",
    "EditRequest",
    "EmptyChm",
    "EmptyRequest",
    "GenerativeFunction",
    "GenerativeFunctionClosure",
    "IndexRequest",
    "IndexedChm",
    "LeafSel",
    "Mask",
    "NoneSel",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "Retdiff",
    "Retval",
    "S",
    "Score",
    "Selection",
    "SelectionBuilder",
    "StaticChm",
    "SwitchChm",
    "Trace",
    "Update",
    "ValueChm",
    "VectorRequest",
    "Weight",
]

# The reference's ``genjax_tpu.core`` names the generative types too; ``core``
# imports nothing above it, so they are set on it from here.
from .. import core as _core  # noqa: E402

for _name in _core._GENERATIVE_EXPORTS:
    setattr(_core, _name, globals()[_name])

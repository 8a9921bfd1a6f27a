"""Substrate: pytree dataclasses, the effect-handler stack, change
tangents and their propagation, named effects, staging and the PRNG keys
(``keys``). As the reference's ``genjax_tpu.core`` does, it also names the
generative types (``ChoiceMap``, ``Trace``, ``Selection``, ...), which
``generative`` sets here when it is imported."""

from .changes import ChangeMode, changed_through
from . import keys
from .diff import Argdiffs, Diff, NoChange, Retdiff, UnknownChange
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
from .pytree import Closure, Const, Pytree, PythonicPytree, nth, tree_const, tree_const_unwrap
from .staging import (
    FlagOp,
    ShapeDtype,
    empty_trace,
    get_shaped_aval,
    multi_switch,
    stage,
    staged_check,
    staged_choose,
    to_shape_fn,
    tree_choose,
)
from .typing_ import (
    Address,
    AddressComponent,
    Array,
    ArrayLike,
    BoolArray,
    Flag,
    FloatArray,
    IntArray,
    PRNGKey,
    R,
    ScalarFlag,
    ScalarInt,
    StaticAddress,
    static_check_is_concrete,
    static_check_supports_grad,
)

__all__ = [
    "Argdiffs",
    "Array",
    "ArrayLike",
    "BoolArray",
    "Flag",
    "FlagOp",
    "FloatArray",
    "IntArray",
    "PRNGKey",
    "Retdiff",
    "ScalarFlag",
    "ScalarInt",
    "StaticAddress",
    "empty_trace",
    "keys",
    "multi_switch",
    "static_check_is_concrete",
    "static_check_supports_grad",
    "staged_check",
    "staged_choose",
    "tree_choose",
    "tree_const",
    "tree_const_unwrap",
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

# The generative types, as the reference's ``genjax_tpu.core`` names them.
# ``core`` imports nothing above it, so ``generative`` sets them here when
# it is imported (which importing ``genjax_tpu_torch`` always does).
_GENERATIVE_EXPORTS = (
    "ChoiceMap",
    "ChoiceMapBuilder",
    "EditRequest",
    "EmptyRequest",
    "GenerativeFunction",
    "IndexRequest",
    "Mask",
    "NotSupportedEditRequest",
    "PrimitiveEditRequest",
    "Regenerate",
    "Selection",
    "SelectionBuilder",
    "Trace",
    "Update",
)

__all__ += list(_GENERATIVE_EXPORTS)

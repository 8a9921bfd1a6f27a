"""Type checks at the interface's boundary: the public facade of
``generative/typecheck.py``.

Counterpart of ``genjax_tpu/typecheck.py``.
"""

from .generative.typecheck import (
    GFITypeError,
    check_args,
    check_constraint,
    check_key,
    check_selection,
    install_import_hook,
)

__all__ = [
    "GFITypeError",
    "check_args",
    "check_constraint",
    "check_key",
    "check_selection",
    "install_import_hook",
]

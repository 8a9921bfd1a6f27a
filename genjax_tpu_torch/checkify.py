"""Optional runtime checks: the public facade of ``core/checkify.py``.

Counterpart of ``genjax_tpu/checkify.py``.
"""

from .core.checkify import (
    CheckError,
    check,
    checkify_enabled,
    constraint_validation_active,
    do_checkify,
    optional_check,
    suppress_constraint_validation,
)

__all__ = [
    "CheckError",
    "check",
    "checkify_enabled",
    "constraint_validation_active",
    "do_checkify",
    "optional_check",
    "suppress_constraint_validation",
]

"""Checkpoint and restore of inference state.

Counterpart of ``genjax_tpu/io/__init__.py``. Every framework object is a
pytree of tensors, so a state is saved as its flattened leaves and restored
into the structure of a template rebuilt from code.
"""

from .checkpoint import (
    check_meta_matches,
    load_increments,
    load_segment_state,
    restore_pytree,
    save_pytree,
    save_segment_state,
)

__all__ = [
    "check_meta_matches",
    "load_increments",
    "load_segment_state",
    "restore_pytree",
    "save_pytree",
    "save_segment_state",
]

"""Change tangents: the public facade of ``core/diff.py``.

Counterpart of ``genjax_tpu/incremental.py``.
"""

from .core.diff import Diff, NoChange, UnknownChange

__all__ = ["Diff", "NoChange", "UnknownChange"]

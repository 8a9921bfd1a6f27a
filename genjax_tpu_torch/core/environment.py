"""Values recorded by position.

Counterpart of ``genjax_tpu/core/environment.py``, which maps a jaxpr's
variables to their values while an interpreter walks it. The port has no
jaxpr: an ``Environment`` is keyed by a record point's position in a run (the
time-travel debugger numbers its record points as they fire), or by any
hashable key.
"""

from __future__ import annotations

from typing import Any


class Environment:
    """A mapping from keys (record points' positions) to values.

    >>> env = Environment()
    >>> env[0] = "x"
    >>> 0 in env, env.read(0), 1 in env.copy()
    (True, 'x', False)
    """

    def __init__(self):
        self.env: dict[Any, Any] = {}

    def read(self, key: Any) -> Any:
        return self.env[key]

    def write(self, key: Any, value: Any) -> Any:
        self.env[key] = value
        return value

    def __getitem__(self, key):
        return self.read(key)

    def __setitem__(self, key, value):
        self.write(key, value)

    def __contains__(self, key) -> bool:
        return key in self.env

    def copy(self) -> "Environment":
        new = Environment()
        new.env = self.env.copy()
        return new

"""The ``Trace`` abstract base: a record of one execution of a generative
function.

Counterpart of ``genjax_tpu/generative/trace.py``. ``get_score()`` is
``log P(choices; args)`` for exact-density generative functions. Edits of a
trace wait for the trace-path slice of the port.
"""

from __future__ import annotations

import abc
from typing import Any

from ..core.pytree import Pytree
from .concepts import Arguments, Score


class Trace(Pytree):
    @abc.abstractmethod
    def get_args(self) -> Arguments:
        ...

    @abc.abstractmethod
    def get_retval(self) -> Any:
        ...

    @abc.abstractmethod
    def get_score(self) -> Score:
        ...

    @abc.abstractmethod
    def get_choices(self) -> Any:
        """The addressed random choices as a ChoiceMap."""

    @abc.abstractmethod
    def get_gen_fn(self) -> Any:
        ...

    def __getitem__(self, addr):
        return self.get_choices()[addr]

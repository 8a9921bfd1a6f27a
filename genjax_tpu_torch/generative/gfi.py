"""``GenerativeFunction``: the Generative Function Interface (GFI).

Counterpart of ``genjax_tpu/generative/gfi.py`` with ``simulate``,
``assess`` and ``generate``.
Randomness comes from an explicit ``torch.Generator`` in place of a JAX key:
draws are made on the generator's device. ``edit``, ``update`` and
``project`` wait for the trace-path slice.
"""

from __future__ import annotations

import abc
from typing import Any

import torch

from ..core.handlers import dispatch_trace
from ..core.pytree import Pytree
from .choice_map import ChoiceMap
from .concepts import Arguments, Score, Weight
from .trace import Trace

_TRACE_PATH = (
    "edit/update/project are part of the trace-path slice of the port "
    "(ROADMAP queue 1: the HMC edit request, mh and run_chains_hmc)"
)


class GenerativeFunction(Pytree):
    """A probability measure over an addressed sample space, with the GFI
    ``simulate``/``assess``/``generate``."""

    @abc.abstractmethod
    def simulate(self, gen: torch.Generator, args: Arguments) -> Trace:
        """Sample ``choices ~ P(.; args)`` and return an execution trace."""

    @abc.abstractmethod
    def assess(self, chm: ChoiceMap, args: Arguments) -> tuple[Score, Any]:
        """Full-constraint density evaluation: ``(log P(chm; args), retval)``."""

    @abc.abstractmethod
    def generate(
        self, gen: torch.Generator, constraint: ChoiceMap, args: Arguments
    ) -> tuple[Trace, Weight]:
        """Importance sampling under partial constraints: a trace that agrees
        with ``constraint`` and the log weight of the constrained choices."""

    def edit(self, *args, **kwargs):
        raise NotImplementedError(_TRACE_PATH)

    def update(self, *args, **kwargs):
        raise NotImplementedError(_TRACE_PATH)

    def project(self, *args, **kwargs):
        raise NotImplementedError(_TRACE_PATH)

    def __call__(self, *args) -> "GenerativeFunctionClosure":
        return GenerativeFunctionClosure(self, args)

    def __matmul__(self, addr):
        """Support zero-argument models: ``model @ "x"``."""
        return GenerativeFunctionClosure(self, ()) @ addr


@Pytree.dataclass
class GenerativeFunctionClosure(Pytree):
    """Returned by ``gen_fn(*args)``: binds the call into an enclosing ``@gen``
    body via ``@ "addr"``."""

    gen_fn: GenerativeFunction
    args: tuple

    def __matmul__(self, addr):
        return dispatch_trace(addr, self.gen_fn, self.args)

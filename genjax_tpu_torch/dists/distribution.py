"""``Distribution``: generative functions over a single (unaddressed) choice.

Counterpart of ``genjax_tpu/dists/distribution.py``: the GFI of a primitive
distribution (``simulate``, ``assess``, ``generate`` under a full or absent
constraint), ``ExactDensity`` and the ``exact_density`` factory.
Draws come from the caller's ``torch.Generator`` on its device.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import torch

from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap, ValueChm
from ..generative.concepts import Score, Weight
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..generative.trace import Trace


@Pytree.dataclass
class DistributionTrace(Trace):
    gen_fn: "Distribution"
    args: tuple
    value: Any
    score: Score

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.value

    def get_score(self) -> Score:
        return self.score

    def get_gen_fn(self) -> "Distribution":
        return self.gen_fn

    def get_choices(self) -> ChoiceMap:
        return ValueChm(self.value)


class Distribution(GenerativeFunction):
    """Measure over a single choice, with (possibly estimated) densities.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> round(float(g.normal.logpdf(0.0, 0.0, 1.0)), 5)  # N(0,1) at 0
    -0.91894
    >>> tr = g.normal.simulate(torch.Generator().manual_seed(0), (0.0, 1.0))
    >>> bool(torch.isclose(tr.get_score(), g.normal.logpdf(tr.get_retval(), 0.0, 1.0)))
    True
    """

    @abc.abstractmethod
    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, Any]:
        """Sample ``v`` and return ``(log density-estimate at v, v)``."""

    @abc.abstractmethod
    def estimate_logpdf(self, gen: torch.Generator | None, v: Any, *args) -> Score:
        ...

    def simulate(self, gen: torch.Generator, args: tuple) -> DistributionTrace:
        score, v = self.random_weighted(gen, *args)
        return DistributionTrace(self, args, v, score)

    def assess(self, chm: ChoiceMap, args: tuple):
        raise NotImplementedError(
            "assess requires an exact density; use ExactDensity."
        )

    def generate(
        self, gen: torch.Generator, constraint: ChoiceMap, args: tuple
    ) -> tuple[DistributionTrace, Weight]:
        v = constraint.get_value()
        if v is None:
            tr = self.simulate(gen, args)
            return tr, torch.zeros((), device=gen.device)
        if isinstance(v, Mask):
            raise NotImplementedError(
                "generate under a masked constraint comes with the combinator "
                "slice of the port (ROADMAP queue 1, slice 3)"
            )
        w = self.estimate_logpdf(gen, v, *args)
        return DistributionTrace(self, args, v, w), w


class ExactDensity(Distribution):
    """A distribution with an exactly computable density: supplies ``sample``
    and ``logpdf``."""

    @abc.abstractmethod
    def sample(self, gen: torch.Generator, *args) -> Any:
        ...

    @abc.abstractmethod
    def logpdf(self, v: Any, *args) -> Score:
        ...

    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, Any]:
        v = self.sample(gen, *args)
        return self.logpdf(v, *args), v

    def estimate_logpdf(self, gen: torch.Generator | None, v: Any, *args) -> Score:
        return self.logpdf(v, *args)

    def assess(self, chm: ChoiceMap, args: tuple):
        v = chm.get_value()
        if isinstance(v, Mask):
            v = v.value
        return self.logpdf(v, *args), v


@Pytree.dataclass
class LambdaDensity(ExactDensity):
    """An ExactDensity from a sampler/logpdf function pair."""

    sampler: Callable = Pytree.static()
    logpdf_fn: Callable = Pytree.static()
    name: str = Pytree.static(default="exact_density")

    def sample(self, gen: torch.Generator, *args) -> Any:
        return self.sampler(gen, *args)

    def logpdf(self, v: Any, *args) -> Score:
        return self.logpdf_fn(v, *args)

    def __repr__(self):
        return f"genjax_tpu_torch.{self.name}"


def exact_density(
    sample: Callable, logpdf: Callable, name: str = "exact_density"
) -> LambdaDensity:
    """Build an ``ExactDensity`` from ``sample(gen, *args)`` and
    ``logpdf(v, *args)``."""
    return LambdaDensity(sample, logpdf, name)

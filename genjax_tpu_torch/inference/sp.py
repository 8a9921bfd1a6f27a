"""GenSP: posterior targets, stochastic-probability algorithms and marginal
distributions.

Counterpart of ``genjax_tpu/inference/sp.py``: ``Target``,
``SampleDistribution``, ``Algorithm``, ``Marginal`` and ``marginal``, on the
port's ``Distribution``. The contracts (Lew et al. 2023, "Probabilistic
programming with stochastic probabilities"): ``Algorithm.random_weighted(gen,
target)`` returns ``(w, S)`` with ``E[1/w | S] = 1 / P(S | constraint;
args)``; ``estimate_logpdf(gen, S, target)`` returns ``w`` with ``E[w] =
P(S | constraint; args)``. As distributions they run where their key or
generator lives: a key (``core/keys.py``) is split as the reference splits
it, and draws what the reference draws from the same key; one
``torch.Generator`` is drawn from in sequence where the reference splits a
key.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import torch

from ..core import keys
from ..core.pytree import Const, Pytree
from ..dists.distribution import Distribution
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import Score, Weight
from ..generative.gfi import GenerativeFunction, register_combinators
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device


@Pytree.dataclass
class Target(Pytree):
    """An unnormalised posterior: the generative function ``p`` at
    arguments ``args``, conditioned on ``constraint``."""

    p: GenerativeFunction
    args: tuple
    constraint: ChoiceMap

    def __post_init__(self):
        # the constraint's Python numbers become tensors, as a trace records
        # them: the latent choices a target filters out of a trace carry its
        # selection, and torch.func.vmap returns tensor leaves only
        device = lambda: trace_device((self.constraint, self.args)) or torch.device("cpu")  # noqa: E731
        object.__setattr__(self, "constraint", tensor_leaves(self.constraint, device))

    def importance(self, gen: torch.Generator, constraint: ChoiceMap) -> tuple[Trace, Weight]:
        """``generate`` under the target's constraint merged with
        ``constraint``."""
        return self.p.importance(gen, self.constraint.merge(constraint), self.args)

    def filter_to_unconstrained(self, choice_map: ChoiceMap) -> ChoiceMap:
        return choice_map.filter(~self.constraint.get_selection())

    def __getitem__(self, addr):
        return self.constraint[addr]


class SampleDistribution(Distribution):
    """A distribution whose value is a ``ChoiceMap``."""


class Algorithm(SampleDistribution):
    """An inference algorithm: a distribution over choice maps that
    approximates a ``Target``'s posterior, with unbiased density
    estimates."""

    @abc.abstractmethod
    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, ChoiceMap]:
        ...

    @abc.abstractmethod
    def estimate_logpdf(self, gen: torch.Generator, v: ChoiceMap, *args) -> Score:
        ...

    @abc.abstractmethod
    def estimate_normalizing_constant(self, gen, target: Target, **kw) -> Weight:
        ...

    @abc.abstractmethod
    def estimate_reciprocal_normalizing_constant(
        self, gen, target: Target, latent_choices: ChoiceMap, w: Weight, **kw
    ) -> Weight:
        ...


@Pytree.dataclass
class Marginal(SampleDistribution):
    """The marginal distribution of a generative function over a selection
    of its addresses, with density estimates by nested inference.
    ``selection`` and ``algorithm`` ride in ``Const`` wrappers."""

    gen_fn: GenerativeFunction
    selection: Any  # Const[Selection]
    algorithm: Any = None  # Const[Algorithm | None]

    def _selection(self) -> Selection:
        return self.selection.unwrap() if isinstance(self.selection, Const) else self.selection

    def _algorithm(self):
        return self.algorithm.unwrap() if isinstance(self.algorithm, Const) else self.algorithm

    def random_weighted(self, gen: torch.Generator, *args) -> tuple[Score, ChoiceMap]:
        selection = self._selection()
        gen, sim_gen, proj_gen = keys.split_stream(gen, 3)
        tr = self.gen_fn.simulate(sim_gen, args)
        choices = tr.get_choices()
        latent_choices = choices.filter(selection)
        # the density estimate of the latent sample: the full score less the
        # internal proposal density of the choices marginalised out (Lew
        # 2023, Defn 3.2), as the reference corrects its own reference
        weight = tr.get_score() - tr.project(proj_gen, ~selection)
        algorithm = self._algorithm()
        if algorithm is None:
            return weight, latent_choices
        target = Target(self.gen_fn, args, latent_choices)
        Z = algorithm.estimate_reciprocal_normalizing_constant(
            gen, target, choices.filter(~selection), weight, device=gen.device
        )
        return Z, latent_choices

    def estimate_logpdf(self, gen: torch.Generator, v: ChoiceMap, *args) -> Score:
        algorithm = self._algorithm()
        if algorithm is None:
            _, weight = self.gen_fn.importance(gen, v, args)
            return weight
        return algorithm.estimate_normalizing_constant(
            gen, Target(self.gen_fn, args, v), device=gen.device
        )


def marginal(
    selection: Selection | None = None,
    algorithm: Algorithm | None = None,
) -> Callable[[GenerativeFunction], Marginal]:
    """Decorator: ``marginal(selection)(gen_fn)``."""
    if selection is None:
        selection = Selection.all()

    def decorator(gen_fn: GenerativeFunction) -> Marginal:
        return Marginal(gen_fn, Const(selection), Const(algorithm))

    return decorator


def _postfix_marginal(gen_fn: GenerativeFunction, *, selection=None, algorithm=None) -> Marginal:
    return marginal(selection, algorithm)(gen_fn)


register_combinators(marginal=_postfix_marginal)

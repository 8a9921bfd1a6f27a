"""``GenerativeFunction``: the Generative Function Interface (GFI).

Counterpart of ``genjax_tpu/generative/gfi.py``: abstract ``simulate``,
``assess``, ``generate``, ``project`` and ``edit`` (SMCP3 semantics), the
derived ``update``, ``importance`` and ``propose``, and the closure that
``gen_fn(*args)`` returns. Randomness comes from an explicit
``torch.Generator`` in place of a JAX key: draws are made on the generator's
device. The postfix combinators (``vmap``, ``scan``, ``switch``, ``mask``,
``dimap`` and the rest) build the classes of ``combinators/``, a layer above
this one: that package fills this module's constructor table when it is
imported (``genjax_tpu_torch`` imports it), so no import points up.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.diff import Diff
from ..core.handlers import dispatch_trace
from ..core.pytree import Pytree
from .choice_map import ChoiceMap
from .concepts import Arguments, EditRequest, Retdiff, Score, Update, Weight
from .selection import Selection
from .trace import Trace, trace_device


_COMBINATORS: dict[str, Callable] = {}


def register_combinators(**constructors: Callable) -> None:
    """Fill the constructor table of the postfix methods
    (``combinators/__init__.py`` and, for ``marginal``, ``inference/sp.py``
    call this)."""
    _COMBINATORS.update(constructors)


def _combinator(name: str, package: str = "combinators") -> Callable:
    try:
        return _COMBINATORS[name]
    except KeyError:
        raise RuntimeError(
            f"GenerativeFunction.{name}: its constructor is not loaded; "
            f"import genjax_tpu_torch.{package} (importing genjax_tpu_torch does)"
        ) from None


def _identity_args(*args):
    return args


def _identity_post(_args, retval):
    return retval


class GenerativeFunction(Pytree):
    """A probability measure over an addressed sample space, with the GFI:
    ``simulate``, ``assess``, ``generate``, ``project``, ``edit`` and the
    derived ``update``, ``importance`` and ``propose``."""

    # ----- abstract GFI -----

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

    @abc.abstractmethod
    def project(self, gen: torch.Generator, trace: Trace, selection: Selection) -> Weight:
        """The log-density contribution of the selected choices."""

    @abc.abstractmethod
    def edit(
        self, gen: torch.Generator, trace: Trace, request: EditRequest, argdiffs: Any
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        """Serve a primitive edit request with SMCP3 weight accounting."""

    # ----- derived GFI -----

    def update(
        self, gen: torch.Generator, trace: Trace, constraint: ChoiceMap, argdiffs: Any = None
    ):
        if argdiffs is None:
            argdiffs = Diff.tree_diff_no_change(trace.get_args())
        new_tr, w, retdiff, bwd = self.edit(gen, trace, Update(constraint), argdiffs)
        discard = bwd.constraint if isinstance(bwd, Update) else bwd
        return new_tr, w, retdiff, discard

    def importance(
        self, gen: torch.Generator, constraint: ChoiceMap, args: Arguments
    ) -> tuple[Trace, Weight]:
        return self.generate(gen, constraint, args)

    def propose(self, gen: torch.Generator, args: Arguments):
        tr = self.simulate(gen, args)
        return tr.get_choices(), tr.get_score(), tr.get_retval()

    def get_zero_trace(self, *args) -> Trace:
        """A trace of the right structure and shapes with every tensor leaf
        zero: one ``simulate`` under a throwaway generator on the arguments'
        device (or the CPU), its leaves zeroed (torch has no abstract
        evaluation of shapes)."""
        tr = self.simulate(torch.Generator(device=trace_device(args) or "cpu").manual_seed(0), args)
        return pytree.tree_map(lambda v: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v, tr)

    # ----- postfix combinators -----

    def vmap(self, /, *, in_axes: Any = 0, axis_size: int | None = None):
        return _combinator("vmap")(self, in_axes=in_axes, axis_size=axis_size)

    def repeat(self, /, *, n: int):
        return _combinator("repeat")(n=n)(self)

    def scan(self, /, *, n: int | None = None):
        return _combinator("scan")(n=n)(self)

    def accumulate(self):
        return _combinator("accumulate")()(self)

    def reduce(self):
        return _combinator("reduce")()(self)

    def iterate(self, /, *, n: int):
        return _combinator("iterate")(n=n)(self)

    def iterate_final(self, /, *, n: int):
        return _combinator("iterate_final")(n=n)(self)

    def masked_iterate(self):
        return _combinator("masked_iterate")()(self)

    def masked_iterate_final(self):
        return _combinator("masked_iterate_final")()(self)

    def mask(self):
        return _combinator("mask")(self)

    def or_else(self, gen_fn: "GenerativeFunction"):
        return _combinator("or_else")(self, gen_fn)

    def switch(self, *branches: "GenerativeFunction"):
        return _combinator("switch")(self, *branches)

    def mix(self, *fns: "GenerativeFunction"):
        return _combinator("mix")(self, *fns)

    def dimap(self, /, *, pre: Callable = _identity_args, post: Callable = _identity_post,
              info: str | None = None):
        return _combinator("dimap")(pre=pre, post=post, info=info)(self)

    def map(self, f: Callable, *, info: str | None = None):
        return _combinator("map")(f, info=info)(self)

    def contramap(self, f: Callable, *, info: str | None = None):
        return _combinator("contramap")(f, info=info)(self)

    def marginal(self, /, *, selection: Any = None, algorithm: Any = None):
        """The marginal distribution over ``selection`` (``inference.sp.Marginal``)."""
        return _combinator("marginal", "inference")(self, selection=selection, algorithm=algorithm)

    # ----- call/closure syntax -----

    def __call__(self, *args, **kwargs) -> "GenerativeFunctionClosure":
        return GenerativeFunctionClosure(self, args, tuple(kwargs.items()))

    def __matmul__(self, addr):
        """Support zero-argument models: ``model @ "x"``."""
        return GenerativeFunctionClosure(self, (), ()) @ addr

    def handle_kwargs(self) -> "GenerativeFunction":
        """A generative function equivalent to this one that takes
        ``(args, kwargs_dict)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support keyword arguments."
        )


@Pytree.dataclass
class GenerativeFunctionClosure(Pytree):
    """Returned by ``gen_fn(*args)``: binds the call into an enclosing ``@gen``
    body via ``@ "addr"``, and forwards the GFI with the arguments applied."""

    gen_fn: GenerativeFunction
    args: tuple
    kwargs: tuple = ()  # (name, value) pairs

    def _resolved(self) -> tuple[GenerativeFunction, tuple]:
        if self.kwargs:
            return self.gen_fn.handle_kwargs(), (self.args, dict(self.kwargs))
        return self.gen_fn, self.args

    def __matmul__(self, addr):
        gen_fn, args = self._resolved()
        return dispatch_trace(addr, gen_fn, args)

    def simulate(self, gen: torch.Generator) -> Trace:
        gen_fn, args = self._resolved()
        return gen_fn.simulate(gen, args)

    def assess(self, chm: ChoiceMap) -> tuple[Score, Any]:
        gen_fn, args = self._resolved()
        return gen_fn.assess(chm, args)

    def generate(self, gen: torch.Generator, constraint: ChoiceMap):
        gen_fn, args = self._resolved()
        return gen_fn.generate(gen, constraint, args)

    def importance(self, gen: torch.Generator, constraint: ChoiceMap):
        gen_fn, args = self._resolved()
        return gen_fn.importance(gen, constraint, args)

    def propose(self, gen: torch.Generator):
        gen_fn, args = self._resolved()
        return gen_fn.propose(gen, args)

    def __call__(self, gen: torch.Generator):
        gen_fn, args = self._resolved()
        return gen_fn.simulate(gen, args).get_retval()

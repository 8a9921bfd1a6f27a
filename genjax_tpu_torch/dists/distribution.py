"""``Distribution``: generative functions over a single (unaddressed) choice.

Counterpart of ``genjax_tpu/dists/distribution.py``: the GFI of a primitive
distribution (``simulate``, ``assess``, ``generate``, ``project`` and the
``Update`` and ``Regenerate`` edits, under a full or absent constraint and a
concrete selection), ``ExactDensity``, the keyword-argument adaptor and the
``exact_density`` factory. Draws come from the caller's key (as the
reference's draw from the same key) or ``torch.Generator``, on its device. A constraint ``Mask``-wrapped under a tensor flag, and a
selection whose ``check()`` is a tensor, are served lane by lane as the
reference's ``lax.cond`` is under ``vmap``: both sides are computed and
``torch.where`` selects.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

import torch

from ..core.checkify import check, constraint_validation_active, optional_check
from ..core.diff import Diff
from ..core.handlers import active_handler
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap, ChoiceMapInvalidAddress, ValueChm, exists_flag
from ..generative.concepts import (
    EditRequest,
    NotSupportedEditRequest,
    Regenerate,
    Retdiff,
    Score,
    Update,
    Weight,
)
from ..generative.gfi import GenerativeFunction
from ..core.staging import FlagOp
from ..generative.mask import Mask
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves
from ..generative.typecheck import GFITypeError


def _select_value(flag, new, old):
    """``new`` where ``flag`` holds, else ``old``, in a dtype both fit (an
    integer observation may constrain a boolean draw)."""
    new, old = torch.as_tensor(new), torch.as_tensor(old)
    dtype = torch.promote_types(new.dtype, old.dtype)
    return FlagOp.where(flag, new.to(dtype), old.to(dtype))


@Pytree.dataclass
class DistributionTrace(Trace):
    gen_fn: "Distribution"
    args: tuple
    value: Any
    score: Score

    def __post_init__(self):
        # a recorded trace holds tensor leaves only (``tensor_leaves``)
        device = self.score.device if isinstance(self.score, torch.Tensor) else None
        object.__setattr__(self, "args", tensor_leaves(self.args, device))
        object.__setattr__(self, "value", tensor_leaves(self.value, device))

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
            if (
                constraint_validation_active()
                and active_handler() is None
                and FlagOp.concrete_true(exists_flag(constraint))
            ):
                raise ChoiceMapInvalidAddress(
                    "generate: a distribution takes a value constraint at the root, "
                    f"got sub-addressed entries: {constraint}"
                )
            tr = self.simulate(gen, args)
            return tr, torch.zeros((), device=gen.device)
        if isinstance(v, Mask):
            # the constrained lanes score the constraint, the others draw
            _score, fresh = self.random_weighted(gen, *args)
            value = _select_value(v.flag, v.value, fresh)
            score = self.estimate_logpdf(gen, value, *args)
            return DistributionTrace(self, args, value, score), FlagOp.where(
                v.flag, score, torch.zeros_like(score)
            )
        # a constraint's Python number is made a tensor where the generator
        # lives, so a draw whose arguments are numbers too scores there
        v = tensor_leaves(v, gen.device)
        w = self.estimate_logpdf(gen, v, *args)
        return DistributionTrace(self, args, v, w), w

    def project(self, gen: torch.Generator | None, trace: Trace, selection: Selection) -> Weight:
        score = trace.get_score()
        return FlagOp.where(selection.check(), score, torch.zeros_like(score))

    # ----- edits -----

    def edit(
        self, gen: torch.Generator, trace: Trace, request: EditRequest, argdiffs: Any
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if isinstance(request, Update):
            return self._edit_update(gen, trace, request.constraint, argdiffs)
        if isinstance(request, Regenerate):
            return self._edit_regenerate(gen, trace, request.selection, argdiffs)
        raise NotSupportedEditRequest(
            f"{type(self).__name__} cannot serve {type(request).__name__}."
        )

    def _edit_update(self, gen, trace, constraint: ChoiceMap, argdiffs):
        primals = Diff.tree_primal(argdiffs)
        v = constraint.get_value()
        old_choices = trace.get_choices()
        if v is None:
            old_v = old_choices.get_value()
            fwd = self.estimate_logpdf(gen, old_v, *primals)
            new_tr = DistributionTrace(self, primals, old_v, fwd)
            return new_tr, fwd - trace.get_score(), Diff.no_change(old_v), Update(ChoiceMap.empty())
        if isinstance(v, Mask):
            new_v = _select_value(v.flag, v.value, old_choices.get_value())
            fwd = self.estimate_logpdf(gen, new_v, *primals)
            return (
                DistributionTrace(self, primals, new_v, fwd),
                fwd - trace.get_score(),
                Diff.unknown_change(new_v),
                Update(old_choices.mask(v.flag)),
            )
        fwd = self.estimate_logpdf(gen, v, *primals)
        new_tr = DistributionTrace(self, primals, v, fwd)
        return new_tr, fwd - trace.get_score(), Diff.unknown_change(new_tr.value), Update(old_choices)

    def _edit_regenerate(self, gen, trace, selection: Selection, argdiffs):
        check = selection.check()
        primals = Diff.tree_primal(argdiffs)
        if FlagOp.concrete_true(check):
            score, new_v = self.random_weighted(gen, *primals)
            new_tr = DistributionTrace(self, primals, new_v, score)
            return (
                new_tr,
                score - trace.get_score(),
                Diff.unknown_change(new_v),
                Update(ValueChm(trace.get_retval())),
            )
        if FlagOp.concrete_false(check):
            if Diff.static_check_no_change(argdiffs):
                return (
                    trace,
                    torch.zeros_like(trace.get_score()),
                    Diff.no_change(trace.get_retval()),
                    Update(ChoiceMap.empty()),
                )
            old_v = trace.get_choices().get_value()
            new_score = self.estimate_logpdf(gen, old_v, *primals)
            return (
                DistributionTrace(self, primals, old_v, new_score),
                new_score - trace.get_score(),
                Diff.no_change(trace.get_retval()),
                Update(ChoiceMap.empty()),
            )
        # a tensor flag: the selected lanes draw afresh, the others keep
        old_v = trace.get_choices().get_value()
        _score, fresh = self.random_weighted(gen, *primals)
        new_v = _select_value(check, fresh, old_v)
        score = self.estimate_logpdf(gen, new_v, *primals)
        return (
            DistributionTrace(self, primals, new_v, score),
            score - trace.get_score(),
            Diff.unknown_change(new_v),
            Update(ValueChm(old_v).mask(check)),
        )

    def handle_kwargs(self) -> GenerativeFunction:
        return KwargsDistribution(self)


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
            optional_check(lambda: check(v.flag, "assess: masked constraint with invalid flag"))
            v = v.value
        return self.logpdf(v, *args), v


@Pytree.dataclass
class KwargsDistribution(Distribution):
    """Keyword-argument adaptor: args are ``(positional_args, kwargs_dict)``."""

    inner: Distribution

    def _exact(self) -> ExactDensity:
        if not isinstance(self.inner, ExactDensity):
            raise NotImplementedError("kwargs on non-exact distributions")
        return self.inner

    def random_weighted(self, gen, *args):
        (pos, kw) = args
        v = self._exact().sample(gen, *pos, **kw)
        return self.inner.logpdf(v, *pos, **kw), v

    def estimate_logpdf(self, gen, v, *args):
        (pos, kw) = args
        return self._exact().logpdf(v, *pos, **kw)

    def assess(self, chm, args):
        (pos, kw) = args
        v = chm.get_value()
        if isinstance(v, Mask):
            v = v.value
        return self._exact().logpdf(v, *pos, **kw), v


@Pytree.dataclass
class LambdaDensity(ExactDensity):
    """An ExactDensity from a sampler/logpdf function pair."""

    sampler: Callable = Pytree.static()
    logpdf_fn: Callable = Pytree.static()
    name: str = Pytree.static(default="exact_density")

    def sample(self, gen: torch.Generator, *args, **kwargs) -> Any:
        return self.sampler(gen, *args, **kwargs)

    def logpdf(self, v: Any, *args, **kwargs) -> Score:
        return self.logpdf_fn(v, *args, **kwargs)

    def __repr__(self):
        return f"genjax_tpu_torch.{self.name}"


def torch_distribution(dist_ctor, name: str = "torch_distribution") -> LambdaDensity:
    """An ``ExactDensity`` over a ``torch.distributions`` constructor: the
    counterpart of the reference's ``tfp_distribution``.

    ``torch.distributions`` samplers take no generator and draw from torch's
    global streams, so the draw is made a function of the caller's
    generator: one int64 is drawn from it and seeds the default generator of
    the generator's device (and the CPU's) under ``torch.random.fork_rng``,
    which restores the global streams afterwards. Reading that seed is a
    host read, so this sampler does not run under ``torch.func.vmap``. The
    log-density sums over any axes ``log_prob`` leaves.
    """

    def sampler(gen: torch.Generator, *args, sample_shape=(), **kwargs):
        if not isinstance(gen, torch.Generator):
            raise GFITypeError(
                f"{name}: a torch.distributions sampler does not draw under a key; pass a torch.Generator"
            )
        seed = int(torch.randint(0, 2**63 - 1, (), generator=gen, device=gen.device))
        cuda = [gen.device] if gen.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.random.default_generator.manual_seed(seed)
            if cuda:
                torch.cuda.default_generators[gen.device.index or 0].manual_seed(seed)
            return dist_ctor(*args, **kwargs).sample(torch.Size(sample_shape))

    def logpdf(v, *args, sample_shape=(), **kwargs):
        lp = dist_ctor(*args, **kwargs).log_prob(torch.as_tensor(v))
        return torch.sum(lp) if lp.dim() else lp

    return LambdaDensity(sampler, logpdf, name)


def exact_density(
    sample: Callable, logpdf: Callable, name: str = "exact_density"
) -> LambdaDensity:
    """Build an ``ExactDensity`` from ``sample(gen, *args)`` and
    ``logpdf(v, *args)``."""
    return LambdaDensity(sample, logpdf, name)

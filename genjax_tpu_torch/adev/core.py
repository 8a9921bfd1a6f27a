"""ADEV core: forward-mode AD through probabilistic programs, where each
sampling primitive carries its own unbiased gradient-estimation strategy.

Counterpart of ``genjax_tpu/adev/core.py`` (Lew, Huot, Staton and
Mansinghka 2023, "ADEV: Sound Automatic Differentiation of Expected
Values"): ``Dual``, ``ADEVPrimitive``, ``TailCallADEVPrimitive``,
``BatchedTailCallPrimitive``, ``sample_primitive``, ``transform_forward``,
``ADEVProgram``, ``Expectation`` and ``@expectation``.

The reference stages the loss to a jaxpr and a CPS interpreter hands each
``sample_p`` site its pure and dual continuations. Torch has no jaxpr, so
the transform here runs the program itself, with an ``_ADEVRun`` handler
on the port's handler stack (``core/handlers.py``) that every
``sample_primitive`` call reaches, from however deep inside the GFI it is
made. Outside a transform ``sample_primitive`` just samples.

A dual number is a tensor whose derivative is its tangent: the transform
runs under ``torch.func.jvp`` (``jvp_estimate``) or ``torch.func.grad``
(``grad_estimate``), and a strategy's estimator is written with
``detach()`` as the stop-gradient, so that the program's value carries the
estimator's derivative in either mode. REINFORCE, for example, turns the
continuation's value ``r`` into ``r + r.detach() * (lp - lp.detach())``:
the same primal, and the tangent ``dr + r dlp``. ``grad_estimate`` is then
one reverse pass over the one forward run: the transpose of the linear map
``jvp_estimate`` computes.

The transform draws from one stream, a key (``core/keys.py``) or a
``torch.Generator``; the stream is the one thing that differs between the
two. Under a key the handler carries the key as it stands at each site, as
the reference's interpreter does: a tail call splits it into the draw's key
and the continuation's, ``REINFORCE`` into the continuation's and the
draw's, and a strategy that runs its continuation hands it the key it
chooses (``kdual(k, v)``). So the port draws the reference's draws. A
generator is drawn from in sequence.

The continuation is the rest of the program, which Python cannot capture.
Strategies that call it once (the tail calls, ``REINFORCE`` and
``add_cost``) run inline: ``inline_estimate`` returns the site's value, a
map that turns the continuation's value into the site's estimate (applied
on the way out) and the continuation's stream. Strategies that call it
more than once (the enumerations, ``flip_mvd``, a ``baseline`` around
them) end the run: their ``kdual(k, v)`` and ``kpure(k, v)`` run the
program again from the start, where ``v`` is forced at the site. Under a
key the prefix makes the same draws again, since a draw is a function of
its key, and the continuation starts from ``k``. Under a generator every
generator is rewound so that the prefix makes the same draws, and the
continuation draws from a stream forked at the site (both continuations of
one site draw the same numbers, as the reference hands both the same key);
``k`` is not used. Generators that the program closes over (the model's
randomness in the VI losses) are named in ``streams=`` and rewound with
the transform's own.

The reference's pure continuation (``kpure``, reached through ``flip_mvd``
and a ``baseline`` around it) draws each later site under ``fold_in(key,
i)``, ``i`` the site's equation index in its staged program, which the port
has no program to count. Under a key a pure continuation that reaches a
later site raises ``GFITypeError``; one that reaches none draws nothing and
is the reference's.

Under ``torch.func.vmap`` begun inside the program (the particles of
``ImportanceK``), a tail-call draw keeps its strategy
(``BatchedTailCallPrimitive``); any other strategy raises
``NotImplementedError``, as the reference's batching rule does. Under a key
lane ``i`` draws under ``split(k, lanes)[i]`` of the site's draw key ``k``,
as the reference's does.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.handlers import NotTracedError, TraceHandler, handle, innermost_handler
from ..core.pytree import Pytree
from ..generative.typecheck import GFITypeError, check_generator


@Pytree.dataclass
class Dual(Pytree):
    """A (primal, tangent) pair: the input and output of
    ``Expectation.jvp_estimate``."""

    primal: Any
    tangent: Any

    @staticmethod
    def _is(v) -> bool:
        return isinstance(v, Dual)

    @staticmethod
    def tree_pure(v):
        """Wrap every non-Dual leaf with a zero tangent."""
        return pytree.tree_map(
            lambda x: x if isinstance(x, Dual) else Dual(x, torch.zeros_like(torch.as_tensor(x))),
            v,
            is_leaf=Dual._is,
        )

    @staticmethod
    def dual_tree(primals, tangents):
        return pytree.tree_map(Dual, primals, tangents)

    @staticmethod
    def tree_primal(v):
        return pytree.tree_map(lambda x: x.primal if isinstance(x, Dual) else x, v, is_leaf=Dual._is)

    @staticmethod
    def tree_tangent(v):
        return pytree.tree_map(lambda x: x.tangent if isinstance(x, Dual) else x, v, is_leaf=Dual._is)

    @staticmethod
    def tree_leaves(v):
        return pytree.tree_leaves(Dual.tree_pure(v), is_leaf=Dual._is)

    @staticmethod
    def tree_unzip(v):
        return tuple(pytree.tree_leaves(Dual.tree_primal(v))), tuple(pytree.tree_leaves(Dual.tree_tangent(v)))

    @staticmethod
    def static_check_dual_tree(v) -> bool:
        return all(isinstance(leaf, Dual) for leaf in pytree.tree_leaves(v, is_leaf=Dual._is))


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------


class ADEVPrimitive(Pytree):
    """A sampler paired with a gradient-estimation strategy. Each method
    draws from ``stream``, a key or a ``torch.Generator``.

    ``jvp_estimate(stream, dual_tree, (kpure, kdual))`` estimates the
    derivative of ``E[continuation(sample)]``: ``dual_tree`` is the tuple of
    the primitive's arguments as dual tensors, ``kdual(k, v)`` is the rest
    of the program's dual value from the value ``v`` at this site, its draws
    starting from the key ``k`` (a generator's strategy passes its
    generator), and ``kpure(k, v)`` its primal value alone. A strategy that
    calls its continuation exactly once gives ``inline_estimate`` instead,
    which lets the transform run it without running the program again.
    """

    def sample(self, stream, *args) -> Any:
        raise NotImplementedError

    def jvp_estimate(self, stream, dual_tree: tuple, konts: tuple[Callable, Callable]):
        inline = self.inline_estimate(stream, dual_tree)
        if inline is None:
            raise NotImplementedError(f"{type(self).__name__} gives no gradient strategy")
        value, post, cont = inline
        _, kdual = konts
        out = kdual(cont, value)
        return out if post is None else post(out)

    def inline_estimate(self, stream, dual_tree: tuple):
        """``(value, post, cont)`` for a strategy that calls its continuation
        once with ``value``, from the stream ``cont``, and makes its
        estimate ``post(r)`` of that call's result ``r`` (``post`` None:
        ``r`` itself); None for a strategy that needs its continuation as a
        function."""
        return None

    def __call__(self, *args, gen=None):
        return sample_primitive(self, *args, gen=gen)

    def pure_sample(self, stream, *args) -> Any:
        """The draw of a PURE continuation (no tangents)."""
        return self.sample(stream, *args)

    def pure_cost(self, *args):
        """This primitive's additive contribution to the value of a PURE
        continuation: None except for ``AddCost``, whose effect would
        otherwise reach only the dual path and be dropped from the
        alternative-sample evaluations of enumeration and MVD."""
        return None


class TailCallADEVPrimitive(ADEVPrimitive):
    """A strategy that needs no continuation (reparameterization): it makes
    the site's dual value and tail-calls ``kdual`` with it. A key is split
    into the draw's key and the continuation's."""

    def before_tail_call(self, stream, dual_tree: tuple):
        raise NotImplementedError

    def inline_estimate(self, stream, dual_tree):
        self_stream, cont = keys.split_stream(stream)
        return self.before_tail_call(self_stream, dual_tree), None, cont


def _lane_keys(k: torch.Tensor) -> torch.Tensor:
    """``split(k, lanes)`` as the lanes' own keys, batched at the
    ``torch.func.vmap`` running now (``lanes`` its batch size): lane ``i``
    reads the ``i``-th."""
    from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter

    vm = retrieve_current_functorch_interpreter()
    return torch._C._functorch._add_batch_dim(keys.split(k, vm.batch_size()), 0, vm.level())


@Pytree.dataclass
class BatchedTailCallPrimitive(TailCallADEVPrimitive):
    """A tail-call draw met under a ``torch.func.vmap`` begun inside the
    program (a vmap over particles), whose strategy is kept. Under a key
    lane ``i`` draws under ``split(k, lanes)[i]`` of the draw key ``k``, as
    the reference's batched primitive does; a generator's draws and dual
    values are made per lane by that vmap (``randomness="different"``).
    Strategies that need their continuation cannot be batched."""

    inner: TailCallADEVPrimitive

    def sample(self, stream, *args):
        return self.inner.sample(stream, *args)

    def before_tail_call(self, stream, dual_tree):
        if keys.is_key(stream):
            stream = _lane_keys(stream)
        return self.inner.before_tail_call(stream, dual_tree)


# ----------------------------------------------------------------------
# the sample intrinsic
# ----------------------------------------------------------------------


_DTYPES = {bool: torch.bool, int: torch.int64, float: torch.float32}


def _as_tensor(x, device):
    """A Python number as a tensor filled on ``device``; anything else as
    it is."""
    if type(x) in _DTYPES:
        return torch.full((), x, dtype=_DTYPES[type(x)], device=device)
    return x


def _tensor_args(args, device):
    return pytree.tree_map(lambda x: _as_tensor(x, device), args)


def sample_primitive(adev_prim: ADEVPrimitive, *args, gen=None):
    """A draw of ``adev_prim``: under an ADEV transform the primitive's
    strategy runs on the transform's stream (``gen`` is not used, as the
    reference's interpreter does not use the key a site carries); outside
    one it samples from ``gen``, a key or a generator."""
    run = innermost_handler(_ADEVRun)
    if run is not None:
        return run.site(adev_prim, args)
    if gen is None:
        raise ValueError(
            f"a {type(adev_prim).__name__} draw outside an ADEV transform needs a key or a generator (gen=)"
        )
    return adev_prim.sample(gen, *_tensor_args(args, gen.device))


# ----------------------------------------------------------------------
# the transform
# ----------------------------------------------------------------------


def _level() -> int:
    """The depth of ``torch.func`` transforms running now."""
    level = torch._C._functorch.maybe_current_level()
    return 0 if level is None else level


def derived_seed(gen: torch.Generator, salt: bytes) -> int:
    """A 63-bit seed that is a function of ``gen``'s state and ``salt``; no
    draw is made and nothing waits on the card. A generator's alone: a key
    raises ``GFITypeError`` (split a key with ``keys.split``)."""
    check_generator(gen, "derived_seed")
    # through a list: under torch.func transforms the state tensor refuses
    # .numpy()
    state = bytes(gen.get_state().tolist())
    digest = hashlib.blake2b(state + salt, digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def fork(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device for a second stream, seeded from
    ``gen``'s state, which then moves on (the port's ``jax.random.split``
    where a function of the key must not read it). A generator's alone: a
    key raises ``GFITypeError`` (split a key with ``keys.split``)."""
    check_generator(gen, "fork")
    child = torch.Generator(device=gen.device).manual_seed(derived_seed(gen, b"fork"))
    gen.manual_seed(derived_seed(gen, b"next"))
    return child


class _Ended(Exception):
    """A run ended at a site whose strategy ran the continuation itself."""

    def __init__(self, run, value):
        super().__init__()
        self.run = run
        self.value = value


class _Transform:
    """One estimate: the program, its dual arguments and its stream, a key
    or a generator (with the generators the program closes over)."""

    def __init__(self, source: Callable, args: tuple, stream, streams: tuple):
        self.source = source
        self.args = args
        self.stream = stream
        self.keyed = keys.is_key(stream)
        self.device = stream.device
        self.gens = streams if self.keyed else (stream, *streams)
        self.states = [g.get_state() for g in self.gens]
        self.reruns = 0

    def estimate(self):
        out = self.run(())
        if self.reruns and not self.keyed:
            # the runs rewound the transform's stream: move it past them all
            self.stream.set_state(self.states[0])
            self.stream.manual_seed(derived_seed(self.stream, b"after"))
        return out

    def run(self, forced: tuple, *, pure: bool = False):
        """A run of the program with the values of ``forced``, ``(site,
        value, stream)`` triples, at their sites; the last is where the run
        starts to estimate (or, ``pure``, to sample)."""
        if forced:
            self.reruns += 1
            for g, s in zip(self.gens, self.states):
                g.set_state(s)
        h = _ADEVRun(self, forced, pure)
        try:
            with handle(h):
                out = self.source(*self.args)
            out = _as_tensor(out, self.device)
        except _Ended as e:
            if e.run is not h:
                raise
            out = e.value
        for post in reversed(h.posts):
            out = post(out)
        return out.detach() if pure else out

    def batched(self, prim: ADEVPrimitive, base_level: int) -> "BatchedTailCallPrimitive":
        """``prim`` met under a vmap that the program began, in a run that
        began at ``base_level``."""
        if not isinstance(prim, TailCallADEVPrimitive):
            raise NotImplementedError(
                f"ADEV: vmap over a {type(prim).__name__} draw: only reparameterization-style "
                "(tail-call) strategies support batching. Restructure enumeration/REINFORCE "
                "draws outside the vmap, or use a *_reparam primitive."
            )
        if self.keyed:
            from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter

            vm = retrieve_current_functorch_interpreter()
            if _level() != base_level + 1 or not hasattr(vm, "batch_size"):
                raise GFITypeError(
                    f"ADEV: a {type(prim).__name__} draw under a key inside a transform other than one "
                    "torch.func.vmap begun by the program is not reproduced here; pass a torch.Generator"
                )
        return BatchedTailCallPrimitive(prim)


class _ADEVRun(TraceHandler):
    """One run of the program: sites before the run's start replay the
    draws of the run that spawned it, the start site takes its forced value,
    and later sites run their strategies (or, in a PURE run, just sample).
    Under a key the handler holds the key as it stands at the next site."""

    def __init__(self, transform: _Transform, forced: tuple, pure: bool):
        self.t = transform
        self.forced = {j: (v, cont) for j, v, cont in forced}
        self.forced_items = forced
        self.start = forced[-1][0] if forced else -1
        self.pure = pure
        self.key = transform.stream if transform.keyed else None
        # a run of a continuation that a strategy maps over its branches
        # (under a key) begins inside that map
        self.base_level = _level()
        self.count = 0
        self.posts: list[Callable] = []

    def handle_trace(self, addr, gen_fn, args):
        raise NotTracedError(
            f"Address binding {addr!r} executed directly in an ADEV program; addressed "
            "calls run inside a generative function's GFI method."
        )

    def site(self, prim: ADEVPrimitive, args: tuple):
        j = self.count
        self.count += 1
        t = self.t
        if j in self.forced:
            value, cont = self.forced[j]
            if t.keyed:
                self.key = cont
            elif j == self.start:
                t.stream.manual_seed(cont)
            return value
        stream = self.key if t.keyed else t.stream
        args = _tensor_args(args, t.device)
        if self.pure and j > self.start:
            if t.keyed:
                raise GFITypeError(
                    f"ADEV: under a key, a pure continuation (flip_mvd's other branch) that reaches a later "
                    f"draw (a {type(prim).__name__}) is not reproduced here (the reference draws it under "
                    "fold_in(key, i), i its equation index in a staged program); pass a torch.Generator"
                )
            cost = prim.pure_cost(*args)
            if cost is not None:
                self.posts.append(lambda r, c=cost: r + c)
            return prim.pure_sample(stream, *args)
        if _level() > self.base_level:
            prim = t.batched(prim, self.base_level)
        inline = prim.inline_estimate(stream, args)
        if inline is not None:
            value, post, cont = inline
            # the prefix (j < start) makes the draws of the run that spawned
            # this one, whose sites before this run's start all ran inline (a
            # run ends at its first site that needs its continuation)
            if post is not None and j > self.start:
                self.posts.append(post)
            if t.keyed:
                self.key = cont
            return value
        child = None if t.keyed else derived_seed(t.stream, b"continuation")

        def forcing(k, v):
            return self.forced_items + ((j, v, k if t.keyed else child),)

        def kdual(k, v):
            return t.run(forcing(k, v))

        def kpure(k, v):
            return t.run(forcing(k, v), pure=True)

        raise _Ended(self, prim.jvp_estimate(stream, args, (kpure, kdual)))


def _tensorize(tree, device):
    """The Python numbers of ``tree`` as float32 tensors filled on
    ``device``: the arguments a transform differentiates."""
    return pytree.tree_map(
        lambda x: torch.full((), x, dtype=torch.float32, device=device) if type(x) in (int, float) else x,
        tree,
    )


def transform_forward(f: Callable, kont: Callable = lambda d: d) -> Callable:
    """The ADEV forward-mode transform: ``g(stream, dual_tree, streams=())
    -> kont(Dual)``, the dual value of ``f`` at the duals in ``dual_tree``
    (a tuple of ``f``'s arguments), drawn under ``stream``, a key or a
    generator."""

    def transformed(gen, dual_tree, streams: tuple = ()):
        dual_tree = Dual.tree_pure(_tensorize(dual_tree, gen.device))
        primals, tangents = Dual.tree_primal(dual_tree), Dual.tree_tangent(dual_tree)
        p, t = torch.func.jvp(
            lambda args: _Transform(f, tuple(args), gen, streams).estimate(), (primals,), (tangents,)
        )
        return kont(Dual(p, t))

    return transformed


# ----------------------------------------------------------------------
# programs and expectations
# ----------------------------------------------------------------------


@Pytree.dataclass
class ADEVProgram(Pytree):
    source: Callable = Pytree.static()

    def jvp_estimate(self, gen, dual_tree, dual_kont=lambda d: d, streams: tuple = ()):
        return transform_forward(self.source, dual_kont)(gen, dual_tree, streams)


@Pytree.dataclass
class Expectation(Pytree):
    """An expected-value objective ``E[source(*args)]`` with unbiased
    forward and reverse gradient estimators. Each method draws from
    ``gen``, a key (the reference's draws) or a ``torch.Generator``;
    ``streams=`` names the generators the program closes over, which every
    run of the program starts from the same state."""

    prog: ADEVProgram

    def jvp_estimate(self, gen, dual_tree, *, streams: tuple = ()) -> Dual:
        return self.prog.jvp_estimate(gen, dual_tree, streams=streams)

    def estimate(self, gen, args: tuple, *, streams: tuple = ()):
        args = _tensorize(tuple(args), gen.device)
        return _Transform(self.prog.source, args, gen, streams).estimate().detach()

    def grad_estimate(self, gen, primals: tuple, *, streams: tuple = ()):
        """An unbiased estimate of the gradient of ``E[source(*primals)]``,
        shaped as ``primals``: one reverse pass over the transformed run."""
        primals = _tensorize(tuple(primals), gen.device)
        return torch.func.grad(lambda args: _Transform(self.prog.source, tuple(args), gen, streams).estimate())(
            primals
        )


def expectation(source: Callable) -> Expectation:
    """Decorator: a probabilistic loss program becomes an ``Expectation``.

    ``grad_estimate`` returns an unbiased gradient of the expected value,
    exact under enumeration estimators:

    >>> import torch
    >>> from genjax_tpu_torch.adev import expectation, flip_enum
    >>> @expectation
    ... def obj(p):
    ...     b = flip_enum(p)
    ...     return torch.where(b, 1.0, 0.0)
    >>> (dp,) = obj.grad_estimate(torch.Generator().manual_seed(0), (0.3,))
    >>> float(dp)   # E[obj] = p, so d/dp = 1 exactly
    1.0
    """
    return Expectation(ADEVProgram(source))

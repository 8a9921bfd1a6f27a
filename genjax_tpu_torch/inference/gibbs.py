"""Enumerative Gibbs moves for discrete addresses, and a cyclic sweep
driver for composing Gibbs-within-MH kernels.

Counterpart of ``genjax_tpu/inference/gibbs.py``. The ``Update`` weight of
a fully determined constraint at a discrete address is the joint-density
ratio ``log p(c, rest) - log p(cur, rest)``, so a categorical draw over the
enumerated weights is the exact full conditional ``p(addr = c | rest)``: a
Gibbs move, accepted with probability 1. The support enumeration is one
``torch.func.vmap`` over candidates; the per-lane variant vmaps (lane x
candidate) ``IndexRequest`` edits, block Gibbs since the lanes of a
``Vmap`` combinator are conditionally independent given everything outside
it. A sweep is a Python loop over sweeps, where the reference runs
``lax.scan``. Under a key (``core/keys.py``) every function splits it as
the reference does (a move into its enumeration, draw and edit keys, a
sweep into a key a sweep and that into a key a move), so the moves draw
the reference's draws; a ``torch.Generator`` is drawn from in sequence,
and moves run under ``torch.func.vmap(..., randomness="different")`` over
chains.

If changing the discrete value flips a ``Switch`` branch so that new
addresses are sampled, the ``Update`` weight includes proposal terms and the
move is no longer an exact conditional: use ``mh_move`` there.

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     z = g.flip(0.5) @ "z"
...     _ = g.normal(torch.where(z, 1.0, -1.0), 1.0) @ "x"
>>> gen = torch.Generator().manual_seed(0)
>>> tr, _ = model.generate(gen, g.C["x"].set(0.0), ())
>>> _, info = enumerative_gibbs(gen, tr, "z", torch.tensor([False, True]))
>>> torch.exp(info.log_probs)
tensor([0.5000, 0.5000])
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.pytree import Pytree
from ..dists import categorical
from ..generative.choice_map import C, ChoiceMap
from ..generative.concepts import EditRequest, IndexRequest, Update
from ..generative.trace import Trace, trace_device
from ..lang.static_lang import StaticRequest


@Pytree.dataclass
class GibbsInfo(Pytree):
    """Diagnostics of one enumerative move: the sampled support index (per
    lane for the vmap variant) and the enumerated conditional
    log-probabilities."""

    index: Any
    log_probs: Any


def _set_path(path: tuple, value) -> ChoiceMap:
    """``C[*path].set(value)``; the empty path is a bare distribution's
    constraint."""
    return C[path].set(value) if path else ChoiceMap.entry(value)


def _request_for(site, value) -> EditRequest:
    if callable(site):
        return site(value)
    return Update(_set_path(site if isinstance(site, tuple) else (site,), value))


def _support_on(support, trace: Trace):
    dev = trace_device(trace)
    return pytree.tree_map(lambda s: torch.as_tensor(s, device=dev), support)


def _take(support, idx):
    return pytree.tree_map(lambda s: s[idx], support)


def enumerative_gibbs(gen: torch.Generator, trace: Trace, site, support) -> tuple[Trace, GibbsInfo]:
    """Exact Gibbs at one discrete address: enumerate ``support``, draw from
    the full conditional, apply the chosen value.

    ``site`` is an address (str or tuple path) or a callable ``value ->
    EditRequest``; ``support`` a tensor (or a pytree with a leading candidate
    axis) of candidate values."""
    support = _support_on(support, trace)
    k_enum, k_cat, k_apply = keys.split_stream(gen, 3)

    def weight_of(c):
        return trace.edit(k_enum, _request_for(site, c))[1]

    log_w = torch.func.vmap(weight_of, randomness="different")(support)
    idx = categorical.sample(k_cat, log_w)
    new_trace = trace.edit(k_apply, _request_for(site, _take(support, idx)))[0]
    return new_trace, GibbsInfo(index=idx, log_probs=torch.log_softmax(log_w, dim=-1))


def _lane_count(trace: Trace, prefix: tuple, postfix: tuple) -> int:
    cur = trace.get_choices()
    for a in prefix:
        cur = cur.get_submap(a)
    probe = cur[(slice(None),) + postfix] if postfix else cur[:]
    return int(pytree.tree_leaves(probe)[0].shape[0])


def enumerative_gibbs_vmap(
    gen: torch.Generator,
    trace: Trace,
    site: tuple,
    support,
    n_lanes: int | None = None,
    lane_batch: int | None = None,
) -> tuple[Trace, GibbsInfo]:
    """Block Gibbs over every lane of a ``Vmap``-combinator site.

    ``site`` is the address path to the per-lane choice with exactly one
    ``None`` marking the lane axis, e.g. ``("assign", None, "z")`` (or
    ``(None,)`` when the trace's own generative function is the vmap of a
    bare distribution). Every lane's full conditional is enumerated against
    the same base trace, then all lanes' draws are applied in one
    ``Update``.

    Cost: ``n_lanes x K`` one-lane edits in one vmapped program, with as
    many trace copies in flight. ``lane_batch`` bounds them: lanes go
    ``lane_batch`` at a time, in a Python loop, with the same conditionals
    and the same draws as the whole batch."""
    if site.count(None) != 1:
        raise ValueError(f"site must contain exactly one None marking the lane axis; got {site!r}")
    lane_pos = site.index(None)
    prefix, postfix = site[:lane_pos], site[lane_pos + 1:]
    support = _support_on(support, trace)
    if n_lanes is None:
        n_lanes = _lane_count(trace, prefix, postfix)
    k_enum, k_cat, k_apply = keys.split_stream(gen, 3)

    def lane_request(i, c) -> EditRequest:
        req: EditRequest = IndexRequest(i, Update(_set_path(postfix, c)))
        for a in reversed(prefix):
            req = StaticRequest.d({a: req})
        return req

    def lane_weights(i):
        return torch.func.vmap(lambda c: trace.edit(k_enum, lane_request(i, c))[1], randomness="different")(support)

    lanes = torch.arange(n_lanes, device=trace_device(trace))
    batch = n_lanes if lane_batch is None else max(1, min(lane_batch, n_lanes))
    log_w = torch.cat([torch.func.vmap(lane_weights, randomness="different")(lanes[s:s + batch])
                       for s in range(0, n_lanes, batch)])
    idx = categorical.sample(k_cat, log_w)
    new_trace = trace.edit(k_apply, Update(C[prefix + (lanes,) + postfix].set(_take(support, idx))))[0]
    return new_trace, GibbsInfo(index=idx, log_probs=torch.log_softmax(log_w, dim=-1))


def enum_move(site, support) -> Callable:
    """A sweep move: exact enumerative Gibbs at ``site``."""

    def move(gen: torch.Generator, trace: Trace) -> Trace:
        return enumerative_gibbs(gen, trace, site, support)[0]

    return move


def enum_vmap_move(site: tuple, support, n_lanes: int | None = None, lane_batch: int | None = None) -> Callable:
    """A sweep move: per-lane block Gibbs at a vmapped ``site``."""

    def move(gen: torch.Generator, trace: Trace) -> Trace:
        return enumerative_gibbs_vmap(gen, trace, site, support, n_lanes=n_lanes, lane_batch=lane_batch)[0]

    return move


def mh_move(request) -> Callable:
    """A sweep move: one MH-accepted edit (``HMC`` on a continuous block, a
    ``Selection`` or ``Regenerate`` for structure-changing discrete
    sites)."""

    def move(gen: torch.Generator, trace: Trace) -> Trace:
        from .mcmc import mh

        return mh(gen, trace, request)[0]

    return move


@Pytree.dataclass
class GibbsSweepResult(Pytree):
    """The final trace and the per-sweep records (leading axis
    ``n_sweeps``; None without ``record``)."""

    trace: Trace
    history: Any


def gibbs_sweep(
    gen: torch.Generator,
    trace: Trace,
    moves: Sequence[Callable],
    n_sweeps: int = 1,
    *,
    record: Callable[[Trace], Any] | None = None,
) -> GibbsSweepResult:
    """Cycle ``moves`` (each ``(gen, trace) -> trace``) for ``n_sweeps``, the
    deterministic-scan Gibbs kernel, where the trace lives. Build moves with
    ``enum_move``, ``enum_vmap_move``, ``mh_move`` or
    ``involutive.involutive_move``; ``record(trace)`` is kept after every
    sweep. A key is split into a key a sweep and each of those into a key a
    move, as the reference's scan splits it."""
    moves = tuple(moves)
    history = []
    for k in keys.split_stream(gen, n_sweeps):
        for mv, mk in zip(moves, keys.split_stream(k, len(moves))):
            trace = mv(mk, trace)
        if record is not None:
            history.append(record(trace))
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs), *history) if history else None
    return GibbsSweepResult(trace=trace, history=stacked)

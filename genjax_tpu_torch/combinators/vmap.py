"""``Vmap`` combinator: broadcast a generative function over a batch axis.

Counterpart of ``genjax_tpu/combinators/vmap.py``: ``VmapTrace``,
``VmapCombinator`` (``simulate``, ``generate``, ``assess``, ``project``, and
the edits ``_edit_choice_map``, ``_edit_regenerate``, ``_edit_vector`` and
``_edit_index``) and the ``vmap`` decorator. The batch runs as one
``torch.func.vmap`` with ``randomness="different"``, over the lane index
and the arguments' leaves along ``in_axes`` (an int, None, or a prefix
tree of them); the batched inner trace is one trace whose leaves carry the
lane axis in front. Lane ``i`` reads ``constraint.get_submap(i)``, where
``i`` is a tensor under the vmap, so its values come ``Mask``-wrapped; a
dense constraint (``C[:, "x"]``) whose leaves all carry the lane axis is
handed to the lanes along that axis instead, with no mask.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.diff import Diff
from ..core.pytree import Pytree, none_free
from ..generative.choice_map import ChoiceMap, IndexedChm
from ..generative.concepts import (
    EditRequest,
    IndexRequest,
    NotSupportedEditRequest,
    Regenerate,
    Retdiff,
    Update,
    VectorRequest,
    Weight,
    dispatch_edit,
)
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..generative.trace import Trace, tensor_leaves, trace_device


def _score_of(tr: Trace) -> torch.Tensor:
    return tr.get_score()


def stacked_score(inner: Trace) -> torch.Tensor:
    """The sum over the leading axis of a stacked trace's scores."""
    return torch.func.vmap(_score_of)(inner).sum(0)


def put(v: torch.Tensor, idx, s: torch.Tensor) -> torch.Tensor:
    """``v`` with slice ``idx`` of its leading axis replaced by ``s``, out of
    place. A tensor ``idx`` selects with ``torch.where`` over the axis,
    which has a batching rule where a per-lane scatter has none."""
    s = torch.as_tensor(s, device=v.device).to(v.dtype)
    if isinstance(idx, int):
        return torch.cat((v[:idx], s.unsqueeze(0), v[idx + 1 :]))
    hit = torch.arange(v.shape[0], device=v.device) == idx
    return torch.where(hit.reshape((-1,) + (1,) * (v.ndim - 1)), s.unsqueeze(0), v)


def _leaf_axes(axes: Any, tree: Any) -> list:
    """One axis (or None) for each leaf of ``tree``, from ``axes``: an int or
    None for a whole subtree, or a tuple, list or dict prefix of ``tree``."""
    if tree is None:
        return []
    if axes is None or isinstance(axes, int):
        return [axes] * len(pytree.tree_leaves(none_free(tree)))
    if isinstance(axes, (tuple, list)) and isinstance(tree, (tuple, list)) and len(axes) == len(tree):
        return [a for ax, sub in zip(axes, tree) for a in _leaf_axes(ax, sub)]
    if isinstance(axes, dict) and isinstance(tree, dict) and axes.keys() == tree.keys():
        return [a for k in tree for a in _leaf_axes(axes[k], tree[k])]
    raise ValueError(f"vmap: in_axes {axes!r} is not a prefix of the arguments' structure")


def _dense_lanes(constraint: ChoiceMap, n: int):
    """A dense constraint whose every leaf carries the lane axis: its inner
    map, handed to the lanes along axis 0. Else None."""
    if not isinstance(constraint, IndexedChm) or constraint.idx is not None:
        return None
    leaves = pytree.tree_leaves(constraint.inner)
    if leaves and all(isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == n for v in leaves):
        return constraint.inner
    return None


@Pytree.dataclass
class VmapTrace(Trace):
    """Trace of a vmapped generative function: one inner trace with the lane
    axis in front of every leaf."""

    gen_fn: "VmapCombinator"
    inner: Trace
    args: tuple
    n: int = Pytree.static()

    def __post_init__(self):
        object.__setattr__(self, "args", tensor_leaves(self.args, lambda: trace_device(self.inner)))

    def get_args(self) -> tuple:
        return self.args

    def get_retval(self) -> Any:
        return self.inner.get_retval()

    def get_gen_fn(self) -> "VmapCombinator":
        return self.gen_fn

    def get_score(self):
        return stacked_score(self.inner)

    def get_choices(self) -> ChoiceMap:
        return IndexedChm.build(self.inner.get_choices(), None)

    def get_inner_trace(self, address) -> Trace:
        return pytree.tree_map(lambda v: v[address], self.inner)


@Pytree.dataclass
class VmapCombinator(GenerativeFunction):
    """``gen_fn`` broadcast over a leading batch axis of its arguments."""

    gen_fn: GenerativeFunction
    in_axes: Any = Pytree.static(default=0)
    axis_size: int | None = Pytree.static(default=None)

    def _axis_size(self, tree) -> int:
        leaves = pytree.tree_leaves(none_free(tree))
        sizes = {
            int(torch.as_tensor(leaf).shape[ax])
            for ax, leaf in zip(_leaf_axes(self.in_axes, tree), leaves)
            if ax is not None
        }
        if self.axis_size is not None:
            sizes.add(self.axis_size)
        if len(sizes) > 1:
            raise ValueError(
                f"vmap: inconsistent batch axis sizes {sorted(sizes)}; check in_axes/axis_size."
            )
        if not sizes:
            raise ValueError(
                "vmap: could not infer the batch axis size — all in_axes are None and no "
                "axis_size was given."
            )
        return next(iter(sizes))

    def _map(self, fn: Callable, tree: Any, extras: tuple, extra_dims: tuple):
        """``fn(*extras_lane, lane_of_tree)`` over the lanes: one
        ``torch.func.vmap``, with the lane index first among ``extras``."""
        leaves, spec = pytree.tree_flatten(none_free(tree))
        axes = _leaf_axes(self.in_axes, tree)
        k = len(extras)

        def body(*xs):
            # a lane's None (a body that returns nothing) is no vmap output
            return none_free(fn(*xs[:k], pytree.tree_unflatten(list(xs[k:]), spec)))

        return torch.func.vmap(body, in_dims=(*extra_dims, *axes), randomness="different")(
            *extras, *leaves
        )

    @staticmethod
    def _lanes(n: int, device) -> torch.Tensor:
        return torch.arange(n, device=device)

    # ----- GFI -----

    def simulate(self, gen: torch.Generator, args: tuple) -> VmapTrace:
        n = self._axis_size(args)
        inner = self._map(
            lambda _i, a: self.gen_fn.simulate(gen, a), args, (self._lanes(n, gen.device),), (0,)
        )
        return VmapTrace(self, inner, args, n)

    def _with_constraint(self, fn, constraint: ChoiceMap, tree, n: int, device):
        """``fn(lane_constraint, lane_of_tree)`` over the lanes."""
        dense = _dense_lanes(constraint, n)
        if dense is not None:
            return self._map(fn, tree, (dense,), (0,))
        return self._map(
            lambda i, a: fn(constraint.get_submap(i), a), tree, (self._lanes(n, device),), (0,)
        )

    def generate(self, gen: torch.Generator, constraint: ChoiceMap, args: tuple):
        n = self._axis_size(args)
        inner, ws = self._with_constraint(
            lambda chm, a: self.gen_fn.generate(gen, chm, a), constraint, args, n, gen.device
        )
        return VmapTrace(self, inner, args, n), ws.sum(0)

    def assess(self, chm: ChoiceMap, args: tuple):
        n = self._axis_size(args)
        scores, retvals = self._with_constraint(
            lambda c, a: self.gen_fn.assess(c, a), chm, args, n, trace_device((chm, args))
        )
        return scores.sum(0), retvals

    def project(self, gen: torch.Generator, trace: VmapTrace, selection: Selection) -> Weight:
        lanes = self._lanes(trace.n, trace_device(trace.inner))
        ws = torch.func.vmap(
            lambda i, tr: self.gen_fn.project(gen, tr, selection.get_subselection(i)),
            randomness="different",
        )(lanes, trace.inner)
        return ws.sum(0)

    # ----- edits -----

    def edit(
        self, gen: torch.Generator, trace: VmapTrace, request: EditRequest, argdiffs: Any
    ) -> tuple[VmapTrace, Weight, Retdiff, EditRequest]:
        if isinstance(request, Update):
            return self._edit_choice_map(gen, trace, request.constraint, argdiffs)
        if isinstance(request, Regenerate):
            return self._edit_regenerate(gen, trace, request.selection, argdiffs)
        if isinstance(request, IndexRequest):
            return self._edit_index(gen, trace, request.index, request.request, argdiffs)
        if isinstance(request, VectorRequest):
            return self._edit_vector(gen, trace, request.request, argdiffs)
        raise NotSupportedEditRequest(f"VmapCombinator cannot serve {type(request).__name__}.")

    def _lane_edits(self, gen, trace: VmapTrace, argdiffs, edit_one, per_lane, per_lane_dim):
        """``edit_one(per_lane_item, lane_trace, lane_argdiffs)`` over the
        lanes, and the new trace, total weight, retdiff and backward request."""
        def body(x, sub_tr, ad):
            new_tr, w, _rd, bwd = edit_one(x, sub_tr, ad)
            return new_tr, w, bwd

        new_inner, ws, bwds = self._map(body, argdiffs, (per_lane, trace.inner), (per_lane_dim, 0))
        new_tr = VmapTrace(self, new_inner, Diff.tree_primal(argdiffs), trace.n)
        return new_tr, ws.sum(0), Diff.tree_diff_unknown_change(new_tr.get_retval()), _lossless_bwd(bwds)

    def _edit_choice_map(self, gen, trace: VmapTrace, constraint: ChoiceMap, argdiffs):
        dense = _dense_lanes(constraint, trace.n)
        if dense is not None:
            return self._lane_edits(
                gen, trace, argdiffs,
                lambda chm, tr, ad: self.gen_fn.edit(gen, tr, Update(chm), ad), dense, 0,
            )
        return self._lane_edits(
            gen, trace, argdiffs,
            lambda i, tr, ad: self.gen_fn.edit(gen, tr, Update(constraint.get_submap(i)), ad),
            self._lanes(trace.n, trace_device(trace.inner)), 0,
        )

    def _edit_regenerate(self, gen, trace: VmapTrace, selection: Selection, argdiffs):
        return self._lane_edits(
            gen, trace, argdiffs,
            lambda i, tr, ad: self.gen_fn.edit(gen, tr, Regenerate(selection.get_subselection(i)), ad),
            self._lanes(trace.n, trace_device(trace.inner)), 0,
        )

    def _edit_vector(self, gen, trace: VmapTrace, per_lane: EditRequest, argdiffs):
        """A per-lane request pytree, every leaf batched on axis 0."""
        if isinstance(per_lane, tuple):
            raise NotSupportedEditRequest("VmapCombinator serves a stacked VectorRequest only.")
        return self._lane_edits(
            gen, trace, argdiffs,
            lambda req, tr, ad: dispatch_edit(self.gen_fn, gen, tr, req, ad), per_lane, 0,
        )

    def _edit_index(self, gen, trace: VmapTrace, idx, request: EditRequest, argdiffs):
        """One lane's edit: slice the lane, edit it, put it back; the kernel
        runs once, whatever the lane count."""
        if not Diff.static_check_no_change(argdiffs):
            raise NotSupportedEditRequest("IndexRequest into Vmap requires unchanged arguments.")
        slice_tr = pytree.tree_map(lambda v: v[idx], trace.inner)
        new_slice, w, _rd, bwd = dispatch_edit(
            self.gen_fn, gen, slice_tr, request, Diff.tree_diff_no_change(slice_tr.get_args())
        )
        new_inner = pytree.tree_map(lambda v, s: put(v, idx, s), trace.inner, new_slice)
        new_tr = VmapTrace(self, new_inner, trace.args, trace.n)
        return new_tr, w, Diff.tree_diff_unknown_change(new_tr.get_retval()), IndexRequest(idx, bwd)


def _lossless_bwd(bwds) -> EditRequest:
    """The lanes' backward requests: Updates make the usual dense discard,
    anything else rides per lane."""
    if isinstance(bwds, Update):
        return Update(IndexedChm.build(bwds.constraint, None))
    return VectorRequest(bwds)


def vmap(*, in_axes: Any = 0, axis_size: int | None = None):
    """Decorator form: ``vmap(in_axes=...)(gen_fn)``. One batched execution;
    choices index by lane first:

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> @g.vmap(in_axes=(0,))
    ... @g.gen
    ... def batched(mu):
    ...     return g.normal(mu, 1.0) @ "x"
    >>> tr = batched.simulate(torch.Generator().manual_seed(0), (torch.zeros(3),))
    >>> tuple(tr.get_choices()[1, "x"].shape)
    ()
    >>> tuple(tr.get_retval().shape)
    (3,)
    """

    def decorator(gen_fn: GenerativeFunction) -> VmapCombinator:
        return VmapCombinator(gen_fn, in_axes=in_axes, axis_size=axis_size)

    return decorator

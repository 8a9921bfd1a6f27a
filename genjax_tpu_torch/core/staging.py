"""The flag algebra and index selection over concrete or tensor values.

Counterpart of the flag and switch half of ``genjax_tpu/core/staging.py``
(``FlagOp``, ``staged_choose``, ``tree_choose``, ``multi_switch``). As in
the reference, only a Python ``bool`` (a flag) or ``int`` (an index) is
concrete: the concrete cases short-circuit to plain Python and touch no
tensor. Every tensor is "traced": it may differ between the lanes of a
``torch.func.vmap``, so it is never read to the host, and a choice made on
it runs both sides and selects with ``torch.where``. That is what
``lax.cond`` and ``lax.switch`` lower to under ``vmap``, and the only form
valid under ``torch.func.vmap``.

The staging half (``stage``, ``to_shape_fn``, ``get_shaped_aval``) is public
API and nothing on the edit path uses it: the port's incremental edit
follows changes on running ops (``core/changes.py``) and stages no program.
``stage`` gives a ``torch.fx`` graph of a call, from ``make_fx``, the
counterpart of ``make_jaxpr``; ``to_shape_fn`` evaluates a function on
``device="meta"`` tensors, which carry shapes and dtypes and no data, where
the reference uses ``eval_shape``. ``cached_stage_dynamic``, which caches the
staged body of an edit, has no counterpart, since no edit stages.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import torch
import torch.utils._pytree as pytree

Flag = Any  # bool | torch.Tensor of dtype bool


class ShapeDtype(NamedTuple):
    """A value's shape and dtype, with no data: the counterpart of
    ``jax.ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype


def get_shaped_aval(x: Any) -> ShapeDtype:
    """The shape and dtype of ``x`` (a tensor, a numpy array or a number).

    >>> get_shaped_aval(torch.zeros(2, 3))
    ShapeDtype(shape=(2, 3), dtype=torch.float32)
    """
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return ShapeDtype(tuple(t.shape), t.dtype)


def _meta(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, ShapeDtype):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def to_shape_fn(fn: Callable, fill: Callable | None = None) -> Callable:
    """``fn`` evaluated for shapes alone: its tensor arguments (and any
    ``ShapeDtype``) become ``device="meta"`` tensors, and each tensor it
    returns becomes a ``ShapeDtype``, or ``fill(shape, dtype)`` with ``fill``
    (``torch.zeros``, say).

    >>> to_shape_fn(lambda a: (a @ a.T, a.sum()))(torch.ones(4, 2))
    (ShapeDtype(shape=(4, 4), dtype=torch.float32), ShapeDtype(shape=(), dtype=torch.float32))
    """

    def wrapped(*args, **kwargs):
        out = fn(*pytree.tree_map(_meta, args), **pytree.tree_map(_meta, kwargs))

        def leaf(v):
            if not isinstance(v, torch.Tensor):
                return v
            return ShapeDtype(tuple(v.shape), v.dtype) if fill is None else fill(tuple(v.shape), dtype=v.dtype)

        return pytree.tree_map(leaf, out)

    return wrapped


def stage(fn: Callable, **make_fx_kwargs) -> Callable:
    """``stage(fn)(*args)`` returns ``(graph, (flat_args, in_tree,
    out_tree))``: a ``torch.fx`` graph of ``fn`` on the flat tensor leaves
    of ``args`` (``make_fx``), and the trees that fold them back.

    >>> graph, (flat, in_tree, out_tree) = stage(lambda a, b: {"s": a + b})(torch.ones(2), torch.ones(2))
    >>> [n.target.__name__ for n in graph.graph.nodes if n.op == "call_function"]
    ['add.Tensor']
    >>> pytree.tree_unflatten(graph(*flat), out_tree)["s"].tolist()
    [2.0, 2.0]
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    def wrapped(*args):
        flat_args, in_tree = pytree.tree_flatten(args)
        out_tree: list = []

        def flat_fn(*flat):
            out_leaves, spec = pytree.tree_flatten(fn(*pytree.tree_unflatten(list(flat), in_tree)))
            out_tree.append(spec)
            return out_leaves

        graph = make_fx(flat_fn, **make_fx_kwargs)(*flat_args)
        return graph, (flat_args, in_tree, out_tree[0])

    return wrapped


def _broadcast_flag(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``flag`` with trailing unit axes, so that its shape, a prefix of
    ``x``'s, broadcasts against it."""
    return flag.reshape(tuple(flag.shape) + (1,) * (x.ndim - flag.ndim))


def _where_leaf(flag, a, b):
    if _nothing((a, b), "FlagOp.where"):
        return None
    a = torch.as_tensor(a)
    device = a.device if a.device.type != "cpu" else torch.as_tensor(b).device
    a = a.to(device)
    b = torch.as_tensor(b, device=device)
    dtype = torch.promote_types(a.dtype, b.dtype)
    f = _broadcast_flag(torch.as_tensor(flag, device=device), a if a.ndim >= b.ndim else b)
    return torch.where(f, a.to(dtype), b.to(dtype))


class FlagOp:
    """Boolean algebra over flags that are Python bools (concrete) or bool
    tensors whose shape is a prefix of the values they govern."""

    @staticmethod
    def is_concrete(f: Flag) -> bool:
        return isinstance(f, bool)

    @staticmethod
    def concrete_true(f: Flag) -> bool:
        return f is True

    @staticmethod
    def concrete_false(f: Flag) -> bool:
        return f is False

    @staticmethod
    def and_(f: Flag, g: Flag) -> Flag:
        if f is False or g is False:
            return False
        if f is True:
            return g
        if g is True:
            return f
        return torch.logical_and(f, g)

    @staticmethod
    def or_(f: Flag, g: Flag) -> Flag:
        if f is True or g is True:
            return True
        if f is False:
            return g
        if g is False:
            return f
        return torch.logical_or(f, g)

    @staticmethod
    def xor_(f: Flag, g: Flag) -> Flag:
        if FlagOp.is_concrete(f) and FlagOp.is_concrete(g):
            return f != g
        return torch.logical_xor(torch.as_tensor(f), torch.as_tensor(g))

    @staticmethod
    def not_(f: Flag) -> Flag:
        return (not f) if FlagOp.is_concrete(f) else torch.logical_not(f)

    @staticmethod
    def where(f: Flag, tv: Any, fv: Any) -> Any:
        """``tv`` where ``f`` holds, else ``fv``, leaf by leaf; a concrete
        ``f`` returns one side untouched."""
        if f is True:
            return tv
        if f is False:
            return fv
        return pytree.tree_map(lambda a, b: _where_leaf(f, a, b), tv, fv)


def _nothing(vs: Sequence[Any], what: str) -> bool:
    """Whether every value of ``vs`` is ``None``: a position that holds
    nothing in every tree (JAX's pytree takes ``None`` for an empty tree,
    torch's for a leaf), whose choice is ``None``. Where only some values
    are ``None`` the trees differ in structure, and that raises."""
    nones = [v is None for v in vs]
    if all(nones):
        return True
    if any(nones):
        raise ValueError(
            f"{what}: the values to choose between differ in structure: some are None "
            "and some are not, so no choice between them is defined"
        )
    return False


def staged_check(v: Flag) -> bool:
    """True only for a concretely true flag (``True``, not a tensor)."""
    return FlagOp.concrete_true(v)


def empty_trace(gen_fn, args: tuple) -> Any:
    """A trace of ``gen_fn`` at ``args`` with the right shapes and dtypes and
    every tensor zero: ``simulate`` run on ``device="meta"`` tensors, which
    compute nothing, under a key (``core/keys.py``)."""
    from .keys import key

    return to_shape_fn(gen_fn.simulate, torch.zeros)(key(0, device="cpu"), args)


def is_concrete_index(idx) -> bool:
    """A Python int (not a bool) is a concrete index; a tensor is not."""
    return isinstance(idx, int) and not isinstance(idx, bool)


def staged_choose(idx, vs: Sequence[Any]):
    """``vs[idx]`` for scalar or tensor values: a concrete ``idx`` indexes
    the list; a tensor ``idx`` (clipped into range, as ``lax.select_n``
    does) selects elementwise. Where every value is ``None`` the choice
    is ``None``; where only some are, it raises."""
    if is_concrete_index(idx):
        return vs[idx]
    if _nothing(vs, "staged_choose"):
        return None
    arrs = [torch.as_tensor(v) for v in vs]
    device = next((a.device for a in arrs if a.device.type != "cpu"), torch.as_tensor(idx).device)
    dtype = arrs[0].dtype
    for a in arrs[1:]:
        dtype = torch.promote_types(dtype, a.dtype)
    arrs = [a.to(device=device, dtype=dtype) for a in arrs]
    i = torch.clamp(torch.as_tensor(idx, device=device), 0, len(arrs) - 1)
    out = arrs[-1]
    for k in range(len(arrs) - 2, -1, -1):
        out = torch.where(_broadcast_flag(i == k, out), arrs[k], out)
    return out


def tree_choose(idx, trees: Sequence[Any]):
    """Select ``trees[idx]`` over structurally matching trees: a concrete
    index returns the tree with no tensor work, a tensor index selects each
    leaf with ``torch.where``. A position that is ``None`` in every tree is
    ``None`` in the choice (a branch that returns nothing, or a ``None``
    field); one that is ``None`` in some trees only raises."""
    if is_concrete_index(idx):
        return trees[idx]
    return pytree.tree_map(lambda *leaves: staged_choose(idx, leaves), *trees)


def multi_switch(idx, fns: Sequence[Callable], operands: Sequence[tuple]) -> list:
    """``lax.switch`` over branches whose outputs may differ in structure.

    Returns one entry for each branch. A concrete ``idx`` runs only that
    branch and leaves ``None`` in the other entries. A tensor ``idx`` runs
    every branch on its own operands and returns every output: each lane
    then picks its branch's with ``tree_choose``. The reference zero-pads the
    slots of the branches ``lax.switch`` did not run; here every branch ran,
    so every slot holds that branch's real output (which lanes of it count
    is the index's business), and the generator's stream differs from a
    single branch's.
    """
    if is_concrete_index(idx):
        out: list = [None] * len(fns)
        out[idx] = fns[idx](*operands[idx])
        return out
    return [fn(*ops) for fn, ops in zip(fns, operands)]

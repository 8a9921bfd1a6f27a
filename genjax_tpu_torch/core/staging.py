"""The flag algebra and index selection over concrete or tensor values.

Counterpart of the flag and switch half of ``genjax_tpu/core/staging.py``
(``FlagOp``, ``staged_choose``, ``tree_choose``, ``multi_switch``). As in
the reference, only a Python ``bool`` (a flag) or ``int`` (an index) is
concrete: the concrete cases short-circuit to plain Python and touch no
tensor. Every tensor is "traced": it may differ between the lanes of a
``torch.func.vmap``, so it is never read to the host, and a choice made on
it runs both sides and selects with ``torch.where``. That is what
``lax.cond`` and ``lax.switch`` lower to under ``vmap``, and the only form
valid under ``torch.func.vmap``. The jaxpr half of the reference module
(``stage``, ``cached_stage_dynamic``, ``empty_trace``) has no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

Flag = Any  # bool | torch.Tensor of dtype bool


def _broadcast_flag(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``flag`` with trailing unit axes, so that its shape, a prefix of
    ``x``'s, broadcasts against it."""
    return flag.reshape(tuple(flag.shape) + (1,) * (x.ndim - flag.ndim))


def _where_leaf(flag, a, b):
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


def is_concrete_index(idx) -> bool:
    """A Python int (not a bool) is a concrete index; a tensor is not."""
    return isinstance(idx, int) and not isinstance(idx, bool)


def staged_choose(idx, vs: Sequence[Any]):
    """``vs[idx]`` for scalar or tensor values: a concrete ``idx`` indexes
    the list; a tensor ``idx`` (clipped into range, as ``lax.select_n``
    does) selects elementwise."""
    if is_concrete_index(idx):
        return vs[idx]
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
    leaf with ``torch.where``."""
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

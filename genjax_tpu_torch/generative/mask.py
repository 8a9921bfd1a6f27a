"""``Mask``: a value with a validity flag, the framework's fixed-shape sum
type.

Counterpart of ``genjax_tpu/generative/mask.py``. A flag is a Python bool
(concrete) or a boolean tensor whose shape is a prefix of every leaf's
shape, so a batch of particles can carry per-particle validity.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core.pytree import Pytree

Flag = Any  # bool | torch.Tensor of dtype bool


def is_concrete(flag: Flag) -> bool:
    return isinstance(flag, bool)


def concrete_true(flag: Flag) -> bool:
    return flag is True


def concrete_false(flag: Flag) -> bool:
    return flag is False


def flag_and(f1: Flag, f2: Flag) -> Flag:
    if is_concrete(f1) and is_concrete(f2):
        return f1 and f2
    if concrete_false(f1) or concrete_false(f2):
        return False
    if concrete_true(f1):
        return f2
    if concrete_true(f2):
        return f1
    return torch.logical_and(f1, f2)


def flag_or(f1: Flag, f2: Flag) -> Flag:
    if is_concrete(f1) and is_concrete(f2):
        return f1 or f2
    if concrete_true(f1) or concrete_true(f2):
        return True
    if concrete_false(f1):
        return f2
    if concrete_false(f2):
        return f1
    return torch.logical_or(f1, f2)


def flag_not(f: Flag) -> Flag:
    return (not f) if is_concrete(f) else torch.logical_not(f)


def _check_flag_prefix(value: Any, flag: Flag) -> None:
    if is_concrete(flag):
        return
    fshape = tuple(flag.shape)
    if fshape == ():
        return
    for leaf in pytree.tree_leaves(value):
        lshape = tuple(torch.as_tensor(leaf).shape)
        if lshape[: len(fshape)] != fshape:
            raise ValueError(
                f"Mask flag shape {fshape} must be a prefix of every leaf "
                f"shape; got leaf shape {lshape}."
            )


def _where(flag: Flag, a: Any, b: Any) -> Any:
    """Leafwise select: ``a`` where ``flag`` holds, else ``b``."""

    def per_leaf(x, y):
        x = torch.as_tensor(x)
        f = torch.as_tensor(flag, device=x.device)
        f = f.reshape(tuple(f.shape) + (1,) * (x.ndim - f.ndim))
        return torch.where(f, x, torch.as_tensor(y, dtype=x.dtype, device=x.device))

    return pytree.tree_map(per_leaf, a, b)


@Pytree.dataclass(init=False)
class Mask(Pytree):
    """A value plus a validity flag.

    >>> import genjax_tpu_torch as g
    >>> m = g.Mask(1.5, True)
    >>> float(m.unmask()), bool(m.flag)
    (1.5, True)
    >>> float(g.Mask(2.5, False).unmask(default=0.0))   # invalid -> default
    0.0
    """

    value: Any
    flag: Flag

    def __init__(self, value: Any, flag: Flag = True):
        if isinstance(value, Mask):
            flag = flag_and(flag, value.flag)
            value = value.value
        _check_flag_prefix(value, flag)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "flag", flag)

    @staticmethod
    def maybe_none(v: Any):
        """Collapse a concretely invalid Mask to None; unwrap a concretely
        valid one."""
        if isinstance(v, Mask):
            if concrete_true(v.flag):
                return v.value
            if concrete_false(v.flag):
                return None
        return v

    @staticmethod
    def maybe_mask(v: Any, flag: Flag):
        """``v`` under ``flag``: ``v`` itself where the flag is concretely
        true, None where it is concretely false (or ``v`` is None), else a
        ``Mask``."""
        if v is None or concrete_false(flag):
            return None
        if concrete_true(flag) and not isinstance(v, Mask):
            return v
        return Mask.maybe_none(Mask(v, flag))

    def unmask(self, default: Any = None) -> Any:
        """The value; with ``default``, invalid lanes are replaced by it."""
        if default is None:
            return self.value
        if is_concrete(self.flag):
            return self.value if self.flag else default
        return _where(self.flag, self.value, default)

    def __or__(self, other: "Mask") -> "Mask":
        # valid(self) ? self : other
        f1, f2 = self.flag, other.flag
        if is_concrete(f1):
            value = self.value if f1 else other.value
        else:
            value = _where(f1, self.value, other.value)
        return Mask(value, flag_or(f1, f2))

    def __invert__(self) -> "Mask":
        return Mask(self.value, flag_not(self.flag))

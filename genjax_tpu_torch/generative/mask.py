"""``Mask``: a value with a validity flag, the framework's fixed-shape sum
type.

Counterpart of ``genjax_tpu/generative/mask.py``. A flag is a Python bool
(concrete) or a boolean tensor whose shape is a prefix of every leaf's
shape, so a batch of particles can carry per-particle validity. The flag
algebra is ``core.staging.FlagOp``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core.checkify import check, optional_check
from ..core.pytree import Pytree
from ..core.staging import Flag, FlagOp


def _check_flag_prefix(value: Any, flag: Flag) -> None:
    if FlagOp.is_concrete(flag) or not isinstance(flag, torch.Tensor):
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


@Pytree.dataclass(init=False)
class Mask(Pytree):
    """A value plus a validity flag.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> m = g.Mask(1.5, True)
    >>> float(m.unmask()), bool(m.flag)
    (1.5, True)
    >>> float(g.Mask(2.5, False).unmask(default=0.0))   # invalid -> default
    0.0
    >>> g.Mask(torch.tensor([1.0, 2.0]), torch.tensor([True, False])).unmask(default=0.0)
    tensor([1., 0.])
    """

    value: Any
    flag: Flag

    def __init__(self, value: Any, flag: Flag = True):
        if isinstance(value, Mask):
            flag = FlagOp.and_(flag, value.flag)
            value = value.value
        _check_flag_prefix(value, flag)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "flag", flag)

    @staticmethod
    def maybe_none(v: Any):
        """Collapse a concretely invalid Mask to None; unwrap a concretely
        valid one."""
        if isinstance(v, Mask):
            if FlagOp.concrete_true(v.flag):
                return v.value
            if FlagOp.concrete_false(v.flag):
                return None
        return v

    @staticmethod
    def maybe_mask(v: Any, flag: Flag):
        """``v`` under ``flag``: ``v`` itself where the flag is concretely
        true (an inner Mask keeps its own flag), None where it is concretely
        false (or ``v`` is None), else a ``Mask`` whose flag ANDs with any
        inner one."""
        if v is None or FlagOp.concrete_false(flag):
            return None
        if FlagOp.concrete_true(flag):
            return v
        return Mask(v, flag)

    def primal_flag(self) -> Flag:
        return self.flag

    def unmask(self, default: Any = None) -> Any:
        """The value; with ``default``, invalid lanes are replaced by it.
        Without one, under ``do_checkify()``, an invalid flag raises
        (``core/checkify.py``)."""
        if default is None:
            optional_check(lambda: check(self.flag, "Attempted to unmask an invalid Mask."))
            return self.value
        return FlagOp.where(self.flag, self.value, default)

    # ----- combination: index-select truth tables -----

    def __or__(self, other: "Mask") -> "Mask":
        # valid(self) ? self : other
        f1, f2 = self.flag, other.flag
        value = _choose_value(_flag_to_idx2(f1, f2, "or"), self.value, other.value)
        return Mask(value, FlagOp.or_(f1, f2))

    def __xor__(self, other: "Mask") -> "Mask":
        # valid only where exactly one side is
        f1, f2 = self.flag, other.flag
        value = _choose_value(_flag_to_idx2(f1, f2, "xor"), self.value, other.value)
        return Mask(value, FlagOp.xor_(f1, f2))

    def __invert__(self) -> "Mask":
        return Mask(self.value, FlagOp.not_(self.flag))


def _flag_to_idx2(f1: Flag, f2: Flag, mode: str):
    """Which value to take: 0 the first, 1 the second; an int for concrete
    flags, else a tensor of the flags' shape."""
    if FlagOp.is_concrete(f1) and FlagOp.is_concrete(f2):
        return 0 if f1 else 1
    a1, a2 = torch.as_tensor(f1), torch.as_tensor(f2)
    if mode == "or":
        return torch.where(a1, 0, 1)
    return torch.where(a1 & ~a2, 0, torch.where(a2 & ~a1, 1, 0))


def _choose_value(idx, v1, v2):
    if isinstance(idx, int):
        return (v1, v2)[idx]
    return FlagOp.where(idx == 0, v1, v2)

"""``Selection``: an algebra of address predicates.

Counterpart of ``genjax_tpu/generative/selection.py``: static addresses
(strings, tuples, Python ints and the ``...`` wildcard), index selections
(``IdxSel``: ``S[idx, "z"]`` with a tensor or numpy ``idx``), masked ones
(``MaskedSel``), ``LeafSel`` and ``ChmSel``, the selection of the addresses a
choice map holds. ``check()`` is a ``Flag``: a Python bool, or a bool tensor
where a tensor index or flag decides (``core.staging.FlagOp``).
"""

from __future__ import annotations

import abc
from typing import Any

import numpy as np
import torch

from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from ..core.staging import Flag, FlagOp
from .mask import Mask


class Selection(Pytree):
    """A predicate over addresses. Build with ``S``; combine with
    ``|``/``&``/``~``; test membership with ``in``:

    >>> import genjax_tpu_torch as g
    >>> sel = g.S["x"] | g.S["y", "z"]
    >>> ("x",) in sel, ("y", "z") in sel, ("y",) in sel
    (True, True, False)
    >>> ("x",) in ~sel, ("other",) in ~sel
    (False, True)
    """

    @abc.abstractmethod
    def check(self) -> Flag:
        """Is the address *ending here* selected?"""

    @abc.abstractmethod
    def get_subselection(self, addr) -> "Selection":
        ...

    @staticmethod
    def all() -> "Selection":
        return AllSel()

    @staticmethod
    def none() -> "Selection":
        return NoneSel()

    @staticmethod
    def leaf() -> "Selection":
        return LeafSel()

    def __or__(self, other: "Selection") -> "Selection":
        if isinstance(self, AllSel) or isinstance(other, AllSel):
            return AllSel()
        if isinstance(self, NoneSel):
            return other
        if isinstance(other, NoneSel):
            return self
        return OrSel(self, other)

    def __and__(self, other: "Selection") -> "Selection":
        if isinstance(self, NoneSel) or isinstance(other, NoneSel):
            return NoneSel()
        if isinstance(self, AllSel):
            return other
        if isinstance(other, AllSel):
            return self
        return AndSel(self, other)

    def __invert__(self) -> "Selection":
        if isinstance(self, AllSel):
            return NoneSel()
        if isinstance(self, NoneSel):
            return AllSel()
        return ComplementSel(self)

    def complement(self) -> "Selection":
        return ~self

    def mask(self, flag: Flag) -> "Selection":
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return NoneSel()
        return MaskedSel(self, flag)

    def extend(self, *addrs) -> "Selection":
        """Prefix this selection with address components (outermost first);
        a tensor or numpy index component becomes an ``IdxSel``."""
        sel = self
        for addr in reversed(addrs):
            sel = _component(sel, addr)
        return sel

    def __call__(self, *addr) -> "Selection":
        sel = self
        for comp in addr:
            sel = sel.get_subselection(comp)
        return sel

    def __getitem__(self, addr) -> Flag:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return self(*addr).check()

    def __contains__(self, addr) -> bool:
        flag = self[addr]
        if isinstance(flag, torch.Tensor) and flag.numel() != 1:
            raise GenJAXError(
                "`addr in selection` needs a concrete membership flag; this selection's "
                "check is a tensor (a tensor index or mask). Use `selection[addr]` to keep it."
            )
        return bool(flag)


@Pytree.dataclass
class AllSel(Selection):
    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class NoneSel(Selection):
    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        return self


@Pytree.dataclass
class LeafSel(Selection):
    """Selects exactly the choice at the current node."""

    def check(self) -> Flag:
        return True

    def get_subselection(self, addr) -> Selection:
        return NoneSel()


@Pytree.dataclass
class ComplementSel(Selection):
    inner: Selection

    def check(self) -> Flag:
        return FlagOp.not_(self.inner.check())

    def get_subselection(self, addr) -> Selection:
        return ~self.inner.get_subselection(addr)


@Pytree.dataclass
class MaskedSel(Selection):
    inner: Selection
    flag: Flag

    def check(self) -> Flag:
        return FlagOp.and_(self.flag, self.inner.check())

    def get_subselection(self, addr) -> Selection:
        return self.inner.get_subselection(addr).mask(self.flag)


def _addr_match(key, addr) -> Flag:
    """An address component against a selection key: concrete unless one
    side is a tensor; the ``...`` wildcard matches anything."""
    if key is Ellipsis:
        return True
    if not isinstance(key, torch.Tensor) and not isinstance(addr, torch.Tensor):
        return key == addr
    if isinstance(key, str) or isinstance(addr, str) or addr is None:
        return False
    return torch.as_tensor(key) == torch.as_tensor(addr)


@Pytree.dataclass
class StaticSel(Selection):
    """Selects addresses under a single component (or the ``...`` wildcard)."""

    inner: Selection
    addr: Any = Pytree.static()

    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        return self.inner.mask(_addr_match(self.addr, addr))


@Pytree.dataclass
class IdxSel(Selection):
    """Selects the integer addresses in an index tensor."""

    inner: Selection
    idx: Any  # 1-D int tensor

    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        if isinstance(addr, str) or addr is None or addr is Ellipsis or isinstance(addr, slice):
            return NoneSel()
        idx = self.idx
        return self.inner.mask(torch.any(idx == torch.as_tensor(addr, device=idx.device), dim=-1))


@Pytree.dataclass
class AndSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return FlagOp.and_(self.a.check(), self.b.check())

    def get_subselection(self, addr) -> Selection:
        return self.a.get_subselection(addr) & self.b.get_subselection(addr)


@Pytree.dataclass
class OrSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return FlagOp.or_(self.a.check(), self.b.check())

    def get_subselection(self, addr) -> Selection:
        return self.a.get_subselection(addr) | self.b.get_subselection(addr)


@Pytree.dataclass
class ChmSel(Selection):
    """Selection of every address that holds a value in a choice map."""

    chm: Any  # ChoiceMap, typed loosely: choice_map imports this module

    def check(self) -> Flag:
        v = self.chm.get_value()
        if v is None:
            return False
        return v.flag if isinstance(v, Mask) else True

    def get_subselection(self, addr) -> Selection:
        sub = self.chm.get_submap(addr)
        return NoneSel() if sub.static_is_empty() else ChmSel(sub)


def _is_dynamic_int(comp) -> bool:
    """An index component that must not ride in ``StaticSel``'s static
    context: a tensor, or a numpy array of one or more dimensions."""
    if isinstance(comp, np.ndarray):
        return comp.ndim > 0
    return isinstance(comp, torch.Tensor)


def _component(inner: Selection, comp) -> Selection:
    if _is_dynamic_int(comp):
        return IdxSel(inner, torch.atleast_1d(torch.as_tensor(comp)))
    if isinstance(comp, np.generic):
        comp = comp.item()
    return StaticSel(inner, comp)


class _SelectionBuilder:
    """``S["x", "y"]`` selects the subtree at path x/y; ``S[...]`` is the
    wildcard; ``S[idx, "z"]`` with a tensor or numpy ``idx`` selects the
    indices it holds; ``S.all()``, ``S.none()``, ``S.leaf()``."""

    def __getitem__(self, addr) -> Selection:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return AllSel().extend(*addr)

    @property
    def all(self):
        return Selection.all

    @property
    def none(self):
        return Selection.none

    @property
    def leaf(self):
        return Selection.leaf


S = _SelectionBuilder()
SelectionBuilder = _SelectionBuilder

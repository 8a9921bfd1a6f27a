"""``Selection``: an algebra of static-address predicates.

Counterpart of ``genjax_tpu/generative/selection.py`` for static addresses
(strings, tuples, Python ints and the ``...`` wildcard), with ``ChmSel``,
the selection of the addresses a choice map holds. Dynamic index selections
wait for the combinator slice.
"""

from __future__ import annotations

import abc
from typing import Any

from ..core.pytree import Pytree
from .mask import Flag, Mask, flag_and, flag_not, flag_or


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

    def mask(self, flag: bool) -> "Selection":
        return self if flag else NoneSel()

    def extend(self, *addrs) -> "Selection":
        """Prefix this selection with address components (outermost first)."""
        sel = self
        for addr in reversed(addrs):
            sel = StaticSel(sel, addr)
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
        return bool(self[addr])


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
class ComplementSel(Selection):
    inner: Selection

    def check(self) -> Flag:
        return flag_not(self.inner.check())

    def get_subselection(self, addr) -> Selection:
        return ~self.inner.get_subselection(addr)


@Pytree.dataclass
class StaticSel(Selection):
    """Selects addresses under a single component (or the ``...`` wildcard)."""

    inner: Selection
    addr: Any = Pytree.static()

    def check(self) -> Flag:
        return False

    def get_subselection(self, addr) -> Selection:
        return self.inner.mask(self.addr is Ellipsis or self.addr == addr)


@Pytree.dataclass
class AndSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return flag_and(self.a.check(), self.b.check())

    def get_subselection(self, addr) -> Selection:
        return self.a.get_subselection(addr) & self.b.get_subselection(addr)


@Pytree.dataclass
class OrSel(Selection):
    a: Selection
    b: Selection

    def check(self) -> Flag:
        return flag_or(self.a.check(), self.b.check())

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


class _SelectionBuilder:
    """``S["x", "y"]`` selects the subtree at path x/y; ``S[...]`` is the
    wildcard; ``S.all()``, ``S.none()``."""

    def __getitem__(self, addr) -> Selection:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return AllSel().extend(*addr)

    @property
    def all(self):
        return Selection.all

    @property
    def none(self):
        return Selection.none


S = _SelectionBuilder()

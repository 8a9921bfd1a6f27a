"""``ChoiceMap``: hierarchical addressed sample storage.

Counterpart of ``genjax_tpu/generative/choice_map.py`` for static and value
nodes: the ``C`` builder, ``ChoiceMap.empty``/``entry``/``d``,
``get_submap``/``get_value``/``static_is_empty``, left-priority ``|`` and
``merge``, and filtering by a static selection (``filter``, lazy as in the
reference; ``filter_eager``, pruned; ``get_selection``). Indexed, switch and
masked nodes, and filters whose flags are tensors, wait for the combinator
slice.
"""

from __future__ import annotations

import abc
from typing import Any, Iterable, Mapping

from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from .mask import Flag, Mask, concrete_false, concrete_true, is_concrete
from .selection import AllSel, ChmSel, NoneSel, Selection


class ChoiceMapNoValueAtAddress(GenJAXError):
    pass


def _not_yet(what: str):
    return NotImplementedError(
        f"{what} needs indexed choice maps, which come with the combinator "
        "slice of the port (ROADMAP queue 1, slice 3)"
    )


def _traced_flag(what: str):
    return NotImplementedError(
        f"{what} under a flag that is a tensor needs masked choice maps, which come "
        "with the combinators of the port (ROADMAP queue 1, item 7)"
    )


class ChoiceMap(Pytree):
    """Hierarchical, address-indexed storage of sampled values.

    >>> import genjax_tpu_torch as g
    >>> chm = g.C["obs", "y"].set(1.0) | g.C["mu"].set(0.5)
    >>> float(chm["obs", "y"]), float(chm["mu"])
    (1.0, 0.5)
    >>> float((g.C["mu"].set(9.9) | chm)["mu"])   # left priority
    9.9
    """

    @abc.abstractmethod
    def get_value(self) -> Any:
        """Value stored at this node: None, a raw value, or a ``Mask``."""

    @abc.abstractmethod
    def get_inner_map(self, addr) -> "ChoiceMap":
        """Submap under a *single* address component."""

    def static_is_empty(self) -> bool:
        return False

    # ----- builders -----

    @staticmethod
    def empty() -> "ChoiceMap":
        return _EMPTY

    @staticmethod
    def entry(v: Any, *addrs) -> "ChoiceMap":
        if isinstance(v, ChoiceMap):
            chm = v
        elif isinstance(v, Mapping):
            chm = ChoiceMap.d(v)
        else:
            chm = ValueChm(v)
        return chm.extend(*addrs)

    @staticmethod
    def from_mapping(pairs: Iterable[tuple[Any, Any]]) -> "ChoiceMap":
        acc = ChoiceMap.empty()
        for addr, v in pairs:
            addr = addr if isinstance(addr, tuple) else (addr,)
            acc |= ChoiceMap.entry(v, *addr)
        return acc

    @staticmethod
    def d(mapping: Mapping[Any, Any]) -> "ChoiceMap":
        return ChoiceMap.from_mapping(mapping.items())

    # ----- queries -----

    def has_value(self) -> bool:
        return self.get_value() is not None

    def get_submap(self, *addresses) -> "ChoiceMap":
        chm = self
        for addr in addresses:
            for comp in addr if isinstance(addr, tuple) else (addr,):
                chm = chm.get_inner_map(comp)
        return chm

    def filter_eager(self, selection: Selection) -> "ChoiceMap":
        """Prune to the entries ``selection`` covers: unlike the lazy
        ``filter``, unselected subtrees leave the result's structure. For
        where the result's leaf set matters: raveling a selection into a flat
        position vector must carry no inert unselected leaf."""
        return _invalid_extras(self, ~selection)

    def filter(self, selection: Selection | Flag) -> "ChoiceMap":
        if not isinstance(selection, Selection):
            return self.mask(selection)
        if isinstance(selection, AllSel):
            return self
        if isinstance(selection, NoneSel):
            return ChoiceMap.empty()
        if self.static_is_empty():
            return self
        return FilteredChm(self, selection)

    def mask(self, flag: Flag) -> "ChoiceMap":
        if concrete_true(flag):
            return self
        if concrete_false(flag):
            return ChoiceMap.empty()
        raise _traced_flag("ChoiceMap.mask")

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def get_selection(self) -> Selection:
        return ChmSel(self)

    def extend(self, *addrs) -> "ChoiceMap":
        acc = self
        for addr in reversed(addrs):
            if isinstance(addr, tuple):
                acc = acc.extend(*addr)
            elif isinstance(addr, str):
                acc = StaticChm.build({addr: acc})
            else:
                raise _not_yet(f"the integer address {addr!r}")
        return acc

    def static_addresses(self) -> tuple:
        return ()

    # ----- dunders -----

    def __or__(self, other: "ChoiceMap") -> "ChoiceMap":
        return _or_build(self, other)

    def __call__(self, *addresses) -> "ChoiceMap":
        return self.get_submap(*addresses)

    def __getitem__(self, addr):
        addr = addr if isinstance(addr, tuple) else (addr,)
        v = self.get_submap(*addr).get_value()
        if v is None:
            raise ChoiceMapNoValueAtAddress(addr)
        return v

    def __contains__(self, addr) -> bool:
        addr = addr if isinstance(addr, tuple) else (addr,)
        return self.get_submap(*addr).has_value()


@Pytree.dataclass
class EmptyChm(ChoiceMap):
    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        return self

    def static_is_empty(self) -> bool:
        return True


_EMPTY = EmptyChm()


@Pytree.dataclass
class ValueChm(ChoiceMap):
    """A leaf choice."""

    v: Any

    def get_value(self) -> Any:
        return Mask.maybe_none(self.v)

    def get_inner_map(self, addr) -> ChoiceMap:
        return _EMPTY

    def static_is_empty(self) -> bool:
        return isinstance(self.v, Mask) and concrete_false(self.v.flag)


@Pytree.dataclass
class StaticChm(ChoiceMap):
    """String-keyed mapping of submaps."""

    submaps: tuple
    keys: tuple = Pytree.static()

    @staticmethod
    def build(mapping: Mapping[Any, ChoiceMap]) -> ChoiceMap:
        items = [(k, v) for k, v in mapping.items() if not v.static_is_empty()]
        if not items:
            return _EMPTY
        return StaticChm(tuple(v for _, v in items), tuple(k for k, _ in items))

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        if addr in self.keys:
            return self.submaps[self.keys.index(addr)]
        return _EMPTY

    def static_addresses(self) -> tuple:
        return self.keys

    def static_is_empty(self) -> bool:
        return all(s.static_is_empty() for s in self.submaps)


@Pytree.dataclass
class FilteredChm(ChoiceMap):
    """Lazy filter by a selection, resolved at read time: the unselected
    leaves stay in the tree and read as absent."""

    inner: ChoiceMap
    selection: Selection

    def get_value(self) -> Any:
        check = self.selection.check()
        if not is_concrete(check):
            raise _traced_flag("a read of a filtered choice map")
        return Mask.maybe_mask(self.inner.get_value(), check)

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.inner.get_inner_map(addr).filter(self.selection.get_subselection(addr))

    def static_addresses(self) -> tuple:
        return self.inner.static_addresses()

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty()


@Pytree.dataclass
class OrChm(ChoiceMap):
    """Left-priority union of two maps of different node kinds."""

    c1: ChoiceMap
    c2: ChoiceMap

    def get_value(self) -> Any:
        v1 = self.c1.get_value()
        v2 = self.c2.get_value()
        if v1 is None:
            return v2
        if v2 is None:
            return v1
        return Mask.maybe_none(Mask(v1) | Mask(v2))

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.c1.get_inner_map(addr) | self.c2.get_inner_map(addr)

    def filter(self, selection) -> ChoiceMap:
        return self.c1.filter(selection) | self.c2.filter(selection)

    def static_addresses(self) -> tuple:
        out = list(self.c1.static_addresses())
        out += [a for a in self.c2.static_addresses() if a not in out]
        return tuple(out)

    def static_is_empty(self) -> bool:
        return self.c1.static_is_empty() and self.c2.static_is_empty()


def _or_build(c1: ChoiceMap, c2: ChoiceMap) -> ChoiceMap:
    if c2.static_is_empty():
        return c1
    if c1.static_is_empty():
        return c2
    if isinstance(c1, StaticChm) and isinstance(c2, StaticChm):
        merged: dict = dict(zip(c1.keys, c1.submaps))
        for k, v in zip(c2.keys, c2.submaps):
            merged[k] = _or_build(merged[k], v) if k in merged else v
        return StaticChm.build(merged)
    if isinstance(c1, ValueChm) and isinstance(c2, ValueChm):
        return ValueChm(Mask.maybe_none(Mask(c1.v) | Mask(c2.v)))
    return OrChm(c1, c2)


def _invalid_extras(chm: ChoiceMap, sel: Selection) -> ChoiceMap:
    """``chm`` pruned to the entries ``sel`` does NOT cover; statically empty
    when ``sel`` covers them all."""
    if chm.static_is_empty():
        return _EMPTY
    if isinstance(chm, ValueChm):
        check = sel.check()
        if not is_concrete(check):
            raise _traced_flag("pruning a choice map")
        return _EMPTY if check else chm
    if isinstance(chm, StaticChm):
        return StaticChm.build(
            {k: _invalid_extras(sub, sel.get_subselection(k)) for k, sub in zip(chm.keys, chm.submaps)}
        )
    if isinstance(chm, FilteredChm):
        # the selected part is what the filter keeps and ``sel`` does not cover
        return _invalid_extras(chm.inner, sel | ~chm.selection)
    if isinstance(chm, OrChm):
        return _or_build(_invalid_extras(chm.c1, sel), _invalid_extras(chm.c2, sel))
    return chm


class _ChoiceMapBuilder:
    """``C["x", "y"].set(v)``: fluent construction of nested entries."""

    def __init__(self, path: tuple):
        self._path = path

    def __getitem__(self, addr) -> "_ChoiceMapBuilder":
        addr = addr if isinstance(addr, tuple) else (addr,)
        return _ChoiceMapBuilder(self._path + addr)

    def set(self, v) -> ChoiceMap:
        return ChoiceMap.entry(v, *self._path)


C = _ChoiceMapBuilder(())

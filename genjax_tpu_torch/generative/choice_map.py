"""``ChoiceMap``: hierarchical addressed sample storage.

Counterpart of ``genjax_tpu/generative/choice_map.py``: the ``C`` builder
(``C[:, "y"]``, ``C[idx, "y"]`` and ``C[3, "y"]`` included),
``ChoiceMap.empty``/``entry``/``d``/``switch``, ``get_submap``/``get_value``/
``static_is_empty``, left-priority ``|`` and ``merge``, lazy ``filter`` and
``mask`` and the pruning ``filter_eager``, ``get_selection``; the node kinds
``ValueChm``, ``StaticChm``, ``IndexedChm`` (dense, with the lane or time
axis in front of every leaf, or sparse at a scalar or 1-D index),
``MaskedChm``, ``FilteredChm``, ``SwitchChm`` and ``OrChm``;
``shape_selection`` and ``exists_flag``. A value read where a tensor index or
flag decides comes back ``Mask``-wrapped; ``unmask()`` it.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.handlers import GenJAXError
from ..core.pytree import Pytree
from ..core.staging import Flag, FlagOp
from .mask import Mask
from .selection import AllSel, ChmSel, LeafSel, NoneSel, Selection


class ChoiceMapNoValueAtAddress(GenJAXError):
    pass


class ChoiceMapCoercionError(GenJAXError):
    pass


class ChoiceMapInvalidAddress(GenJAXError):
    """A constraint addressed a location the generative function never
    samples (a typo, say): under ``do_checkify()`` this is an error instead
    of a constraint silently ignored."""


def _is_dynamic(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _static_addr(x) -> bool:
    return isinstance(x, str) or x is Ellipsis or isinstance(x, tuple)


def _eq_flag(a, b) -> Flag:
    """Address equality, concrete when both sides are."""
    if not _is_dynamic(a) and not _is_dynamic(b):
        return a == b
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a == b.to(a.device)


def _slice_leaves(chm: "ChoiceMap", i) -> "ChoiceMap":
    """Every tensor leaf of ``chm`` indexed at ``i`` along its leading axis
    (a numpy leaf becomes a tensor first); scalar leaves pass through."""

    def ix(leaf):
        if _is_dynamic(leaf) and leaf.ndim >= 1:
            leaf = torch.as_tensor(leaf)
            return leaf[i.to(leaf.device) if isinstance(i, torch.Tensor) else i]
        return leaf

    return pytree.tree_map(ix, chm)


def _leading_axis_size(chm: "ChoiceMap") -> int | None:
    for leaf in pytree.tree_leaves(chm):
        if _is_dynamic(leaf) and leaf.ndim >= 1:
            return int(leaf.shape[0])
    return None


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
    def choice(v: Any) -> "ChoiceMap":
        """A value node: the map of ``v`` at the empty address."""
        return ValueChm(v)

    value = choice

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

    @staticmethod
    def kw(**kwargs) -> "ChoiceMap":
        return ChoiceMap.d(kwargs)

    @staticmethod
    def switch(idx, chms: Iterable["ChoiceMap"]) -> "ChoiceMap":
        """The branch map ``chms[idx]``: a concrete ``idx`` picks it, a tensor
        one makes a ``SwitchChm`` whose reads are masked by the index."""
        chms = list(chms)
        if isinstance(idx, int) and not isinstance(idx, bool):
            return chms[idx]
        return SwitchChm(torch.as_tensor(idx), tuple(chms))

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

    def invalid_subset(self, gen_fn, args: tuple) -> "ChoiceMap | None":
        """The entries of this map that no run of ``gen_fn(*args)`` samples
        (misspelled constraint addresses, say), or None where there are
        none. The address tree comes from ``gen_fn.get_zero_trace``, one
        ``simulate``; an entry that a tensor flag or index decides stays,
        masked by it.

        >>> import genjax_tpu_torch as g
        >>> @g.gen
        ... def model():
        ...     return g.normal(0.0, 1.0) @ "y"
        >>> extras = g.ChoiceMap.d({"y": 1.0, "z": 2.0}).invalid_subset(model, ())
        >>> "z" in extras, "y" in extras
        (True, False)
        """
        extras = _invalid_extras(self, shape_selection(gen_fn.get_zero_trace(*args).get_choices()))
        return None if extras.static_is_empty() else extras

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
        if FlagOp.concrete_true(flag):
            return self
        if FlagOp.concrete_false(flag):
            return ChoiceMap.empty()
        if self.static_is_empty():
            return self
        return MaskedChm(self, flag)

    def merge(self, other: "ChoiceMap") -> "ChoiceMap":
        return self | other

    def get_selection(self) -> Selection:
        return ChmSel(self)

    @property
    def at(self) -> "_ChoiceMapBuilder":
        """``chm.at["a"].set(v)``: the entry layered over this map, with
        priority."""
        return _ChoiceMapBuilder(self, ())

    def extend(self, *addrs) -> "ChoiceMap":
        acc = self
        for addr in reversed(addrs):
            if isinstance(addr, tuple):
                acc = acc.extend(*addr)
            elif isinstance(addr, str):
                acc = StaticChm.build({addr: acc})
            else:
                acc = IndexedChm.build(acc, addr)
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
        return isinstance(self.v, Mask) and FlagOp.concrete_false(self.v.flag)


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
        if not _static_addr(addr) and not isinstance(addr, int):
            return _EMPTY
        if addr in self.keys:
            return self.submaps[self.keys.index(addr)]
        return _EMPTY

    def static_addresses(self) -> tuple:
        return self.keys

    def static_is_empty(self) -> bool:
        return all(s.static_is_empty() for s in self.submaps)


@Pytree.dataclass(init=False)
class IndexedChm(ChoiceMap):
    """Integer-addressed submaps, in one of three modes set by ``idx``:

    - ``idx is None`` (dense): every tensor leaf of ``inner`` carries a
      leading axis of size T, and address ``j`` reads slice ``j``: the
      layout of ``vmap`` and ``scan`` traces. Negative ``j`` reads count
      from the end, as in Python;
    - a scalar ``idx``: ``inner`` has no leading axis, and address ``j`` is
      valid where ``j == idx``;
    - a 1-D ``idx`` of N indices: ``inner``'s leaves carry a leading axis
      of N, and address ``j`` reads the position that holds ``j``, masked
      where none does.

    A concrete address and index give a concrete read; a tensor on either
    side gives a ``Mask``-wrapped one. A Python int index rides in the
    tree's context, so a map built at one passes through ``torch.func.vmap``.
    """

    inner: ChoiceMap
    dyn_idx: Any  # None | 0-d or 1-D int tensor
    static_idx: Any = Pytree.static(default=None)  # None | int

    def __init__(self, inner: ChoiceMap, idx):
        object.__setattr__(self, "inner", inner)
        concrete = isinstance(idx, int) and not isinstance(idx, bool)
        object.__setattr__(self, "dyn_idx", None if concrete else idx)
        object.__setattr__(self, "static_idx", idx if concrete else None)

    @property
    def idx(self):
        return self.static_idx if self.static_idx is not None else self.dyn_idx

    @staticmethod
    def build(inner: ChoiceMap, idx) -> ChoiceMap:
        if inner.static_is_empty():
            return _EMPTY
        if idx is None:
            return IndexedChm(inner, None)
        if isinstance(idx, slice):
            if idx == slice(None, None, None):
                return IndexedChm(inner, None)
            raise ChoiceMapCoercionError(f"Unsupported slice address: {idx}")
        if isinstance(idx, np.generic):
            idx = idx.item()
        if _is_dynamic(idx):
            idx = torch.as_tensor(idx)
        return IndexedChm(inner, idx)

    def get_value(self) -> Any:
        return None

    def get_inner_map(self, addr) -> ChoiceMap:
        if _static_addr(addr) or addr is None:
            return _EMPTY
        if isinstance(addr, slice):
            if addr != slice(None, None, None):
                raise ValueError(f"Partial slices not supported: {addr}")
            if self.idx is None:
                return self.inner
            raise ValueError("Slice reads are not supported on sparsely indexed maps")
        if isinstance(addr, np.generic):
            addr = addr.item()
        if self.idx is None:
            size = _leading_axis_size(self.inner)
            if size is None:
                return _EMPTY
            if not _is_dynamic(addr):
                return _slice_leaves(self.inner, addr) if -size <= addr < size else _EMPTY
            j = torch.as_tensor(addr)
            j = torch.where(j < 0, j + size, j)
            valid = (j >= 0) & (j < size)
            return _slice_leaves(self.inner, torch.clamp(j, 0, size - 1)).mask(valid)
        if not _is_dynamic(self.idx) or self.idx.ndim == 0:
            return self.inner.mask(_eq_flag(addr, self.idx))
        matches = self.idx == torch.as_tensor(addr, device=self.idx.device)
        return _slice_leaves(self.inner, torch.argmax(matches.to(torch.int32))).mask(torch.any(matches))

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty()


@Pytree.dataclass
class MaskedChm(ChoiceMap):
    """``inner`` under a flag: its reads are masked by it."""

    inner: ChoiceMap
    flag: Flag

    def get_value(self) -> Any:
        return Mask.maybe_mask(self.inner.get_value(), self.flag)

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.inner.get_inner_map(addr).mask(self.flag)

    def mask(self, flag: Flag) -> ChoiceMap:
        return self.inner.mask(FlagOp.and_(self.flag, flag))

    def static_addresses(self) -> tuple:
        return self.inner.static_addresses()

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty() or FlagOp.concrete_false(self.flag)


@Pytree.dataclass
class FilteredChm(ChoiceMap):
    """Lazy filter by a selection, resolved at read time: the unselected
    leaves stay in the tree and read as absent."""

    inner: ChoiceMap
    selection: Selection

    def get_value(self) -> Any:
        v = self.inner.get_value()
        return None if v is None else Mask.maybe_mask(v, self.selection.check())

    def get_inner_map(self, addr) -> ChoiceMap:
        return self.inner.get_inner_map(addr).filter(self.selection.get_subselection(addr))

    def static_addresses(self) -> tuple:
        return self.inner.static_addresses()

    def static_is_empty(self) -> bool:
        return self.inner.static_is_empty()


@Pytree.dataclass
class SwitchChm(ChoiceMap):
    """The union of branch maps, each read masked by ``idx == branch``."""

    idx: Any
    branches: tuple

    def get_value(self) -> Any:
        acc = None
        for i, b in enumerate(self.branches):
            v = b.get_value()
            if v is None:
                continue
            m = Mask(v, _eq_flag(self.idx, i))
            acc = m if acc is None else (acc | m)
        return None if acc is None else Mask.maybe_none(acc)

    def get_inner_map(self, addr) -> ChoiceMap:
        subs = tuple(b.get_inner_map(addr) for b in self.branches)
        if all(s.static_is_empty() for s in subs):
            return _EMPTY
        return SwitchChm(self.idx, subs)

    def static_addresses(self) -> tuple:
        out: list = []
        for b in self.branches:
            out += [a for a in b.static_addresses() if a not in out]
        return tuple(out)

    def static_is_empty(self) -> bool:
        return all(b.static_is_empty() for b in self.branches)


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
    if isinstance(c1, SwitchChm) and not isinstance(c2, SwitchChm):
        return SwitchChm(c1.idx, tuple(b | c2 for b in c1.branches))
    if isinstance(c2, SwitchChm) and not isinstance(c1, SwitchChm):
        return SwitchChm(c2.idx, tuple(c1 | b for b in c2.branches))
    return OrChm(c1, c2)


def shape_selection(chm: ChoiceMap) -> Selection:
    """The selection of every address reachable in ``chm``'s address tree;
    integer-indexed levels widen to the ``...`` wildcard."""
    if isinstance(chm, EmptyChm):
        return NoneSel()
    if isinstance(chm, ValueChm):
        return LeafSel()
    if isinstance(chm, StaticChm):
        acc: Selection = NoneSel()
        for k, sub in zip(chm.keys, chm.submaps):
            acc = acc | shape_selection(sub).extend(k)
        return acc
    if isinstance(chm, IndexedChm):
        return shape_selection(chm.inner).extend(...)
    if isinstance(chm, (MaskedChm, FilteredChm)):
        return shape_selection(chm.inner)
    if isinstance(chm, SwitchChm):
        acc = NoneSel()
        for b in chm.branches:
            acc = acc | shape_selection(b)
        return acc
    if isinstance(chm, OrChm):
        return shape_selection(chm.c1) | shape_selection(chm.c2)
    raise ValueError(f"Unknown ChoiceMap node: {type(chm).__name__}")


def _invalid_extras(chm: ChoiceMap, sel: Selection) -> ChoiceMap:
    """``chm`` pruned to the entries ``sel`` does NOT cover; statically empty
    when ``sel`` covers them all concretely. Entries that a tensor flag
    decides stay, masked by it."""
    if chm.static_is_empty():
        return _EMPTY
    if isinstance(chm, ValueChm):
        check = sel.check()
        if FlagOp.concrete_true(check):
            return _EMPTY
        if FlagOp.concrete_false(check):
            return chm
        return MaskedChm(chm, FlagOp.not_(check))
    if isinstance(chm, StaticChm):
        return StaticChm.build(
            {k: _invalid_extras(sub, sel.get_subselection(k)) for k, sub in zip(chm.keys, chm.submaps)}
        )
    if isinstance(chm, IndexedChm):
        return _indexed_extras(chm, sel)
    if isinstance(chm, MaskedChm):
        return _invalid_extras(chm.inner, sel).mask(chm.flag)
    if isinstance(chm, FilteredChm):
        # the selected part is what the filter keeps and ``sel`` does not cover
        return _invalid_extras(chm.inner, sel | ~chm.selection)
    if isinstance(chm, SwitchChm):
        subs = tuple(_invalid_extras(b, sel) for b in chm.branches)
        if all(s.static_is_empty() for s in subs):
            return _EMPTY
        return SwitchChm(chm.idx, subs)
    if isinstance(chm, OrChm):
        return _or_build(_invalid_extras(chm.c1, sel), _invalid_extras(chm.c2, sel))
    return chm


def _indexed_extras(chm: IndexedChm, sel: Selection) -> ChoiceMap:
    if chm.idx is not None and (not _is_dynamic(chm.idx) or chm.idx.ndim == 0):
        # a scalar index: resolve at that index
        ex = _invalid_extras(chm.inner, sel.get_subselection(chm.idx))
        return _EMPTY if ex.static_is_empty() else IndexedChm(ex, chm.idx)
    if chm.idx is None:
        size = _leading_axis_size(chm.inner)
        if size is None:
            ex = _invalid_extras(chm.inner, sel.get_subselection(0))
            return _EMPTY if ex.static_is_empty() else IndexedChm(ex, None)
        if size == 0:
            return _EMPTY
        # selections resolve at the canonical, non-negative indices
        subsels = [sel.get_subselection(j) for j in range(size)]
        if _sels_uniform(subsels):
            # one verdict for every index (the wildcard and shape-selection
            # case): one representative keeps the dense leaves
            ex = _invalid_extras(chm.inner, subsels[0])
            return _EMPTY if ex.static_is_empty() else IndexedChm(ex, None)
        acc: ChoiceMap = _EMPTY
        for j in range(size):
            ex = _invalid_extras(_slice_leaves(chm.inner, j), subsels[j])
            if not ex.static_is_empty():
                acc = _or_build(acc, IndexedChm(ex, j))
        return acc
    # a 1-D index: resolve each stored position at its own index
    acc = _EMPTY
    for pos in range(int(chm.idx.shape[0])):
        iv = chm.idx[pos]
        ex = _invalid_extras(_slice_leaves(chm.inner, pos), sel.get_subselection(iv))
        if not ex.static_is_empty():
            acc = _or_build(acc, IndexedChm(ex, iv))
    return acc


def _sels_uniform(sels) -> bool:
    """Are these selections structurally identical, with the same verdict at
    every index? Conservative: a tensor leaf or any difference says no."""
    spec0 = pytree.tree_structure(sels[0])
    leaves0 = pytree.tree_leaves(sels[0])
    for s in sels[1:]:
        if s is sels[0]:
            continue
        if pytree.tree_structure(s) != spec0:
            return False
        for a, b in zip(leaves0, pytree.tree_leaves(s)):
            if a is b:
                continue
            if _is_dynamic(a) or _is_dynamic(b) or a != b:
                return False
    return True


def exists_flag(chm: ChoiceMap) -> Flag:
    """Does any value exist in ``chm``? Concrete ``True`` means provably
    present; a tensor where a tensor flag or index decides."""
    if isinstance(chm, EmptyChm):
        return False
    if isinstance(chm, ValueChm):
        v = chm.get_value()
        if v is None:
            return False
        return v.flag if isinstance(v, Mask) else True
    if isinstance(chm, StaticChm):
        flag: Flag = False
        for sub in chm.submaps:
            flag = FlagOp.or_(flag, exists_flag(sub))
        return flag
    if isinstance(chm, IndexedChm):
        return exists_flag(chm.inner)
    if isinstance(chm, MaskedChm):
        return FlagOp.and_(chm.flag, exists_flag(chm.inner))
    if isinstance(chm, SwitchChm):
        flag = False
        for i, b in enumerate(chm.branches):
            flag = FlagOp.or_(flag, FlagOp.and_(_eq_flag(chm.idx, i), exists_flag(b)))
        return flag
    if isinstance(chm, OrChm):
        return FlagOp.or_(exists_flag(chm.c1), exists_flag(chm.c2))
    if isinstance(chm, FilteredChm):
        return exists_flag(chm.inner)  # an over-approximation
    return True


class _ChoiceMapBuilder:
    """``C["x", "y"].set(v)``: fluent construction of nested entries. An
    integer component indexes (``C[3, "y"]``), a full slice takes the leading
    axis of ``v`` as the index (``C[:, "y"].set(ys)``), and a tensor or numpy
    index array takes one position of ``v``'s leading axis each
    (``C[idx, "y"]``)."""

    def __init__(self, base: ChoiceMap | None, path: tuple):
        self._base = base
        self._path = path

    def __getitem__(self, addr) -> "_ChoiceMapBuilder":
        addr = addr if isinstance(addr, tuple) else (addr,)
        return _ChoiceMapBuilder(self._base, self._path + addr)

    def set(self, v) -> ChoiceMap:
        entry = ChoiceMap.entry(v, *self._path)
        if self._base is None or self._base.static_is_empty():
            return entry
        return entry | self._base

    def update(self, fn: Callable[[Any], Any]) -> ChoiceMap:
        """The entry set to ``fn`` of the base map's value there (of None
        without a base)."""
        if self._base is None:
            return self.set(fn(None))
        return self.set(fn(self._base.get_submap(*self._path).get_value()))

    # the ChoiceMap constructors, placed at the builder's path
    def kw(self, **kwargs) -> ChoiceMap:
        return ChoiceMap.kw(**kwargs).extend(*self._path)

    def d(self, mapping) -> ChoiceMap:
        return ChoiceMap.d(mapping).extend(*self._path)

    def v(self, value) -> ChoiceMap:
        return ChoiceMap.entry(value, *self._path)

    value = v

    def from_mapping(self, pairs) -> ChoiceMap:
        return ChoiceMap.from_mapping(pairs).extend(*self._path)

    def switch(self, idx, chms) -> ChoiceMap:
        return ChoiceMap.switch(idx, chms).extend(*self._path)

    def empty(self) -> ChoiceMap:
        return ChoiceMap.empty()


C = _ChoiceMapBuilder(None, ())
ChoiceMapBuilder = C

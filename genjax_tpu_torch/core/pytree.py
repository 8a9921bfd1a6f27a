"""Pytree dataclass substrate on ``torch.utils._pytree``.

Counterpart of ``genjax_tpu/core/pytree.py``. Every framework object
(traces, choice maps, generative functions) is a frozen dataclass registered
as a torch pytree node: fields declared with ``Pytree.static()`` ride in the
node's context (they must compare by value), every other field is a child,
so ``tree_map`` over a trace reaches its tensors. A child field that holds
``None`` is an empty subtree, as in JAX (torch's own pytrees make ``None`` a
leaf, which ``torch.func.vmap`` refuses as an input or an output): which
fields are absent rides in the context. ``none_free`` does the same for the
``None`` entries of a tuple (a scan's ``(init, None)`` arguments, a
``(carry, None)`` return value).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, TypeVar

import torch
import torch.utils._pytree as pytree

T = TypeVar("T")

_STATIC_MARK = "genjax_tpu_torch_static"


class Pytree:
    """Base mixin for pytree-registered dataclasses.

    Subclasses are declared with ``@Pytree.dataclass``; fields declared with
    ``Pytree.static()`` live in the tree's context, all others are children.

    >>> import torch
    >>> import torch.utils._pytree as pytree
    >>> from genjax_tpu_torch import Pytree
    >>> @Pytree.dataclass
    ... class Particle(Pytree):
    ...     pos: torch.Tensor
    ...     name: str = Pytree.static(default="p")
    >>> p = Particle(torch.zeros(3))
    >>> [leaf.shape for leaf in pytree.tree_leaves(p)]
    [torch.Size([3])]
    >>> pytree.tree_map(lambda x: x + 1.0, p).name  # static rides along
    'p'
    """

    @staticmethod
    def dataclass(cls: type[T] | None = None, /, **kwargs) -> type[T]:
        if cls is None:
            return functools.partial(Pytree.dataclass, **kwargs)  # type: ignore

        kwargs.setdefault("frozen", True)
        dcls = dataclasses.dataclass(**kwargs)(cls)
        data_fields, meta_fields = [], []
        for f in dataclasses.fields(dcls):
            (meta_fields if f.metadata.get(_STATIC_MARK) else data_fields).append(f.name)

        def flatten(obj):
            values = [getattr(obj, n) for n in data_fields]
            absent = tuple(v is None for v in values)
            meta = tuple(getattr(obj, n) for n in meta_fields)
            return [v for v in values if v is not None], (meta, absent)

        def unflatten(children, context):
            meta, absent = context
            children = iter(children)
            obj = object.__new__(dcls)
            for n, gone in zip(data_fields, absent):
                object.__setattr__(obj, n, None if gone else next(children))
            for n, v in zip(meta_fields, meta):
                object.__setattr__(obj, n, v)
            return obj

        pytree.register_pytree_node(
            dcls, flatten, unflatten,
            serialized_type_name=f"{dcls.__module__}.{dcls.__qualname__}",
        )
        return dcls

    @staticmethod
    def static(**kwargs) -> Any:
        """Declare a static (context) field."""
        metadata = dict(kwargs.pop("metadata", {}))
        metadata[_STATIC_MARK] = True
        return dataclasses.field(metadata=metadata, **kwargs)

    @staticmethod
    def field(**kwargs) -> Any:
        """Declare a dynamic (leaf-bearing) field."""
        return dataclasses.field(**kwargs)

    @staticmethod
    def const(v: Any) -> "Const":
        """``v`` as a static constant carried in the tree's context."""
        return v if isinstance(v, Const) else Const(v)

    @staticmethod
    def partial(*closed_over) -> Callable[[Callable], "Closure"]:
        """``Pytree.partial(x)(fn)``: ``fn`` closed over the dynamic ``x``."""

        def decorator(fn: Callable) -> "Closure":
            return Closure(closed_over, fn)

        return decorator

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)  # type: ignore[type-var]

    def __repr__(self) -> str:
        parts = []
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) and v.ndim > 0:
                parts.append(f"{f.name}=<{v.dtype}{list(v.shape)}>")
            else:
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


@Pytree.dataclass
class Const(Pytree):
    """A static value carried in the tree's context, with no tensor leaves."""

    val: Any = Pytree.static()

    def unwrap(self) -> Any:
        return self.val

    def __call__(self, *args, **kwargs):
        return self.val(*args, **kwargs)


def _is_const(x: Any) -> bool:
    return isinstance(x, Const)


def tree_const(v: Any) -> Any:
    """Every leaf of ``v`` wrapped in ``Const``; a ``Const`` stays as it is."""
    return pytree.tree_map(lambda x: x if isinstance(x, Const) else Const(x), v, is_leaf=_is_const)


def tree_const_unwrap(v: Any) -> Any:
    """Every ``Const`` of ``v`` replaced by the value it carries."""
    return pytree.tree_map(lambda x: x.val if isinstance(x, Const) else x, v, is_leaf=_is_const)


@Pytree.dataclass
class Closure(Pytree):
    """A static callable with dynamic closed-over arguments; the source
    carrier of ``@gen`` functions."""

    dyn_args: tuple
    fn: Callable = Pytree.static()

    def __call__(self, *args, **kwargs):
        return self.fn(*self.dyn_args, *args, **kwargs)


class NoneFreeTuple(tuple):
    """A tuple whose ``None`` entries are no leaves: which entries are
    ``None`` rides in the tree's context, as a ``None`` field of a
    ``Pytree.dataclass`` does. It is a ``tuple`` in every other respect."""

    def __repr__(self):
        return f"NoneFreeTuple({tuple.__repr__(self)})"


def _flatten_none_free(t):
    return [x for x in t if x is not None], tuple(x is None for x in t)


def _unflatten_none_free(children, absent):
    children = iter(children)
    return NoneFreeTuple(None if gone else next(children) for gone in absent)


pytree.register_pytree_node(
    NoneFreeTuple, _flatten_none_free, _unflatten_none_free,
    serialized_type_name=f"{__name__}.NoneFreeTuple",
)


class NoneFreeDict(dict):
    """A dict whose ``None`` values are no leaves, as ``NoneFreeTuple``'s
    entries: which keys hold ``None`` rides in the tree's context. It is a
    ``dict`` in every other respect."""

    def __repr__(self):
        return f"NoneFreeDict({dict.__repr__(self)})"


def _flatten_none_free_dict(d):
    keys = tuple(d)
    return [d[k] for k in keys if d[k] is not None], (keys, tuple(d[k] is None for k in keys))


def _unflatten_none_free_dict(children, context):
    keys, absent = context
    children = iter(children)
    return NoneFreeDict((k, None if gone else next(children)) for k, gone in zip(keys, absent))


pytree.register_pytree_node(
    NoneFreeDict, _flatten_none_free_dict, _unflatten_none_free_dict,
    serialized_type_name=f"{__name__}.NoneFreeDict",
)


def none_free(tree: Any) -> Any:
    """``tree`` with every plain tuple (or ``NoneFreeTuple``) and every plain
    dict (or ``NoneFreeDict``) that holds a ``None``, at any depth of nested
    tuples and dicts, made a ``NoneFreeTuple`` or a ``NoneFreeDict``, so
    that ``torch.func.vmap`` can take and return it (JAX's pytree takes a
    ``None`` for an empty tree, torch's for a leaf). Other nodes are left as
    they are."""
    if type(tree) is dict or isinstance(tree, NoneFreeDict):
        items = {k: none_free(v) for k, v in tree.items()}
        if any(v is None for v in items.values()):
            return NoneFreeDict(items)
        return tree if all(items[k] is tree[k] for k in tree) else items
    if type(tree) is not tuple and not isinstance(tree, NoneFreeTuple):
        return tree
    items = tuple(none_free(x) for x in tree)
    return NoneFreeTuple(items) if any(x is None for x in items) else items


class PythonicPytree(Pytree):
    """Sugar for pytrees whose leaves share a leading axis: indexing,
    ``len``, iteration and concatenation.

    >>> import torch
    >>> @Pytree.dataclass
    ... class Pts(PythonicPytree):
    ...     x: torch.Tensor
    >>> pts = Pts(torch.arange(3.0))
    >>> len(pts), float(pts[1].x), len(pts + pts)
    (3, 1.0, 6)
    """

    def __getitem__(self, idx):
        return pytree.tree_map(lambda leaf: leaf[idx], self)

    def __len__(self) -> int:
        leaves = pytree.tree_leaves(self)
        return int(leaves[0].shape[0]) if leaves else 0

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __add__(self, other):
        return pytree.tree_map(lambda a, b: torch.cat([a, b], dim=0), self, other)


def nth(tree: Any, idx) -> Any:
    """Every leaf of ``tree`` indexed at ``idx`` along its leading axis."""
    return pytree.tree_map(lambda leaf: leaf[idx], tree)

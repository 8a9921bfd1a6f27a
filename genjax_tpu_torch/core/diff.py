"""Change tangents (``Diff``) for incremental computation.

Counterpart of ``genjax_tpu/core/diff.py``: a primal value paired with
``NoChange`` or ``UnknownChange``, propagated structurally by the edit
handlers, whose payoff is that an edit may reuse the subtraces that nothing
upstream changed. ``leaf_changes`` reads a tree's tangents leaf by leaf (the
reference's ``flat_changed`` and ``has_hidden_static_change`` in one);
``core/changes.py`` carries them through running torch ops
(``changed_through``).
"""

from __future__ import annotations

from typing import Any

import torch.utils._pytree as pytree

from .pytree import Pytree


class _ChangeTangent:
    _instances: dict[str, "_ChangeTangent"] = {}

    def __new__(cls, name: str):
        if name not in cls._instances:
            inst = super().__new__(cls)
            inst.name = name
            cls._instances[name] = inst
        return cls._instances[name]

    def __repr__(self):
        return self.name


NoChange = _ChangeTangent("NoChange")
UnknownChange = _ChangeTangent("UnknownChange")


def _is_diff(x) -> bool:
    return isinstance(x, Diff)


def _wrap(tree: Any, tangent) -> Any:
    """A ``Diff`` around every leaf; ``None`` is an empty subtree, as in JAX
    (an absent return value has nothing that could change)."""
    return pytree.tree_map(lambda p: None if p is None else Diff(p, tangent), tree)


@Pytree.dataclass
class Diff(Pytree):
    """A primal value paired with a change tangent.

    >>> from genjax_tpu_torch import Diff
    >>> args = (Diff.no_change(1.0), Diff.unknown_change(2.0))
    >>> Diff.static_check_no_change(args), Diff.tree_primal(args)
    (False, (1.0, 2.0))
    >>> Diff.static_check_no_change(Diff.tree_diff_no_change((1.0, 2.0)))
    True
    """

    primal: Any
    tangent: _ChangeTangent = Pytree.static(default=UnknownChange)

    # ----- constructors -----

    @staticmethod
    def unknown_change(v: Any) -> "Diff":
        return Diff(Diff.tree_primal(v), UnknownChange)

    @staticmethod
    def no_change(v: Any) -> "Diff":
        return Diff(Diff.tree_primal(v), NoChange)

    # ----- predicates -----

    @staticmethod
    def static_check_tree_diff(v: Any) -> bool:
        """True if every leaf-level node of ``v`` is a Diff."""
        leaves = pytree.tree_leaves(v, is_leaf=_is_diff)
        return all(_is_diff(leaf) for leaf in leaves) and len(leaves) > 0

    @staticmethod
    def static_check_no_change(v: Any) -> bool:
        """True if every Diff in ``v`` carries NoChange."""
        leaves = pytree.tree_leaves(v, is_leaf=_is_diff)
        return all(leaf.tangent is NoChange for leaf in leaves if _is_diff(leaf))

    # ----- tree ops -----

    @staticmethod
    def tree_primal(v: Any) -> Any:
        """Strip all Diff wrappers, leaving primal values."""
        return pytree.tree_map(lambda x: x.primal if _is_diff(x) else x, v, is_leaf=_is_diff)

    @staticmethod
    def tree_tangent(v: Any) -> Any:
        return pytree.tree_map(
            lambda x: x.tangent if _is_diff(x) else NoChange, v, is_leaf=_is_diff
        )

    @staticmethod
    def tree_diff(tree: Any, tangent_tree: Any) -> Any:
        return pytree.tree_map(Diff, tree, tangent_tree)

    @staticmethod
    def tree_diff_unknown_change(tree: Any) -> Any:
        return _wrap(Diff.tree_primal(tree), UnknownChange)

    @staticmethod
    def tree_diff_no_change(tree: Any) -> Any:
        return _wrap(Diff.tree_primal(tree), NoChange)


def leaf_changes(diff_tree: Any) -> list | None:
    """``(leaf, changed)`` for each primal leaf of a ``Diff``-annotated tree,
    ``None`` leaves left out (nothing can change there). A ``Diff`` around a
    subtree gives its tangent to every leaf under it; a leaf with no ``Diff``
    counts as changed. Returns None where a change has no leaf to carry it (a
    changed ``Diff`` whose primal has no leaf, such as a changed ``Const``):
    per-leaf flags cannot express that, and callers take everything as
    changed.

    >>> from genjax_tpu_torch import Diff
    >>> leaf_changes((Diff.no_change(1.0), Diff.unknown_change((2.0, None))))
    [(1.0, False), (2.0, True)]
    """
    out: list = []
    for node in pytree.tree_leaves(diff_tree, is_leaf=_is_diff):
        if _is_diff(node):
            changed = node.tangent is not NoChange
            leaves = [v for v in pytree.tree_leaves(node.primal) if v is not None]
            if changed and not leaves:
                return None
            out.extend((v, changed) for v in leaves)
        elif node is not None:
            out.append((node, True))
    return out


# Short aliases used throughout edit code.
tree_diff_primal = Diff.tree_primal
tree_diff_no_change = Diff.tree_diff_no_change
tree_diff_unknown_change = Diff.tree_diff_unknown_change

Argdiffs = Any  # tuple of Diff-annotated arguments
Retdiff = Any  # Diff-annotated return value

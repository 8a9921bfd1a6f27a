"""Change propagation on running torch ops.

Counterpart of the propagation half of ``genjax_tpu/lang/staged_edit.py``
and of ``changed_through`` in ``genjax_tpu/core/diff.py``. The reference
stages a body to a jaxpr and carries ``NoChange``/``UnknownChange`` through
it equation by equation: an equation's outputs changed iff any of its inputs
changed. Torch stages no such program, so ``ChangeMode`` applies the same
rule to the ops as they run. It is a ``TorchFunctionMode`` that keeps the set
of changed tensors by ``id`` (holding each one, so that no id is reused while
the mode lives):

- an op with a changed input marks each tensor it returns changed; an op
  with no changed input marks nothing;
- an in-place op, ``__setitem__`` or an ``out=`` op with a changed input
  marks its target changed, where the target is a tensor made under the mode
  that is no view and has had no view taken of it; any other target may have
  aliases the mode cannot see, and the mode degrades;
- an op with a changed input whose result holds a value that is no tensor
  (``item``, ``__bool__``, ``__float__``, ``__int__``, ``__index__``,
  ``tolist``, ``numpy``, ``__array__``, ``__format__`` and the like, but not
  a shape, dtype or device) degrades the mode: the value escaped to Python,
  where no mark can follow it;
- an op inside a ``torch.func`` transform that the body itself entered
  (``vmap``, ``grad``), while any value is marked, degrades the mode: the
  transform wraps its inputs in tensors of its own, which no mark follows.

Once degraded, every value counts as changed. That is the reference's
fallback to its conservative edit (``static_lang.py:363-367``), reached by
detection here where the reference gets a tracer error. The mode works under
``torch.func.vmap``: it sees the batched tensors that the lanes share, so
its marks are the same in every lane.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode, _get_current_function_mode, _pop_mode, _push_mode

from .diff import Diff, NoChange, UnknownChange, leaf_changes

# ops whose non-tensor results describe a tensor's layout, not its values
_METADATA = frozenset(
    {
        "__get__", "size", "dim", "ndimension", "numel", "nelement", "__len__", "stride",
        "is_floating_point", "is_complex", "element_size", "get_device", "is_contiguous",
        "storage_offset", "data_ptr", "_is_view", "__repr__", "__str__", "__hash__", "type",
        "is_signed", "__sizeof__",
    }
)
# values that hold no tensor: neither an op's arguments nor a closure reach one through them
_ATOMS = (bool, int, float, complex, str, bytes, slice, type(Ellipsis), type(None), type, types.ModuleType,
          types.BuiltinFunctionType, torch.dtype, torch.device, torch.Generator)


def _functorch_level():
    from torch._C._functorch import maybe_current_level

    return maybe_current_level()


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor under ``torch.func``'s wrappers (a vmapped lane's
    batched tensor, a gradient's tracking tensor)."""
    from torch._C import _functorch

    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t


def _collect(x, out: list) -> None:
    """Append the tensors of ``x`` to ``out``: the containers an op's
    arguments and results come in are walked here, anything else by
    ``pytree``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _collect(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _collect(y, out)
    elif not isinstance(x, _ATOMS):
        out.extend(t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor))


def _tensors(tree) -> list:
    out: list = []
    _collect(tree, out)
    return out


def _escapes(out) -> bool:
    """Does an op's result hold a value that is no tensor (and no None)?"""
    if isinstance(out, torch.Tensor) or out is None:
        return False
    if isinstance(out, (tuple, list)):
        return any(_escapes(x) for x in out)
    return True


def _inplace_targets(name: str, args: tuple, kwargs: dict) -> list:
    if "out" in kwargs and kwargs["out"] is not None:
        return _tensors(kwargs["out"])
    if name == "__setitem__" or (name.endswith("_") and not name.endswith("__")):
        return [args[0]] if args and isinstance(args[0], torch.Tensor) else []
    return []


def _reach(obj: Any, on_tensor: Callable[[torch.Tensor], bool], depth: int = 0, seen: set | None = None) -> bool:
    """Walk ``obj`` through Python closure cells, defaults, bound methods,
    partials, dataclass fields and containers, calling ``on_tensor`` on every
    tensor reached; True where it returned True for one, or where the walk
    met what it cannot see through (an object of an unknown kind, more than
    eight levels down). Every branch is walked, so ``on_tensor`` sees every
    tensor within reach."""
    seen = set() if seen is None else seen
    if depth > 8:
        return True
    if isinstance(obj, torch.Tensor):
        return bool(on_tensor(obj))
    if isinstance(obj, _ATOMS) or id(obj) in seen:
        return False
    seen.add(id(obj))

    def walk_all(xs) -> bool:
        return any([_reach(x, on_tensor, depth + 1, seen) for x in xs])

    if isinstance(obj, types.FunctionType):
        cells = []
        for cell in obj.__closure__ or ():
            try:
                cells.append(cell.cell_contents)
            except ValueError:  # an empty cell
                pass
        return walk_all(cells + list(obj.__defaults__ or ()))
    if isinstance(obj, types.MethodType):
        return walk_all([obj.__self__, obj.__func__])
    if isinstance(obj, functools.partial):
        return walk_all([obj.func, *obj.args, *obj.keywords.values()])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return walk_all([getattr(obj, f.name, None) for f in dataclasses.fields(obj)])
    if isinstance(obj, (tuple, list, set, frozenset)):
        return walk_all(list(obj))
    if isinstance(obj, dict):
        return walk_all(list(obj.values()))
    return True


class ChangeMode(TorchFunctionMode):
    """Marks the tensors that depend on changed ones while torch ops run
    under it (see the module docstring).

    >>> import torch
    >>> mode = ChangeMode()
    >>> a, b = torch.ones(2), torch.ones(2)
    >>> _ = mode.mark(a)
    >>> with mode:
    ...     c, d = a * 2, b + 1
    >>> mode.is_changed(c), mode.is_changed(d)
    (True, False)
    >>> with mode:
    ...     _ = float(c[0])
    >>> mode.degraded
    '__float__ read an edited value'
    """

    def __init__(self):
        super().__init__()
        self._changed: dict[int, torch.Tensor] = {}
        # tensors made under the mode that are no view and have no view
        self._fresh: dict[int, torch.Tensor] = {}
        self._paused = 0
        self._level = None
        self.degraded: str | None = None

    def __enter__(self):
        # the torch.func level the body runs at (an edit under vmap runs in one)
        self._level = _functorch_level()
        return super().__enter__()

    # ----- marks -----

    def mark(self, x: Any) -> bool:
        """Mark ``x`` changed; False where ``x`` is no tensor (a changed
        Python value has no identity to follow)."""
        if isinstance(x, torch.Tensor):
            self._changed[id(x)] = x
            return True
        return x is None

    def is_changed(self, x: Any) -> bool:
        if self.degraded is not None:
            return True
        return isinstance(x, torch.Tensor) and id(x) in self._changed

    def any_changed(self, tree: Any) -> bool:
        if self.degraded is not None:
            return True
        return bool(self._changed) and any(id(t) in self._changed for t in _tensors(tree))

    def degrade(self, reason: str) -> None:
        if self.degraded is None:
            self.degraded = reason
            self._changed.clear()
            self._fresh.clear()

    def captures_changed(self, obj: Any) -> bool:
        """Does ``obj`` reach a changed tensor through Python closure cells,
        fields or containers, which no pytree flattening sees? What the walk
        cannot see through (an object of an unknown kind, more than eight
        levels down) counts as changed."""
        return _reach(obj, self.is_changed)

    def handed_off(self, args: Any, callee: Any) -> None:
        """An addressed call received ``args`` and ``callee``: the tensors
        they reach, as arguments or closure leaves, leave ``_fresh``. The
        call's sub-edit runs unseen (``paused``), so a view it returns of
        one of them is a view the mode never saw, and a later write into
        the tensor must degrade."""
        def forget(t: torch.Tensor) -> bool:
            self._fresh.pop(id(t), None)
            return False

        for t in _tensors(args):
            forget(t)
        _reach(callee, forget)

    def paused(self) -> "_Paused":
        """Run torch ops unseen by the mode (an addressed call's sub-edit):
        they are neither marked nor intercepted."""
        return _Paused(self)

    # ----- the rule -----

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused or self.degraded is not None:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if self._changed and _functorch_level() != self._level:
            self.degrade(f"{name} ran inside a torch.func transform that the body entered")
            return func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        changed_in = any(id(t) in self._changed for t in inputs)
        targets = _inplace_targets(name, args, kwargs)
        if changed_in and any(id(t) not in self._fresh for t in targets):
            self.degrade(f"{name} wrote an edited value into a tensor that may have aliases")
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if changed_in:
            if name == "__iter__":
                out = list(out)
                for t in out:
                    self.mark(t)
                return iter(out)
            for t in targets:
                self.mark(t)
            if name not in _METADATA and _escapes(out):
                self.degrade(f"{name} read an edited value")
                return out
            for t in _tensors(out):
                self.mark(t)
        self._track_views(inputs, out)
        return out

    def _track_views(self, inputs: list, out: Any) -> None:
        for t in [out] if isinstance(out, torch.Tensor) else _tensors(out):
            if any(t is x for x in inputs):
                continue  # an in-place op returns its target
            if _unwrapped(t)._is_view():
                for x in inputs:
                    self._fresh.pop(id(x), None)
            else:
                self._fresh[id(t)] = t


class _Paused:
    """``ChangeMode.paused()``: the mode off the stack while it is on top
    (the usual case), else passing ops through."""

    def __init__(self, mode: ChangeMode):
        self.mode = mode
        self.popped = False

    def __enter__(self):
        if _get_current_function_mode() is self.mode:
            _pop_mode()
            self.popped = True
        else:
            self.mode._paused += 1

    def __exit__(self, *exc):
        if self.popped:
            _push_mode(self.mode)
        else:
            self.mode._paused -= 1
        return False


def mark_diffs(mode: ChangeMode, diff_tree: Any) -> str | None:
    """Mark the leaves of a ``Diff``-annotated tree that carry a change;
    returns why the mode cannot follow them (a change on a leaf that is no
    tensor, or on a ``Diff`` with no leaf at all), else None."""
    pairs = leaf_changes(diff_tree)
    if pairs is None:
        return "a changed value has no leaf to carry the change"
    for leaf, changed in pairs:
        if changed and not mode.mark(leaf):
            return f"a changed {type(leaf).__name__} is no tensor"
    return None


def diffs_of(mode: ChangeMode, tree: Any) -> Any:
    """``tree`` with ``UnknownChange`` on its leaves the mode marked and
    ``NoChange`` on the others."""
    if type(tree) is tuple and all(isinstance(x, (torch.Tensor, bool, int, float)) for x in tree):
        return tuple(Diff(v, UnknownChange if mode.is_changed(v) else NoChange) for v in tree)
    return pytree.tree_map(
        lambda v: None if v is None else Diff(v, UnknownChange if mode.is_changed(v) else NoChange), tree
    )


def changed_through(fn: Callable, diff_args: Any) -> Any:
    """Propagate per-leaf change tangents through a pure function: run
    ``fn(*primals)`` under a ``ChangeMode`` with the changed input leaves
    marked, and return its output with ``UnknownChange`` on the leaves that
    depend on a changed one. Returns None where the change cannot be
    followed (a changed leaf that is no tensor, or a value that escaped to
    Python); callers then take every output as changed.

    >>> import torch
    >>> from genjax_tpu_torch import Diff
    >>> a, b = torch.ones(2), torch.zeros(2)
    >>> out = changed_through(lambda x, y: (x * 2, y - 1), (Diff.unknown_change(a), Diff.no_change(b)))
    >>> [d.tangent for d in out]
    [UnknownChange, NoChange]
    """
    mode = ChangeMode()
    if mark_diffs(mode, diff_args) is not None:
        return None
    with mode:
        out = fn(*Diff.tree_primal(diff_args))
    if mode.degraded is not None:
        return None
    return diffs_of(mode, out)

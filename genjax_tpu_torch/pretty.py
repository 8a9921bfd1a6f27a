"""Rich rendering in a notebook.

Counterpart of ``genjax_tpu/pretty.py``, without ``treescope``: inside
IPython, ``pretty()`` makes the port's own tree printing the plain-text
``repr`` of every framework object; outside IPython it does nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .core.pytree import Pytree


def tree_text(obj: Any, indent: int = 0) -> str:
    """A framework object as an indented tree, one field a line, with each
    tensor as its dtype and shape (no value is read from the device).

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> print(tree_text(g.Mask(torch.zeros(2), True)))
    Mask(
      value=<torch.float32[2]>,
      flag=True,
    )
    """
    pad = "  " * (indent + 1)
    if isinstance(obj, torch.Tensor):
        return f"<{obj.dtype}{list(obj.shape)}>"
    if isinstance(obj, Pytree) and dataclasses.is_dataclass(obj):
        lines = [f"{pad}{f.name}={tree_text(getattr(obj, f.name), indent + 1)}," for f in dataclasses.fields(obj)]
        return "\n".join([f"{type(obj).__name__}(", *lines, "  " * indent + ")"])
    if isinstance(obj, (tuple, list)) and obj:
        open_, close = ("(", ")") if isinstance(obj, tuple) else ("[", "]")
        lines = [f"{pad}{tree_text(x, indent + 1)}," for x in obj]
        return "\n".join([open_, *lines, "  " * indent + close])
    return repr(obj)


def pretty() -> None:
    """Make ``tree_text`` the plain-text display of framework objects in
    the running IPython session; a no-op outside IPython."""
    try:
        import IPython
    except ImportError:
        return
    ip = IPython.get_ipython()
    if ip is None:
        return
    ip.display_formatter.formatters["text/plain"].for_type(Pytree, lambda obj, p, cycle: p.text(tree_text(obj)))


__all__ = ["pretty", "tree_text"]

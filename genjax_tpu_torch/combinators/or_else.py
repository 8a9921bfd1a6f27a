"""``or_else`` combinator: a two-branch switch gated by a boolean.

Counterpart of ``genjax_tpu/combinators/or_else.py``: the boolean becomes a
two-branch ``Switch`` index through a ``contramap``. Arguments are
``(flag, if_args, else_args)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..generative.gfi import GenerativeFunction
from .dimap import DimapCombinator
from .switch import SwitchCombinator


def _pre(flag, if_args, else_args):
    # branch 0 is `if` (flag true), branch 1 `else`. A Python or numpy bool
    # stays a Python int, so the switch runs only its branch
    if isinstance(flag, (bool, np.bool_)):
        idx = 0 if flag else 1
    else:
        idx = torch.logical_not(torch.as_tensor(flag)).to(torch.int64)
    return (idx, if_args, else_args)


def or_else(if_gen_fn: GenerativeFunction, else_gen_fn: GenerativeFunction) -> GenerativeFunction:
    """Boolean-gated branching; arguments ``(flag, if_args, else_args)``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> oe = g.or_else(
    ...     g.gen(lambda: g.normal(0.0, 0.1) @ "x"),
    ...     g.gen(lambda: g.normal(100.0, 0.1) @ "x"),
    ... )
    >>> tr = oe.simulate(torch.Generator().manual_seed(0), (True, (), ()))
    >>> bool(tr.get_retval() < 50.0)   # flag True took the if-branch
    True
    """
    return DimapCombinator(SwitchCombinator((if_gen_fn, else_gen_fn)), pre=_pre, info="or_else")

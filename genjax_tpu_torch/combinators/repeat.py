"""``repeat`` combinator: n i.i.d. copies of a generative function.

Counterpart of ``genjax_tpu/combinators/repeat.py``, which maps a
``contramap`` over a dummy ``jnp.zeros(n)``: here the arguments are shared
by every lane (``in_axes=None``) and the lane count is ``axis_size``, so no
dummy is made (one made here would sit on the CPU whatever device the
arguments are on). Addresses gain a leading integer component, the
repetition.
"""

from __future__ import annotations

from ..generative.gfi import GenerativeFunction
from .vmap import VmapCombinator


def repeat(*, n: int):
    """``repeat(n=n)(gen_fn)``: the same arguments, choices and retval with a
    leading axis of ``n`` i.i.d. repetitions.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> one = g.gen(lambda: g.normal(0.0, 1.0) @ "v")
    >>> tr = g.repeat(n=4)(one).simulate(torch.Generator().manual_seed(0), ())
    >>> tuple(tr.get_retval().shape)
    (4,)
    >>> tuple(tr.get_choices()[2, "v"].shape)
    ()
    """

    def decorator(gen_fn: GenerativeFunction) -> VmapCombinator:
        return VmapCombinator(gen_fn, in_axes=None, axis_size=n)

    return decorator

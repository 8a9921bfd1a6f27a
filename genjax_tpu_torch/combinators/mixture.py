"""``mix`` combinator: a mixture over component generative functions.

Counterpart of ``genjax_tpu/combinators/mixture.py``: an ``@gen`` model
that draws ``categorical(logits) @ "mixture_component"`` and runs the
component through ``switch(...) @ "component_sample"``. Arguments are
``(logits, args_1, ..., args_n)``. The drawn index is a tensor, so every
component runs and the draw's lane picks one (``switch``).
"""

from __future__ import annotations

from ..dists import categorical
from ..generative.gfi import GenerativeFunction
from ..lang.static_lang import gen
from .switch import SwitchCombinator


def mix(*gen_fns: GenerativeFunction) -> GenerativeFunction:
    """A mixture: ``mix(f1, ..., fn)(logits, args_1, ..., args_n)``.

    >>> import torch
    >>> import genjax_tpu_torch as g
    >>> mx = g.mix(
    ...     g.gen(lambda: g.normal(-2.0, 0.5) @ "x"),
    ...     g.gen(lambda: g.normal(2.0, 0.5) @ "x"),
    ... )
    >>> tr = mx.simulate(torch.Generator().manual_seed(0), (torch.log(torch.tensor([0.5, 0.5])), (), ()))
    >>> tr.get_choices().static_addresses()
    ('mixture_component', 'component_sample')
    """
    switch_fn = SwitchCombinator(tuple(gen_fns))

    @gen
    def mixture_model(logits, *args):
        mix_idx = categorical(logits) @ "mixture_component"
        return switch_fn(mix_idx, *args) @ "component_sample"

    return mixture_model

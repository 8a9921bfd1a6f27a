"""Posterior-predictive sampling from fitted draws.

Counterpart of ``genjax_tpu/inference/predictive.py``: replay posterior
draws through the model, the addresses that hold draws constrained and
every other address sampled fresh, as one ``torch.func.vmap`` of
``generate`` over the draws, where the key or generator lives. Under a key
draw ``i`` is made under the ``i``-th of ``split(key, n)``, as the
reference's; a ``torch.Generator`` gives each draw its own numbers
(``randomness="different"``).

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     mu = g.normal(0.0, 1.0) @ "mu"
...     _ = g.normal(mu, 1.0) @ "y"
>>> out = posterior_predictive(torch.Generator().manual_seed(0), model, (), {"mu": torch.zeros(5)})
>>> tuple(out["y"].shape), out["mu"].tolist()
((5,), [0.0, 0.0, 0.0, 0.0, 0.0])
"""

from __future__ import annotations

from typing import Any

import torch

from ..core import keys
from ..generative.choice_map import C, ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from .sample import PosteriorSamples


def _draws_dict(samples) -> dict:
    """A draws container as ``{path: (n_draws, *event)}``."""
    if isinstance(samples, PosteriorSamples):
        out = {}

        def walk(chm, prefix=()):
            v = chm.get_value()
            if v is not None:
                if isinstance(v, Mask):
                    v = v.value
                # (chains, samples, *event) -> (chains * samples, *event)
                out[prefix if len(prefix) > 1 else prefix[0]] = v.reshape((-1,) + tuple(v.shape[2:]))
                return
            for a in chm.static_addresses():
                walk(chm.get_submap(a), prefix + (a,))

        walk(samples.positions)
        return out
    return {k: torch.as_tensor(v) for k, v in dict(samples).items()}


def posterior_predictive(
    gen: torch.Generator,
    model: GenerativeFunction,
    args: tuple,
    samples,
    *,
    n_draws: int | None = None,
) -> Any:
    """Replay posterior draws through ``model`` on ``gen``'s device: every
    address in ``samples`` is constrained to a draw, every other address
    (the predictive sites) is drawn fresh. Returns the predictive traces'
    choices, batched over draws: read ``out[addr]``.

    ``samples``: a ``PosteriorSamples`` (chains and samples flattened into
    one draw axis) or a dict ``{address path: (n, *event)}``. ``n_draws``:
    an evenly spaced subsample of the draws (the floor of
    ``linspace(0, n - 1, n_draws)``, in integers)."""
    draws = _draws_dict(samples)
    if not draws:
        raise ValueError("posterior_predictive needs at least one site")
    sizes = {k: int(v.shape[0]) for k, v in draws.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"sites disagree on the draw count: {sizes}")
    n = min(sizes.values())
    draws = {k: v.to(gen.device) for k, v in draws.items()}
    if n_draws is not None and n_draws < n:
        steps = torch.arange(n_draws, device=gen.device)
        idx = steps * (n - 1) // max(n_draws - 1, 1)
        draws = {k: v[idx] for k, v in draws.items()}
        n = n_draws
    paths = list(draws.keys())

    def one(stream, *row):
        cm = ChoiceMap.empty()
        for p, v in zip(paths, row):
            cm = cm | C[p if isinstance(p, tuple) else (p,)].set(v)
        return model.generate(stream, cm, args)[0].get_choices()

    return keys.vmap_streams(one, gen, n, in_dims=(0,) * len(paths))(*(draws[p] for p in paths))

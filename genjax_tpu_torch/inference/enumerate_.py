"""Exact inference by enumeration over discrete supports.

Counterpart of ``genjax_tpu/inference/enumerate_.py``: for a model whose
unobserved addresses are discrete with known finite supports, the joint
table is one ``torch.func.vmap`` of ``assess`` over the flat index of the
supports' cartesian product, giving exact posteriors, marginals and the
log-evidence. Enumeration is exponential in the number of sites; the
table's size is checked before anything runs.

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     z = g.categorical(torch.log(torch.tensor([0.2, 0.8]))) @ "z"
...     _ = g.normal(torch.where(z == 1, 1.0, -1.0), 1.0) @ "x"
>>> res = enumerate_posterior(model, (), g.C["x"].set(0.0), {"z": torch.arange(2)}, device="cpu")
>>> torch.exp(res.log_posterior)
tensor([0.2000, 0.8000])
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.device import entry_device, to_device
from ..core.pytree import Pytree
from ..generative.choice_map import C, ChoiceMap
from ..generative.gfi import GenerativeFunction

_MAX_TABLE = 1 << 22  # 4M joint states: 16 MB of float32


@Pytree.dataclass
class EnumerationResult(Pytree):
    """Exact enumeration output.

    ``log_joint``: unnormalized ``log p(sites = combo, observations)``,
    shaped ``(K1, ..., Kn)`` in the order the sites were given.
    ``log_evidence``: ``log p(observations)``, the logsumexp of the table.
    ``log_posterior``: the normalized table. ``supports``: the candidate
    values of each site, in axis order."""

    log_joint: Any
    log_evidence: Any
    log_posterior: Any
    supports: tuple

    def marginal(self, axis: int):
        """The exact marginal posterior of one site (log space)."""
        axes = tuple(i for i in range(self.log_posterior.ndim) if i != axis)
        return torch.logsumexp(self.log_posterior, dim=axes) if axes else self.log_posterior


def _set_path(path, value) -> ChoiceMap:
    return C[path if isinstance(path, tuple) else (path,)].set(value)


def enumerate_posterior(
    model: GenerativeFunction,
    args: tuple,
    observations: ChoiceMap,
    sites: dict,
    *,
    device="cuda",
) -> EnumerationResult:
    """The exact posterior over ``sites`` given ``observations``, on
    ``device`` (the card by default; without one it raises, and
    ``device="cpu"`` runs on the CPU).

    ``sites`` maps each unobserved address (str or tuple path) to its
    support. Every unobserved address of the model must appear: ``assess``
    raises ``MissingAddress`` for a forgotten one."""
    device = entry_device(device, "enumerate_posterior")
    names = list(sites.keys())
    supports = tuple(torch.as_tensor(sites[n], device=device) for n in names)
    sizes = tuple(int(s.shape[0]) for s in supports)
    total = 1
    for k in sizes:
        total *= k
    if total > _MAX_TABLE:
        raise ValueError(
            f"enumeration table has {total} joint states (> {_MAX_TABLE}); marginalize sites or use "
            "sampling inference"
        )
    observations = to_device(observations, device)
    args = to_device(args, device)
    # the flat cartesian product of support indices, (total, n_sites)
    if sizes:
        grids = torch.meshgrid(*[torch.arange(k, device=device) for k in sizes], indexing="ij")
        flat_idx = torch.stack([gr.reshape(-1) for gr in grids], dim=-1)
    else:
        flat_idx = torch.zeros((1, 0), dtype=torch.int64, device=device)

    def log_joint_of(idx_row):
        cm = observations
        for j, name in enumerate(names):
            cm = cm | _set_path(name, supports[j][idx_row[j]])
        score, _ = model.assess(cm, args)
        return score

    flat = torch.func.vmap(log_joint_of)(flat_idx)
    log_joint = flat.reshape(sizes) if sizes else flat[0]
    log_evidence = torch.logsumexp(log_joint.reshape(-1), dim=0)
    return EnumerationResult(
        log_joint=log_joint,
        log_evidence=log_evidence,
        log_posterior=log_joint - log_evidence,
        supports=supports,
    )

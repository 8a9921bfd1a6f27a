"""The rows of a column twin's chains: all on this rank, or this rank's block
of a row-sharded (tensor-parallel) density's rows.

A density whose position rows are split over a model axis
(``parallel.tensor_parallel_logdensity``) carries ``.row_shard``: the sum of
a per-chain partial over that axis (one collective), the rank's place on it
(the axis size, the rank's index, its row block) and the chain axis its
columns are split over. This layer does not import ``parallel``; it reads
the attribute, as it reads ``.body``.

Every sum over rows inside the HMC, NUTS and ChEES twins (the kinetic
energies, the U-turn dot products, the ChEES criterion) goes through
``Rows.sums``, one reduction a call; the momenta are drawn full height from
a stream seeded alike on the whole model axis and each rank keeps its own
rows, so the model ranks of a chain draw, integrate and accept alike. A
density without ``.row_shard`` runs as it always has.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core import keys
from ..core.device import stream_seed


def row_shard(logdensity_cols):
    """The density's ``.row_shard``, or None for a density whose rows all
    live on this rank."""
    return getattr(logdensity_cols, "row_shard", None)


def refuse_row_sharded(logdensity_cols, entry: str) -> None:
    """Raise for a row-sharded density in a sampler that sums over rows
    without the model axis: it would return a wrong chain."""
    shard = row_shard(logdensity_cols)
    if shard is not None:
        raise ValueError(
            f"{entry} does not sample a row-sharded density: its rows are split over the "
            f"{shard.size}-rank model axis {shard.model_axis!r}, and {entry} sums over the rows "
            "this rank holds. Sample it with pallas_hmc or pallas_nuts (backend='torch'), "
            "nuts_sweep_cols, chees_hmc or their warmups."
        )


def chain_mesh(logdensity_cols, mesh, axis: str):
    """``(mesh, axis)`` over which a sampler's adaptation averages across
    chains: the caller's, or where none is given and the density's columns
    are split over a chain axis of more than one rank, that axis (on one
    rank the local statistics are the whole's, as the unsharded run
    computes them)."""
    shard = row_shard(logdensity_cols)
    if mesh is None and shard is not None and shard.chain_size > 1:
        return shard.mesh, shard.chain_axis
    return mesh, axis


class Rows:
    """How a twin reduces over the rows of ``(D_local, N)`` positions of
    ``logdensity_cols`` and draws their momenta."""

    def __init__(self, logdensity_cols: Callable, d_local: int):
        self.shard = row_shard(logdensity_cols)
        if self.shard is None:
            self.d_full, self.block = d_local, slice(None)
        else:
            self.d_full, self.block = d_local * self.shard.size, self.shard.rows(d_local)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every row of the chain, ``(N,)``."""
        s = torch.sum(x, dim=0)
        return s if self.shard is None else self.shard.sum(s)

    def sums(self, *xs: torch.Tensor) -> tuple:
        """Each of ``xs`` summed over every row of the chain, in one
        reduction."""
        if self.shard is None:
            return tuple(torch.sum(x, dim=0) for x in xs)
        return tuple(self.shard.sum(torch.stack([torch.sum(x, dim=0) for x in xs])).unbind(0))

    def all_finite(self, x: torch.Tensor) -> torch.Tensor:
        """Whether every row of each chain is finite, ``(N,)`` bool."""
        if self.shard is None:
            return torch.all(torch.isfinite(x), dim=0)
        return self.sum((~torch.isfinite(x)).to(torch.float32)) == 0

    def normal(self, draw: Callable[[int], torch.Tensor]) -> torch.Tensor:
        """This rank's rows of ``draw(D_full)``, the full-height draw every
        model rank makes alike."""
        return draw(self.d_full)[self.block]

    def seed(self, seed):
        """The stream of this rank's chains: an int ``seed`` as given, or on
        a chain axis of more than one rank ``stream_seed(seed,
        chain_index)``; a generator is used as it is (the caller holds it in
        the same state on every model rank of a chain)."""
        if self.shard is None or isinstance(seed, torch.Generator) or self.shard.chain_size <= 1:
            return seed
        return stream_seed(int(seed), self.shard.chain_index)

    def stream(self, seed, device, entry: str, impl: str = "rbg"):
        """``keys.sampler_stream`` of this rank's ``seed``: an int seed
        is the rank's (``seed``), a key or a generator is used as it is. A
        key cannot be split over a chain axis of more than one rank, and
        raises there."""
        if keys.is_key(seed) and self.shard is not None and self.shard.chain_size > 1:
            raise ValueError(
                f"{entry}: a key is not split over the {self.shard.chain_size}-rank chain axis "
                f"{self.shard.chain_axis!r} of a density row-sharded over the model axis "
                f"{self.shard.model_axis!r}; pass an int seed or a torch.Generator"
            )
        return keys.sampler_stream(self.seed(seed), device, entry, impl)

    def chain_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A rank-local mean over chains made the mean over every chain of
        the mesh."""
        return x if self.shard is None else self.shard.chain_mean(x)

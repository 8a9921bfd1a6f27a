"""Simulation-based calibration (Talts, Betancourt, Simpson, Vehtari &
Gelman 2018).

Counterpart of ``genjax_tpu/inference/sbc.py``. Draw ``theta_0`` from the
prior, simulate data given it, run the posterior sampler on the data, and
record the rank of ``theta_0`` among the posterior draws: for a sampler of
the exact posterior the ranks are uniform on ``{0, ..., L}`` for every
parameter. The battery is one ``torch.func.vmap`` over simulations: under a
key simulation ``i`` splits the ``i``-th of ``split(key, n_sims)`` into its
prior draw's and its sampler's keys, as the reference does; a
``torch.Generator`` is shared by the simulations, each drawing its own. The
uniformity test's chi-square tail is ``torch.special.gammaincc``, where the
reference calls ``jax.scipy.stats.chi2``.

>>> import torch
>>> ranks = torch.tensor([[0], [1], [2], [3]])
>>> pvals, counts = sbc_uniformity(ranks, 3, n_bins=4)
>>> counts.tolist(), float(pvals[0])
([[1, 1, 1, 1]], 1.0)
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from .requests.grad_view import split_ravel


@Pytree.dataclass
class SBCResult(Pytree):
    """``ranks (n_sims, d)`` of the prior draw among ``n_draws`` posterior
    draws for each raveled parameter dimension (ranks in ``{0..n_draws}``),
    and the draw count."""

    ranks: Any
    n_draws: int = Pytree.static()


def sbc_ranks(
    gen,
    model: GenerativeFunction,
    args: tuple,
    selection: Selection,
    sampler: Callable,
    *,
    n_sims: int,
    device="cuda",
) -> SBCResult:
    """Run the SBC battery on ``device``, the card by default
    (``device="cpu"`` for the CPU; without a card the default raises);
    ``gen`` is a key (placed there), a generator there or an int seed.

    ``model`` is the generative program (prior over ``selection``,
    likelihood over its complement); ``sampler(gen, constraint)`` returns
    ``(n_draws, d)`` posterior draws of the raveled selected parameters
    given the simulated observations, raveled as ``split_ravel`` ravels
    ``filter_eager(selection)``. It runs under ``torch.func.vmap`` over
    simulations, with a simulation's key or the shared generator
    (``randomness="different"``). For a calibrated pipeline
    each column of ``ranks`` is uniform: test it with
    :func:`sbc_uniformity`."""
    gen, device = keys.entry_stream(gen, device, "sbc_ranks")
    args = to_device(args, device)
    meta = {}

    def one(stream):
        k_sim, k_post = keys.split_stream(stream)
        chm = model.simulate(k_sim, args).get_choices()
        theta0, _ = split_ravel(chm.filter_eager(selection))
        if theta0.shape[0] == 0:
            raise ValueError(
                "sbc_ranks: the selection contains no continuous (inexact-dtype) parameters; discrete "
                "latents need tie-broken ranks and are not supported by this battery"
            )
        draws = sampler(k_post, chm.filter(~selection))  # (n_draws, d)
        meta["n_draws"] = int(draws.shape[0])
        return torch.sum(draws < theta0[None, :], dim=0)

    ranks = keys.vmap_streams(one, gen, n_sims)()
    return SBCResult(ranks=ranks, n_draws=meta["n_draws"])


def sbc_uniformity(result_or_ranks, n_draws: int | None = None, *, n_bins: int = 20):
    """The chi-square uniformity test of each parameter dimension: returns
    ``(pvalues (d,), counts (d, n_bins))``. Ranks in ``{0..L}`` fall into
    ``n_bins`` equiprobable bins (choose ``n_bins`` dividing ``L + 1``)."""
    if hasattr(result_or_ranks, "ranks"):
        ranks = torch.as_tensor(result_or_ranks.ranks)
        n_draws = result_or_ranks.n_draws if n_draws is None else n_draws
    else:
        ranks = torch.as_tensor(result_or_ranks)
    if n_draws is None or n_draws <= 0:
        raise ValueError(f"sbc_uniformity needs a positive n_draws, got {n_draws!r}")
    n_sims = ranks.shape[0]
    edges = (n_draws + 1) * torch.arange(1, n_bins, device=ranks.device, dtype=torch.float32) / n_bins
    bins = torch.sum(ranks[..., None] >= edges, dim=-1)  # (n_sims, d)
    counts = torch.stack([torch.bincount(col, minlength=n_bins) for col in bins.T])
    expected = n_sims / n_bins
    stat = torch.sum((counts - expected) ** 2 / expected, dim=1)
    # the chi-square survival function at n_bins - 1 degrees of freedom
    pvals = torch.special.gammaincc(torch.tensor((n_bins - 1) / 2.0, device=stat.device), stat / 2.0)
    return pvals, counts

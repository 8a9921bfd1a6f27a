"""Resampling on one device: weight statistics, index and count generators,
and the row moves that apply them to a particle pytree.

Counterpart of the single-device half of ``genjax_tpu/parallel/
resampling.py`` (``_normalize`` to ``resample_particles``). The collective
half (``collective_*``, resampling across devices) waits for
``torch.distributed`` (``ROADMAP.md`` item 15).

Every function runs where its weights live and draws from a
``torch.Generator`` there. Nothing reads a value back to the host:
``torch.repeat_interleave`` is given its ``output_size``, which it would
otherwise read from the counts on every resample. The monotonic methods
(systematic, stratified) resample by counts, without a binary search. The
reference packs the 4-byte leaves into one matrix before a row move (a TPU
measurement); on the card a move leaf by leaf is faster (``chip_smoke.py``'s
``[pf row moves]``), so nothing is packed. ``_systematic_counts`` and
``_stratified_counts`` take their uniforms as arguments, so that the counts
can be held against the reference's from the same uniforms.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils._pytree as pytree


def _normalize(log_weights: torch.Tensor) -> torch.Tensor:
    return log_weights - torch.logsumexp(log_weights, dim=0)


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / sum of the squared normalised weights."""
    return torch.exp(-torch.logsumexp(2.0 * _normalize(log_weights), dim=0))


def _last_bucket(t: torch.Tensor, n: int) -> torch.Tensor:
    """Per-source copy counts from the cumulative target counts ``t``, with
    the last bucket ending at exactly ``n``: the float32 CDF need not end
    at 1 (at 131,072 particles it does not). A running maximum first: the
    card's parallel ``cumsum`` rounds neighbouring sums along different
    paths, so where a weight underflows the CDF can step back, and a count
    would go negative; on a monotone CDF it changes nothing."""
    t = torch.cummax(t, dim=0).values
    t = torch.cat([t[:-1], t.new_full((1,), n)])
    return torch.diff(t, prepend=t.new_zeros(1))


def _systematic_counts(u0: torch.Tensor, log_weights: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic counts at the uniform ``u0``: target ``j`` lands on source
    ``i`` iff ``cdf_{i-1} <= (j + u0) / n < cdf_i``, so the number of
    targets below ``cdf_i`` is ``ceil(n cdf_i - u0)``."""
    cdf = torch.cumsum(torch.exp(_normalize(log_weights)), dim=0)
    t = torch.clamp(torch.ceil(n * cdf - u0), 0, n).to(torch.int64)
    return _last_bucket(t, n)


def systematic_counts(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Per-source copy counts for systematic resampling (int64, summing to
    ``n``), in O(K) arithmetic from one uniform."""
    n = log_weights.shape[0] if n is None else n
    u0 = torch.rand((), generator=gen, device=log_weights.device)
    return _systematic_counts(u0, log_weights, n)


def _stratified_counts(us: torch.Tensor, log_weights: torch.Tensor, n: int) -> torch.Tensor:
    """Stratified counts at the ``n`` uniforms ``us``: the strata points
    ``(j + us_j) / n`` are sorted, so a search of the CDF among them gives
    the cumulative counts."""
    cdf = torch.cumsum(torch.exp(_normalize(log_weights)), dim=0)
    points = (torch.arange(n, device=us.device) + us) / n
    t = torch.searchsorted(points, cdf, side="left")
    return _last_bucket(t, n)


def stratified_counts(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Per-source copy counts for stratified resampling (one uniform a
    stratum)."""
    n = log_weights.shape[0] if n is None else n
    us = torch.rand(n, generator=gen, device=log_weights.device)
    return _stratified_counts(us, log_weights, n)


def _indices_from_counts(counts: torch.Tensor, n: int) -> torch.Tensor:
    k = counts.shape[0]
    return torch.repeat_interleave(torch.arange(k, device=counts.device), counts, output_size=n)


def systematic_indices(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Systematic (low-variance) resampling indices, ascending."""
    n = log_weights.shape[0] if n is None else n
    return _indices_from_counts(systematic_counts(gen, log_weights, n), n)


def stratified_indices(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Stratified resampling indices, ascending."""
    n = log_weights.shape[0] if n is None else n
    return _indices_from_counts(stratified_counts(gen, log_weights, n), n)


def _draw(gen: torch.Generator, probs: torch.Tensor, n: int) -> torch.Tensor:
    return torch.multinomial(probs, n, replacement=True, generator=gen)


def multinomial_indices(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """``n`` independent draws of a source index from the normalised
    weights."""
    n = log_weights.shape[0] if n is None else n
    return _draw(gen, torch.exp(_normalize(log_weights)), n)


def residual_indices(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Residual resampling: ``floor(n w_i)`` deterministic copies of each
    source fill the first slots, multinomial draws from the remainders
    ``n w_i - floor(n w_i)`` the rest. Fixed shapes: every slot draws, and
    the deterministic slots keep their copy."""
    k = log_weights.shape[0]
    n = k if n is None else n
    w = torch.exp(_normalize(log_weights))
    counts = torch.floor(n * w).to(torch.int64)
    resid = torch.clamp(n * w - counts, min=1e-37)
    slots = torch.arange(n, device=w.device)
    det_idx = torch.searchsorted(torch.cumsum(counts, dim=0), slots, side="right")
    rand_idx = _draw(gen, resid / resid.sum(), n)
    return torch.where(slots < counts.sum(), torch.clamp(det_idx, 0, k - 1), rand_idx)


_METHODS = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
    "residual": residual_indices,
}

_COUNT_METHODS = {
    "systematic": systematic_counts,
    "stratified": stratified_counts,
}


def resample_indices(gen: torch.Generator, log_weights, n: int | None = None, method: str = "systematic"):
    return _METHODS[method](gen, log_weights, n)


def _gather(particles: Any, idx: torch.Tensor) -> Any:
    return pytree.tree_map(lambda v: torch.index_select(v, 0, idx), particles)


def redistribute(particles: Any, counts: torch.Tensor, n: int | None = None) -> Any:
    """Copy particle ``i`` ``counts[i]`` times, contiguously: the
    redistribution of a monotonic resampler (systematic, stratified). A
    single leaf is repeated by its counts; a tree of more leaves is gathered
    leaf by leaf along one index vector made from the counts, which launches
    fewer kernels than a repeat of each leaf."""
    k = counts.shape[0]
    total = k if n is None else n
    leaves = pytree.tree_leaves(particles)
    if len(leaves) == 1:
        return pytree.tree_map(
            lambda v: torch.repeat_interleave(v, counts, dim=0, output_size=total), particles
        )
    return _gather(particles, _indices_from_counts(counts, total))


def packed_take(particles: Any, idx: torch.Tensor, k: int) -> Any:
    """Gather the rows ``idx`` of every leaf of a particle pytree (the
    reference's name: there the 4-byte leaves are packed into one matrix
    first, which the card does not need; ``k`` is the source count)."""
    return _gather(particles, idx)


def resample_particles(gen: torch.Generator, particles: Any, log_weights, n: int | None = None,
                       method: str = "systematic") -> Any:
    """Resample a particle pytree: the monotonic methods by counts, the
    others by a gather at their indices."""
    k = log_weights.shape[0]
    n = k if n is None else n
    if method in _COUNT_METHODS:
        return redistribute(particles, _COUNT_METHODS[method](gen, log_weights, n), n)
    return packed_take(particles, _METHODS[method](gen, log_weights, n), k)

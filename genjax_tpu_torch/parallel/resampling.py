"""Resampling on one device: weight statistics, index and count generators,
and the row moves that apply them to a particle pytree.

Counterpart of ``genjax_tpu/parallel/resampling.py``: the single-device
half (``_normalize`` to ``resample_particles``) and the collective half
(``collective_weight_stats``, ``collective_log_normalizer``,
``collective_resample``), which every rank of a mesh axis runs on its own
shard of the particles, its reductions calls of ``parallel/_comm.py``.

Every function runs where its weights live and draws from a
``torch.Generator`` there, or from a key (``core/keys.py``): under a key it
draws what the reference draws from the same key (``uniform(key)`` for the
systematic offset, ``uniform(key, (n,))`` for the strata,
``categorical(key, ..., shape=(n,))`` for the multinomial and residual
draws), and sums the CDF in XLA's association (``_xla_cumsum``), its
``n cdf - u0`` one fused multiply-add as XLA makes it, so that the counts
flip where the reference's do and nowhere else. Nothing reads a value back
to the host:
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

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..generative.typecheck import check_generator
from . import _comm


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


_SCAN_BASE = 16


def _running_sums(x: torch.Tensor) -> torch.Tensor:
    """The running sums along the last axis, one float32 add at a time."""
    acc = x[..., 0]
    out = [acc]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis in the association XLA's CPU
    compiler gives it, bit for bit: up to 16 elements a running sum; above,
    rows of 16 (zero-padded) summed so, and each row's sums shifted by the
    sums, taken the same way, of the rows before it. Every step is an
    exact IEEE add, so the card gives the same sums."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        return _running_sums(x)
    rows = -(-n // _SCAN_BASE)
    pad = x.new_zeros(x.shape[:-1] + (rows * _SCAN_BASE - n,))
    within = _running_sums(torch.cat([x, pad], dim=-1).unflatten(-1, (rows, _SCAN_BASE)))
    before = _xla_cumsum(within[..., -1])
    before = torch.cat([torch.zeros_like(before[..., :1]), before[..., :-1]], dim=-1)
    return (within + before.unsqueeze(-1)).flatten(-2)[..., :n]


def _reference_cdf(log_weights: torch.Tensor) -> torch.Tensor:
    return _xla_cumsum(torch.exp(_normalize(log_weights)))


def _systematic_counts_keyed(u0: torch.Tensor, log_weights: torch.Tensor, n: int) -> torch.Tensor:
    """``_systematic_counts`` as the reference computes it: the CDF summed
    in XLA's association and ``n cdf - u0`` one fused multiply-add."""
    t = torch.ceil(keys._fma(torch.full_like(u0, n), _reference_cdf(log_weights), -u0))
    return _last_bucket(torch.clamp(t, 0, n).to(torch.int64), n)


def systematic_counts(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Per-source copy counts for systematic resampling (int64, summing to
    ``n``), in O(K) arithmetic from one uniform."""
    n = log_weights.shape[0] if n is None else n
    if keys.is_key(gen):
        return _systematic_counts_keyed(keys.uniform(gen), log_weights, n)
    u0 = torch.rand((), generator=gen, device=log_weights.device)
    return _systematic_counts(u0, log_weights, n)


def _stratified_counts(us: torch.Tensor, log_weights: torch.Tensor, n: int, cdf=None) -> torch.Tensor:
    """Stratified counts at the ``n`` uniforms ``us``: the strata points
    ``(j + us_j) / n`` are sorted, so a search of the CDF among them gives
    the cumulative counts."""
    if cdf is None:
        cdf = torch.cumsum(torch.exp(_normalize(log_weights)), dim=0)
    points = (torch.arange(n, device=us.device) + us) / n
    t = torch.searchsorted(points, cdf, side="left")
    return _last_bucket(t, n)


def stratified_counts(gen: torch.Generator, log_weights: torch.Tensor, n: int | None = None):
    """Per-source copy counts for stratified resampling (one uniform a
    stratum)."""
    n = log_weights.shape[0] if n is None else n
    if keys.is_key(gen):
        return _stratified_counts(keys.uniform(gen, (n,)), log_weights, n, _reference_cdf(log_weights))
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
    if keys.is_key(gen):
        return keys.categorical(gen, _normalize(log_weights), shape=(n,))
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
    slots = torch.arange(n, device=w.device)
    det_idx = torch.searchsorted(torch.cumsum(counts, dim=0), slots, side="right")
    if keys.is_key(gen):
        # the remainder n w - counts as XLA fuses it, and the reference's draw
        resid = torch.clamp(keys._fma(torch.full_like(w, n), w, -counts.to(w.dtype)), min=1e-37)
        rand_idx = keys.categorical(gen, torch.log(resid), shape=(n,))
    else:
        resid = torch.clamp(n * w - counts, min=1e-37)
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


# ----------------------------------------------------------------------
# collective (cross-shard) resampling: every rank of the axis calls these
# ----------------------------------------------------------------------


def collective_weight_stats(log_weights: torch.Tensor, mesh, axis: str = "batch"):
    """The global ``(ess, log_normalizer)`` of a weight vector sharded over
    ``axis``, in two collectives: one max for the stable shift, then one sum
    of the pair ``(sum w, sum w^2)``. The same values on every rank."""
    global_max = _comm.all_reduce_max(torch.max(log_weights), mesh, axis)
    shifted = torch.exp(log_weights - global_max)
    sums = _comm.all_reduce_sum(torch.stack([shifted.sum(), (shifted * shifted).sum()]), mesh, axis)
    ess = sums[0] * sums[0] / sums[1]
    k_global = log_weights.shape[0] * _comm.axis_size(mesh, axis)
    return ess, global_max + torch.log(sums[0]) - math.log(k_global)


def collective_log_normalizer(log_weights: torch.Tensor, mesh, axis: str = "batch") -> torch.Tensor:
    """``log (1 / K) sum_global exp(lw)``, stably: one max and one sum."""
    global_max = _comm.all_reduce_max(torch.max(log_weights), mesh, axis)
    total = _comm.all_reduce_sum(torch.sum(torch.exp(log_weights - global_max)), mesh, axis)
    k_global = log_weights.shape[0] * _comm.axis_size(mesh, axis)
    return global_max + torch.log(total) - math.log(k_global)


def collective_resample(gen: torch.Generator, particles: Any, log_weights: torch.Tensor, mesh,
                        axis: str = "batch", *, method: str = "systematic", mode: str = "local",
                        log_z_inc=None):
    """Resample a particle collection sharded over ``axis``; every rank of
    the axis calls it with its own shard. Returns ``(new_particles,
    new_log_weights, log_marginal_increment)``, the increment the global
    mean-weight normalizer (``log_z_inc`` where the caller has it, which
    spares its collectives).

    - ``"local"``: each rank resamples its own shard from ``gen``, its own
      stream, and keeps the shard's mean weight as the (uniform) weight of
      its particles, so the whole collection stays properly weighted;
    - ``"all_gather"``: exact global resampling. The log weights and the
      particles are gathered, every rank draws the same global index vector
      from ``gen``, which must be in the same state on every rank (the
      caller's generator), and takes its slice of it.
    """
    if keys.is_key(gen):
        check_generator(gen, "collective_resample")
    k_local = log_weights.shape[0]
    if log_z_inc is None:
        log_z_inc = collective_log_normalizer(log_weights, mesh, axis)
    if mode == "local":
        new_particles = resample_particles(gen, particles, log_weights, k_local, method)
        shard_log_mean = torch.logsumexp(log_weights, dim=0) - math.log(k_local)
        return new_particles, (shard_log_mean - log_z_inc).expand(k_local).clone(), log_z_inc
    if mode == "all_gather":
        flat_lw = _comm.all_gather_cat(log_weights, mesh, axis)
        k = flat_lw.shape[0]
        all_idx = resample_indices(gen, flat_lw, k, method)
        start = _comm.axis_index(mesh, axis) * k_local
        gathered = pytree.tree_map(
            lambda v: _comm.all_gather_cat(v, mesh, axis) if isinstance(v, torch.Tensor) else v, particles
        )
        new_particles = packed_take(gathered, all_idx[start : start + k_local], k)
        return new_particles, torch.zeros_like(log_weights), log_z_inc
    raise ValueError(f"Unknown collective resampling mode: {mode!r}")

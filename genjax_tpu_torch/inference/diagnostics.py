"""MCMC convergence diagnostics: split-R̂ and the bulk effective sample size.

Counterpart of ``genjax_tpu/inference/diagnostics.py``. Both are
deterministic reductions over the leading ``(n_chains, n_draws)`` axes, and
batch over any trailing axes natively: draws shaped ``(chains, draws, dim)``
give one value a dimension, where the reference vmaps over the event axis.
They run on the device of the draws.

One deviation from the reference (``ROADMAP.md`` queue 3): ``ess(...,
return_tau=True)`` returns a flag ``truncated`` that is True when the lag
budget cut the Geyer sum short, which is what its name says; the reference's
flag of that name is True in the opposite case.

With ``mesh`` (a ``parallel.Mesh``), the chains are sharded over its
``axis``: each rank passes its own chains, and the reductions over chains
(the mean and variance of the chain means, the within-chain variance, the
autocovariance sums at each lag) are two sums over the axis. Every rank gets
what one rank computes on the gathered draws.
"""

from __future__ import annotations

import torch


def _split(draws: torch.Tensor) -> torch.Tensor:
    """Each chain's first and second half as chains of their own, the odd
    last draw dropped: ``(2 n_chains, n_draws // 2, ...)``."""
    half = draws.shape[1] // 2
    return torch.cat([draws[:, :half], draws[:, half : 2 * half]], dim=0)


def _chain_stats(split: torch.Tensor, within: torch.Tensor, extra, mesh, axis: str):
    """Over every rank's split chains: ``(M, mean of within, mean of the
    chain means' squared deviations over M - 1, sum of extra over
    chains)``, in two sums over ``axis``. ``within (m, ...)`` and ``extra
    (m, L, ...)`` (or None) are per split chain."""
    m = split.shape[0]
    big_m = m * mesh.axis_size(axis)
    means = split.mean(dim=1)
    first = mesh.all_reduce_sum(torch.stack([within.sum(dim=0), means.sum(dim=0)]), axis) / big_m
    dev = ((means - first[1]) ** 2).sum(dim=0, keepdim=True)
    second = dev if extra is None else torch.cat([dev, extra.sum(dim=0)])
    second = mesh.all_reduce_sum(second, axis)
    b = second[0] / (big_m - 1) if big_m > 1 else torch.zeros_like(second[0])
    return big_m, first[0], b, second[1:]


def split_rhat(draws: torch.Tensor, *, mesh=None, axis: str = "batch") -> torch.Tensor:
    """Split-chain potential scale reduction factor (Gelman et al., BDA3;
    Vehtari et al. 2021) of ``draws (n_chains, n_draws, ...)``, one value for
    each trailing index. Values near 1 indicate convergence.

    >>> import torch
    >>> from genjax_tpu_torch.inference.diagnostics import split_rhat
    >>> iid = torch.randn(4, 400, generator=torch.Generator().manual_seed(0))
    >>> bool(split_rhat(iid) < 1.05)      # well-mixed chains
    True
    >>> bool(split_rhat(iid + 5.0 * torch.arange(4.0)[:, None]) > 1.5)  # chains disagree
    True
    """
    split = _split(draws)
    n = split.shape[1]
    if n == 0:  # one draw a chain: no halves to compare
        return torch.full(draws.shape[2:], torch.nan, dtype=draws.dtype, device=draws.device)
    if mesh is None:
        w = torch.var(split, dim=1, correction=1).mean(dim=0)
        b = n * torch.var(split.mean(dim=1), dim=0, correction=1)
    else:
        _m, w, var_means, _ = _chain_stats(split, torch.var(split, dim=1, correction=1), None, mesh, axis)
        b = n * var_means
    return torch.sqrt(((n - 1) / n * w + b / n) / w)


def ess(draws: torch.Tensor, max_lag: int | None = None, *, return_tau: bool = False, mesh=None,
        axis: str = "batch"):
    """Bulk effective sample size (Vehtari et al. 2021) of ``draws
    (n_chains, n_draws, ...)``, one value for each trailing index: split
    chains, autocorrelations over the pooled variance, and Geyer's initial
    positive sequence within a fixed lag budget (``max_lag``, at most
    ``n - 1`` for split chains of ``n`` draws; 256 by default).

    ``return_tau=True`` also returns ``(tau_hat, truncated)``: the
    integrated autocorrelation time, at least 1, and whether the budget cut
    the positive sequence short (then ``tau_hat`` is a floor and the ESS may
    be too high).

    >>> import torch
    >>> from genjax_tpu_torch.inference.diagnostics import ess
    >>> iid = torch.randn(4, 400, generator=torch.Generator().manual_seed(0))
    >>> bool(ess(iid) > 1000.0)   # iid draws: ESS near n_chains * n_draws
    True
    >>> _e, (tau, truncated) = ess(iid, return_tau=True)
    >>> bool(tau < 2.0), bool(truncated)   # the sequence stops inside the budget
    (True, False)

    The lag-t correlation is ``rho_t = 1 - (W - mean_acov_t) / var_plus``
    with ``var_plus = (n - 1) / n W + B / n``: chains that disagree (stuck
    in different modes) inflate ``var_plus`` and drive the estimate toward
    zero, where a within-chain normalization would report the most ESS.
    """
    n_chains, n_draws = draws.shape[0], draws.shape[1]
    if mesh is not None:
        n_chains *= mesh.axis_size(axis)
    total = float(n_chains * n_draws)
    split = _split(draws) if n_draws // 2 >= 2 else draws
    m, n = split.shape[0], split.shape[1]
    max_lag = min(n - 1, 256 if max_lag is None else max_lag)
    event = draws.shape[2:]
    if max_lag < 1:
        # one draw a chain carries no autocorrelation: tau = 1
        out = torch.full(event, total, dtype=draws.dtype, device=draws.device)
        if return_tau:
            return out, (torch.ones_like(out), torch.zeros(event, dtype=torch.bool, device=draws.device))
        return out
    means = split.mean(dim=1, keepdim=True)
    centered = split - means

    # the autocovariance at each lag: the chain rolled back by the lag, the
    # wrapped tail masked off; one lag at a time, so one rolled copy lives
    valid_shape = (1, n) + (1,) * len(event)
    positions = torch.arange(n, device=draws.device).reshape(valid_shape)
    acov_sums = []
    for lag in range(1, max_lag + 1):
        shifted = torch.roll(centered, -lag, dims=1)
        valid = (positions < n - lag).to(centered.dtype)
        acov_sums.append(torch.sum(centered * shifted * valid, dim=1) / n)
    within = torch.sum(centered * centered, dim=1) / (n - 1)
    if mesh is None:
        w = within.mean(dim=0) + 1e-12
        b_over_n = torch.var(means[:, 0], dim=0, correction=1) if m > 1 else 0.0
        acovs = [a.mean(dim=0) for a in acov_sums]
    else:
        big_m, w, b_over_n, acov_total = _chain_stats(split, within, torch.stack(acov_sums, dim=1), mesh, axis)
        w = w + 1e-12
        acovs = list(acov_total / big_m)
    var_plus = (n - 1) / n * w + b_over_n

    rhos = 1.0 - (w - torch.stack(acovs)) / var_plus
    # Geyer: sum consecutive pairs while they stay positive
    n_pairs = max_lag // 2
    pair_sums = rhos[0 : 2 * n_pairs : 2] + rhos[1 : 2 * n_pairs : 2]
    positive = torch.cumprod((pair_sums > 0).to(torch.int32), dim=0).to(torch.bool)
    tau = 1.0 + 2.0 * torch.sum(torch.where(positive, pair_sums, 0.0), dim=0)
    out = torch.clamp(total / tau, 0.0, total)
    if return_tau:
        # the budget cut the sum short when no pair in it was non-positive
        return out, (torch.clamp(tau, min=1.0), positive.all(dim=0))
    return out


__all__ = ["ess", "split_rhat"]

"""Stein variational gradient descent (Liu & Wang 2016) in the column layout.

Counterpart of ``genjax_tpu/kernels/svgd.py``. A set of interacting particles
flows deterministically along the kernelised Stein discrepancy's steepest
descent,

    phi(q_i) = (1/N) sum_j [ k(q_j, q_i) grad log p(q_j) + grad_{q_j} k(q_j, q_i) ],

so the empirical measure approaches the target with no sampling noise. The
particles are columns ``(D, N)``; an update is an ``(N, N)`` RBF Gram matrix,
two products against it and one gradient of the column log-density.

The bandwidth is the median heuristic ``h = med**2 / log(N + 1)``. Its median
is the reference's (``jnp.median``: the mean of the two middle values of an
even count, where ``torch.median`` would return the lower one), taken from a
``subsample x N`` slice of the distance matrix and refreshed every
``bandwidth_every`` steps. Deterministic: no generator.

One deviation from the reference: a particle whose score is not finite (it
has left the target's support, where the log-density is ``-inf``) adds no
score term to the flow, and the kernel's attraction brings it back. The
reference lets its NaN gradient reach every particle through the Gram
matrix: on the flagship ``hierarchical_regression`` (``tau > 0``), at 4,096
particles, every particle of its run is NaN after 100 steps.
"""

from __future__ import annotations

from typing import Callable

import torch

from .adaptation import _f32
from .hmc import _lp_grad
from .rows import refuse_row_sharded


def _pairwise_sq_dists(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Squared distances between the columns of ``qa`` and ``qb``: ``(Na, Nb)``."""
    d2 = torch.sum(qa**2, dim=0)[:, None] + torch.sum(qb**2, dim=0)[None, :] - 2.0 * (qa.T @ qb)
    return torch.clamp(d2, min=0.0)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all elements: the middle value of an odd count, the
    mean of the two middle values of an even one (by a sort: no size limit,
    unlike ``torch.quantile``)."""
    s = torch.sort(x.reshape(-1)).values
    m = s.numel() // 2
    if s.numel() % 2:
        return s[m]
    return (s[m - 1] + s[m]) * 0.5


def _log_n1(n: int, device) -> torch.Tensor:
    return torch.log(torch.tensor(n + 1.0, dtype=torch.float32, device=device))


def median_bandwidth(q: torch.Tensor, subsample: int | None = 64) -> torch.Tensor:
    """The median heuristic ``h = med**2 / log(N + 1)``. With ``subsample=k``
    the median is taken over the ``k x N`` distance slice against every
    ``N // k``-th particle; ``subsample=None`` (or ``k >= N``) uses the whole
    Gram matrix."""
    n = q.shape[1]
    if subsample is None or subsample >= n:
        d2 = _pairwise_sq_dists(q, q)
    else:
        d2 = _pairwise_sq_dists(q[:, :: max(1, n // subsample)], q)
    return _median(d2) / _log_n1(n, q.device) + 1e-8


def rbf_kernel_and_grad(q: torch.Tensor, bandwidth=None, *, h=None):
    """The RBF Gram matrix ``K(i, j) = exp(-|q_i - q_j|**2 / h)`` over the
    particle columns and the repulsion ``sum_j grad_{q_j} k(q_j, q_i)``.
    ``h`` is the squared scale, used as is; ``bandwidth`` a length scale,
    squared; with neither, the exact median heuristic."""
    d2 = _pairwise_sq_dists(q, q)
    if h is None:
        if bandwidth is None:
            h = _median(d2) / _log_n1(q.shape[1], q.device) + 1e-8
        else:
            h = _f32(bandwidth) ** 2
    K = torch.exp(-d2 / h)
    # grad_term[:, i] = (2/h) sum_j K(j, i) (q_i - q_j)
    sum_k = torch.sum(K, dim=0)
    grad_term = (2.0 / h) * (q * sum_k[None, :] - q @ K)
    return K, grad_term


def svgd(
    logdensity_cols: Callable,
    q0,
    *,
    n_steps: int,
    step_size: float = 0.1,
    bandwidth=None,
    adagrad: bool = True,
    alpha: float = 0.9,
    bandwidth_subsample: int | None = 64,
    bandwidth_every: int = 10,
) -> torch.Tensor:
    """SVGD from the particle columns ``q0 (D, N)``, on their device.
    Deterministic: no generator. ``adagrad`` takes the original paper's
    AdaGrad-with-momentum step, otherwise plain gradient steps.

    ``bandwidth=None`` uses the median heuristic from a
    ``bandwidth_subsample x N`` distance slice, refreshed every
    ``bandwidth_every`` steps; ``bandwidth_subsample=None`` with
    ``bandwidth_every=1`` is the exact heuristic each step, and an explicit
    ``bandwidth`` pins the scale. Returns the final particles ``(D, N)``.
    """
    refuse_row_sharded(logdensity_cols, "svgd")
    q = _f32(q0)
    n = q.shape[1]
    h = None if bandwidth is None else _f32(bandwidth).to(q.device) ** 2
    hist = torch.zeros_like(q)
    for i in range(n_steps):
        if bandwidth is None and i % bandwidth_every == 0:
            h = median_bandwidth(q, bandwidth_subsample)
        _lp, g = _lp_grad(logdensity_cols, q)
        # a particle outside the target's support (a -inf density, whose
        # gradient is NaN) has no score: without this one such particle
        # turns every particle NaN through the Gram matrix
        g = torch.where(torch.isfinite(g), g, 0.0)
        K, repulse = rbf_kernel_and_grad(q, h=h)
        p = (g @ K + repulse) / n
        if adagrad:
            hist = p**2 if i == 0 else alpha * hist + (1.0 - alpha) * p**2
            q = q + step_size * p / (1e-6 + torch.sqrt(hist))
        else:
            q = q + step_size * p
    return q


__all__ = ["median_bandwidth", "rbf_kernel_and_grad", "svgd"]

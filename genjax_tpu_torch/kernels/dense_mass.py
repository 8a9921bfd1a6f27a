"""Dense mass-matrix HMC in the column layout.

Counterpart of ``genjax_tpu/kernels/dense_mass.py``. A diagonal metric
cannot precondition a correlated posterior: with correlation rho the step
size is capped by the smallest conditional scale, about ``sqrt(1 - rho**2)``.
With thousands of chains one cross-chain time slice gives a full-rank
covariance estimate (``cross_chain_cov``), and applying it is a
``(D, D) x (D, N)`` matrix product a leapfrog.

Conventions: ``cov_chol`` is the lower Cholesky factor ``L`` of the estimated
posterior covariance ``Sigma``. Momenta are ``p = L^-T z`` (covariance
``Sigma^-1``), the kinetic energy is ``p^T Sigma p / 2`` and the drift is
``eps * Sigma p``: a perfect estimate makes the target locally an isotropic
standard normal.

The reference computes these products with XLA outside any Pallas kernel;
here they are ``torch.matmul`` in float32 (TF32 stays off, as it is by
default). Randomness comes from one ``torch.Generator`` on the chains'
device, drawn in sequence where the reference splits a key; ``seed`` is an
int or such a generator. Chains stay on the device they were given.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.device import chain_generator
from .adaptation import _f32, chain_mean, multiplicative_nudge
from .hmc import _lp_grad
from .rows import refuse_row_sharded


def cross_chain_cov(q: torch.Tensor, *, shrinkage: float = 0.1, jitter: float = 1e-6, mesh=None,
                    axis: str = "batch") -> torch.Tensor:
    """Full posterior-covariance estimate from the cross-chain spread of
    ``q (D, N)``: the sample covariance over the chains shrunk toward its own
    diagonal, ``(1 - shrinkage) S + shrinkage diag(S) + jitter I``. The
    shrinkage keeps early estimates well conditioned, and for ``N <= D`` it is
    what makes the Cholesky factor exist; the diagonal is kept exactly. With
    ``mesh`` (a ``parallel.Mesh``), the chains are sharded over its ``axis``
    and the covariance is that of every rank's (two sums)."""
    d, n = q.shape
    c = q - chain_mean(q, 1, mesh=mesh, axis=axis, keepdim=True)
    if mesh is None:
        s = (c @ c.T) / max(n - 1, 1)
    else:
        s = mesh.all_reduce_sum(c @ c.T, axis) / max(n * mesh.axis_size(axis) - 1, 1)
    diag = torch.diag(torch.diagonal(s))
    eye = torch.eye(d, dtype=q.dtype, device=q.device)
    return (1.0 - shrinkage) * s + shrinkage * diag + jitter * eye


def hmc_sweep_dense_cols(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed,
    *,
    n_steps: int,
    eps,
    L: int,
    cov_chol,
    collect: bool = False,
    mesh=None,
    axis: str = "batch",
):
    """``n_steps`` MH-adjusted HMC transitions under the dense metric
    ``Sigma = cov_chol cov_chol^T``, on ``q0``'s device.

    ``logdensity_cols`` maps ``(D, N) -> (N,)``; ``seed`` is an int or a
    ``torch.Generator`` on ``q0``'s device; ``eps`` a float or a scalar
    tensor. A NaN log acceptance is a rejection. Returns ``(q,
    accept_rate)``, with ``collect=True`` also every transition's positions
    ``(n_steps, D, N)``. With ``mesh``, the accept rate is every rank's
    chains'.
    """
    refuse_row_sharded(logdensity_cols, "hmc_sweep_dense_cols")
    d, n = q0.shape
    device = q0.device
    gen = chain_generator(seed, device, "hmc_sweep_dense_cols")
    cov_chol = _f32(cov_chol).to(device)
    sigma = cov_chol @ cov_chol.T
    # p = L^-T z: materialised once, so a refresh is one product
    eye = torch.eye(d, dtype=torch.float32, device=device)
    mom_factor = torch.linalg.solve_triangular(cov_chol.T, eye, upper=True)

    def kinetic(p):
        return 0.5 * torch.sum(p * (sigma @ p), dim=0)

    q = q0.to(torch.float32)
    lp, g = _lp_grad(logdensity_cols, q)
    acc = torch.zeros((), dtype=torch.float32, device=device)
    draws = []
    for _ in range(n_steps):
        p = mom_factor @ torch.randn((d, n), generator=gen, device=device)
        u = torch.rand((n,), generator=gen, device=device)
        ke0 = kinetic(p)
        q_new, g_new, lp_new = q, g, lp
        for _ in range(L):
            p = p + (eps / 2.0) * g_new
            q_new = q_new + eps * (sigma @ p)
            lp_new, g_new = _lp_grad(logdensity_cols, q_new)
            p = p + (eps / 2.0) * g_new
        log_alpha = (lp_new - kinetic(p)) - (lp - ke0)
        log_alpha = torch.where(torch.isnan(log_alpha), -torch.inf, log_alpha)
        accept = torch.log(u) < log_alpha
        q = torch.where(accept, q_new, q)
        lp = torch.where(accept, lp_new, lp)
        g = torch.where(accept, g_new, g)
        acc = acc + chain_mean(accept.to(torch.float32), 0, mesh=mesh, axis=axis)
        if collect:
            draws.append(q)
    if collect:
        stacked = torch.stack(draws) if draws else q.new_zeros((0, d, n))
        return q, acc / n_steps, stacked
    return q, acc / n_steps


def warmup_column_dense(
    logdensity_cols: Callable,
    q0: torch.Tensor,
    seed,
    *,
    n_phases: int = 6,
    steps_per_phase: int = 25,
    eps0: float = 0.1,
    L: int = 5,
    target_accept: float = 0.8,
    shrinkage: float = 0.1,
    mesh=None,
    axis: str = "batch",
):
    """Windowed warmup for dense-metric HMC, on ``q0``'s device: per phase,
    a sweep at the current metric, a nudge of the step size toward
    ``target_accept`` (``multiplicative_nudge``) and a new full covariance
    from the cross-chain spread, its shrinkage annealed linearly from 1 to
    ``shrinkage`` by the last phase.

    ``seed`` is an int (a warmup stream is seeded from it, apart from the
    sweep's) or a ``torch.Generator`` on ``q0``'s device, drawn from
    directly. Returns ``(q, eps, cov_chol)`` for ``hmc_sweep_dense_cols``,
    ``eps`` a float32 scalar tensor on the device. With ``mesh``, ``q0`` is
    this rank's share of chains over its ``axis``, and the accept rates and
    covariances are every rank's.
    """
    refuse_row_sharded(logdensity_cols, "warmup_column_dense")
    d, _ = q0.shape
    if not isinstance(seed, torch.Generator):
        seed = (int(seed) + 1) * 1_000_003
    gen = chain_generator(seed, q0.device, "warmup_column_dense")
    q = q0.to(torch.float32)
    eps = _f32(eps0).to(q0.device)
    cov_chol = torch.eye(d, dtype=torch.float32, device=q0.device)
    for idx in range(n_phases):
        q, acc = hmc_sweep_dense_cols(
            logdensity_cols, q, gen, n_steps=steps_per_phase, eps=eps, L=L, cov_chol=cov_chol, mesh=mesh,
            axis=axis,
        )
        eps = multiplicative_nudge(eps, acc, target_accept=target_accept)
        # heavy shrinkage early (estimates from an unconverged cloud), the
        # final value by the last phase
        lam = shrinkage + (1.0 - shrinkage) * (1.0 - (idx + 1.0) / n_phases)
        cov_chol = torch.linalg.cholesky(cross_chain_cov(q, shrinkage=lam, mesh=mesh, axis=axis))
    return q, eps, cov_chol


def whiten_logdensity(logdensity_cols: Callable, cov_chol, mean=0.0):
    """Give any column sampler a dense metric by reparameterisation.

    With ``Sigma = L L^T`` the estimated posterior covariance, sampling
    ``u = L^-1 (q - m)`` from ``white_ld(u) = logdensity(m + L u)`` is the
    chain with kinetic energy ``p^T Sigma p / 2`` (the constant Jacobian
    shifts the log-density by a constant), under the identity metric: NUTS,
    ChEES and parallel tempering gain full-covariance preconditioning
    unchanged.

    Returns ``(white_ld, whiten, unwhiten)``: the whitened log-density
    ``(D, N) -> (N,)``, ``q -> u`` and ``u -> q``. Everything runs on
    ``cov_chol``'s device.

    >>> import torch
    >>> from genjax_tpu_torch.kernels import whiten_logdensity
    >>> chol = torch.tensor([[1.0, 0.0], [0.9, 0.435890]])  # rho ~ 0.9
    >>> ld = lambda q: -0.5 * torch.sum(q * q, dim=0)
    >>> white_ld, whiten, unwhiten = whiten_logdensity(ld, chol)
    >>> q = torch.tensor([[1.0], [0.5]])
    >>> bool(torch.allclose(unwhiten(whiten(q)), q, atol=1e-6))
    True
    """
    refuse_row_sharded(logdensity_cols, "whiten_logdensity")
    cov_chol = _f32(cov_chol)
    d = cov_chol.shape[0]
    mean = _f32(mean).to(cov_chol.device)
    mean_col = mean.reshape(-1, 1) if mean.ndim > 0 else mean.expand(d, 1)

    def white_ld(u):
        return logdensity_cols(mean_col + cov_chol @ u)

    def whiten(q):
        return torch.linalg.solve_triangular(cov_chol, q - mean_col, upper=False)

    def unwhiten(u):
        return mean_col + cov_chol @ u

    return white_ld, whiten, unwhiten


__all__ = ["cross_chain_cov", "hmc_sweep_dense_cols", "warmup_column_dense", "whiten_logdensity"]

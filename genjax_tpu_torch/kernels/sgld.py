"""Stochastic-gradient MCMC in the column layout: SGLD, pSGLD, SGHMC.

Counterpart of ``genjax_tpu/kernels/sgld.py`` (Welling & Teh 2011; Li et al.
2016; Chen et al. 2014). Each step uses an unbiased minibatch gradient of the
log posterior, so a step costs O(batch) instead of O(dataset). Positions are
chains-on-columns ``(D, N)`` float32 on their own device; a gradient function
is ``grad_fn(q (D, N), gen) -> (D, N)``, ``gen`` the sweep's
``torch.Generator`` (a minibatch draws its rows from it).

Constant-step SGLD and SGHMC sample a perturbation of the posterior with
O(eps) bias, by design: no MH correction. The sweeps are Python loops;
randomness is one ``torch.Generator`` on the chains' device, drawn in
sequence where the reference folds a key in a step; ``seed`` is an int or
such a generator.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core.device import chain_generator
from .hmc import _lp_grad
from .rows import refuse_row_sharded


def minibatch_grad_cols(
    log_prior: Callable,
    log_lik: Callable,
    data: Any,
    batch_size: int,
    *,
    n_total: int | None = None,
) -> Callable:
    """An unbiased stochastic gradient in the column layout.

    Returns ``grad_fn(q (D, N), gen) -> (D, N)`` estimating ``grad_q
    [log_prior(q) + sum_i log_lik(q, x_i)]`` from ``batch_size`` rows drawn
    uniformly with replacement from ``gen`` at each call, the likelihood
    scaled by ``n_total / batch_size``. ``log_prior(q) -> (N,)``;
    ``log_lik(q, rows) -> (N,)`` sums over the rows given; ``data`` is a
    tensor or a tuple of tensors with the rows first. ``grad_fn.on_rows(q,
    idx)`` is the same estimate on the rows ``idx``.
    """
    m = pytree.tree_leaves(data)[0].shape[0]
    scale = (m if n_total is None else n_total) / batch_size

    def on_rows(q, idx):
        batch = pytree.tree_map(lambda x: x[idx.to(x.device)], data)
        return _lp_grad(lambda qq: log_prior(qq) + scale * log_lik(qq, batch), q)[1]

    def grad_fn(q, gen):
        idx = torch.randint(0, m, (batch_size,), generator=gen, device=gen.device)
        return on_rows(q, idx)

    grad_fn.on_rows = on_rows
    return grad_fn


def full_grad_cols(logdensity_cols: Callable) -> Callable:
    """The exact gradient of a column log-density ``(D, N) -> (N,)`` as a
    ``grad_fn(q, gen)`` that draws nothing: SGLD with it is ULA, SGHMC
    underdamped Langevin."""
    refuse_row_sharded(logdensity_cols, "full_grad_cols")

    def grad_fn(q, gen):
        return _lp_grad(logdensity_cols, q)[1]

    return grad_fn


def sgld_sweep_cols(
    grad_fn: Callable,
    q0,
    seed,
    *,
    n_steps: int,
    eps: float,
    collect: bool = False,
    precondition: bool = False,
    rms_alpha: float = 0.99,
    rms_lambda: float = 1e-5,
):
    """SGLD: ``q <- q + (eps/2) G g(q) + N(0, eps G)`` for ``n_steps``, on
    ``q0``'s device.

    With ``precondition=True`` this is pSGLD: ``G`` is the RMSprop diagonal
    ``1 / (lambda + sqrt(v))`` kept from the stochastic gradients (its Gamma
    correction term left out, as is usual). Each step calls ``grad_fn(q,
    gen)`` and then draws the noise. Returns ``(q_final, draws)``, ``draws``
    ``(n_steps, D, N)`` with ``collect`` and None otherwise.
    """
    q = torch.as_tensor(q0, dtype=torch.float32)
    gen = chain_generator(seed, q.device, "sgld_sweep_cols")
    v = torch.ones_like(q)
    draws = []
    for _ in range(n_steps):
        g = grad_fn(q, gen)
        if precondition:
            v = rms_alpha * v + (1.0 - rms_alpha) * g * g
            G = 1.0 / (rms_lambda + torch.sqrt(v))
        else:
            G = 1.0
        noise = torch.randn(q.shape, generator=gen, device=q.device)
        q = q + 0.5 * eps * G * g + (eps * G) ** 0.5 * noise
        if collect:
            draws.append(q)
    return q, (torch.stack(draws) if draws else q.new_zeros((0, *q.shape))) if collect else None


def sghmc_sweep_cols(
    grad_fn: Callable,
    q0,
    seed,
    *,
    n_steps: int,
    eps: float,
    friction: float = 1.0,
):
    """SGHMC (Chen et al. 2014, eq. 15 with B = 0), on ``q0``'s device:
    underdamped Langevin with momentum ``p``,

        p <- (1 - eps C) p + eps g(q) + N(0, 2 C eps)
        q <- q + eps p

    ``friction`` is C. The momentum starts as a standard normal draw. An int
    ``seed`` seeds the stream with ``seed ^ 0x5A17``, apart from SGLD's.
    Returns ``(q_final, p_final)``.
    """
    q = torch.as_tensor(q0, dtype=torch.float32)
    if not isinstance(seed, torch.Generator):
        seed = int(seed) ^ 0x5A17
    gen = chain_generator(seed, q.device, "sghmc_sweep_cols")
    p = torch.randn(q.shape, generator=gen, device=q.device)
    for _ in range(n_steps):
        g = grad_fn(q, gen)
        noise = torch.randn(q.shape, generator=gen, device=q.device)
        p = (1.0 - eps * friction) * p + eps * g + (2.0 * friction * eps) ** 0.5 * noise
        q = q + eps * p
    return q, p


__all__ = ["full_grad_cols", "minibatch_grad_cols", "sghmc_sweep_cols", "sgld_sweep_cols"]

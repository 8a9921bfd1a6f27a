"""Stochastic-gradient MCMC in the column layout: SGLD, pSGLD, SGHMC.

Counterpart of ``genjax_tpu/kernels/sgld.py`` (Welling & Teh 2011; Li et al.
2016; Chen et al. 2014). Each step uses an unbiased minibatch gradient of the
log posterior, so a step costs O(batch) instead of O(dataset). Positions are
chains-on-columns ``(D, N)`` float32 on their own device; a gradient function
is ``grad_fn(q (D, N), stream) -> (D, N)``, ``stream`` the step's key (as the
reference's) or the sweep's ``torch.Generator`` (a minibatch draws its rows
from it).

Constant-step SGLD and SGHMC sample a perturbation of the posterior with
O(eps) bias, by design: no MH correction. The sweeps are Python loops. The
draws are the reference's: an int ``seed`` is the threefry root key
``key(seed)`` (SGHMC's ``key(seed ^ 0x5A17)``) and a key is the root itself;
step ``i`` splits ``fold_in(root, i)`` into the gradient's key and the
noise's (``core/keys.py``). A ``torch.Generator`` in the seed's place is drawn
from in sequence, in law.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
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

    Returns ``grad_fn(q (D, N), stream) -> (D, N)`` estimating ``grad_q
    [log_prior(q) + sum_i log_lik(q, x_i)]`` from ``batch_size`` rows drawn
    uniformly with replacement at each call (``randint(key, (batch_size,),
    0, m)`` under a key, as the reference's; from a generator in its
    place), the likelihood
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

    def grad_fn(q, stream):
        if keys.is_key(stream):
            idx = keys.randint(stream, (batch_size,), 0, m)
        else:
            idx = torch.randint(0, m, (batch_size,), generator=stream, device=stream.device)
        return on_rows(q, idx)

    grad_fn.on_rows = on_rows
    return grad_fn


def full_grad_cols(logdensity_cols: Callable) -> Callable:
    """The exact gradient of a column log-density ``(D, N) -> (N,)`` as a
    ``grad_fn(q, stream)`` that draws nothing: SGLD with it is ULA, SGHMC
    underdamped Langevin."""
    refuse_row_sharded(logdensity_cols, "full_grad_cols")

    def grad_fn(q, stream):
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
    correction term left out, as is usual). ``seed`` is an int (the root
    key ``key(seed)``), a key on ``q0``'s device (the root) or a
    ``torch.Generator`` there. Each step calls ``grad_fn(q, k_grad)`` and
    then draws the noise from ``k_noise``, ``k_grad, k_noise = split(fold_in(root,
    i))``, or both from the generator. Returns ``(q_final, draws)``,
    ``draws`` ``(n_steps, D, N)`` with ``collect`` and None otherwise.
    """
    q = torch.as_tensor(q0, dtype=torch.float32)
    root = keys.sampler_stream(seed, q.device, "sgld_sweep_cols", "threefry2x32")
    v = torch.ones_like(q)
    draws = []
    for k_grad, k_noise in _step_streams(root, n_steps):
        g = grad_fn(q, k_grad)
        if precondition:
            v = rms_alpha * v + (1.0 - rms_alpha) * g * g
            G = 1.0 / (rms_lambda + torch.sqrt(v))
        else:
            G = _f32(1.0, q.device)
        noise = _normal(k_noise, q)
        q = q + 0.5 * eps * G * g + torch.sqrt(eps * G) * noise
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

    ``friction`` is C. An int ``seed`` is the root key ``key(seed ^
    0x5A17)``, apart from SGLD's, and a key on ``q0``'s device is the root;
    the momentum starts as the standard normal draw of ``fold_in(root,
    n_steps)`` and step ``i`` draws as SGLD's. A ``torch.Generator`` in the
    seed's place is drawn from in sequence. Returns ``(q_final, p_final)``.
    """
    q = torch.as_tensor(q0, dtype=torch.float32)
    if not (isinstance(seed, torch.Generator) or keys.is_key(seed)):
        seed = int(seed) ^ 0x5A17
    root = keys.sampler_stream(seed, q.device, "sghmc_sweep_cols", "threefry2x32")
    # the steps' keys are fold_in(root, 0 .. n_steps - 1): n_steps is apart
    p = _normal(keys.fold_in(root, n_steps) if keys.is_key(root) else root, q)
    kick = torch.sqrt(_f32(2.0 * friction * eps, q.device))
    for k_grad, k_noise in _step_streams(root, n_steps):
        g = grad_fn(q, k_grad)
        noise = _normal(k_noise, q)
        p = (1.0 - eps * friction) * p + eps * g + kick * noise
        q = q + eps * p
    return q, p


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _step_streams(root, n_steps: int) -> tuple:
    """Each step's ``(k_grad, k_noise) = split(fold_in(root, i))``, made for
    every step in two hashes, or the generator for both."""
    if not keys.is_key(root):
        return ((root, root),) * n_steps
    if not n_steps:
        return ()
    return keys.split_each(keys.fold_in(root, torch.arange(n_steps, device=root.device)))


def _normal(stream, q: torch.Tensor) -> torch.Tensor:
    """Standard normals shaped as ``q``, from a key or a generator."""
    return keys.normal_from(stream, tuple(q.shape), q.device)


__all__ = ["full_grad_cols", "minibatch_grad_cols", "sghmc_sweep_cols", "sgld_sweep_cols"]

"""Pathfinder variational inference (Zhang, Carpenter, Gelman & Vehtari,
JMLR 2022) over column log-densities.

Counterpart of ``genjax_tpu/inference/pathfinder.py``: ``_mvn_logpdf_cols``,
``_inverse_hessian``, ``PathfinderResult``, ``pathfinder``,
``MultiPathfinderResult``, ``multi_pathfinder``, ``PathfinderPosterior`` and
``column_pathfinder``. L-BFGS runs on the negative log density; at every
iterate the quadratic approximation ``N(theta_k - H_k grad f(theta_k),
H_k)``, ``H_k`` the L-BFGS inverse-Hessian estimate in the compact form of
Byrd, Nocedal & Schnabel (1994) with a scalar initial scaling, is scored by
a Monte-Carlo ELBO, and the draws come from the best. The covariance is
dense (one ``(D, D)`` Cholesky an iterate), as the reference's is.

The L-BFGS is ``inference._lbfgs``, a copy of ``optax.lbfgs`` with its zoom
linesearch written for a batch of paths: ``multi_pathfinder`` runs all its
paths as one batch ``(n_paths, D)``, every path's trial point evaluated in
one ``(D, n_paths)`` column call, each path frozen when its own linesearch
ends; ``pathfinder`` is the batch of one. The linesearch costs one host read
a step. ``multi_pathfinder`` pools the draws and resamples them by their
Pareto-smoothed importance weights (``model_comparison._psis_smooth_column``).

The entry points run on ``device``, the card unless the caller asks for the
CPU, and draw from one ``torch.Generator`` there.

>>> import torch
>>> from genjax_tpu_torch.inference import pathfinder
>>> ld = lambda z: -0.5 * torch.sum((z - 1.0) ** 2 / 0.25, dim=0)
>>> res = pathfinder(0, ld, 2, n_iters=20, n_draws=500, device="cpu")
>>> torch.allclose(res.mu, torch.ones(2), atol=1e-3)
True
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..core.device import entry_generator, to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..kernels.model_interface import ColumnPacker, column_logdensity
from ._lbfgs import lbfgs_init, lbfgs_update, value_and_grad_from_state
from .model_comparison import _psis_smooth_column
from ..kernels.rows import refuse_row_sharded

_LOG2PI = 1.8378770664093453


def _mvn_logpdf_cols(z, mu, chol):
    """The log density of ``N(mu, chol chol^T)`` at the columns ``z (..., D,
    K)``; ``mu (..., D)``, ``chol (..., D, D)`` lower triangular."""
    d = mu.shape[-1]
    y = torch.linalg.solve_triangular(chol, z - mu[..., None], upper=False)
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * torch.sum(y**2, dim=-2) - logdet[..., None] - 0.5 * d * _LOG2PI


def _inverse_hessian(S, Z, valid, gamma):
    """The dense inverse-Hessian estimate from the compact BFGS form

    ``H = gI + [S gZ] [[R^-T (D + g Z^T Z) R^-1, -R^-T], [-R^-1, 0]] [S gZ]^T``

    with ``R = triu(S^T Z)`` and ``D = diag(S^T Z)`` (Byrd, Nocedal &
    Schnabel, eq. 4.7, for the inverse). ``S``, ``Z`` are ``(..., D, J)``;
    the invalid history slots carry zeroed columns and a unit diagonal in
    ``R``, so the solves stay finite and those slots add exactly zero."""
    dim = S.shape[-2]
    valid = torch.as_tensor(valid, dtype=S.dtype, device=S.device)
    gamma = torch.as_tensor(gamma, dtype=S.dtype, device=S.device)[..., None, None]
    S = S * valid[..., None, :]
    Z = Z * valid[..., None, :]
    StZ = S.transpose(-1, -2) @ Z
    on = valid > 0
    R = torch.triu(StZ) + torch.diag_embed(torch.where(on, 0.0, 1.0).to(S.dtype))
    d_diag = torch.where(on, torch.diagonal(StZ, dim1=-2, dim2=-1), 0.0)
    T = torch.linalg.solve_triangular(R, S.transpose(-1, -2), upper=True)  # R^-1 S^T
    mid = torch.diag_embed(d_diag) + gamma * (Z.transpose(-1, -2) @ Z)
    Tt = T.transpose(-1, -2)
    eye = torch.eye(dim, dtype=S.dtype, device=S.device)
    return gamma * eye + Tt @ (mid @ T) - gamma * (Tt @ Z.transpose(-1, -2)) - gamma * (Z @ T)


@Pytree.dataclass
class PathfinderResult(Pytree):
    """The best-ELBO Gaussian along an L-BFGS path: ``mu``/``scale_tril``
    parameterise it; ``draws`` is ``(D, n_draws)`` with their ``logq`` and
    ``logp``; ``elbo_trace`` is the ELBO of every iterate (-inf where the
    local curvature was unusable); ``linesearch_steps`` the steps of each
    iterate's linesearch. ``multi_pathfinder``'s paths carry a leading path
    axis on every field."""

    mu: Any
    scale_tril: Any
    elbo: Any
    elbo_trace: Any
    draws: Any
    logq: Any
    logp: Any
    linesearch_steps: Any

    def sample(self, gen: torch.Generator, n: int):
        eps = torch.randn((self.mu.shape[0], n), generator=gen, device=self.mu.device)
        return self.mu[:, None] + self.scale_tril @ eps


def _paths(gen, logdensity_cols: Callable, dim: int, n_paths: int, device, *, init=None, n_iters: int = 60,
           history: int = 6, n_elbo_samples: int = 30, n_draws: int = 200, init_scale: float = 2.0,
           jitter: float = 1e-6) -> PathfinderResult:
    """``n_paths`` Pathfinders as one batch; every field leads with the
    path axis."""
    p = n_paths

    def value_and_grad(theta):  # f = -logdensity, every path's point a column
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            v = -logdensity_cols(theta.T)
            (g,) = torch.autograd.grad(v.sum(), theta)
        return v.detach(), g

    def ld_paths(z):  # (P, D, K) -> (P, K) in one column call
        k = z.shape[-1]
        return logdensity_cols(z.permute(1, 0, 2).reshape(dim, p * k)).reshape(p, k).detach()

    if init is None:
        theta = (torch.rand((p, dim), generator=gen, device=device) * 2.0 - 1.0) * init_scale
    else:
        theta = torch.as_tensor(init, dtype=torch.float32, device=device).expand(p, dim).clone()
    state = lbfgs_init(theta, history)
    S = theta.new_zeros((p, dim, history))
    Z = theta.new_zeros((p, dim, history))
    valid = torch.zeros((p, history), dtype=torch.bool, device=device)
    gamma = theta.new_ones(p)
    eye = torch.eye(dim, dtype=theta.dtype, device=device)
    best_elbo = theta.new_full((p,), float("-inf"))
    best_mu, best_chol = theta.clone(), eye.expand(p, dim, dim).clone()
    trace, steps = [], []
    for _ in range(n_iters):
        value, grad = value_and_grad_from_state(value_and_grad, theta, state)
        theta_new, state = lbfgs_update(value_and_grad, grad, state, theta, value)
        _, grad_new = value_and_grad_from_state(value_and_grad, theta_new, state)
        steps.append(state.linesearch_steps)
        # push this move's (s, z) pair where its curvature is positive, which
        # keeps H positive definite
        s, z = theta_new - theta, grad_new - grad
        sz = torch.sum(s * z, dim=-1)
        ok = sz > 1e-11 * torch.linalg.vector_norm(s, dim=-1) * torch.linalg.vector_norm(z, dim=-1)
        S = torch.where(ok[:, None, None], torch.cat([S[..., 1:], s[..., None]], dim=-1), S)
        Z = torch.where(ok[:, None, None], torch.cat([Z[..., 1:], z[..., None]], dim=-1), Z)
        valid = torch.where(ok[:, None], torch.cat([valid[:, 1:], ok.new_ones((p, 1))], dim=-1), valid)
        gamma = torch.where(ok, sz / torch.sum(z * z, dim=-1), gamma)
        # the local Gaussian at theta_new: N(theta - H grad, H)
        H = _inverse_hessian(S, Z, valid.to(S.dtype), gamma)
        chol, info = torch.linalg.cholesky_ex(H + jitter * eye)
        chol = torch.where((info == 0)[:, None, None], chol, float("nan"))
        mu = theta_new - (H @ grad_new[..., None])[..., 0]
        eps = torch.randn((p, dim, n_elbo_samples), generator=gen, device=device)
        zs = mu[..., None] + chol @ eps
        elbo = torch.mean(ld_paths(zs) - _mvn_logpdf_cols(zs, mu, chol), dim=-1)
        elbo = torch.where(torch.isfinite(elbo), elbo, float("-inf"))
        better = elbo > best_elbo
        best_elbo = torch.where(better, elbo, best_elbo)
        best_mu = torch.where(better[:, None], mu, best_mu)
        best_chol = torch.where(better[:, None, None], chol, best_chol)
        trace.append(elbo)
        theta = theta_new
    eps = torch.randn((p, dim, n_draws), generator=gen, device=device)
    draws = best_mu[..., None] + best_chol @ eps
    return PathfinderResult(
        mu=best_mu, scale_tril=best_chol, elbo=best_elbo, elbo_trace=torch.stack(trace, dim=1), draws=draws,
        logq=_mvn_logpdf_cols(draws, best_mu, best_chol), logp=ld_paths(draws),
        linesearch_steps=torch.stack(steps, dim=1),
    )


def pathfinder(
    gen,
    logdensity_cols: Callable,
    dim: int,
    *,
    init=None,
    n_iters: int = 60,
    history: int = 6,
    n_elbo_samples: int = 30,
    n_draws: int = 200,
    init_scale: float = 2.0,
    jitter: float = 1e-6,
    device="cuda",
) -> PathfinderResult:
    """Single-path Pathfinder: L-BFGS on ``-logdensity``, the local Gaussian
    of every iterate scored by its ELBO, draws from the best.

    ``logdensity_cols``: the batched target ``(D, K) -> (K,)`` (the
    ``column_logdensity`` convention), through which autograd goes.
    ``init``: an optional ``(D,)`` start (by default uniform on
    ``(-init_scale, init_scale)``, Stan's convention)."""
    refuse_row_sharded(logdensity_cols, "pathfinder")
    gen, device = entry_generator(gen, device, "pathfinder")
    res = _paths(gen, logdensity_cols, dim, 1, device, init=init, n_iters=n_iters, history=history,
                 n_elbo_samples=n_elbo_samples, n_draws=n_draws, init_scale=init_scale, jitter=jitter)
    return PathfinderResult(*(v[0] for v in (res.mu, res.scale_tril, res.elbo, res.elbo_trace, res.draws,
                                             res.logq, res.logp, res.linesearch_steps)))


@Pytree.dataclass
class MultiPathfinderResult(Pytree):
    """Pooled draws of several paths resampled by their Pareto-smoothed
    importance weights: ``draws`` ``(D, n_resample)``; ``pareto_k`` the
    pooled ratios' tail shape (k-hat > 0.7 flags an unreliable
    approximation); ``path_elbos`` each path's best ELBO."""

    draws: Any
    pareto_k: Any
    path_elbos: Any
    paths: PathfinderResult

    def mean(self):
        return torch.mean(self.draws, dim=1)


def _pool(paths: PathfinderResult):
    """The paths' draws pooled ``(D, n_paths * n_draws)``, path by path,
    their log ratios ``log p - log q`` Pareto-smoothed, and the k-hat (NaN
    under 25 draws, too few for the tail fit)."""
    dim = paths.draws.shape[1]
    pooled = paths.draws.permute(1, 0, 2).reshape(dim, -1)
    lw = (paths.logp - paths.logq).reshape(-1)
    lw = torch.where(torch.isfinite(lw), lw, float("-inf"))
    lw = lw - torch.max(lw)
    total = lw.shape[0]
    if total < 25:
        return pooled, lw, torch.tensor(float("nan"), device=lw.device)
    lw_s, k_hat = _psis_smooth_column(lw, total)
    return pooled, lw_s, k_hat


def _multi(gen, logdensity_cols, dim, n_paths, n_resample, device, path_kwargs) -> MultiPathfinderResult:
    paths = _paths(gen, logdensity_cols, dim, n_paths, device, **path_kwargs)
    pooled, lw_s, k_hat = _pool(paths)
    idx = torch.multinomial(torch.exp(lw_s - torch.max(lw_s)), n_resample, replacement=True, generator=gen)
    return MultiPathfinderResult(draws=pooled[:, idx], pareto_k=k_hat, path_elbos=paths.elbo, paths=paths)


def multi_pathfinder(
    gen,
    logdensity_cols: Callable,
    dim: int,
    *,
    n_paths: int = 8,
    n_resample: int = 200,
    device="cuda",
    **path_kwargs,
) -> MultiPathfinderResult:
    """``n_paths`` Pathfinders from independent starts, run as one batch,
    their draws pooled and resampled by Pareto-smoothed importance weights
    ``log p - log q`` (Vehtari et al. 2017): the paper's algorithm 2."""
    refuse_row_sharded(logdensity_cols, "multi_pathfinder")
    gen, device = entry_generator(gen, device, "multi_pathfinder")
    return _multi(gen, logdensity_cols, dim, n_paths, n_resample, device, path_kwargs)


@Pytree.dataclass
class PathfinderPosterior(Pytree):
    """A :class:`MultiPathfinderResult` bound to a model's packer: draws
    decode to choice maps over the fitted addresses."""

    result: MultiPathfinderResult
    packer: Any = Pytree.static()

    def sample_choices(self, gen: torch.Generator, n: int):
        draws = self.result.draws
        idx = torch.randint(0, draws.shape[1], (n,), generator=gen, device=draws.device)
        return torch.func.vmap(self.packer.unpack, in_dims=1)(draws[:, idx])

    def mean_choices(self):
        return self.packer.unpack(self.result.mean())


def column_pathfinder(
    gen,
    model,
    constraint,
    args: tuple,
    addresses: Sequence[Any],
    *,
    n_paths: int = 8,
    n_resample: int = 200,
    device="cuda",
    **path_kwargs,
) -> PathfinderPosterior:
    """Multi-path Pathfinder over a model's continuous addresses in the
    column layout (the bridge of ``column_advi``)."""
    gen, device = entry_generator(gen, device, "column_pathfinder")
    if constraint is None:
        constraint = ChoiceMap.empty()
    constraint, args = to_device(constraint, device), to_device(args, device)
    packer = ColumnPacker(model, constraint, args, addresses)
    ld = column_logdensity(model, constraint, args, packer)
    result = _multi(gen, ld, packer.padded_dim, n_paths, n_resample, device, path_kwargs)
    return PathfinderPosterior(result=result, packer=packer)


__all__ = [
    "MultiPathfinderResult",
    "PathfinderPosterior",
    "PathfinderResult",
    "column_pathfinder",
    "multi_pathfinder",
    "pathfinder",
]

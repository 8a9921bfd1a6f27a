"""The Rao-Blackwellized particle filter (the mixture Kalman filter).

Counterpart of ``genjax_tpu/parallel/rbpf.py`` (``RBPFResult``, ``rbpf``).
For conditionally linear-Gaussian models

    u_t ~ f(u_t | u_{t-1})                       (the regime)
    z_t = A(u_t) z_{t-1} + w_t,  w_t ~ N(0, Q(u_t))
    y_t = C(u_t) z_t + v_t,      v_t ~ N(0, R(u_t))

each particle samples the regime ``u`` alone and carries the exact Kalman
mean and covariance of ``z | u_{1:t}, y_{1:t}`` (``dists/lgssm.py``'s
update); its weight is the exact one-step predictive density. One device, no
process group.

Under a key (``core/keys.py``) the filter draws the reference's draws:
step ``t`` splits ``fold_in(key, t)`` into its extension and resample keys,
and particle ``i``'s ``sample_regime`` gets the ``i``-th of
``split(extension key, K)``, as ``SSMParticleFilter.run`` does.

Deviations, results alike in law: under a generator (or an int seed)
``sample_regime`` takes ``(gen, u_prev, t)`` and draws from the generator
under ``torch.func.vmap`` over the particles; the resample decision is one
host read of the ESS a step (``smc.resample_if``), where the reference
decides in ``lax.cond``.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.pytree import Pytree
from ..dists.lgssm import kalman_update
from .resampling import effective_sample_size
from .smc import resample_if, step_streams


@Pytree.dataclass
class RBPFResult(Pytree):
    """Final regime particles, their Gaussian filters ``(means, covs)`` over
    the linear state, normalised log weights, the log marginal likelihood
    estimate, and the ESS of every step (before its resample)."""

    regimes: Any
    means: Any
    covs: Any
    log_weights: Any
    log_marginal: Any
    ess_history: Any


def rbpf(
    gen,
    sample_regime: Callable,
    matrices: Callable,
    ys,
    *,
    n_particles: int,
    init_regime: Any,
    mu0,
    P0,
    ess_threshold: float = 0.5,
    method: str = "systematic",
    device="cuda",
) -> RBPFResult:
    """Run the Rao-Blackwellized filter on ``device`` (the card unless the
    caller asks for the CPU).

    Args:
        gen: a key (placed on ``device``), a ``torch.Generator`` there, or
            an int seed.
        sample_regime: ``(gen, u_prev, t) -> u``, one prior draw of the
            regime from a particle's key or the generator (torch ops;
            vmapped over the particles).
        matrices: ``u -> (A, Q, C, R)``, the linear system of regime ``u``
            (shapes ``(Dz, Dz), (Dz, Dz), (Dy, Dz), (Dy, Dy)``).
        ys: observations ``(T, Dy)``.
        init_regime: the initial ``u_0`` (every particle's), which
            ``sample_regime`` gets at ``t = 0``.
        mu0, P0: the prior mean and covariance of ``z_0``; the first
            observation is of ``z_1 = A(u_1) z_0 + w``.
        ess_threshold: the resample trigger, a fraction of ``n_particles``.

    >>> import torch
    >>> from genjax_tpu_torch.parallel import rbpf
    >>> eye = torch.eye(1)
    >>> res = rbpf(0, lambda gen, u, t: u, lambda u: (eye, eye, eye, eye * 0.25),
    ...            torch.tensor([[0.3], [-0.1]]), n_particles=64, init_regime=torch.tensor(0),
    ...            mu0=torch.zeros(1), P0=eye, device="cpu")
    >>> tuple(res.means.shape), bool(torch.isfinite(res.log_marginal))
    ((64, 1), True)
    """
    gen, device = keys.entry_stream(gen, device, "rbpf")
    k = n_particles
    ys = torch.as_tensor(ys, dtype=torch.float32, device=device)
    mu0 = torch.as_tensor(mu0, dtype=torch.float32, device=device)
    P0 = torch.as_tensor(P0, dtype=torch.float32, device=device)

    def particle_step(pgen, u_prev, mean, cov, t, y):
        u = sample_regime(pgen, u_prev, t)
        A, Q, C, R = matrices(u)
        # predict through the regime's dynamics, then update on y: the
        # weight is the exact predictive density p(y_t | u_{1:t}, y_<t)
        mean_pred = A @ mean
        cov_pred = A @ cov @ A.T + Q
        mean_f, cov_f, ll = kalman_update(mean_pred, cov_pred, C, R, y)
        return u, mean_f, cov_f, ll

    def step(sgen, *rest):
        return keys.vmap_streams(particle_step, sgen, k, in_dims=(0, 0, 0, None, None))(*rest)
    dz = mu0.shape[0]
    us = pytree.tree_map(
        lambda v: torch.as_tensor(v, device=device).expand((k,) + tuple(torch.as_tensor(v).shape)).clone(),
        init_regime,
    )
    means = mu0.expand(k, dz).clone()
    covs = P0.expand(k, dz, dz).clone()
    log_w = torch.zeros(k, device=device)
    log_z = torch.zeros((), device=device)
    ess_hist = []
    for t, (extend_gen, resample_gen) in enumerate(step_streams(gen, ys.shape[0])):
        us, means, covs, lls = step(extend_gen, us, means, covs, torch.tensor(t, device=device), ys[t])
        log_w = log_w + lls
        ess = effective_sample_size(log_w)
        ess_hist.append(ess)
        (us, means, covs), log_w, log_z = resample_if(
            resample_gen, ess < ess_threshold * k, (us, means, covs), log_w, log_z, method
        )
    log_norm = torch.logsumexp(log_w, dim=0)
    return RBPFResult(
        regimes=us,
        means=means,
        covs=covs,
        log_weights=log_w - log_norm,
        log_marginal=log_z + log_norm - math.log(k),
        ess_history=torch.stack(ess_hist),
    )

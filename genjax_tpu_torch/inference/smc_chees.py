"""ChEES-adaptive tempered SMC in the column layout.

Counterpart of ``genjax_tpu/inference/smc_chees.py``: ``ChEESTemperedResult``,
``chees_tempered_smc`` and ``column_tempered_chees``. A tempered SMC sampler
("Incorporating the ChEES Criterion into Sequential Monte Carlo Samplers",
arXiv:2504.02627) whose HMC rejuvenation tunes itself from the particle
population at every rung:

- the temperature ladder by bisection on the conditional ESS (Zhou,
  Johansen & Aston 2016; ``inference.tempered._choose_delta``, 30 halvings
  on the device);
- the step size by dual averaging on the population's mean acceptance
  (``kernels.adaptation``);
- the trajectory length by Adam ascent on the ChEES gradient from every
  particle's proposal end point (``kernels.chees``'s estimator and Adam
  step), with Halton-jittered trajectory times;
- a diagonal inverse mass from the cross-particle variance.

Positions are columns ``(D, N)``, the particles on the last axis. The
tempered density and its gradient are one ``torch.func.vjp`` of ``(prior +
beta lik, lik)`` with the cotangent ``(1, 0)``.

Deviations from the reference, results alike in law:

- the leapfrog count of a sweep is one number for the whole population, so
  the integrator is a host loop of ``int(L)`` steps: one read a sweep;
- the ladder stops when ``beta`` reaches 1, one read a rung, and its
  histories are then padded to ``max_rungs`` with the reference's idle rows
  (the final ``beta``, zeros elsewhere), so the result has the reference's
  shapes and ``n_rungs`` counts the same rungs;
- resampling is decided on the host (``parallel.smc.resample_if``);
- under a ``torch.Generator`` it is drawn from in sequence; an int seed
  makes a generator here too (where the column samplers read an int as
  ``key(seed)``), so that the cookbooks that run this sampler
  keep their streams and their cost: a key's hashes are many launches each.

Under a key (``core/keys.py``) the sampler splits and folds it in as the
reference does and draws its draws: ``init_key, ladder_key = split(key)``,
rung ``t`` resamples under ``fold_in(fold_in(ladder_key, t), 1)``, and its
sweep ``j`` draws its momenta and accepts from the two halves of
``split(fold_in(fold_in(fold_in(ladder_key, t), 2), j))``;
``column_tempered_chees`` draws its prior particles by ``simulate`` under
``split(k_init, N)`` and its padding rows under ``fold_in(k_init, 1)``, and
runs the sampler under ``k_run`` (``k_init, k_run = split(key)``).

``chees_tempered_smc`` runs where its ``q0`` lives; ``column_tempered_chees``
makes its particles on ``device``, the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..core import keys
from ..core.device import chain_generator, same_device, to_device
from ..core.pytree import Pytree
from ..kernels.adaptation import StepSizeAdaptState, _halton2, cross_chain_inv_mass, dual_averaging_update
from ..kernels.chees import _adam
from ..kernels.model_interface import ColumnPacker, packed_prior_draws, tempered_factors
from ..parallel.resampling import effective_sample_size
from ..parallel.smc import resample_if
from .tempered import _choose_delta


@Pytree.dataclass
class ChEESTemperedResult(Pytree):
    """Final particle columns ``(D, N)``, the evidence estimate and the
    adaptation record. The histories have ``max_rungs`` rows; the rows
    after ``beta`` reached 1 are idle (``beta`` repeated, zeros elsewhere):
    mask them by ``n_rungs``."""

    particles: Any
    log_weights: Any
    log_marginal: Any
    beta_history: Any
    final_beta: Any
    n_rungs: Any
    ess_history: Any
    accept_history: Any
    eps_history: Any
    trajectory_history: Any
    leapfrog_history: Any


def chees_tempered_smc(
    gen,
    log_prior_cols: Callable[[Any], Any],
    log_lik_cols: Callable[[Any], Any],
    q0,
    *,
    cess_target: float = 0.9,
    max_rungs: int = 64,
    n_bisect: int = 30,
    ess_threshold: float = 0.5,
    n_rejuvenation: int = 2,
    eps0: float = 0.1,
    t0: float = 1.0,
    target_accept: float = 0.651,
    max_leapfrogs: int = 256,
    adam_lr: float = 0.025,
    adapt_mass: bool = True,
    method: str = "systematic",
) -> ChEESTemperedResult:
    """Anneal ``N`` column particles from prior draws ``q0 (D, N)`` to the
    posterior ``prior * lik`` with a self-tuning HMC rejuvenation.

    ``log_prior_cols``/``log_lik_cols`` are batched column densities ``(D,
    N) -> (N,)`` through which ``torch.func.vjp`` goes. The run lives where
    ``q0`` does; ``gen`` is a ``torch.Generator`` there or an int seeding
    one. ``final_beta < 1`` means the ladder used up ``max_rungs``.
    """
    if not 0.0 < cess_target < 1.0:
        raise ValueError(f"cess_target must be in (0, 1), got {cess_target}")
    q0 = torch.as_tensor(q0)
    device = q0.device
    keyed = keys.is_key(gen)
    if keyed:
        if not same_device(gen.device, device):
            raise ValueError(f"chees_tempered_smc: the key lives on {gen.device} and q0 on {device}")
        ladder = keys.split(gen)[1]
    else:
        gen = chain_generator(gen, device, "chees_tempered_smc")
    q = q0.to(torch.float32)
    d, n = q.shape

    def lp_g(q, beta):
        """The tempered log-density and its gradient in one pass, and the
        likelihood alone (the next rung's reweighting)."""

        def both(qq):
            lik = log_lik_cols(qq)
            return log_prior_cols(qq) + beta * lik, lik

        (lp, lik), pullback = torch.func.vjp(both, q)
        (g,) = pullback((torch.ones_like(lp), torch.zeros_like(lik)))
        return lp.detach(), g.detach(), lik.detach()

    def sweep(q, lp, g, lik, step_idx, beta, eps, log_t, inv_mass, key=None):
        """One jittered-trajectory HMC sweep on the tempered target, with
        ``kernels.chees``'s integrator, accept and ChEES gradient driven by
        the particle population; under ``key`` its momenta and accepts are
        the reference's."""
        im_col = inv_mass[:, None]
        if key is not None:
            k_p, k_u = keys.split(key).unbind(-2)
            p = (1.0 / torch.sqrt(im_col)) * keys.normal(k_p, (d, n))
        else:
            p = torch.randn((d, n), generator=gen, device=device) / torch.sqrt(im_col)

        def kinetic(p_):
            return 0.5 * torch.sum(im_col * p_ * p_, dim=0)

        tau = _halton2(step_idx).to(device) * torch.exp(log_t)
        big_l = torch.clamp(torch.ceil(tau / eps).to(torch.int32), 1, max_leapfrogs)
        q1, p1, g1, lp1, lik1 = q, p, g, lp, lik
        for _ in range(int(big_l)):  # one host read a sweep
            p1 = p1 + (eps / 2.0) * g1
            q1 = q1 + eps * im_col * p1
            lp1, g1, lik1 = lp_g(q1, beta)
            p1 = p1 + (eps / 2.0) * g1
        log_alpha = (lp1 - kinetic(p1)) - (lp - kinetic(p))
        alpha = torch.where(
            torch.isnan(log_alpha), 0.0, torch.clamp(torch.exp(torch.clamp(log_alpha, max=0.0)), max=1.0)
        )
        finite_pos = torch.all(torch.isfinite(q1), dim=0)
        log_u = torch.log(keys.uniform(k_u, (n,)) if key is not None else torch.rand(n, generator=gen, device=device))
        accept = (log_u < log_alpha) & finite_pos
        qn = torch.where(accept[None, :], q1, q)
        lpn = torch.where(accept, lp1, lp)
        gn = torch.where(accept[None, :], g1, g)
        likn = torch.where(accept, lik1, lik)

        # the ChEES gradient (kernels/chees.py's estimator and divergence guard)
        ok = finite_pos & ~torch.isnan(lp1)
        q1s = torch.where(ok[None, :], q1, q)
        p1s = torch.where(ok[None, :], p1, torch.zeros_like(p1))
        qm = q.mean(dim=1, keepdim=True)
        qm1 = q1s.mean(dim=1, keepdim=True)
        dsq0 = torch.sum((q - qm) ** 2, dim=0)
        dsq1 = torch.sum((q1s - qm1) ** 2, dim=0)
        proj = torch.sum((q1s - qm1) * (im_col * p1s), dim=0)
        per_chain = (dsq1 - dsq0) * proj
        contrib = torch.where(torch.isfinite(per_chain), alpha * per_chain, 0.0)
        grad_logt = torch.sum(contrib) / (torch.sum(alpha) + 1e-12) * tau
        grad_logt = torch.where(torch.isfinite(grad_logt), grad_logt, 0.0)
        return qn, lpn, gn, likn, alpha.mean(), grad_logt, big_l

    def clamp_logt(log_t, eps):
        return torch.minimum(torch.maximum(log_t, torch.log(eps)), torch.log(eps * max_leapfrogs))

    lik = log_lik_cols(q).detach()
    log_w = torch.zeros(n, device=device)
    log_z = torch.zeros((), device=device)
    beta = torch.zeros((), device=device)
    adapt = StepSizeAdaptState.init(eps0, device=device)
    log_t = torch.log(torch.tensor(t0, dtype=torch.float32, device=device))
    mv = (torch.zeros((), device=device), torch.zeros((), device=device))
    inv_mass = torch.ones(d, dtype=torch.float32, device=device)
    hist = []
    for t in range(max_rungs):
        delta = _choose_delta(log_w, lik, beta, cess_target, n_bisect)
        beta = torch.clamp(beta + delta, max=1.0)
        log_w = log_w + delta * lik
        ess = effective_sample_size(log_w)
        if keyed:
            rung = keys.fold_in(ladder, t)
            resample_gen, rejuv = keys.fold_in(rung, torch.arange(1, 3, device=device)).unbind(-2)
            sweep_keys = keys.fold_in(rejuv, torch.arange(n_rejuvenation, device=device)).unbind(-2)
        else:
            resample_gen, sweep_keys = gen, [None] * n_rejuvenation
        (qT, lik), log_w, log_z = resample_if(
            resample_gen, ess < ess_threshold * n, (q.T, lik), log_w, log_z, method)
        q = qT.T
        lp, g, lik = lp_g(q, beta)
        alphas, ls = [], []
        for j in range(n_rejuvenation):
            eps = torch.exp(adapt.log_eps)
            q, lp, g, lik, alpha, grad_logt, big_l = sweep(
                q, lp, g, lik, t * n_rejuvenation + j, beta, eps, log_t, inv_mass, sweep_keys[j]
            )
            mv, update = _adam(mv, grad_logt, adapt.step)
            log_t = clamp_logt(log_t + adam_lr * update, eps)
            adapt = dual_averaging_update(adapt, alpha, target_accept=target_accept)
            alphas.append(alpha)
            ls.append(big_l)
        if adapt_mass:
            inv_mass = cross_chain_inv_mass(q, chain_axis=1)
        nan = torch.tensor(float("nan"), device=device)  # the mean of no sweep
        hist.append((beta, ess, torch.stack(alphas).mean() if alphas else nan, torch.exp(adapt.log_eps),
                     torch.exp(log_t), torch.stack(ls).to(torch.float32).mean() if ls else nan))
        if bool(beta >= 1.0):  # one host read a rung
            break
    n_rungs = len(hist)
    pad = max_rungs - n_rungs
    cols = [torch.stack(c) for c in zip(*hist)]
    zeros = torch.zeros(pad, device=device)
    beta_hist = torch.cat([cols[0], beta.expand(pad)])
    rest = [torch.cat([c, zeros]) for c in cols[1:]]
    return ChEESTemperedResult(
        particles=q,
        log_weights=log_w,
        log_marginal=log_z + torch.logsumexp(log_w, dim=0) - math.log(n),
        beta_history=beta_hist,
        final_beta=beta,
        n_rungs=torch.tensor(n_rungs, device=device),
        ess_history=rest[0],
        accept_history=rest[1],
        eps_history=rest[2],
        trajectory_history=rest[3],
        leapfrog_history=rest[4],
    )


def column_tempered_chees(
    model,
    constraint,
    args: tuple,
    addresses,
    gen,
    n_particles: int,
    *,
    device="cuda",
    **kwargs,
):
    """Run a ``@gen`` model through :func:`chees_tempered_smc` by the column
    bridge: the prior column density is the ``generate`` weight under the
    latents alone and the likelihood the joint (``column_logdensity``) minus
    it. Returns ``(result, packer)``."""
    gen, device = keys.entry_stream(gen, device, "column_tempered_chees")
    constraint, args = to_device(constraint, device), to_device(args, device)
    packer = ColumnPacker(model, constraint, args, list(addresses))
    prior_cols, lik_cols = tempered_factors(model, constraint, args, packer, device)
    if not keys.is_key(gen):
        q0 = packed_prior_draws(gen, model, constraint, args, packer, n_particles, device)
        return chees_tempered_smc(gen, prior_cols, lik_cols, q0, **kwargs), packer
    k_init, k_run = keys.split(gen).unbind(-2)
    q0 = torch.func.vmap(lambda k: packer.pack(model.simulate(k, args).get_choices()), out_dims=1)(
        keys.split(k_init, n_particles)).contiguous()
    n_pad = packer.padded_dim - packer.dim
    if n_pad:
        q0[packer.dim :] = keys.normal(keys.fold_in(k_init, 1), (n_pad, n_particles))
    return chees_tempered_smc(k_run, prior_cols, lik_cols, q0, **kwargs), packer


__all__ = ["ChEESTemperedResult", "chees_tempered_smc", "column_tempered_chees"]

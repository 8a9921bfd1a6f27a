"""Tempered SMC (SMC samplers): anneal from the prior to the posterior
through a ladder of likelihood temperatures, with resampling and MCMC
rejuvenation at each rung.

Counterpart of ``genjax_tpu/inference/tempered.py``: ``tempered_smc``,
``adaptive_tempered_smc`` (the next temperature by bisection on the
conditional ESS), ``geometric_ladder`` and the two result types. The
tempered target at ``beta`` is ``prior(z) likelihood(z)^beta``: since
``generate`` under the constraint weighs a particle by the log-likelihood
of the constrained choices, a rung's incremental weight is ``(beta_t -
beta_{t-1}) llh``. Rejuvenation is an edit request applied to each particle
with the tempered MH correction ``alpha = w - (1 - beta) dllh``.

Deviations from the reference, results alike:
- the rungs are a Python loop (the reference's ``lax.scan``), and the
  adaptive ladder stops when ``beta`` reaches 1, one read of ``beta`` to the
  host a rung; its histories are padded as the reference's are: the final
  beta repeated, ESS and accept 0 after the end, ``n_rungs`` the active
  rungs;
- the particles lead every leaf throughout (the reference moves them to the
  last axis for the TPU's lanes between resamples);
- resampling is decided on the host (``parallel.smc.resample_if``), as the
  particle filter's is;
- under a ``torch.Generator`` (an int seed makes one) it is drawn from in
  sequence where the reference splits or folds in a key.

Under a key (``core/keys.py``) the drivers split and fold it in as the
reference does, and draw its draws: ``init_key, ladder_key = split(key)``,
particle ``i`` starts under the ``i``-th of ``split(init_key, K)``, rung
``t`` resamples under ``fold_in(fold_in(ladder_key, t), 1)`` and
rejuvenates under ``fold_in(..., 2)``, whose ``n_rejuvenation`` sweeps take
``split(rejuvenation key, n_rejuvenation)``, particle ``i`` of a sweep the
``i``-th of that sweep key's ``split(., K)``, folded in with 0 (the edit), 1
(the accept), 2 and 3 (the projections).

The drivers make their particles on ``device``, the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.concepts import DiffAnnotate, EditRequest, Regenerate
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..parallel.resampling import effective_sample_size
from ..parallel.smc import resample_if
from .requests.hmc import mh_accept
from .requests.nuts import NUTS


@Pytree.dataclass
class TemperedSMCResult(Pytree):
    traces: Any  # the particles at beta = 1, particles first
    log_weights: Any
    log_marginal: Any
    ess_history: Any
    accept_history: Any


@Pytree.dataclass
class AdaptiveTemperedSMCResult(Pytree):
    traces: Any
    log_weights: Any
    log_marginal: Any
    beta_history: Any  # (max_rungs,); after the end the final beta repeats
    final_beta: Any  # 1 on success; below 1 the ladder ran out of rungs, and
    #   log_marginal estimates the partly tempered target's normaliser, not
    #   the evidence: raise max_rungs or lower cess_target
    n_rungs: Any
    ess_history: Any  # 0 after the end (mask by n_rungs)
    accept_history: Any


def _rung_streams(ladder, t: int):
    """Rung ``t``'s ``(resample, rejuvenation)`` streams: ``fold_in(fold_in(
    ladder_key, t), 1)`` and ``2``, or the generator twice."""
    if not keys.is_key(ladder):
        return ladder, ladder
    rung = keys.fold_in(ladder, t)
    return keys.fold_in(rung, torch.arange(1, 3, device=rung.device)).unbind(-2)


def _log_mean_exp(log_w: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(log_w, dim=0) - math.log(log_w.shape[0])


def tempered_smc(
    gen,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    *,
    n_particles: int,
    betas,
    rejuvenation: EditRequest | Selection | None = None,
    n_rejuvenation: int = 1,
    ess_threshold: float = 0.5,
    method: str = "systematic",
    device="cuda",
) -> TemperedSMCResult:
    """Tempered SMC over the ascending ladder ``betas`` (ending at 1), with
    ``n_particles`` particles on ``device``; ``gen`` is a
    ``torch.Generator`` there or an int seed.

    >>> import genjax_tpu_torch as g
    >>> from genjax_tpu_torch.inference import geometric_ladder, tempered_smc
    >>> @g.gen
    ... def model():
    ...     mu = g.normal(0.0, 1.0) @ "mu"
    ...     _ = g.normal(mu, 0.5) @ "y"
    >>> res = tempered_smc(0, model, g.C["y"].set(1.5), (), n_particles=2048,
    ...                    betas=geometric_ladder(8), rejuvenation=g.S["mu"], device="cpu")
    >>> abs(float(res.log_marginal) - (-1.9305)) < 0.1  # log N(1.5; 0, 1.25)
    True
    """
    gen, device = keys.entry_stream(gen, device, "tempered_smc")
    _validate_rejuvenation(rejuvenation)
    k = n_particles
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
    constraint, args = to_device(constraint, device), to_device(args, device)
    init_gen, ladder = keys.split_stream(gen)
    traces, llhs = keys.vmap_streams(lambda g: model.generate(g, constraint, args), init_gen, k)()
    rejuvenate = _make_rejuvenator(constraint, rejuvenation, n_rejuvenation)
    log_w = torch.zeros(k, device=device)
    log_z = torch.zeros((), device=device)
    beta_prev = torch.zeros((), device=device)
    ess_hist, acc_hist = [], []
    for t in range(betas.shape[0]):
        beta = betas[t]
        log_w = log_w + (beta - beta_prev) * llhs
        ess = effective_sample_size(log_w)
        resample_gen, rejuv_gen = _rung_streams(ladder, t)
        (traces, llhs), log_w, log_z = resample_if(
            resample_gen, ess < ess_threshold * k, (traces, llhs), log_w, log_z, method
        )
        traces, llhs, acc = rejuvenate(rejuv_gen, traces, llhs, beta)
        ess_hist.append(ess)
        acc_hist.append(acc)
        beta_prev = beta
    return TemperedSMCResult(
        traces, log_w, log_z + _log_mean_exp(log_w), torch.stack(ess_hist), torch.stack(acc_hist)
    )


def _cess(log_w: torch.Tensor, llhs: torch.Tensor, delta) -> torch.Tensor:
    """The conditional ESS of the incremental weights ``exp(delta llh)``
    under the current normalised weights (Zhou, Johansen & Aston 2016, eq.
    3.2)."""
    k = log_w.shape[0]
    log_W = log_w - torch.logsumexp(log_w, dim=0)
    lu = delta * llhs
    num = 2.0 * torch.logsumexp(log_W + lu, dim=0)
    den = torch.logsumexp(log_W + 2.0 * lu, dim=0)
    return k * torch.exp(num - den)


def _choose_delta(log_w, llhs, beta, cess_target: float, n_bisect: int) -> torch.Tensor:
    """The temperature increment in ``(0, 1 - beta]`` that keeps the
    conditional ESS at ``cess_target * K``: ``1 - beta`` if that already
    does, else ``n_bisect`` halvings, all on the device."""
    target = cess_target * log_w.shape[0]
    hi0 = 1.0 - beta
    lo, hi = torch.zeros_like(hi0), hi0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        too_big = _cess(log_w, llhs, mid) < target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    return torch.where(_cess(log_w, llhs, hi0) >= target, hi0, lo)


def adaptive_tempered_smc(
    gen,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    *,
    n_particles: int,
    cess_target: float = 0.9,
    max_rungs: int = 64,
    n_bisect: int = 30,
    rejuvenation: EditRequest | Selection | None = None,
    n_rejuvenation: int = 1,
    ess_threshold: float = 0.5,
    method: str = "systematic",
    device="cuda",
) -> AdaptiveTemperedSMCResult:
    """Tempered SMC with the ladder chosen on line (Zhou, Johansen & Aston
    2016): each rung's increment is found by bisection so that the
    conditional ESS of the incremental weights stays at ``cess_target *
    N``. Same rejuvenation as :func:`tempered_smc`; at most ``max_rungs``
    rungs."""
    if not 0.0 < cess_target < 1.0:
        raise ValueError(
            f"cess_target must be in (0, 1), got {cess_target} — at 1.0 "
            "the bisection returns a zero temperature increment forever"
        )
    gen, device = keys.entry_stream(gen, device, "adaptive_tempered_smc")
    _validate_rejuvenation(rejuvenation)
    k = n_particles
    constraint, args = to_device(constraint, device), to_device(args, device)
    init_gen, ladder = keys.split_stream(gen)
    traces, llhs = keys.vmap_streams(lambda g: model.generate(g, constraint, args), init_gen, k)()
    rejuvenate = _make_rejuvenator(constraint, rejuvenation, n_rejuvenation)
    log_w = torch.zeros(k, device=device)
    log_z = torch.zeros((), device=device)
    beta = torch.zeros((), device=device)
    beta_hist, ess_hist, acc_hist = [], [], []
    for t in range(max_rungs):
        delta = _choose_delta(log_w, llhs, beta, cess_target, n_bisect)
        beta = torch.clamp(beta + delta, max=1.0)
        log_w = log_w + delta * llhs
        ess = effective_sample_size(log_w)
        resample_gen, rejuv_gen = _rung_streams(ladder, t)
        (traces, llhs), log_w, log_z = resample_if(
            resample_gen, ess < ess_threshold * k, (traces, llhs), log_w, log_z, method
        )
        traces, llhs, acc = rejuvenate(rejuv_gen, traces, llhs, beta)
        beta_hist.append(beta)
        ess_hist.append(ess)
        acc_hist.append(acc)
        if bool(beta >= 1.0):
            break
    n_rungs = len(beta_hist)
    pad = max_rungs - n_rungs
    zeros = torch.zeros(pad, device=device)
    return AdaptiveTemperedSMCResult(
        traces=traces,
        log_weights=log_w,
        log_marginal=log_z + _log_mean_exp(log_w),
        beta_history=torch.cat([torch.stack(beta_hist), beta.expand(pad)]),
        final_beta=beta,
        n_rungs=torch.tensor(n_rungs, device=device),
        ess_history=torch.cat([torch.stack(ess_hist), zeros]),
        accept_history=torch.cat([torch.stack(acc_hist), zeros]),
    )


def _validate_rejuvenation(rejuvenation):
    if rejuvenation is None or isinstance(rejuvenation, Selection):
        return
    inner = rejuvenation
    while isinstance(inner, DiffAnnotate):
        inner = inner.request
    if isinstance(inner, NUTS):
        raise ValueError(
            "tempered-SMC rejuvenation does not support NUTS: it "
            "accepts internally, so the tempered-target MH "
            "correction cannot be composed around it. Use HMC, "
            "MALA, Rejuvenate, or a Selection (prior Regenerate)."
        )


def _make_rejuvenator(constraint, rejuvenation, n_rejuvenation: int):
    """The tempered-target rejuvenation sweep ``(gen, traces, llhs, beta) ->
    (traces, llhs, accept_rate)``: ``n_rejuvenation`` moves of every
    particle, each accepted at ``alpha = w - (1 - beta) dllh``. A
    ``Selection`` is a prior ``Regenerate``, whose weight is corrected by the
    change of the selected choices' prior density (``project``), so that it
    is the MH ratio of the posterior as HMC's, MALA's and Rejuvenate's are."""
    if rejuvenation is None:
        return lambda gen, traces, llhs, beta: (traces, llhs, torch.zeros((), device=llhs.device))

    request = Regenerate(rejuvenation) if isinstance(rejuvenation, Selection) else rejuvenation
    is_prior_regen = isinstance(request, Regenerate)

    def rejuvenate(gen, traces, llhs, beta):
        def per_particle(g, tr, llh):
            if keys.is_key(g):
                k_edit, k_acc, k_new, k_old = keys.fold_in(g, torch.arange(4, device=g.device)).unbind(-2)
                k_score = keys.key(0, device=g.device)
            else:
                k_edit = k_acc = k_new = k_old = k_score = g
            new_tr, w, _rd, _bwd = tr.edit(k_edit, request)
            new_llh = _constrained_score(constraint, new_tr, k_score)
            dllh = new_llh - llh
            if is_prior_regen:
                sel = request.selection
                w = w - (new_tr.project(k_new, sel) - tr.project(k_old, sel))
            out_tr, accept = mh_accept(k_acc, tr, new_tr, w - (1.0 - beta) * dllh)
            return out_tr, torch.where(accept, new_llh, llh), accept.to(torch.float32)

        accs = []
        for sweep in keys.split_stream(gen, n_rejuvenation):
            traces, llhs, acc = keys.vmap_streams(per_particle, sweep, llhs.shape[0])(traces, llhs)
            accs.append(acc.mean())
        return traces, llhs, torch.stack(accs).mean()

    return rejuvenate


def _constrained_score(constraint: ChoiceMap, trace, gen: torch.Generator | None = None):
    """The log-likelihood of the constrained (observed) choices under the
    trace's latents: the trace's score projected onto the constraint's
    addresses (exact for exact-density models; the reference projects
    under ``key(0)``)."""
    return trace.project(gen, constraint.get_selection())


def geometric_ladder(n: int, power: float = 3.0) -> torch.Tensor:
    """An ascending temperature ladder in (0, 1], denser near 0."""
    return (torch.arange(1, n + 1, dtype=torch.float32) / n) ** power

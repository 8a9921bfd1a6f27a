"""Nested sampling (Skilling 2006): evidence estimation by replacing the
worst live point, again and again, with a prior draw constrained to a higher
likelihood.

Counterpart of ``genjax_tpu/inference/nested.py``: ``NestedSamplingResult``,
``nested_sampling`` and ``column_nested_sampling``. A run is sequential (one
dead point an iteration), so the unit of parallelism is the run: ``n_runs``
independent replicas, whose spread is the honest error bar. The constrained
replacement is a fixed ``n_mcmc``-step random-walk MH on the prior
restricted to ``{log_lik > L_min}``, its proposal scaled by the live set's
standard deviation in each dimension and its step self-tuned toward 35%
acceptance.

The reference vmaps one run over the replicas. Here the runs are a batch
axis of explicit tensors: the live points are ``(n_runs, D, n_live)``, the
argmin, pick and replace of every run are batched gathers and scatters, and
a step of the constrained walk hands every run's proposal to the column
densities at once, as one ``(D, n_runs)`` call. A step is thus one set of
launches, however many runs there are, and nothing is read to the host.

Under a key (``core/keys.py``) the runs are the reference's draw for draw:
each run draws under its element of ``split(key, n_runs)``, as the
reference's vmap over runs: ``k_init, k_scan = split(run key)``,
``sample_prior(k_init, n_live)``, and iteration ``i``'s pick and walk from
``split(split(k_scan, n_iter)[i])``, the walk's step ``m`` from
``split(split(k_mcmc, n_mcmc)[m])``. Every run's picks, normals and
uniforms are made at once (one ``torch.func.vmap`` over the run keys, in a
few hashes however many iterations); then the runs walk as one batch, in
the loop a generator drives.

``column_nested_sampling`` bridges ``@gen`` models: the prior density over
a packed column is the ``generate`` weight under the latents alone, and the
likelihood the joint column density minus it, so the padding rows cancel
and contribute a factor 1 to the evidence. Both entry points run on
``device``, the card unless the caller asks for the CPU, and draw from one
``torch.Generator`` there (``sample_prior(gen, n)`` is handed it), or from
a key placed there (``sample_prior(key, n)``).

>>> import math, torch
>>> from genjax_tpu_torch.inference import nested_sampling
>>> c = -0.5 * math.log(2 * math.pi)
>>> res = nested_sampling(
...     lambda gen, n: torch.randn((1, n), generator=gen),
...     lambda q: -0.5 * q[0] ** 2 + c,
...     lambda q: -0.5 * ((q[0] - 0.5) / 0.5) ** 2 - math.log(0.5) + c,
...     0, n_live=64, n_iter=300, n_mcmc=10, n_runs=4, device="cpu")
>>> exact = -0.5 * 0.25 / 1.25 - 0.5 * math.log(1.25) + c
>>> bool(abs(float(res.log_z_mean) - exact) < 0.3)
True
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..kernels.model_interface import ColumnPacker, packed_prior_draws, tempered_factors


@Pytree.dataclass
class NestedSamplingResult(Pytree):
    """Per-run tensors lead with the run axis ``R = n_runs``."""

    log_z: Any  # (R,) evidence estimates
    h: Any  # (R,) information H = E_post[log L] - log Z (nats)
    dead: Any  # (R, n_iter, D) dead points: the posterior draws
    dead_log_lik: Any  # (R, n_iter), non-decreasing
    dead_log_weight: Any  # (R, n_iter) normalised posterior log weights
    live: Any  # (R, D, n_live) final live points (the innermost shell)
    live_log_lik: Any  # (R, n_live)
    accept_rate: Any  # (R,) mean constrained-walk acceptance

    @property
    def log_z_mean(self):
        return torch.mean(self.log_z)

    @property
    def log_z_std(self):
        return torch.std(self.log_z, correction=0)

    @property
    def n_live(self) -> int:
        return self.live.shape[-1]

    def error_estimate(self):
        """Skilling's single-run error sqrt(H / n_live), averaged over runs;
        set it beside ``log_z_std``: disagreement signals a poorly mixing
        constrained walk."""
        return torch.mean(torch.sqrt(torch.clamp(self.h, min=0.0) / self.n_live))

    def posterior_mean(self):
        """The posterior expectation of the position, pooling every run's
        weighted dead points: ``(D,)`` (the live points are not posterior
        draws: they sit on the innermost likelihood shell)."""
        w = torch.exp(self.dead_log_weight)
        w = w / torch.sum(w)
        return torch.einsum("ri,rid->d", w, self.dead)

    def resample_posterior(self, gen: torch.Generator, n: int):
        """``n`` equally weighted posterior draws ``(n, D)``: a categorical
        resample of the pooled dead points by their weights (under a key,
        the reference's ``categorical(key, logits, shape=(n,))``)."""
        r, n_iter, d_dim = self.dead.shape
        logits = self.dead_log_weight.reshape(-1)
        if keys.is_key(gen):
            return self.dead.reshape(r * n_iter, d_dim)[keys.categorical(gen, logits, shape=(n,))]
        probs = torch.exp(logits - torch.max(logits))
        idx = torch.multinomial(probs, n, replacement=True, generator=gen)
        return self.dead.reshape(r * n_iter, d_dim)[idx]


def _evidence(dead_ll: torch.Tensor, live_ll: torch.Tensor, n_live: int):
    """The evidence quadrature at the deterministic shrinkage ``X_i =
    exp(-i / n_live)`` and the information, from each run's dead
    likelihoods ``(R, n_iter)`` and final live likelihoods ``(R, n_live)``.
    Returns ``(log_z (R,), h (R,), dead_log_weight (R, n_iter))``."""
    n_iter = dead_ll.shape[1]
    t = 1.0 / n_live
    i = torch.arange(n_iter, dtype=dead_ll.dtype, device=dead_ll.device)
    # log dX_i = log(X_{i-1} - X_i) = -i t + log(1 - e^-t)
    log_dx = -i * t + math.log(-math.expm1(-t))
    log_z_dead = torch.logsumexp(dead_ll + log_dx, dim=1)
    # the live remainder: X_final times the mean live likelihood
    log_z_live = torch.logsumexp(live_ll, dim=1) - math.log(n_live) - n_iter * t
    log_z = torch.logaddexp(log_z_dead, log_z_live)
    dead_log_w = dead_ll + log_dx - log_z[:, None]
    p_live = torch.exp(live_ll - math.log(n_live) - n_iter * t - log_z[:, None])
    h = torch.sum(torch.exp(dead_log_w) * dead_ll, dim=1) + torch.sum(p_live * live_ll, dim=1) - log_z
    return log_z, h, dead_log_w


def nested_sampling(
    sample_prior: Callable[[torch.Generator, int], Any],
    log_prior: Callable,
    log_lik: Callable,
    gen,
    *,
    n_live: int = 256,
    n_iter: int,
    n_mcmc: int = 20,
    n_runs: int = 32,
    step_scale: float = 0.4,
    device="cuda",
) -> NestedSamplingResult:
    """Run ``n_runs`` independent nested-sampling replicas as one batch.

    Args:
        sample_prior: ``(gen, n) -> (D, n)`` column draws from the prior.
        log_prior: batched column log prior density ``(D, NB) -> (NB,)``
            (unnormalised is fine: only ratios enter).
        log_lik: batched column log likelihood ``(D, NB) -> (NB,)``.
        gen: a ``torch.Generator`` on ``device``, or an int seeding one.
        n_live: live points a run.
        n_iter: dead points a run; the prior shrinks by ``exp(-n_iter /
            n_live)``, so take ``n_iter`` about ``n_live * (H + a few
            nats)``.
        n_mcmc: constrained random-walk MH steps a replacement.
        n_runs: independent replicas (the batch axis).
        step_scale: the initial proposal scale, in units of the live set's
            standard deviation; it tunes itself toward 35% acceptance.
    """
    gen, device = keys.entry_stream(gen, device, "nested_sampling")
    r = n_runs
    rows = torch.arange(r, device=device)
    if keys.is_key(gen):
        q, pick, propose, log_u = _key_draws(sample_prior, gen, n_live, n_iter, n_mcmc, r)
        cols = q.permute(1, 0, 2).reshape(q.shape[1], r * n_live)
    else:
        cols = torch.as_tensor(sample_prior(gen, r * n_live), dtype=torch.float32).to(device)

        def pick(i):
            return torch.randint(0, n_live, (r,), generator=gen, device=device)

        def propose(i, m, qq, step):
            return qq + step * torch.randn(qq.shape, generator=gen, device=device)

        def log_u(i, m):
            return torch.log(torch.rand(r, generator=gen, device=device))

    d = cols.shape[0]
    lp = log_prior(cols).reshape(r, n_live).clone()
    ll = log_lik(cols).reshape(r, n_live).clone()
    q = cols.reshape(d, r, n_live).permute(1, 0, 2).contiguous()  # (R, D, n_live)
    eps = torch.full((r,), step_scale, dtype=torch.float32, device=device)
    dead_q, dead_ll, accs = [], [], []
    for i in range(n_iter):
        i_min = torch.argmin(ll, dim=1)
        l_min = ll[rows, i_min]
        j = pick(i)
        j = torch.where(j == i_min, (j + 1) % n_live, j)
        sigma = torch.std(q, dim=2, correction=0) + 1e-12  # (R, D)
        qq, qlp, qll = q[rows, :, j], lp[rows, j], ll[rows, j]
        n_acc = torch.zeros(r, device=device)
        step = eps[:, None] * sigma
        for m in range(n_mcmc):
            prop = propose(i, m, qq, step)
            cols = prop.T  # every run's proposal in one column call
            plp, pll = log_prior(cols), log_lik(cols)
            ok = (log_u(i, m) < plp - qlp) & (pll > l_min)
            qq = torch.where(ok[:, None], prop, qq)
            qlp = torch.where(ok, plp, qlp)
            qll = torch.where(ok, pll, qll)
            n_acc = n_acc + ok.to(torch.float32)
        acc = n_acc / n_mcmc
        dead_q.append(q[rows, :, i_min])
        dead_ll.append(l_min)
        accs.append(acc)
        q[rows, :, i_min] = qq  # the dead point above is a copy
        lp[rows, i_min] = qlp
        ll[rows, i_min] = qll
        # a multiplicative nudge toward 35% acceptance, clipped so that a
        # run of rejections cannot collapse the walk
        eps = torch.clamp(eps * torch.exp(0.3 * (acc - 0.35)), 1e-4, 1e2)
    dead_ll = torch.stack(dead_ll, dim=1)
    log_z, h, dead_log_w = _evidence(dead_ll, ll, n_live)
    return NestedSamplingResult(
        log_z=log_z,
        h=h,
        dead=torch.stack(dead_q, dim=1),
        dead_log_lik=dead_ll,
        dead_log_weight=dead_log_w,
        live=q,
        live_log_lik=ll,
        accept_rate=torch.stack(accs, dim=1).mean(dim=1),
    )


def _key_draws(sample_prior, key, n_live, n_iter, n_mcmc, n_runs):
    """The reference's draws of every run under ``split(key, n_runs)``,
    made at once: the runs' live points ``(R, D, n_live)`` and the walk's
    draws as ``nested_sampling``'s ``pick(i)``, ``propose(i, m, qq, step)``
    and ``log_u(i, m)``."""

    def run(run_key):
        k_init, k_scan = keys.split(run_key).unbind(-2)
        q = torch.as_tensor(sample_prior(k_init, n_live), dtype=torch.float32)
        k_pick, k_mcmc = keys.split(keys.split(k_scan, n_iter)).unbind(-2)
        k_noise, k_u = keys.split(keys.split(k_mcmc, n_mcmc)).unbind(-2)
        return (q, keys.randint(k_pick, (), 0, n_live), keys.normal(k_noise, (q.shape[0],)),
                torch.log(keys.uniform(k_u, ())))

    q, picks, noise, log_us = torch.func.vmap(run)(keys.split(key, n_runs))

    def propose(i, m, qq, step):
        return keys._fma(step, noise[:, i, m], qq)  # XLA fuses the step into one multiply-add

    return q, (lambda i: picks[:, i]), propose, (lambda i, m: log_us[:, i, m])


def column_nested_sampling(
    model,
    constraint,
    args: tuple,
    addresses,
    gen,
    *,
    n_live: int = 256,
    n_iter: int,
    n_mcmc: int = 20,
    n_runs: int = 32,
    step_scale: float = 0.4,
    device="cuda",
):
    """Nested sampling over a model's continuous latents in the column
    layout. Returns ``(result, packer)``: ``result.log_z`` estimates ``log
    p(constraint)`` and ``packer.unpack`` decodes points to choice maps."""
    gen, device = keys.entry_stream(gen, device, "column_nested_sampling")
    if constraint is None:
        constraint = ChoiceMap.empty()
    constraint, args = to_device(constraint, device), to_device(args, device)
    packer = ColumnPacker(model, constraint, args, addresses)
    prior_cols, lik_cols = tempered_factors(model, constraint, args, packer, device)
    n_pad = packer.padded_dim - packer.dim

    def sample_prior(g, n):
        if not keys.is_key(g):
            return packed_prior_draws(g, model, constraint, args, packer, n, device)

        def init_one(kk):
            # the reference's draw: generate under the first half, the padding rows' normals under the second
            k_tr, k_pad = keys.split(kk).unbind(-2)
            q = packer.pack(model.generate(k_tr, constraint, args)[0].get_choices())
            return torch.cat([q[: packer.dim], keys.normal(k_pad, (n_pad,))]) if n_pad else q

        return torch.func.vmap(init_one, out_dims=1)(keys.split(g, n))

    result = nested_sampling(
        sample_prior, prior_cols, lik_cols, gen, n_live=n_live, n_iter=n_iter, n_mcmc=n_mcmc,
        n_runs=n_runs, step_scale=step_scale, device=device,
    )
    return result, packer


__all__ = ["NestedSamplingResult", "column_nested_sampling", "nested_sampling"]

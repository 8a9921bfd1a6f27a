"""SMC²: online joint parameter and state inference (Chopin, Jacob &
Papaspiliopoulos 2013).

Counterpart of ``genjax_tpu/inference/smc2.py``: ``SMC2Result``, ``_take``
and ``smc2``. ``n_theta`` parameter particles each carry an ``n_x``-particle
bootstrap filter; at every observation the inner filters advance one step
and their incremental evidence multiplies the outer weights; when the
parameter ESS collapses, the parameters resample and rejuvenate through a
PMMH exchange move (a fresh particle filter over the history so far for
each proposal, whose acceptance keeps the parameter posterior exact although
the evidence is estimated).

The nesting is explicit: one ``torch.func.vmap`` over the parameters of a
vmap over each one's state particles, around the same ``kernel.generate``
the single-parameter particle filter uses (``parallel/smc.py``). The inner
filters resample every step (bootstrap) by systematic resampling, their
uniforms drawn outside the vmap, one a parameter, and the copy counts made
by the pure ``_systematic_counts`` under the vmap.

Deviations from the reference, results alike in law:

- the time loop is a Python loop, and the parameter resample decision is one
  host read a step (``parallel.smc.resample_if``'s design), where the
  reference decides in ``lax.cond``;
- the PMMH proposal's filter runs the ``t + 1`` steps of the history so far
  and masks nothing. The reference runs a masked scan over the whole horizon
  (an O(T^2) program); here ``t`` is a host integer, so the filter is the
  same in law and cheaper;
- under a ``torch.Generator`` (an int seed makes one) it is drawn from in
  sequence where the reference splits keys; ``theta_sample`` takes that
  generator.

Under a key (``core/keys.py``) the run is the reference's draw for draw:
``k_init, k_loop = split(fold_in(key, 0x53C2))``, ``theta_sample`` gets
parameter ``i``'s key of ``split(k_init, n_theta)``, step ``t`` splits
``fold_in(k_loop, t)`` in three (the filters, the parameter resample, the
rejuvenation), parameter ``i``'s filter splits its key of ``split(k_ext,
n_theta)`` into its extension and resample keys, and a PMMH move ``j``
splits ``fold_in(k_rej, j)`` in three; the proposal's fresh filter runs
step ``s`` under ``fold_in(its key, s)``. The inner resample's counts are
the keyed ``systematic_counts``'s (XLA's association).

The run makes its particles on ``device``, the card unless the caller asks
for the CPU. ``mesh=`` shards the parameter particles (and each one's inner
filter) over a mesh axis: every rank runs its share, the parameter ESS and
normalizer are two collectives a step, and the parameter resample is exact
and global (``collective_resample(mode="all_gather")``).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.typecheck import check_generator
from ..parallel.mesh import local_count, mesh_generators
from ..parallel.resampling import (
    _systematic_counts,
    _systematic_counts_keyed,
    collective_log_normalizer,
    collective_resample,
    collective_weight_stats,
    effective_sample_size,
    systematic_indices,
)


@Pytree.dataclass
class SMC2Result(Pytree):
    """Final parameter particles and their normalised log weights, the log
    evidence estimate, the parameter ESS of every step, and the mean
    rejuvenation acceptance."""

    thetas: Any
    log_weights: Any
    log_evidence: Any
    ess_history: Any
    rejuv_accept_rate: Any


def _take(tree, idx):
    return pytree.tree_map(lambda v: v[idx], tree)


def _vmap(fn, **kw):
    return torch.func.vmap(fn, randomness="different", **kw)


def _rows(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (v.dim() - 1))


def smc2(
    gen,
    kernel: GenerativeFunction,
    theta_sample: Callable,
    theta_logprior: Callable,
    init_carry: Any,
    xs: Any,
    constraint: ChoiceMap,
    *,
    n_theta: int,
    n_x: int,
    ess_threshold: float = 0.5,
    rw_scales: Any = 0.1,
    n_rejuv: int = 1,
    n_steps: int | None = None,
    mesh=None,
    axis: str = "batch",
    device="cuda",
) -> SMC2Result:
    """Run SMC² over a scanned state-space kernel.

    Args:
        kernel: ``@gen`` step ``((theta, z), x) -> ((theta, z'), y)`` whose
            observation at each step is at address ``"y"``: the single-theta
            ``SSMParticleFilter`` convention with theta in the carry.
        theta_sample: ``gen -> theta`` pytree, a prior draw from the
            ``torch.Generator`` it is given.
        theta_logprior: ``theta -> scalar`` log prior density.
        init_carry: the initial ``z`` (the same for every particle).
        xs: per-step inputs, leaves with a leading time axis (or None).
        constraint: the dense observation choice map, ``C[:, "y"].set(ys)``.
        n_theta / n_x: parameter and state particle counts.
        ess_threshold: the parameter resample trigger, a fraction of
            ``n_theta``.
        rw_scales: Gaussian random-walk scales of the PMMH rejuvenation (a
            number, or a pytree matching theta).
        n_rejuv: PMMH exchange moves per rejuvenation.
        n_steps: the horizon when ``xs`` has no tensor leaves.
        mesh, axis: a ``parallel.Mesh`` shards the ``n_theta`` parameter
            particles over its ``axis``: every rank calls ``smc2`` alike,
            ``gen`` in the same state, runs its share from a stream of its
            own on its device, and gets its particles and log weights (the
            weights normalised over every rank's) with the global log
            evidence, ESS history and acceptance.
    """
    if mesh is None:
        gen, device = keys.entry_stream(gen, device, "smc2")
        n_local = n_theta
    else:
        if keys.is_key(gen):
            check_generator(gen, "smc2(mesh=)")
        n_local = local_count(n_theta, mesh, axis, "n_theta")
        shared, gen = mesh_generators(gen, mesh, "smc2")
        device = mesh.device
    xs, constraint, init_carry = to_device((xs, constraint, init_carry), device)
    t_leaves = [v for v in pytree.tree_leaves(xs) if isinstance(v, torch.Tensor)]
    if t_leaves:
        horizon = t_leaves[0].shape[0]
    elif n_steps is not None:
        horizon = n_steps
    else:
        raise ValueError("smc2: xs is None/empty — pass n_steps.")

    keyed = keys.is_key(gen)
    if keyed:
        k_init, k_loop = keys.split(keys.fold_in(gen, 0x53C2)).unbind(-2)
        thetas = torch.func.vmap(theta_sample)(keys.split(k_init, n_local))
    else:
        thetas = _vmap(lambda _: theta_sample(gen))(torch.zeros(n_local, device=device))
    theta_leaves = pytree.tree_leaves(thetas)
    # a number is shared by every leaf, else a pytree matching theta
    scale_leaves = [rw_scales] * len(theta_leaves) if isinstance(rw_scales, (int, float)) else \
        pytree.tree_leaves(rw_scales)
    scales = [
        torch.broadcast_to(torch.as_tensor(s, dtype=v.dtype, device=device), v.shape[1:])
        for v, s in zip(theta_leaves, scale_leaves)
    ]
    log_prior = torch.func.vmap(theta_logprior)

    def broadcast_z(lead):
        return pytree.tree_map(
            lambda v: torch.as_tensor(v, device=device).expand(lead + torch.as_tensor(v).shape).clone(),
            init_carry,
        )

    def x_at(t):
        return pytree.tree_map(lambda v: v[t] if isinstance(v, torch.Tensor) else v, xs)

    def pf_step(thetas, zss, t, pkeys=None):
        """One bootstrap step of every parameter's filter at observation
        ``t``: the particles extended and resampled, and each parameter's
        log evidence increment ``(n_theta,)``. Under keys, parameter ``i``'s
        filter draws under ``pkeys[i]``."""
        submap, x = constraint.get_submap(t), x_at(t)

        def extend(g, theta, z):
            tr, w = kernel.generate(g, submap, ((theta, z), x))
            (_, z_new), _y = tr.get_retval()
            return z_new, w

        if pkeys is not None:
            def one(pk, theta, zs):
                ek, rk = keys.split(pk).unbind(-2)
                zs_new, ws = torch.func.vmap(extend, in_dims=(0, None, 0))(keys.split(ek, n_x), theta, zs)
                return zs_new, ws, _systematic_counts_keyed(keys.uniform(rk), ws, n_x)

            zss_new, ws, counts = torch.func.vmap(one)(pkeys, thetas, zss)
            n_th = ws.shape[0]
        else:
            zss_new, ws = _vmap(_vmap(lambda theta, z: extend(gen, theta, z), in_dims=(None, 0)))(thetas, zss)
            n_th = ws.shape[0]
            u = torch.rand(n_th, generator=gen, device=device)
            counts = torch.func.vmap(_systematic_counts, in_dims=(0, 0, None))(u, ws, n_x)
        inc = torch.logsumexp(ws, dim=1) - math.log(n_x)
        # source of target j: the first source whose cumulative count passes j
        targets = torch.arange(n_x, device=device).expand(n_th, n_x).contiguous()
        idx = torch.searchsorted(torch.cumsum(counts, dim=1), targets, right=True)
        zss_new = pytree.tree_map(
            lambda v: torch.take_along_dim(v, idx.reshape(idx.shape + (1,) * (v.dim() - 2)), dim=1), zss_new
        )
        return zss_new, inc

    def pf_full(thetas, t_now, pkeys=None):
        """A fresh filter for every parameter over ``y_0 .. y_t_now``: the
        final particles and ``log p-hat(y_0..t_now | theta)``; under keys
        step ``s`` of parameter ``i`` draws under ``fold_in(pkeys[i], s)``."""
        zss = broadcast_z((n_local, n_x))
        log_z = torch.zeros(n_local, device=device)
        for s in range(t_now + 1):
            zss, inc = pf_step(thetas, zss, s, None if pkeys is None else keys.fold_in(pkeys, s))
            log_z = log_z + inc
        return zss, log_z

    def rejuvenate(thetas, zss, log_zs, t_now, k_rej=None):
        """``n_rejuv`` PMMH exchange moves of every parameter particle,
        targeting ``p(theta | y_0..t_now)``: an accepted proposal takes its
        fresh filter's particles and evidence."""
        lps = log_prior(thetas)
        n_acc = torch.zeros((), device=device)
        for j in range(n_rejuv):
            leaves, treedef = pytree.tree_flatten(thetas)
            if keyed:
                k_prop, k_pf, k_acc = keys.split(keys.fold_in(k_rej, j), 3).unbind(-2)
                noise = [keys.normal(nk, v.shape).to(v.dtype)
                         for v, nk in zip(leaves, keys.split(k_prop, len(leaves)).unbind(-2))]
            else:
                noise = [torch.randn(v.shape, generator=gen, device=device, dtype=v.dtype) for v in leaves]
            props = pytree.tree_unflatten([v + s * z for v, s, z in zip(leaves, scales, noise)], treedef)
            lps_new = log_prior(props)
            zss_new, lzs_new = pf_full(props, t_now, keys.split(k_pf, n_local) if keyed else None)
            log_alpha = (lps_new + lzs_new) - (lps + log_zs)
            log_u = torch.log(keys.uniform(k_acc, (n_local,)) if keyed
                              else torch.rand(n_local, generator=gen, device=device))
            accept = log_u < log_alpha
            pick = lambda a, b: torch.where(_rows(accept, a), a, b)  # noqa: E731
            thetas = pytree.tree_map(pick, props, thetas)
            zss = pytree.tree_map(pick, zss_new, zss)
            log_zs = torch.where(accept, lzs_new, log_zs)
            lps = torch.where(accept, lps_new, lps)
            n_acc = n_acc + accept.to(torch.float32).mean()
        return thetas, zss, log_zs, n_acc / n_rejuv

    zss = broadcast_z((n_local, n_x))
    omega = torch.zeros(n_local, device=device)
    log_zs = torch.zeros(n_local, device=device)
    log_ev = torch.zeros((), device=device)
    acc_sum = torch.zeros((), device=device)
    n_rejuvs = 0
    ess_hist = []
    for t in range(horizon):
        if keyed:
            k_ext, k_res, k_rej = keys.split(keys.fold_in(k_loop, t), 3).unbind(-2)
        zss, incs = pf_step(thetas, zss, t, keys.split(k_ext, n_local) if keyed else None)
        omega = omega + incs
        log_zs = log_zs + incs
        if mesh is None:
            ess = effective_sample_size(omega)
        else:
            ess, log_z_inc = collective_weight_stats(omega, mesh, axis)
        ess_hist.append(ess)
        if bool(ess < ess_threshold * n_theta):
            if mesh is None:
                log_ev = log_ev + torch.logsumexp(omega, dim=0) - math.log(n_theta)
                idx = systematic_indices(k_res if keyed else gen, omega, n_theta)
                thetas, zss, log_zs = _take((thetas, zss, log_zs), idx)
            else:
                (thetas, zss, log_zs), _, inc = collective_resample(
                    shared, (thetas, zss, log_zs), omega, mesh, axis, mode="all_gather", log_z_inc=log_z_inc
                )
                log_ev = log_ev + inc
            thetas, zss, log_zs, acc = rejuvenate(thetas, zss, log_zs, t, k_rej if keyed else None)
            omega = torch.zeros(n_local, device=device)
            acc_sum = acc_sum + acc
            n_rejuvs += 1
    if mesh is None:
        log_total = torch.logsumexp(omega, dim=0)
    else:
        log_total = collective_log_normalizer(omega, mesh, axis) + math.log(n_theta)
        acc_sum = mesh.all_reduce_mean(acc_sum, axis)
    return SMC2Result(
        thetas=thetas,
        log_weights=omega - log_total,
        log_evidence=log_ev + log_total - math.log(n_theta),
        ess_history=torch.stack(ess_hist),
        rejuv_accept_rate=acc_sum / max(n_rejuvs, 1),
    )


__all__ = ["SMC2Result", "smc2"]

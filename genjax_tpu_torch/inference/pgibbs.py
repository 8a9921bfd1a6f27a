"""Particle Gibbs (conditional SMC with ancestor sampling) and
particle-marginal Metropolis-Hastings for state-space models.

Counterpart of ``genjax_tpu/inference/pgibbs.py``: ``csmc_sweep``, the
conditional bootstrap particle filter over a scanned kernel, whose retained
trajectory survives every resampling step, and the samplers built on it,
``particle_gibbs`` (iterated CSMC, Andrieu, Doucet & Holenstein 2010,
optionally with ancestor sampling, Lindsten, Jordan & Schon 2014) and
``pmmh`` (a random-walk parameter chain accepted on the particle filter's
unbiased marginal-likelihood estimate). A sweep is a Python loop over time
with the K particles vmapped per step, where the reference runs
``lax.scan``; the ancestral trace-back is a reverse loop over int64
ancestor indices, and the multinomial resampling is
``parallel.resampling.multinomial_indices``.

Under a key (``core/keys.py``) each function splits it as the reference
does and draws its draws: a sweep's step ``t`` takes ``k_anc, k_ext, k_ret,
k_pgas, k_proj = split(fold_in(scan_key, t), 5)`` (made for every step in
two hashes), the ancestors are ``categorical(k_anc, log_w, shape=(K,))``,
particle ``i`` extends under the ``i``-th of ``split(k_ext, K)``, and the
trace-back starts from ``categorical(final_key, log_w)``. A
``torch.Generator`` (an int seed makes one) is drawn from in sequence where
the reference splits a key.

>>> import torch
>>> import genjax_tpu_torch as g
>>> from genjax_tpu_torch.models import linear_gaussian_ssm
>>> kernel, exact = linear_gaussian_ssm()
>>> ys = torch.tensor([0.3, -0.1, 0.4])
>>> out = csmc_sweep(torch.Generator().manual_seed(0), kernel, 0.0, torch.zeros(3), g.C[:, "y"].set(ys), None,
...                  latent_selection=g.S["z"], n_particles=64)
>>> tuple(out.retained["z"].shape), bool(torch.isfinite(out.log_marginal))
((3,), True)
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.utils._pytree as pytree

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..dists import categorical
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.selection import Selection
from ..parallel.resampling import multinomial_indices


@Pytree.dataclass
class CSMCSweepResult(Pytree):
    """One conditional-SMC pass: the freshly sampled trajectory (latent
    choices stacked time-leading), its final carry, and the sweep's
    log-marginal-likelihood estimate."""

    retained: ChoiceMap
    final_carry: Any
    log_marginal: Any


@Pytree.dataclass
class PGibbsResult(Pytree):
    """``particle_gibbs`` output: the sweeps' retained trajectories (leaves
    ``(n_sweeps, T, ...)``) and log-marginal estimates."""

    trajectories: ChoiceMap
    log_marginals: Any


@Pytree.dataclass
class PMMHResult(Pytree):
    """``pmmh`` output: the parameter chain (leaves ``(n_steps, ...)``), the
    chain's log-priors and log-marginal estimates, and the acceptance
    rate."""

    params: Any
    log_priors: Any
    log_zs: Any
    accept_rate: Any


def _take0(tree, idx):
    return pytree.tree_map(lambda v: v[idx], tree)


def _set_last(tree, value):
    """``tree`` with the last slot of every leaf's leading axis set to
    ``value``'s leaf."""
    return pytree.tree_map(
        lambda b, s: torch.cat([b[:-1], torch.as_tensor(s, device=b.device).to(b.dtype)[None]]), tree, value)


def _stack(items: list):
    return pytree.tree_map(lambda *vs: torch.stack(vs), *items)


def csmc_sweep(
    gen: torch.Generator,
    kernel: GenerativeFunction,
    init_carry: Any,
    xs: Any,
    obs: ChoiceMap,
    retained: ChoiceMap | None,
    *,
    latent_selection: Selection,
    n_particles: int,
    ancestor_sampling: bool = True,
    n_steps: int | None = None,
) -> CSMCSweepResult:
    """One (conditional) bootstrap particle-filter sweep over a scanned
    kernel ``(carry, x) -> (carry, y)``, returning a trajectory drawn by
    ancestral trace-back, on ``gen``'s device.

    ``obs`` is the time-indexed observation constraint (``obs.get_submap(t)``
    at step ``t``). ``retained`` is ``None`` (an unconditional sweep, which
    starts a Gibbs chain) or a trajectory in the format this function
    returns: the kernel's latent choices, ``latent_selection``-filtered and
    stacked time-leading. With ``retained`` given, slot ``K-1`` holds it
    through every resampling step (CSMC); with ``ancestor_sampling=True``
    its ancestor is redrawn each step from ``w_j p(z_t^ret | carry_j)``
    (PGAS). Resampling is multinomial at every step, the textbook CSMC
    schedule."""
    k = n_particles
    dev = gen.device
    keyed = keys.is_key(gen)
    init_carry, xs, obs, retained = to_device((init_carry, xs, obs, retained), dev)
    leaves = [v for v in pytree.tree_leaves(xs) if isinstance(v, torch.Tensor)]
    t_count = leaves[0].shape[0] if leaves else n_steps
    if t_count is None:
        raise ValueError("csmc_sweep: xs is None/empty; pass n_steps.")

    def x_at(t):
        return pytree.tree_map(lambda v: v[t], xs) if leaves else None

    def extend_free(g, c, t, x):
        tr, w = kernel.generate(g, obs.get_submap(t), (c, x))
        return tr.get_retval()[0], w, tr.get_choices().filter_eager(latent_selection)

    if keyed:
        scan_key, final_gen = keys.split(gen).unbind(-2)
        step_keys = keys.split(keys.fold_in(scan_key, torch.arange(t_count, device=dev)), 5)
        streams = [tuple(ks.unbind(0)) for ks in step_keys.unbind(0)]
    else:
        final_gen = gen
        streams = [(gen,) * 5] * t_count

    carries = pytree.tree_map(
        lambda v: torch.as_tensor(v, device=dev).expand((k,) + tuple(torch.as_tensor(v).shape)).clone(), init_carry)
    log_w = torch.zeros(k, device=dev)
    log_z = torch.zeros((), device=dev)
    log_k = math.log(k)
    lat_hist, anc_hist = [], []
    for t, (k_anc, k_ext, k_ret, k_pgas, k_proj) in enumerate(streams):
        x = x_at(t)
        ret_t = None if retained is None else pytree.tree_map(lambda v: v[t], retained)
        # resample ancestors from the current weights
        log_z = log_z + torch.logsumexp(log_w, dim=0) - log_k
        anc = keys.categorical(k_anc, log_w, shape=(k,)) if keyed else multinomial_indices(gen, log_w, k)
        if ret_t is not None:
            if ancestor_sampling:
                # PGAS: the retained slot's ancestor by w_j p(ret_t | c_j);
                # assess scores the observation too, a constant across j
                full_t = ret_t | obs.get_submap(t)
                lp_trans = torch.func.vmap(lambda c: kernel.assess(full_t, (c, x))[0])(carries)
                a_ret = categorical.sample(k_pgas, log_w + lp_trans)
            else:
                a_ret = torch.tensor(k - 1, device=dev)
            anc = torch.cat([anc[:-1], a_ret.reshape(1)])
        parents = _take0(carries, anc)
        # extend every particle through the kernel
        carries, ws, lats = keys.vmap_streams(extend_free, k_ext, k, in_dims=(0, None, None))(parents, t, x)
        if ret_t is not None:
            # slot K-1 takes the retained latents; its bootstrap weight is
            # the observation's density alone: generate scores the latents
            # and the observation, and project subtracts the latents' prior
            parent_ret = pytree.tree_map(lambda v: v[-1], parents)
            tr_ret, w_full = kernel.generate(k_ret, ret_t | obs.get_submap(t), (parent_ret, x))
            proj = tr_ret.project(k_proj, latent_selection)
            carries = _set_last(carries, tr_ret.get_retval()[0])
            ws = torch.cat([ws[:-1], (w_full - proj).reshape(1)])
            lats = _set_last(lats, ret_t)
        log_w = ws
        lat_hist.append(lats)
        anc_hist.append(anc)
    log_marginal = log_z + torch.logsumexp(log_w, dim=0) - log_k

    # the ancestral trace-back: anc_hist[t] maps a slot at step t to its
    # parent slot at step t-1; walk back from a draw on the final weights
    b = categorical.sample(final_gen, log_w)
    path = [b]
    for t in range(t_count - 1, 0, -1):
        b = anc_hist[t][b]
        path.append(b)
    path = torch.stack(path[::-1])
    steps = torch.arange(t_count, device=dev)
    new_retained = pytree.tree_map(lambda v: v[steps, path], _stack(lat_hist))
    return CSMCSweepResult(new_retained, _take0(carries, path[-1]), log_marginal)


def particle_gibbs(
    gen,
    kernel: GenerativeFunction,
    init_carry: Any,
    xs: Any,
    obs: ChoiceMap,
    *,
    latent_selection: Selection,
    n_particles: int,
    n_sweeps: int,
    ancestor_sampling: bool = True,
    n_steps: int | None = None,
    device="cuda",
) -> PGibbsResult:
    """Iterated conditional SMC targeting the smoothing posterior ``p(z_{0:T}
    | y_{0:T})``: each sweep runs a conditional particle filter holding the
    previous sweep's trajectory and draws a new one, a Markov kernel that
    leaves the exact posterior invariant for any ``n_particles >= 2``.

    Runs on ``device``, the card by default (``device="cpu"`` for the CPU;
    without a card the default raises); ``gen`` is a generator there or an
    int seed. Returns every sweep's trajectory (leaves ``(n_sweeps, T,
    ...)``); burn in and thin at the call site."""
    gen, device = keys.entry_stream(gen, device, "particle_gibbs")
    kw = dict(latent_selection=latent_selection, n_particles=n_particles, n_steps=n_steps)
    if keys.is_key(gen):
        init_gen, sweep_key = keys.split(gen).unbind(-2)
        sweep_gens = keys.split(sweep_key, n_sweeps).unbind(-2)
    else:
        init_gen, sweep_gens = gen, [gen] * n_sweeps
    retained = csmc_sweep(init_gen, kernel, init_carry, xs, obs, None, **kw).retained
    trajs, log_zs = [], []
    for sweep_gen in sweep_gens:
        out = csmc_sweep(sweep_gen, kernel, init_carry, xs, obs, retained, ancestor_sampling=ancestor_sampling, **kw)
        retained = out.retained
        trajs.append(retained)
        log_zs.append(out.log_marginal)
    return PGibbsResult(_stack(trajs), torch.stack(log_zs))


def pmmh(
    gen,
    init_params: Any,
    log_prior_fn,
    log_z_fn,
    *,
    n_steps: int,
    step_scales: Any,
    device="cuda",
) -> PMMHResult:
    """Particle-marginal Metropolis-Hastings (Andrieu et al. 2010, sec. 2.4):
    a Gaussian random-walk chain over a parameter pytree, accepted on
    ``log_prior_fn(params) + log_z_fn(gen, params)``, where ``log_z_fn`` is
    an unbiased marginal-likelihood estimator (a particle filter's
    ``log_marginal``, or an exact marginal: then this is marginal MH). The
    current estimate rides with the chain.

    Runs on ``device``, the card by default (``device="cpu"`` for the CPU;
    without a card the default raises); ``gen`` is a generator there or an
    int seed. ``step_scales`` is a scalar or a pytree matching
    ``init_params``."""
    gen, device = keys.entry_stream(gen, device, "pmmh")
    keyed = keys.is_key(gen)
    params = pytree.tree_map(lambda v: torch.as_tensor(v, device=device), init_params)
    leaves, spec = pytree.tree_flatten(params)
    scale_leaves = pytree.tree_leaves(step_scales)
    if len(scale_leaves) != len(leaves):
        scale_leaves = [step_scales] * len(leaves)
    scales = [torch.as_tensor(s, device=device) for s in scale_leaves]

    def score(fn, *a):
        return torch.as_tensor(fn(*a), device=device).to(torch.float32)

    if keyed:
        k_init, k_chain = keys.split(gen).unbind(-2)
        steps = [tuple(ks.unbind(0)) for ks in keys.split(keys.split(k_chain, n_steps), 3).unbind(0)]
    else:
        k_init, steps = gen, [(gen,) * 3] * n_steps

    def noise(g, v, i):
        dtype = torch.promote_types(v.dtype, torch.float32)
        if keyed:
            return keys.normal(keys.split(g, len(scales))[i], v.shape).to(dtype)
        return torch.randn(v.shape, generator=g, device=device, dtype=dtype)

    lp, lz = score(log_prior_fn, params), score(log_z_fn, k_init, params)
    chain, lps, lzs, accepts = [], [], [], []
    for k_prop, k_z, k_acc in steps:
        prop = pytree.tree_unflatten(
            [v + s * noise(k_prop, v, i) for i, (v, s) in enumerate(zip(pytree.tree_leaves(params), scales))], spec)
        lp_new, lz_new = score(log_prior_fn, prop), score(log_z_fn, k_z, prop)
        log_u = torch.log(keys.uniform(k_acc) if keyed else torch.rand((), generator=k_acc, device=device))
        accept = log_u < (lp_new + lz_new) - (lp + lz)
        params, lp, lz = pytree.tree_map(lambda a, b: torch.where(accept, a, b), (prop, lp_new, lz_new),
                                         (params, lp, lz))
        chain.append(params)
        lps.append(lp)
        lzs.append(lz)
        accepts.append(accept)
    return PMMHResult(_stack(chain), torch.stack(lps), torch.stack(lzs),
                      torch.stack(accepts).to(torch.float32).mean())

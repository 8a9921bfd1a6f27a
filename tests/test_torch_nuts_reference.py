"""The port's NUTS trace path in law against the reference's: the vmapped
single-chain ``nuts_transition`` against
``genjax_tpu.kernels.nuts.nuts_transition`` vmapped over split keys, and
``run_chains_nuts`` against ``genjax_tpu.inference.mcmc.run_chains_nuts``,
from the same numpy starts with the same step size, inverse mass and depth.

The port draws from a ``torch.Generator`` where the reference splits keys,
so no chain is compared draw for draw: each per-chain statistic (the accept
statistic, leapfrogs, divergence, the depth histogram, the positions'
moments and squared jumps) is held to the same mean in both batches within
4 Monte Carlo standard errors, the chains being independent.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import genjax_tpu as gj
import genjax_tpu_torch as g
from genjax_tpu.inference.mcmc import run_chains_nuts as ref_run_chains_nuts
from genjax_tpu.kernels import nuts as ref_nuts
from genjax_tpu.models import hierarchical_regression as ref_hierarchical_regression
from genjax_tpu_torch.kernels.nuts import nuts_transition
from genjax_tpu_torch.models import hierarchical_regression
from torch_threads import _one_thread  # noqa: F401


def gen_at(seed):
    return torch.Generator().manual_seed(seed)


def flagship_data():
    X = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(16,)).astype(np.float32)
    return X, y


_PREC = torch.tensor([[1.0, 0.9], [0.9, 1.0]]).inverse()  # correlation 0.9, unit variances


SE_LIMIT = 4.0  # Monte Carlo standard errors of a two-sample difference of means


def _same_law(port: dict, ref: dict, n: int) -> None:
    """Each per-chain statistic (chains independent, ``n`` of them in each
    batch) has the same mean in both batches to ``SE_LIMIT`` standard errors
    of the difference; a statistic constant in both is equal."""
    for key in port:
        a, b = np.asarray(port[key], np.float64), np.asarray(ref[key], np.float64)
        gap = np.abs(a.mean(0) - b.mean(0))
        se = np.sqrt((a.var(0) + b.var(0)) / n)
        bad = np.where(se > 0, gap > SE_LIMIT * se, gap > 0)
        assert not bad.any(), (key, a.mean(0), b.mean(0), se)


_SCALES = np.asarray([0.1, 10.0], np.float32)
_NARROW = np.asarray([1.0, 0.1], np.float32)
_PREC_NP = np.linalg.inv(np.asarray([[1.0, 0.9], [0.9, 1.0]], np.float32))

# name: (one chain's log-density in torch and in jax, D, eps, inv_mass)
REF_TARGETS = {
    "standard_normal": (lambda z: -0.5 * (z * z).sum(), lambda z: -0.5 * jnp.sum(z * z), 3, 0.5, None),
    "correlated": (lambda z: -0.5 * z @ _PREC @ z, lambda z: -0.5 * z @ jnp.asarray(_PREC_NP) @ z, 2, 0.25,
                   None),
    "conjugate": (lambda z: -0.5 * (z * z).sum() - 0.5 * ((2.0 - z) ** 2).sum(),
                  lambda z: -0.5 * jnp.sum(z * z) - 0.5 * jnp.sum((2.0 - z) ** 2), 1, 0.6, None),
    # a 100x-conditioned target under the matched (D, 1) inverse mass
    "inv_mass": (lambda z: -0.5 * ((z / torch.from_numpy(_SCALES)) ** 2).sum(),
                 lambda z: -0.5 * jnp.sum((z / _SCALES) ** 2), 2, 0.4, (_SCALES**2)[:, None]),
    # a step 3x the narrow axis' scale, past its stability limit: trees end
    # in their first doublings, about 40% by divergence (the energy gate at
    # 1000), the rest by a U-turn
    "divergent": (lambda z: -0.5 * ((z / torch.from_numpy(_NARROW)) ** 2).sum(),
                  lambda z: -0.5 * jnp.sum((z / _NARROW) ** 2), 2, 0.3, None),
}


def _per_chain_stats(z0, zs, infos, max_depth):
    """Per-chain statistics of ``T`` chained transitions: the means over the
    transitions of the accept statistic, leapfrogs, divergence and each
    depth's indicator, and the last position, its square and its squared
    jump from the start."""
    acc = np.stack([np.asarray(i.accept_prob, np.float64) for i in infos], 1).mean(1)
    leaps = np.stack([np.asarray(i.num_leapfrogs, np.float64) for i in infos], 1).mean(1)
    div = np.stack([np.asarray(i.diverged, np.float64) for i in infos], 1).mean(1)
    depth = np.stack([np.asarray(i.depth) for i in infos], 1)
    hist = np.stack([(depth == k).mean(1) for k in range(max_depth + 1)], 1)
    z = np.asarray(zs, np.float64)
    return {"accept": acc, "leapfrogs": leaps, "diverged": div, "depth histogram": hist,
            "z": z, "z^2": z * z, "jump^2": (z - z0) ** 2}


@pytest.mark.parametrize("name", sorted(REF_TARGETS))
def test_vmapped_transition_in_law_with_the_reference(name):
    """2,048 chains from the same numpy start, 4 chained transitions at
    depth 5 by the port's vmapped ``nuts_transition`` and the reference's,
    vmapped over split keys, with the same ``eps``, ``inv_mass`` and
    ``max_depth``: the mean accept statistic, leapfrogs, divergence rate,
    depth histogram, and the moments and squared jump of the positions
    agree to 4 Monte Carlo SE."""
    ld, ld_jax, d, eps, inv_mass = REF_TARGETS[name]
    n, steps, depth = 2048, 4, 5
    z0 = np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)

    gen = gen_at(4)
    im_t = None if inv_mass is None else torch.from_numpy(inv_mass)
    step = torch.func.vmap(lambda z: nuts_transition(ld, z, gen, eps, max_depth=depth, inv_mass=im_t),
                           randomness="different")
    z, infos = torch.from_numpy(z0), []
    for _ in range(steps):
        z, info = step(z)
        infos.append(info)
    port = _per_chain_stats(z0, z.numpy(), infos, depth)

    im_j = None if inv_mass is None else jnp.asarray(inv_mass)
    ref_step = jax.jit(jax.vmap(lambda z, k: ref_nuts.nuts_transition(ld_jax, z, k, eps, max_depth=depth,
                                                                      inv_mass=im_j)))
    zj, ref_infos = jnp.asarray(z0), []
    for key in jr.split(jr.key(4), steps):
        zj, info = ref_step(zj, jr.split(key, n))
        ref_infos.append(info)
    ref = _per_chain_stats(z0, np.asarray(zj), ref_infos, depth)
    _same_law(port, ref, n)
    if name == "divergent":  # the gate is exercised, in both
        assert 0.05 < port["diverged"].mean() < 0.95 and 0.05 < ref["diverged"].mean() < 0.95


def _flagship_starts(n):
    rng = np.random.default_rng(12)
    tau = np.exp(0.5 * rng.normal(size=n)).astype(np.float32)
    w = (tau[:, None] * rng.normal(size=(n, 8))).astype(np.float32)
    return tau, w


def test_run_chains_nuts_in_law_with_the_reference():
    """The flagship (9 dims over two addresses): 1,024 chains from the same
    numpy positions, 4 transitions at depth 5, the port's ``run_chains_nuts``
    on the CPU (its twin over the GFI's ``assess``) against the reference's.
    The accept statistic within 0.02 and the mean leapfrogs within 5% (the
    chip script's limits for the twin); each position's mean, square and
    squared jump within 4 Monte Carlo SE; ``y`` stays fixed."""
    n, steps, depth, eps = 1024, 4, 5, 0.05
    X, y = flagship_data()
    tau0, w0 = _flagship_starts(n)
    model = hierarchical_regression(X)
    obs = g.C["y"].set(torch.from_numpy(y))
    gen = gen_at(5)
    trs = torch.func.vmap(
        lambda t, w: model.generate(gen, g.C["tau"].set(t) | g.C["w"].set(w) | obs, ())[0],
        randomness="different",
    )(torch.from_numpy(tau0), torch.from_numpy(w0))
    new, acc, leaps = g.run_chains_nuts(gen, trs, g.S["w"] | g.S["tau"], eps=eps, max_depth=depth,
                                        n_steps=steps)
    assert g.run_chains_nuts.last_backend == "torch" and torch.equal(new["y"], trs["y"])

    ref_model = ref_hierarchical_regression(X)
    ref_obs = gj.C["y"].set(jnp.asarray(y))
    ref_trs = jax.vmap(
        lambda t, w: ref_model.generate(jr.key(0), gj.C["tau"].set(t) | gj.C["w"].set(w) | ref_obs, ())[0]
    )(jnp.asarray(tau0), jnp.asarray(w0))
    ref_new, ref_acc, ref_leaps = jax.jit(
        lambda trs: ref_run_chains_nuts(jr.key(5), trs, gj.S["w"] | gj.S["tau"], eps=eps, max_depth=depth,
                                        n_steps=steps)
    )(ref_trs)
    assert abs(float(acc) - float(ref_acc)) < 0.02, (float(acc), float(ref_acc))
    assert abs(float(leaps) - float(ref_leaps)) < 0.05 * float(ref_leaps), (float(leaps), float(ref_leaps))
    start = np.concatenate([tau0[:, None], w0], 1)

    def stats(tau, w):
        z = np.concatenate([np.asarray(tau, np.float64)[:, None], np.asarray(w, np.float64)], 1)
        return {"z": z, "z^2": z * z, "jump^2": (z - start) ** 2}

    ref_chm = ref_new.get_choices()
    _same_law(stats(new["tau"].numpy(), new["w"].numpy()), stats(ref_chm["tau"], ref_chm["w"]), n)

"""Variational inference: ADEV-differentiable guide distributions and
gradient-estimating loss builders.

Counterpart of ``genjax_tpu/inference/vi.py``: ``adev_distribution``, the
nine wrapped guide distributions, ``ELBO``, ``IWELBO``, ``PWake`` and
``QWake`` (each an ``@expectation`` program around SMC's
``estimate_normalizing_constant`` or a posterior approximation's draw), and
the optimizer driver ``fit``. Each loss builder returns
``grad_estimate(gen, args)``. Under a key (``core/keys.py``) it splits the
key into the model's stream and the transform's as the reference does, and
draws the reference's draws. Under a ``torch.Generator`` the model's
randomness comes from generators forked off ``gen`` (``adev.core.fork``),
which every run of the program restarts (``streams=``), and the strategies
draw from ``gen``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ..adev import core as adev_core
from ..adev import primitives as adev_prims
from ..adev.core import ADEVPrimitive, expectation, fork
from ..core import keys
from ..dists import catalog as _catalog
from ..dists.distribution import ExactDensity, exact_density
from ._adam import adam_init, adam_update
from .smc import Importance, ImportanceK
from .sp import SampleDistribution, Target

GradientEstimate = Any


def adev_distribution(adev_primitive: ADEVPrimitive, differentiable_logpdf: Callable, name: str) -> ExactDensity:
    """An ``ExactDensity`` whose sampler is an ADEV primitive: a
    distribution for guide programs, differentiable through
    ``@expectation`` losses."""

    def sampler(gen, *args):
        return adev_core.sample_primitive(adev_primitive, *args, gen=gen)

    def logpdf(v, *args):
        lp = differentiable_logpdf(v, *args)
        return torch.sum(lp) if lp.dim() else lp

    return exact_density(sampler, logpdf, name)


def _logpdf_of(dist) -> Callable:
    return lambda v, *args: dist.logpdf(v, *args)


def _geometric_logpdf(v, p):
    p = torch.as_tensor(p)
    return _catalog.geometric.logpdf(v, torch.log(p) - torch.log1p(-p))


flip_enum = adev_distribution(adev_prims.flip_enum, _logpdf_of(_catalog.flip), "flip_enum")
flip_mvd = adev_distribution(adev_prims.flip_mvd, _logpdf_of(_catalog.flip), "flip_mvd")
flip_reinforce = adev_distribution(adev_prims.flip_reinforce, _logpdf_of(_catalog.flip), "flip_reinforce")
categorical_enum = adev_distribution(
    adev_prims.categorical_enum_parallel, _logpdf_of(_catalog.categorical), "categorical_enum"
)
normal_reinforce = adev_distribution(adev_prims.normal_reinforce, _logpdf_of(_catalog.normal), "normal_reinforce")
normal_reparam = adev_distribution(adev_prims.normal_reparam, _logpdf_of(_catalog.normal), "normal_reparam")
mv_normal_diag_reparam = adev_distribution(
    adev_prims.mv_normal_diag_reparam, _logpdf_of(_catalog.mv_normal_diag), "mv_normal_diag_reparam"
)
geometric_reinforce = adev_distribution(adev_prims.geometric_reinforce, _geometric_logpdf, "geometric_reinforce")
beta_implicit = adev_distribution(adev_prims.beta_implicit, _logpdf_of(_catalog.beta), "beta_implicit")


# ----------------------------------------------------------------------
# the optimizer driver
# ----------------------------------------------------------------------


def fit(
    grad_estimate,
    phi0,
    *,
    key=None,
    gen=None,
    n_steps: int = 500,
    learning_rate: float = 0.05,
    batch_size: int = 16,
):
    """Adam (optax's update with its defaults) on the mean of
    ``batch_size`` gradient estimates a step, drawn in one
    ``torch.func.vmap``; any loss's ``grad_estimate``. Give the
    stream as ``key=``, the reference's keyword, or ``gen=``, a key or a
    ``torch.Generator``. A key is split into a key a step and each of those
    into a key an estimate, as the reference's ``fit`` splits it; a
    generator is shared by the estimates (``randomness="different"``).
    Runs where the stream lives and returns the parameters after
    ``n_steps``."""
    if (key is None) == (gen is None):
        raise ValueError("fit: give the stream as key= or as gen=, not both")
    stream = gen if key is None else key
    phi = pytree.tree_map(lambda v: torch.as_tensor(v, dtype=torch.float32, device=stream.device), phi0)
    state = adam_init(phi)
    for k in keys.split_stream(stream, n_steps):
        batched = keys.vmap_streams(lambda s, p: grad_estimate(s, (p,))[0], k, batch_size, in_dims=(None,))
        g = pytree.tree_map(lambda v: torch.mean(v, dim=0), batched(phi))
        phi, state = adam_update(g, state, phi, learning_rate)
    return phi


# ----------------------------------------------------------------------
# loss builders
# ----------------------------------------------------------------------


def _loss_streams(gen, n: int, at: int) -> tuple:
    """``(transform, model, rewound)``: the transform's stream, the model's
    ``n`` streams and the generators each run of the program restarts.
    Under a key these are the keys of ``split(key, n + 1)``, the
    transform's at position ``at``, as the reference's loss splits them;
    under a generator, ``gen`` and ``n`` generators forked off it."""
    if keys.is_key(gen):
        split = list(keys.split(gen, n + 1).unbind(-2))
        return split.pop(at), tuple(split), ()
    forks = tuple(fork(gen) for _ in range(n))
    return gen, forks, forks


def ELBO(guide: SampleDistribution, make_target: Callable[..., Target]) -> Callable:
    """The gradient of the negative evidence lower bound ``-E_q[log p / q]``."""

    def grad_estimate(gen, args: tuple) -> GradientEstimate:
        adev_gen, (model_gen,), rewound = _loss_streams(gen, 1, 1)

        @expectation
        def _loss(*args):
            target = make_target(*args)
            w = Importance(target, guide).estimate_normalizing_constant(model_gen, target, device=model_gen.device)
            return -w

        return _loss.grad_estimate(adev_gen, args, streams=rewound)

    return grad_estimate


def IWELBO(proposal: SampleDistribution, make_target: Callable[..., Target], N: int) -> Callable:
    """The gradient of the negative importance-weighted ELBO with ``N``
    particles."""

    def grad_estimate(gen, args: tuple) -> GradientEstimate:
        adev_gen, (model_gen,), rewound = _loss_streams(gen, 1, 1)

        @expectation
        def _loss(*args):
            target = make_target(*args)
            alg = ImportanceK(target, proposal, N)
            return -alg.estimate_normalizing_constant(model_gen, target, device=model_gen.device)

        return _loss.grad_estimate(adev_gen, args, streams=rewound)

    return grad_estimate


def PWake(posterior_approx: SampleDistribution, make_target: Callable[..., Target]) -> Callable:
    """The gradient of the wake-phase model-learning loss ``-E_{z ~
    approx}[log p(z, x)]``."""

    def grad_estimate(gen, args: tuple) -> GradientEstimate:
        adev_gen, (g1, g2), rewound = _loss_streams(gen, 2, 0)

        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            _, sample = posterior_approx.random_weighted(g1, target)
            tr, _ = target.importance(g2, sample)
            return -tr.get_score()

        return _loss.grad_estimate(adev_gen, args, streams=rewound)

    return grad_estimate


def QWake(
    proposal: SampleDistribution, posterior_approx: SampleDistribution, make_target: Callable[..., Target]
) -> Callable:
    """The gradient of the wake-phase guide-learning loss ``-E_{z ~
    approx}[log q(z | x)]``."""

    def grad_estimate(gen, args: tuple) -> GradientEstimate:
        adev_gen, (g1, g2), rewound = _loss_streams(gen, 2, 0)

        @expectation
        def _loss(*target_args):
            target = make_target(*target_args)
            _, sample = posterior_approx.random_weighted(g1, target)
            return -proposal.estimate_logpdf(g2, sample, target)

        return _loss.grad_estimate(adev_gen, args, streams=rewound)

    return grad_estimate

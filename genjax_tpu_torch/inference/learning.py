"""Gradient-based point estimation over selected choices.

Counterpart of ``genjax_tpu/inference/learning.py``: ``fit_map`` maximizes
the model's log-joint over the selected (continuous) choices, MAP
estimation or MLE under a flat prior, with Adam (optax's update) from
``n_restarts`` prior draws at once, the best restart winning; and
``laplace_approximation`` adds the Gaussian curvature at the mode by
``torch.func.hessian``. Both reuse the raveled selection of the gradient
requests (``requests.grad_view.split_ravel``), so they work on any ``@gen``
model through ``assess``. Both make their own randomness: they take a key
(``core/keys.py``), a ``torch.Generator`` or an int seed, and ``device``,
the card unless the caller asks for the CPU. Under a key restart ``i``
starts from a prior draw under the ``i``-th of ``split(key, n_restarts)``,
as the reference's do; a generator gives each restart its own draw
(``randomness="different"``).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core import keys
from ..core.device import to_device
from ..core.pytree import Pytree
from ..dists.catalog import cholesky_or_nan
from ..generative.choice_map import ChoiceMap
from ..generative.gfi import GenerativeFunction
from ..generative.mask import Mask
from ..generative.selection import Selection
from ._adam import adam_init, adam_update
from .requests.grad_view import split_ravel


@Pytree.dataclass
class MAPResult(Pytree):
    """``choices``: the optimized selected choices; ``log_joint``: the
    log-density reached; ``trajectory``: the best restart's log-joint at
    each step (before its update)."""

    choices: Any
    log_joint: Any
    trajectory: Any

    def __getitem__(self, addr):
        path = addr if isinstance(addr, tuple) else (addr,)
        v = self.choices.get_submap(*path).get_value()
        return v.value if isinstance(v, Mask) else v


def _fit_map(gen, model, constraint, args, selection, n_steps, learning_rate, n_restarts):
    """``fit_map`` on a placed key or generator, with the log-joint it
    climbed."""
    tr, _ = model.generate(gen, constraint, args)
    chm = tr.get_choices()
    frozen = chm.filter(~selection)
    _z0, rebuild = split_ravel(chm.filter_eager(selection))

    def log_joint(z):
        w, _ = model.assess(rebuild(z).merge(frozen), args)
        return w

    def init_one(stream):
        t, _ = model.generate(stream, constraint, args)
        z, _ = split_ravel(t.get_choices().filter_eager(selection))
        return z.to(torch.float32)

    zs = keys.vmap_streams(init_one, gen, n_restarts)()
    neg_grad = torch.func.vmap(torch.func.grad_and_value(lambda z: -log_joint(z)))
    state = adam_init(zs)
    trajectory = []
    for _ in range(n_steps):
        g, loss = neg_grad(zs)
        zs, state = adam_update(g, state, zs, learning_rate)
        trajectory.append(torch.max(-loss))
    ljs = torch.func.vmap(log_joint)(zs)
    best = torch.argmax(ljs)
    traj = torch.stack(trajectory) if trajectory else torch.zeros(0, device=gen.device)
    return MAPResult(choices=rebuild(zs[best]), log_joint=ljs[best], trajectory=traj), log_joint


def fit_map(
    gen,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    selection: Selection,
    *,
    n_steps: int = 300,
    learning_rate: float = 0.05,
    n_restarts: int = 8,
    device="cuda",
) -> MAPResult:
    """Maximize ``log p(selection, constraint)`` over the selected choices:
    ``n_restarts`` starts drawn from the prior, Adam on each (one
    ``torch.func.vmap``), the best returned."""
    gen, device = keys.entry_stream(gen, device, "fit_map")
    constraint, args = to_device((constraint, args), device)
    return _fit_map(gen, model, constraint, args, selection, n_steps, learning_rate, n_restarts)[0]


@Pytree.dataclass
class LaplaceResult(Pytree):
    """The Gaussian approximation at the MAP point: ``mean`` and ``cov``
    over the raveled selection (``unpack`` maps a raveled vector back to
    the selection's choice map), and the Laplace evidence estimate
    ``log_marginal = log p(y, z_hat) + d/2 log 2 pi - 1/2 log|H|``."""

    map_result: MAPResult
    mean: Any
    cov: Any
    log_marginal: Any

    def unpack(self, z):
        _flat, rebuild = split_ravel(self.map_result.choices)
        return rebuild(z)


def laplace_approximation(
    gen,
    model: GenerativeFunction,
    constraint: ChoiceMap,
    args: tuple,
    selection: Selection,
    *,
    device="cuda",
    **fit_kwargs,
) -> LaplaceResult:
    """``fit_map``, then the inverse of the negative Hessian of the
    log-joint at the mode as the covariance. Exact for Gaussian posteriors.
    Where the negative Hessian is not positive definite (a saddle, an
    unconverged fit) the approximation does not exist: ``cov`` and
    ``log_marginal`` are NaN, as in the reference, and nothing raises or
    waits on the card."""
    gen, device = keys.entry_stream(gen, device, "laplace_approximation")
    constraint, args = to_device((constraint, args), device)
    kw = {"n_steps": 300, "learning_rate": 0.05, "n_restarts": 8, **fit_kwargs}
    res, log_joint = _fit_map(
        gen, model, constraint, args, selection, kw["n_steps"], kw["learning_rate"], kw["n_restarts"]
    )
    z_hat, _ = split_ravel(res.choices)
    prec = -torch.func.hessian(log_joint)(z_hat)
    d = z_hat.shape[0]
    # definiteness by the Cholesky route: the sign of the determinant
    # misses saddles of even signature
    pos_def = torch.all(torch.isfinite(cholesky_or_nan(prec)))
    _sign, logdet = torch.linalg.slogdet(prec)
    logdet = torch.where(pos_def, logdet, torch.nan)
    cov = torch.where(pos_def, torch.linalg.inv_ex(prec)[0], torch.nan)
    log_marginal = res.log_joint + 0.5 * d * math.log(2.0 * math.pi) - 0.5 * logdet
    return LaplaceResult(map_result=res, mean=z_hat, cov=cov, log_marginal=log_marginal)

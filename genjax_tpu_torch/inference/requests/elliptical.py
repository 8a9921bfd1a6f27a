"""Elliptical slice sampling as an edit request: the trace-level
counterpart of ``kernels/elliptical.py``.

Counterpart of ``genjax_tpu/inference/requests/elliptical.py``. The request
targets a model whose selected choices carry a (multivariate) Gaussian
prior; the likelihood is everything else in the trace, computed as
``assess(joint) - N(z; mean, chol chol^T)`` over the raveled selected
values. One transition draws the ellipse through the current value and a
fresh prior draw and shrinks the angle bracket until the slice level is met
(Murray, Adams & MacKay 2010). The transition is in detailed balance with
the posterior, so the SMCP3 weight is 0 and ``mh`` always accepts. Under a
key the draws are the reference's: ``k_nu, k_u, k_theta, k_update =
split(key, 4)``, the shrink step ``i``'s uniform under ``fold_in(k_theta, i
+ 1)``, and the ``Update`` under ``k_update``; a generator is drawn in
sequence.

The reference's shrink is a ``lax.while_loop``. Here it runs the fixed
budget of ``max_iters`` shrink steps, masked: every step evaluates the
likelihood, a lane that has met the slice keeps its angle, and every bound
is a function of the step index alone, so the transition runs under
``torch.func.vmap`` over chains. A lane still outside the slice after the
budget stays where it was (an exact no-op, as the reference's). The
backward request carries ``exhausted``, True where that happened: under
``torch.func.vmap`` of ``Trace.edit`` it counts the lanes that ran out.

>>> import torch
>>> import genjax_tpu_torch as g
>>> @g.gen
... def model():
...     mu = g.normal(0.0, 1.0) @ "mu"
...     _ = g.normal(mu, 1.0) @ "y"
>>> gen = torch.Generator().manual_seed(0)
>>> tr, _ = model.generate(gen, g.C["y"].set(1.0), ())
>>> new_tr, w, _rd, bwd = tr.edit(gen, EllipticalSlice(g.S["mu"]))
>>> float(w), bool(bwd.exhausted)
(0.0, False)
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ...core import keys
from ...core.diff import Diff
from ...core.pytree import Pytree
from ...generative.concepts import Argdiffs, EditRequest, Retdiff, Update, Weight
from ...generative.selection import Selection
from ...generative.trace import Trace
from .grad_view import selected_logdensity

_TWO_PI = 2.0 * math.pi


def _gaussian_logpdf(z, mean, chol):
    """``log N(z; mean, chol chol^T)``; ``chol`` lower ``(d, d)``, or a
    ``(d,)`` or scalar standard deviation."""
    c = z - mean
    if chol.ndim == 2:
        a = torch.linalg.solve_triangular(chol, c[:, None], upper=False)[:, 0]
        logdet = torch.sum(torch.log(torch.diagonal(chol)))
    else:
        std = torch.broadcast_to(chol, z.shape)
        a = c / std
        logdet = torch.sum(torch.log(std))
    return -0.5 * torch.sum(a * a) - logdet - 0.5 * z.shape[0] * math.log(2.0 * math.pi)


def _ess_draws(gen, z0, max_iters: int):
    """The transition's draws ``(eps, u, u_theta, us)``: under a key the
    reference's (``split(gen, 4)``'s first three; shrink step ``i``'s uniform
    under ``fold_in(k_theta, i + 1)``), under a generator the same shapes in
    that order."""
    if keys.is_key(gen):
        k_nu, k_u, k_theta = keys.split(gen, 4).unbind(-2)[:3]
        steps = torch.arange(1, max_iters + 1, device=gen.device)
        return (keys.normal(k_nu, tuple(z0.shape)), keys.uniform(k_u), keys.uniform(k_theta),
                keys.uniform(keys.fold_in(k_theta, steps)))
    dev, dt = z0.device, z0.dtype
    return (torch.randn(z0.shape, generator=gen, device=dev, dtype=dt),
            torch.rand((), generator=gen, device=dev, dtype=dt), torch.rand((), generator=gen, device=dev, dtype=dt),
            torch.rand((max_iters,), generator=gen, device=dev, dtype=dt))


def ess_transition(gen, loglik, z0, mean, chol, max_iters: int):
    """One elliptical slice transition of ``z0 (d,)`` under the prior ``N(mean,
    chol chol^T)`` and the log-likelihood ``loglik``, over the fixed budget
    of ``max_iters`` masked shrink steps. Draws (``_ess_draws``) the prior
    direction, the slice level, the first angle and one uniform a shrink
    step, under a key or from a generator. Returns ``(z1, exhausted)``."""
    eps, u, u_theta, us = _ess_draws(gen, z0, max_iters)
    nu = chol @ eps if chol.ndim == 2 else torch.broadcast_to(chol, z0.shape) * eps
    log_y = loglik(z0) + torch.log(u)
    theta = u_theta * _TWO_PI
    centered = z0 - mean

    def proposal(angle):
        return mean + centered * torch.cos(angle) + nu * torch.sin(angle)

    ok = loglik(proposal(theta)) > log_y
    lo, hi = theta - _TWO_PI, theta
    for i in range(max_iters):
        lo_i = torch.where(theta < 0, theta, lo)
        hi_i = torch.where(theta < 0, hi, theta)
        theta_i = lo_i + (hi_i - lo_i) * us[i]
        ok_i = loglik(proposal(theta_i)) > log_y
        # a lane that met the slice keeps its angle and bracket
        lo, hi, theta = (torch.where(ok, a, b) for a, b in ((lo, lo_i), (hi, hi_i), (theta, theta_i)))
        ok = ok | ok_i
    return torch.where(ok, proposal(theta), z0), ~ok


@Pytree.dataclass
class EllipticalSlice(EditRequest):
    """One elliptical-slice transition over the selected choices.

    ``mean``/``chol`` describe the selected choices' Gaussian prior over
    their raveled vector: ``chol`` is a lower Cholesky factor ``(d, d)``, or
    a ``(d,)``/scalar standard deviation for diagonal priors. ``max_iters``
    is the shrink budget. ``exhausted`` is set on the backward request an
    edit returns (True where the budget ran out); it plays no part in an
    edit."""

    selection: Selection
    mean: Any = 0.0
    chol: Any = 1.0
    max_iters: int = Pytree.static(default=64)
    exhausted: Any = None

    def edit(
        self, gen: torch.Generator, tr: Trace, argdiffs: Argdiffs
    ) -> tuple[Trace, Weight, Retdiff, EditRequest]:
        if not Diff.static_check_no_change(argdiffs):
            raise NotImplementedError("EllipticalSlice requires unchanged arguments.")
        z0, logdensity, to_choices = selected_logdensity(
            tr.get_gen_fn(), tr.get_choices(), self.selection, Diff.tree_primal(argdiffs)
        )
        mean = torch.broadcast_to(torch.as_tensor(self.mean, dtype=z0.dtype, device=z0.device), z0.shape)
        chol = torch.as_tensor(self.chol, dtype=z0.dtype, device=z0.device)

        def loglik(z):
            return logdensity(z) - _gaussian_logpdf(z, mean, chol)

        z1, exhausted = ess_transition(gen, loglik, z0, mean, chol, self.max_iters)
        k_update = keys.split(gen, 4)[3] if keys.is_key(gen) else gen
        final_trace, _, retdiff, _ = Update(to_choices(z1)).edit(k_update, tr, argdiffs)
        return (
            final_trace,
            torch.zeros((), device=z0.device),
            retdiff,
            EllipticalSlice(self.selection, self.mean, self.chol, self.max_iters, exhausted),
        )
